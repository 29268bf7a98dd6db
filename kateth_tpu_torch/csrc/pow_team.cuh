// K2's arithmetic: a Montgomery product split across a team of threads of
// one warp, and the sliding-window pow chain that runs on it.
//
// Why a team.  A pow chain is one long dependent chain of products on few
// lanes (128 at the verify batch, 1 in the easy part's inverse), so the
// time of one product, not the card's multiply rate, sets K2's time.
// field.cuh's one-thread CIOS runs every multiply-add of a product on one
// carry flag: about 580 dependent instructions, 1.6 us a product on the
// H100.
//
// The team.  Thread t holds limbs [2t, 2t + 2) of each operand and of the
// accumulator (K = 2 limbs a thread: 6 threads over Fp, 4 over Fr), and
// every thread holds all N limbs of the multiplier b.  Round i of CIOS
// adds a b_i and m p, then shifts the accumulator down one limb.  The team
// keeps each limb position j of the accumulator as two 64-bit sums,
// c_j + d_j 2^16, of 48-bit products: the 16-bit halves of a's and p's
// limbs times the 32-bit b_i and m.  So no product waits for a carry flag:
// a round's 4K wide multiply-adds are independent, and its dependent path
// is the quotient m = (c_0 + d_0 2^16) N0 mod 2^32 on thread 0, its
// broadcast (one shuffle), and position 0's carry into position 1, of
// which only hi(m p_0) waits for m.  Each thread's position 0 moves to the
// thread below with a shuffle that the next quotient does not wait for.
// Over N rounds a position gathers at most 2N products of 48 bits, below
// 2^54, so the sums never overflow.  At the end each thread resolves its
// positions' carries and passes its carry out (below 2^38) to the thread
// above; the remaining one-bit carries between threads, and the borrows
// of the conditional subtraction of the modulus, are resolved at once
// from two ballots each (generate and propagate masks added as integers).
// Over Fp a product of values below 2p stays below 2p (4p < 2^384), so the
// chain subtracts p once, at the end; over Fr every product does.  Either
// way the result is the canonical value, bit for bit the plain chain's.
//
// Why two limbs a thread.  One warp runs all the team's threads in step,
// so a round costs the instructions of one thread's share, about 4K wide
// multiply-adds and 25 others, or the round's dependent path, whichever
// is longer.  On the H100 three limbs a thread (4 threads over Fp) were
// bound by the instructions; two balance the two; one would put the
// position that moves between threads on the quotient's path.  Fp's 6
// threads span 8 lanes (shuffles take power-of-two widths): the two spare
// threads hold zeros, which also gives the top thread the zero it shifts in.

#pragma once

#include <cstdint>
#include <type_traits>

#include "field.cuh"

namespace kt {

constexpr int kPowMaxSteps = 128;  // cuda_mont.POW_MAX_STEPS
constexpr int kPowMaxTable = 32;   // odd powers a^1 .. a^63: windows of at most 6 bits

// The chain of cuda_mont.pow_chain(e): acc = a^first, then for each step
// acc = acc^(2^s) a^d, step = s | d << 10 (d odd, or 0 for no product).
struct PowChainArg {
  int n_steps;
  int first;
  int table_max;  // the largest odd power the steps use
  uint16_t step[kPowMaxSteps];
};

// A thread's place in its team: thread t, the team's first lane in the
// warp.  Every thread of the warp takes part in each shuffle and ballot (a
// team past the last lane works on a copy of it and stores nothing), so
// they all name the whole warp.
struct PowTeam {
  int t;
  int base;
  static constexpr unsigned mask = 0xffffffffu;
};

// Carries (or borrows) between a team's threads: bit k of gen is thread
// k's carry out, bit k of prop says that a carry into thread k passes
// through it.  Returns the carries into each thread (bit k) and, above the
// team's bits, its carry out: adding a = gen | prop and b = gen as
// integers generates where both are set and propagates where one is.
__device__ __forceinline__ unsigned team_carries(unsigned gen, unsigned prop) {
  const unsigned a = gen | prop, b = gen;
  return (a + b) ^ a ^ b;
}

template <class F>
struct TeamField {
  static constexpr int N = F::N;
  static constexpr int K = 2;               // limbs a thread
  static constexpr int kThreads = N / K;    // 4 over Fr, 6 over Fp
  static constexpr int kWidth = N <= 8 ? 4 : 8;  // lanes a team spans
  static_assert(kThreads <= kWidth && kWidth <= 32 && 32 % kWidth == 0, "a team in a warp");
  static constexpr unsigned kTeamBits = (1u << kThreads) - 1;

  uint32_t pl[K], ph[K];  // this thread's limbs of the modulus, 16-bit halves
  uint32_t p[K];

  // threads kThreads .. kWidth - 1 hold zero limbs and a zero modulus, so
  // their positions stay 0 and the top thread's shuffle reads zeros
  __device__ __forceinline__ explicit TeamField(int t) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      p[j] = t < kThreads ? F::mod(t * K + j) : 0u;
      pl[j] = p[j] & 0xffffu;
      ph[j] = p[j] >> 16;
    }
  }

  // the team's bits of a warp ballot, at bit 0
  __device__ __forceinline__ unsigned ballot(bool pred, const PowTeam& team) const {
    return (__ballot_sync(team.mask, pred) >> team.base) & kTeamBits;
  }

  // All N limbs of a value the team holds K a thread.
  __device__ __forceinline__ void gather(uint32_t* full, const uint32_t* x,
                                         const PowTeam& team) const {
#pragma unroll
    for (int i = 0; i < N; ++i) full[i] = __shfl_sync(team.mask, x[i % K], i / K, kWidth);
  }

  // Over Fp, 4p < 2^384, so a product of operands below 2p is below 2p:
  // the chain's values stay there and are reduced once, at the end.  Over
  // Fr, 4r > 2^256, so every product is reduced.
  static constexpr bool kLazy = std::is_same<F, FpField>::value;

  // r = a b 2^(-32 N) mod F, canonical over Fr and below 2 F over Fp: a and
  // r this thread's K limbs, b all N limbs, each below F (Fr) or 2 F (Fp).
  // r may alias a.
  __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                      const PowTeam& team) const {
    uint32_t al[K], ah[K];
    uint64_t c[K], d[K];  // position j: c[j] + d[j] 2^16
#pragma unroll
    for (int j = 0; j < K; ++j) {
      al[j] = a[j] & 0xffffu;
      ah[j] = a[j] >> 16;
      c[j] = d[j] = 0;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t bi = b[i];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        c[j] += (uint64_t)al[j] * bi;
        d[j] += (uint64_t)ah[j] * bi;
      }
      // the quotient from position 0 of thread 0, x0 = its value mod 2^32
      const uint32_t x0 = (uint32_t)c[0] + ((uint32_t)d[0] << 16);
      const uint32_t m = __shfl_sync(team.mask, x0 * F::N0, 0, kWidth);
      // thread 0: position 0 plus m p_0 is 0 mod 2^32, and its carry into
      // position 1 is q = (its value >> 32) + hi(m p_0) + (x0 != 0), of
      // which only hi(m p_0) waits for m
      const uint64_t q = ((c[0] + ((d[0] & 0xffffu) << 16)) >> 32) + (d[0] >> 16) + (x0 != 0) +
                         __umulhi(m, p[0]);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        c[j] += (uint64_t)m * pl[j];
        d[j] += (uint64_t)m * ph[j];
      }
      // the others: position 0 moves to the top of the thread below
      uint64_t cin = __shfl_down_sync(team.mask, c[0], 1, kWidth);
      uint64_t din = __shfl_down_sync(team.mask, d[0], 1, kWidth);
      if (kThreads == kWidth && team.t == kThreads - 1) cin = din = 0;
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) {
        c[j] = c[j + 1];
        d[j] = d[j + 1];
      }
      c[K - 1] = cin;
      d[K - 1] = din;
      if (team.t == 0) c[0] += q;
    }
    // each thread's positions to limbs, its carry out to the thread above
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t v = c[j] + ((d[j] & 0xffffu) << 16) + carry;
      r[j] = (uint32_t)v;
      carry = (v >> 32) + (d[j] >> 16);
    }
    uint64_t up = __shfl_up_sync(team.mask, carry, 1, kWidth);
    if (team.t == 0) up = 0;
    uint64_t v = (uint64_t)r[0] + (uint32_t)up;
    r[0] = (uint32_t)v;
    v = (v >> 32) + (up >> 32);
#pragma unroll
    for (int j = 1; j < K; ++j) {
      v += r[j];
      r[j] = (uint32_t)v;
      v >>= 32;
    }
    // one-bit carries between the threads: generate v, propagate all ones
    bool ones = true;
#pragma unroll
    for (int j = 0; j < K; ++j) ones = ones && r[j] == 0xffffffffu;
    uint32_t cy = (team_carries(ballot(v != 0, team), ballot(ones, team)) >> team.t) & 1u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t s = (uint64_t)r[j] + cy;
      r[j] = (uint32_t)s;
      cy = (uint32_t)(s >> 32);
    }
    if (!kLazy) reduce(r, team);
  }

  // x = x mod F for x < 2 F: subtract F unless that borrows out of the top
  // thread
  __device__ __forceinline__ void reduce(uint32_t* x, const PowTeam& team) const {
    uint32_t y[K];
    uint32_t borrow = 0;
    bool equal = true;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t s = (uint64_t)x[j] - p[j] - borrow;
      y[j] = (uint32_t)s;
      borrow = (uint32_t)(s >> 63);
      equal = equal && x[j] == p[j];
    }
    const unsigned bw = team_carries(ballot(borrow != 0, team), ballot(equal, team));
    uint32_t bin = (bw >> team.t) & 1u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t s = (uint64_t)y[j] - bin;
      y[j] = (uint32_t)s;
      bin = (uint32_t)(s >> 63);
    }
    const bool keep = (bw >> kThreads) & 1u;  // x < F
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = keep ? x[j] : y[j];
  }
};

// One lane's a^e by the chain, a team of kPowTeam threads: a and out the
// lane's digit rows (2 N int64 digits), table the lane's shared odd
// powers (kPowMaxTable x N limbs).
template <class F>
__device__ __forceinline__ void pow_chain_lane(const int64_t* __restrict__ a,
                                               int64_t* __restrict__ out, const PowChainArg& chain,
                                               uint32_t (*table)[F::N], const PowTeam& team) {
  using TF = TeamField<F>;
  constexpr int N = TF::N, K = TF::K;
  const TF f(team.t);
  const bool active = team.t < TF::kThreads;
  const int first = team.t * K;  // this thread's first limb
  uint32_t x[K], full[N];
#pragma unroll
  for (int j = 0; j < K; ++j)
    x[j] = active ? (uint32_t)a[2 * (first + j)] | ((uint32_t)a[2 * (first + j) + 1] << 16) : 0u;
  // the odd powers a^(2k + 1) = a^(2k - 1) a^2
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) table[0][first + j] = x[j];
  }
  if (chain.table_max > 1) {
    uint32_t sq[K];
    f.gather(full, x, team);
    f.mul(sq, x, full, team);
    f.gather(full, sq, team);  // a^2
    for (int k = 1; 2 * k + 1 <= chain.table_max; ++k) {
      f.mul(x, x, full, team);
      if (active) {
#pragma unroll
        for (int j = 0; j < K; ++j) table[k][first + j] = x[j];
      }
    }
  }
  __syncwarp(team.mask);
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = table[chain.first >> 1][first + j];
  }
  for (int s = 0; s < chain.n_steps; ++s) {
    const uint32_t step = chain.step[s];
    for (int k = step & 0x3ffu; k > 0; --k) {
      f.gather(full, x, team);
      f.mul(x, x, full, team);
    }
    const uint32_t dgt = step >> 10;
    if (dgt) {
      const uint32_t* row = table[dgt >> 1];
#pragma unroll
      for (int i = 0; i < N; ++i) full[i] = row[i];
      f.mul(x, x, full, team);
    }
  }
  if (TF::kLazy) f.reduce(x, team);
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out[2 * (first + j)] = (int64_t)(x[j] & 0xffffu);
      out[2 * (first + j) + 1] = (int64_t)(x[j] >> 16);
    }
  }
}

}  // namespace kt
