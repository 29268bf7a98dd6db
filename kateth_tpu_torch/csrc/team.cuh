// Team kernels: Fp arithmetic on PTX carry chains, and the interpreter of
// the round schedules that team_schedule.py writes (schedule_*.cuh).
//
// A team of threads works on one lane.  The lane's values live in shared
// memory as Fp slots of 12 32-bit limbs (Montgomery, canonical, the limbs
// of field.cuh); each round, thread t of the team runs instructions t,
// t + team, ... of the round, then the team syncs.  No instruction reads
// a slot that another one of its round writes, so the order inside a round
// does not matter.
//
// The Fp product here is CIOS on the hardware's 32-bit carry chains
// (mad.lo.cc / madc.hi.cc): each of the 12 rounds adds a b_i, then m p,
// as two chains of low halves and two of high halves into a 13-word
// accumulator.  p < 2^381 leaves the top word room for every carry, and
// the result, below 2p, takes one conditional subtraction, so like fmul
// it returns the canonical value.  Only the team kernels (K3, K4) use it;
// the other kernels keep field.cuh's fmul.

#pragma once

#include <cstdint>

#include "field.cuh"

namespace kt {

enum class TeamOp : uint32_t { MUL = 0, ADD, SUB, SMALL, SEL };

// one instruction: x = op | dst << 16, y = a | b << 16 (b is the constant
// of SMALL)
#define KT_INSTR(op, d, a, b)                                       \
  {                                                                 \
    (uint32_t)::kt::TeamOp::op | ((uint32_t)(d) << 16),             \
        (uint32_t)(a) | ((uint32_t)(b) << 16)                       \
  }

namespace ptx {

__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

}  // namespace ptx

// r = t < p ? t : t - p, for t < 2p < 2^384
__device__ __forceinline__ void fp_csub_cc(uint32_t* r, const uint32_t* t) {
  uint32_t d[12];
  d[0] = ptx::sub_cc(t[0], FP_MOD[0]);
#pragma unroll
  for (int j = 1; j < 12; ++j) d[j] = ptx::subc_cc(t[j], FP_MOD[j]);
  const uint32_t borrow = ptx::subc(0, 0);  // all ones iff t < p
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = borrow ? t[j] : d[j];
}

// Montgomery product a b 2^-384 mod p, canonical; r may alias a or b.
__device__ __forceinline__ void fp_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 13; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint32_t bi = b[i];
    // t += a b_i: low halves into t[0..11] (carry into t[12]), high halves
    // into t[1..12]
    t[0] = ptx::mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) t[j] = ptx::madc_lo_cc(a[j], bi, t[j]);
    t[12] = ptx::addc(t[12], 0);
    t[1] = ptx::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 11; ++j) t[j + 1] = ptx::madc_hi_cc(a[j], bi, t[j + 1]);
    t[12] = ptx::madc_hi(a[11], bi, t[12]);
    // t += m p with m = -t_0 / p mod 2^32, which clears t[0]
    const uint32_t m = t[0] * FP_N0;
    t[0] = ptx::mad_lo_cc(m, FP_MOD[0], t[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) t[j] = ptx::madc_lo_cc(m, FP_MOD[j], t[j]);
    t[12] = ptx::addc(t[12], 0);
    t[1] = ptx::mad_hi_cc(m, FP_MOD[0], t[1]);
#pragma unroll
    for (int j = 1; j < 11; ++j) t[j + 1] = ptx::madc_hi_cc(m, FP_MOD[j], t[j + 1]);
    t[12] = ptx::madc_hi(m, FP_MOD[11], t[12]);
    // t /= 2^32
#pragma unroll
    for (int j = 0; j < 12; ++j) t[j] = t[j + 1];
    t[12] = 0;
  }
  fp_csub_cc(r, t);
}

// (a + b) mod p; a + b < 2p < 2^384 leaves no carry out of the top limb
__device__ __forceinline__ void fp_add_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[12];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 12; ++j) s[j] = ptx::addc_cc(a[j], b[j]);
  fp_csub_cc(r, s);
}

// (a - b) mod p
__device__ __forceinline__ void fp_sub_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[12];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 12; ++j) d[j] = ptx::subc_cc(a[j], b[j]);
  const uint32_t mask = ptx::subc(0, 0);  // all ones on underflow: add p back
  r[0] = ptx::add_cc(d[0], FP_MOD[0] & mask);
#pragma unroll
  for (int j = 1; j < 11; ++j) r[j] = ptx::addc_cc(d[j], FP_MOD[j] & mask);
  r[11] = ptx::addc(d[11], FP_MOD[11] & mask);
}

// k a mod p for a small constant k >= 1, by doubling and adding
__device__ __forceinline__ void fp_small_cc(uint32_t* r, const uint32_t* a, uint32_t k) {
  uint32_t acc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j] = a[j];
  for (int i = 30 - __clz(k); i >= 0; --i) {
    fp_add_cc(acc, acc, acc);
    if ((k >> i) & 1u) fp_add_cc(acc, acc, a);
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = acc[j];
}

// --- slots ------------------------------------------------------------------

using Slot = uint32_t[12];  // 48 bytes: three 16-byte words

__device__ __forceinline__ void slot_load(uint32_t* r, const Slot& s) {
  const uint4* p = reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = p[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void slot_store(Slot& s, const uint32_t* a) {
  uint4* p = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int q = 0; q < 3; ++q) p[q] = make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

// --- the interpreter ----------------------------------------------------------

__device__ __forceinline__ void team_mul(Slot* slot, uint2 ins) {
  uint32_t x[12], y[12];
  slot_load(x, slot[ins.y & 0xffffu]);
  slot_load(y, slot[ins.y >> 16]);
  fp_mul_cc(x, x, y);
  slot_store(slot[ins.x >> 16], x);
}

__device__ __forceinline__ void team_linear(Slot* slot, uint2 ins, bool bit) {
  const TeamOp op = (TeamOp)(ins.x & 0xffffu);
  const uint32_t b = ins.y >> 16;
  uint32_t x[12], y[12];
  slot_load(x, slot[ins.y & 0xffffu]);
  if (op == TeamOp::SMALL) {
    fp_small_cc(x, x, b);
  } else {
    slot_load(y, slot[b]);
    if (op == TeamOp::ADD) {
      fp_add_cc(x, x, y);
    } else if (op == TeamOp::SUB) {
      fp_sub_cc(x, x, y);
    } else {  // SEL
#pragma unroll
      for (int j = 0; j < 12; ++j) x[j] = bit ? x[j] : y[j];
    }
  }
  slot_store(slot[ins.x >> 16], x);
}

// Run program `prog` of schedule S (a generated schedule_*.cuh) on the
// team's slots: thread t of S::kTeam, `bit` the lane's bit for SEL,
// `sync` the team's barrier after every round.
template <class S, class Sync>
__device__ __forceinline__ void run_program(Slot* slot, int prog, int t, bool bit, Sync sync) {
  const int r1 = S::program(prog + 1);
  for (int r = S::program(prog); r < r1; ++r) {
    const int end = S::round_start(r + 1);
    if (S::round_is_mul(r)) {
      for (int i = S::round_start(r) + t; i < end; i += S::kTeam) team_mul(slot, S::instr(i));
    } else {
      for (int i = S::round_start(r) + t; i < end; i += S::kTeam) team_linear(slot, S::instr(i), bit);
    }
    sync();
  }
}

}  // namespace kt
