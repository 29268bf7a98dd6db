// Montgomery arithmetic over the BLS12-381 fields for one CUDA thread.
//
// An element is an array of N 32-bit limbs, little endian: Fr has N = 8,
// Fp has N = 12.  R = 2^(32 N) = 2^256 and 2^384, the same R as the
// reference's 16-bit digit planes (2^(16 D), D = 16 and 24), so Montgomery
// values are bit-identical to the PyTorch digit planes after packing digit
// pairs into limbs (digit 2i is the low half of limb i).
//
// Multiplication is CIOS with one final conditional subtraction; add and
// sub end in one conditional correction.  Over Fp all three run on PTX
// carry chains (below); over Fr on 64-bit products.  Every function
// returns the canonical value (< modulus), so any formula that computes
// the same field element gives the same bits as the plain path.
//
// The constants below are checked against the Python ones by
// tests/test_torch_cuda_sources.py.

#pragma once

#include <cstdint>

namespace kt {

__constant__ uint32_t FR_MOD[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// R mod r: one in Montgomery form
__constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// -r^-1 mod 2^32
constexpr uint32_t FR_N0 = 0xffffffffu;

__constant__ uint32_t FP_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t FP_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
constexpr uint32_t FP_N0 = 0xfffcfffdu;

struct FrField {
  static constexpr int N = 8;
  static constexpr uint32_t N0 = FR_N0;
  __device__ static uint32_t mod(int i) { return FR_MOD[i]; }
  __device__ static uint32_t one(int i) { return FR_ONE[i]; }
};

struct FpField {
  static constexpr int N = 12;
  static constexpr uint32_t N0 = FP_N0;
  __device__ static uint32_t mod(int i) { return FP_MOD[i]; }
  __device__ static uint32_t one(int i) { return FP_ONE[i]; }
};

// r = (t >= mod) ? t - mod : t, for t < 2 mod held in N limbs plus a top
// carry word `hi`.
template <class F>
__device__ __forceinline__ void csub(uint32_t* r, const uint32_t* t, uint32_t hi) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    uint64_t s = (uint64_t)t[j] - F::mod(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = take ? d[j] : t[j];
}

template <class F>
__device__ __forceinline__ void fadd(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[F::N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  csub<F>(r, s, (uint32_t)c);
}

template <class F>
__device__ __forceinline__ void fsub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // on underflow add the modulus back (the carry out is dropped)
  uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    c += (uint64_t)d[j] + (F::mod(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a b R^-1 mod N by CIOS; r may alias a or b.
template <class F>
__device__ __forceinline__ void fmul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * F::N0;
    c = ((uint64_t)m * F::mod(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * F::mod(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  csub<F>(r, t, t[N]);
}

// --- Fp on PTX carry chains ---------------------------------------------------
//
// Every kernel's Fp arithmetic.  The product is CIOS on the hardware's
// 32-bit carry chains (mad.lo.cc / madc.hi.cc): each of the 12 rounds adds
// a b_i, then m p, as two chains of low halves and two of high halves
// into a 13-word accumulator.  p < 2^381 leaves the top word room for
// every carry, and the result, below 2p, takes one conditional
// subtraction, so it returns the canonical value.  fmul, fadd and fsub
// over FpField are these; Fr keeps the generic 64-bit versions above.

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

template <>
__device__ __forceinline__ void fmul<FpField>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fp_mul_cc(r, a, b);
}

template <>
__device__ __forceinline__ void fadd<FpField>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fp_add_cc(r, a, b);
}

template <>
__device__ __forceinline__ void fsub<FpField>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fp_sub_cc(r, a, b);
}

template <class F>
__device__ __forceinline__ void fzero(uint32_t* r) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = 0;
}

template <class F>
__device__ __forceinline__ void fone(uint32_t* r) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = F::one(j);
}

// 16-bit digit planes (int64, the PyTorch layout) <-> 32-bit limbs
template <class F>
__device__ __forceinline__ void load_digits(uint32_t* r, const int64_t* d) {
#pragma unroll
  for (int j = 0; j < F::N; ++j)
    r[j] = (uint32_t)d[2 * j] | ((uint32_t)d[2 * j + 1] << 16);
}

template <class F>
__device__ __forceinline__ void store_digits(int64_t* d, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    d[2 * j] = (int64_t)(a[j] & 0xffffu);
    d[2 * j + 1] = (int64_t)(a[j] >> 16);
  }
}

}  // namespace kt
