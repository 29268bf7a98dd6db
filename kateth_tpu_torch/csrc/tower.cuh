// Fp2 for one CUDA thread, over the Fp arithmetic of field.cuh (the G2
// point formulas built on it are in g2.cuh).
//
//   Fp2 = Fp[u]/(u^2+1), xi = 1 + u.
//
// Every Fp2 value is a unique canonical field element, so these formulas
// give the same bits as the plain PyTorch Fp2 (kateth_tpu_torch/fields).
// The projective point formulas of the G2 ladder, whose result is not a
// unique field element, mirror curves/ops.py operation for operation in
// g2.cuh.
//
// The Fp2 product is __noinline__ so that the G2 ladder's code stays
// small; its operands then live in local memory.  Used by K6 (g2_ladder.cu,
// through g2.cuh); the Miller loop and the hard part run their own round
// schedules.

#pragma once

#include "field.cuh"

namespace kt {

using FpF = FpField;

struct fp {
  uint32_t v[12];
};
struct fp2 {
  fp c0, c1;
};

// --- Fp -------------------------------------------------------------------

__device__ __forceinline__ fp f_add(const fp& a, const fp& b) {
  fp r;
  fadd<FpF>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ fp f_sub(const fp& a, const fp& b) {
  fp r;
  fsub<FpF>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ fp f_mul(const fp& a, const fp& b) {
  fp r;
  fmul<FpF>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ fp f_zero() {
  fp r;
  fzero<FpF>(r.v);
  return r;
}
__device__ __forceinline__ fp f_one() {
  fp r;
  fone<FpF>(r.v);
  return r;
}
__device__ __forceinline__ fp f_load(const int64_t* d) {
  fp r;
  load_digits<FpF>(r.v, d);
  return r;
}
__device__ __forceinline__ void f_store(int64_t* d, const fp& a) { store_digits<FpF>(d, a.v); }

// --- Fp2 ------------------------------------------------------------------

__device__ __forceinline__ fp2 f2_make(const fp& c0, const fp& c1) {
  fp2 r;
  r.c0 = c0;
  r.c1 = c1;
  return r;
}
__device__ __forceinline__ fp2 f2_zero() { return f2_make(f_zero(), f_zero()); }
__device__ __forceinline__ fp2 f2_one() { return f2_make(f_one(), f_zero()); }
__device__ __forceinline__ fp2 f2_add(const fp2& a, const fp2& b) {
  return f2_make(f_add(a.c0, b.c0), f_add(a.c1, b.c1));
}
__device__ __forceinline__ fp2 f2_sub(const fp2& a, const fp2& b) {
  return f2_make(f_sub(a.c0, b.c0), f_sub(a.c1, b.c1));
}
__device__ __forceinline__ fp2 f2_dbl(const fp2& a) { return f2_add(a, a); }
// (1 + u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u
__device__ __forceinline__ fp2 f2_mul_by_xi(const fp2& a) {
  return f2_make(f_sub(a.c0, a.c1), f_add(a.c0, a.c1));
}
// k a for a small constant k, by a double-and-add chain
__device__ __forceinline__ fp2 f2_mul_small(const fp2& a, int k) {
  int top = 31 - __clz(k);
  fp2 acc = a;
  for (int i = top - 1; i >= 0; --i) {
    acc = f2_dbl(acc);
    if ((k >> i) & 1) acc = f2_add(acc, a);
  }
  return acc;
}
// Karatsuba: 3 Fp products
__device__ __noinline__ fp2 f2_mul(const fp2& a, const fp2& b) {
  fp t0 = f_mul(a.c0, b.c0);
  fp t1 = f_mul(a.c1, b.c1);
  fp t2 = f_mul(f_add(a.c0, a.c1), f_add(b.c0, b.c1));
  return f2_make(f_sub(t0, t1), f_sub(t2, f_add(t0, t1)));
}
__device__ __forceinline__ fp2 f2_load(const int64_t* d) {
  return f2_make(f_load(d), f_load(d + 24));
}
__device__ __forceinline__ void f2_store(int64_t* d, const fp2& a) {
  f_store(d, a.c0);
  f_store(d + 24, a.c1);
}

}  // namespace kt
