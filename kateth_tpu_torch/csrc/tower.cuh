// Fp2 / Fp6 / Fp12 tower for one CUDA thread, over the Fp arithmetic of
// field.cuh (the G2 point formulas built on it are in g2.cuh).
//
//   Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v),
//   xi = 1 + u.
//
// Every tower value is a unique canonical field element, so these formulas
// give the same bits as the plain PyTorch tower (kateth_tpu_torch/fields).
// Two kinds of function must repeat the plain formulas exactly, because
// their result is not a unique field element: the cyclotomic squaring
// (Granger-Scott, exact only on the cyclotomic subgroup) and the projective
// point formulas of the G2 ladder.  Those mirror fields/fp12.py::cyc_sqr
// and curves/ops.py operation for operation.
//
// The products above Fp2 are __noinline__ so that each kernel's code stays
// small; their operands then live in local memory (see the note in
// hard_part.cu).  Used by K5 (hard_part.cu) and K6 (g2_ladder.cu, through
// g2.cuh); the Miller loop runs its own round schedule.

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
struct fp6 {
  fp2 c[3];
};
struct fp12 {
  fp6 c[2];
};

// gamma_i = xi^(i (p-1)/6), i = 1..5, Montgomery form: the Frobenius twists
__constant__ uint32_t FP_GAMMA[5][2][12] = {
    {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
      0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
     {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
      0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
      0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}},
    {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
    {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
      0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
      0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu},
     {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
      0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}},
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
__device__ __forceinline__ fp2 f2_neg(const fp2& a) {
  return f2_make(f_sub(f_zero(), a.c0), f_sub(f_zero(), a.c1));
}
__device__ __forceinline__ fp2 f2_conj(const fp2& a) {
  return f2_make(a.c0, f_sub(f_zero(), a.c1));
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
__device__ __forceinline__ fp2 f2_select(bool m, const fp2& a, const fp2& b) {
  return m ? a : b;
}
// Karatsuba: 3 Fp products
__device__ __noinline__ fp2 f2_mul(const fp2& a, const fp2& b) {
  fp t0 = f_mul(a.c0, b.c0);
  fp t1 = f_mul(a.c1, b.c1);
  fp t2 = f_mul(f_add(a.c0, a.c1), f_add(b.c0, b.c1));
  return f2_make(f_sub(t0, t1), f_sub(t2, f_add(t0, t1)));
}
// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
__device__ __noinline__ fp2 f2_sqr(const fp2& a) {
  fp c0 = f_mul(f_add(a.c0, a.c1), f_sub(a.c0, a.c1));
  fp c1 = f_mul(a.c0, a.c1);
  return f2_make(c0, f_add(c1, c1));
}
__device__ __forceinline__ fp2 f2_load(const int64_t* d) {
  return f2_make(f_load(d), f_load(d + 24));
}
__device__ __forceinline__ void f2_store(int64_t* d, const fp2& a) {
  f_store(d, a.c0);
  f_store(d + 24, a.c1);
}
__device__ __forceinline__ fp2 f2_gamma(int i) {
  fp2 r;
  for (int j = 0; j < 12; ++j) {
    r.c0.v[j] = FP_GAMMA[i][0][j];
    r.c1.v[j] = FP_GAMMA[i][1][j];
  }
  return r;
}

// --- Fp6 ------------------------------------------------------------------

__device__ __forceinline__ fp6 f6_add(const fp6& a, const fp6& b) {
  fp6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = f2_add(a.c[i], b.c[i]);
  return r;
}
__device__ __forceinline__ fp6 f6_sub(const fp6& a, const fp6& b) {
  fp6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = f2_sub(a.c[i], b.c[i]);
  return r;
}
__device__ __forceinline__ fp6 f6_neg(const fp6& a) {
  fp6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = f2_neg(a.c[i]);
  return r;
}
// v (a0, a1, a2) = (xi a2, a0, a1)
__device__ __forceinline__ fp6 f6_mul_by_v(const fp6& a) {
  fp6 r;
  r.c[0] = f2_mul_by_xi(a.c[2]);
  r.c[1] = a.c[0];
  r.c[2] = a.c[1];
  return r;
}
__device__ __noinline__ fp6 f6_mul(const fp6& a, const fp6& b) {
  fp2 t0 = f2_mul(a.c[0], b.c[0]);
  fp2 t1 = f2_mul(a.c[1], b.c[1]);
  fp2 t2 = f2_mul(a.c[2], b.c[2]);
  fp2 s0 = f2_mul(f2_add(a.c[1], a.c[2]), f2_add(b.c[1], b.c[2]));
  fp2 s1 = f2_mul(f2_add(a.c[0], a.c[1]), f2_add(b.c[0], b.c[1]));
  fp2 s2 = f2_mul(f2_add(a.c[0], a.c[2]), f2_add(b.c[0], b.c[2]));
  fp6 r;
  r.c[0] = f2_add(t0, f2_mul_by_xi(f2_sub(s0, f2_add(t1, t2))));
  r.c[1] = f2_add(f2_sub(s1, f2_add(t0, t1)), f2_mul_by_xi(t2));
  r.c[2] = f2_add(f2_sub(s2, f2_add(t0, t2)), t1);
  return r;
}

// --- Fp12 -----------------------------------------------------------------

__device__ __forceinline__ fp12 f12_one() {
  fp12 r;
  for (int w = 0; w < 2; ++w)
    for (int i = 0; i < 3; ++i) r.c[w].c[i] = f2_zero();
  r.c[0].c[0] = f2_one();
  return r;
}
__device__ __forceinline__ fp12 f12_conj(const fp12& a) {
  fp12 r;
  r.c[0] = a.c[0];
  r.c[1] = f6_neg(a.c[1]);
  return r;
}
__device__ __noinline__ fp12 f12_mul(const fp12& a, const fp12& b) {
  fp6 t0 = f6_mul(a.c[0], b.c[0]);
  fp6 t1 = f6_mul(a.c[1], b.c[1]);
  fp6 s = f6_mul(f6_add(a.c[0], a.c[1]), f6_add(b.c[0], b.c[1]));
  fp12 r;
  r.c[0] = f6_add(t0, f6_mul_by_v(t1));
  r.c[1] = f6_sub(s, f6_add(t0, t1));
  return r;
}
// Granger-Scott cyclotomic squaring, the formula of fields/fp12.py::cyc_sqr
__device__ __noinline__ fp12 f12_cyc_sqr(const fp12& a) {
  const fp2 &a0 = a.c[0].c[0], &a1 = a.c[0].c[1], &a2 = a.c[0].c[2];
  const fp2 &b0 = a.c[1].c[0], &b1 = a.c[1].c[1], &b2 = a.c[1].c[2];
  fp2 lo[3] = {b1, a2, b2};
  fp2 hi[3] = {a0, b0, a1};
  fp2 c0[3] = {a0, a1, a2};
  fp2 c1[3] = {b0, b1, b2};
  fp2 u[3], cross[3];
  for (int i = 0; i < 3; ++i) {
    fp2 tl = f2_sqr(lo[i]);
    fp2 th = f2_sqr(hi[i]);
    fp2 ts = f2_sqr(f2_add(lo[i], hi[i]));
    cross[i] = f2_sub(ts, f2_add(tl, th));
    u[i] = f2_add(f2_mul_by_xi(tl), th);
  }
  fp2 t[3] = {f2_mul_by_xi(cross[2]), cross[0], cross[1]};
  fp12 r;
  for (int i = 0; i < 3; ++i) {
    fp2 d0 = f2_sub(u[i], c0[i]);
    r.c[0].c[i] = f2_add(f2_add(d0, d0), u[i]);
    fp2 d1 = f2_add(t[i], c1[i]);
    r.c[1].c[i] = f2_add(f2_add(d1, d1), t[i]);
  }
  return r;
}
// x -> x^p: conjugate every Fp2 coordinate, then twist coordinates
// (c0.1, c0.2, c1.0, c1.1, c1.2) by gamma (2, 4, 1, 3, 5)
__device__ __noinline__ fp12 f12_frob(const fp12& a) {
  const int gidx[6] = {-1, 1, 3, 0, 2, 4};
  fp12 r;
  for (int j = 0; j < 6; ++j) {
    fp2 c = f2_conj(a.c[j / 3].c[j % 3]);
    r.c[j / 3].c[j % 3] = j == 0 ? c : f2_mul(c, f2_gamma(gidx[j]));
  }
  return r;
}
// (..., 2, 3, 2, 24) digit planes: element-row m = (w*3 + v)*2 + u
__device__ __forceinline__ fp12 f12_load(const int64_t* d) {
  fp12 r;
  for (int w = 0; w < 2; ++w)
    for (int v = 0; v < 3; ++v) r.c[w].c[v] = f2_load(d + (w * 3 + v) * 48);
  return r;
}
__device__ __forceinline__ void f12_store(int64_t* d, const fp12& a) {
  for (int w = 0; w < 2; ++w)
    for (int v = 0; v < 3; ++v) f2_store(d + (w * 3 + v) * 48, a.c[w].c[v]);
}

}  // namespace kt
