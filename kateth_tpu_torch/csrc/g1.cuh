// G1 (over Fp) complete projective point formulas for one CUDA thread.
//
// RCB16 Algorithm 7 with a = 0, 3b = 12, in the grouping of
// curves/ops.py::padd, so every result is the same projective
// representative the plain PyTorch formulas give.  Used by K7 (msm.cu); the
// G1 ladder and K8 run their own round schedules (schedule_g1.cuh,
// schedule_comb.cuh).

#pragma once

#include "field.cuh"

namespace kt {

struct G1 {
  uint32_t x[12], y[12], z[12];
};

__device__ __forceinline__ G1 g1_identity() {  // (0 : 1 : 0)
  G1 r;
  fzero<FpField>(r.x);
  fone<FpField>(r.y);
  fzero<FpField>(r.z);
  return r;
}

__device__ __forceinline__ G1 g1_load(const int64_t* x, const int64_t* y, const int64_t* z) {
  G1 r;
  load_digits<FpField>(r.x, x);
  load_digits<FpField>(r.y, y);
  load_digits<FpField>(r.z, z);
  return r;
}

__device__ __forceinline__ void g1_store(int64_t* x, int64_t* y, int64_t* z, const G1& p) {
  store_digits<FpField>(x, p.x);
  store_digits<FpField>(y, p.y);
  store_digits<FpField>(z, p.z);
}

__device__ __forceinline__ void mul12(uint32_t* r, const uint32_t* a) {
  uint32_t a2[12], a4[12], a8[12];
  fadd<FpField>(a2, a, a);
  fadd<FpField>(a4, a2, a2);
  fadd<FpField>(a8, a4, a4);
  fadd<FpField>(r, a8, a4);
}

// RCB16 Algorithm 7 (a = 0), the grouping of curves/ops.py::padd
__device__ __forceinline__ G1 g1_add(const G1& p, const G1& q) {
  using Fp = FpField;
  uint32_t s1[12], s2[12], m0[12], m1[12], m2[12], m3[12], m4[12], m5[12];
  fmul<Fp>(m0, p.x, q.x);
  fmul<Fp>(m1, p.y, q.y);
  fmul<Fp>(m2, p.z, q.z);
  fadd<Fp>(s1, p.x, p.y);
  fadd<Fp>(s2, q.x, q.y);
  fmul<Fp>(m3, s1, s2);
  fadd<Fp>(s1, p.y, p.z);
  fadd<Fp>(s2, q.y, q.z);
  fmul<Fp>(m4, s1, s2);
  fadd<Fp>(s1, p.x, p.z);
  fadd<Fp>(s2, q.x, q.z);
  fmul<Fp>(m5, s1, s2);
  uint32_t t3[12], t4[12], ty[12], t2[12], t0[12], z3[12], t1[12], y3[12];
  fadd<Fp>(s1, m0, m1);
  fsub<Fp>(t3, m3, s1);
  fadd<Fp>(s1, m1, m2);
  fsub<Fp>(t4, m4, s1);
  fadd<Fp>(s1, m0, m2);
  fsub<Fp>(ty, m5, s1);
  mul12(t2, m2);
  fadd<Fp>(t0, m0, m0);
  fadd<Fp>(t0, t0, m0);  // 3 X1 X2
  fadd<Fp>(z3, m1, t2);
  fsub<Fp>(t1, m1, t2);
  mul12(y3, ty);
  uint32_t n0[12], n1[12], n2[12], n3[12], n4[12], n5[12];
  fmul<Fp>(n0, t4, y3);
  fmul<Fp>(n1, t3, t1);
  fmul<Fp>(n2, y3, t0);
  fmul<Fp>(n3, t1, z3);
  fmul<Fp>(n4, t0, t3);
  fmul<Fp>(n5, z3, t4);
  G1 r;
  fsub<Fp>(r.x, n1, n0);
  fadd<Fp>(r.y, n3, n2);
  fadd<Fp>(r.z, n5, n4);
  return r;
}

}  // namespace kt
