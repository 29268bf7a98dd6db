// G2 (the twist, over Fp2) complete projective point formulas for one CUDA
// thread, over the Fp2 of tower.cuh.
//
// RCB16 Algorithms 7 and 9 with a = 0, 3b = 12 xi, in the grouping of
// curves/ops.py::padd and pdouble, so every result is the same projective
// representative the plain PyTorch formulas give.  Used by the G2 ladder
// (g2_ladder.cu); the Miller loop runs its own round schedule
// (schedule_miller.cuh).

#pragma once

#include "tower.cuh"

namespace kt {

struct G2 {
  fp2 x, y, z;
};

// RCB16 Algorithm 9 over Fp2 with 3b = 12 xi (curves/ops.py::pdouble)
__device__ __noinline__ G2 g2_double(const G2& p) {
  fp2 a = f2_mul(p.y, p.y);
  fp2 bb = f2_mul(p.y, p.z);
  fp2 c = f2_mul(p.z, p.z);
  fp2 d = f2_mul(p.x, p.y);
  fp2 cx = f2_mul_by_xi(c);
  fp2 e = f2_mul_small(cx, 12);
  fp2 t2 = f2_mul_small(cx, 36);
  fp2 a8 = f2_mul_small(a, 8);
  fp2 t0 = f2_sub(a, t2);
  fp2 y3a = f2_add(a, e);
  fp2 n0 = f2_mul(e, a8);
  fp2 n1 = f2_mul(bb, a8);
  fp2 n2 = f2_mul(t0, y3a);
  fp2 n3 = f2_mul(t0, d);
  G2 r;
  r.x = f2_add(n3, n3);
  r.y = f2_add(n0, n2);
  r.z = n1;
  return r;
}

// RCB16 Algorithm 7 over Fp2 with 3b = 12 xi (curves/ops.py::padd)
__device__ __noinline__ G2 g2_add(const G2& p, const G2& q) {
  fp2 m0 = f2_mul(p.x, q.x);
  fp2 m1 = f2_mul(p.y, q.y);
  fp2 m2 = f2_mul(p.z, q.z);
  fp2 m3 = f2_mul(f2_add(p.x, p.y), f2_add(q.x, q.y));
  fp2 m4 = f2_mul(f2_add(p.y, p.z), f2_add(q.y, q.z));
  fp2 m5 = f2_mul(f2_add(p.x, p.z), f2_add(q.x, q.z));
  fp2 t3 = f2_sub(m3, f2_add(m0, m1));
  fp2 t4 = f2_sub(m4, f2_add(m1, m2));
  fp2 ty = f2_sub(m5, f2_add(m0, m2));
  fp2 t2 = f2_mul_small(f2_mul_by_xi(m2), 12);
  fp2 t0 = f2_add(f2_add(m0, m0), m0);
  fp2 z3 = f2_add(m1, t2);
  fp2 t1 = f2_sub(m1, t2);
  fp2 y3 = f2_mul_small(f2_mul_by_xi(ty), 12);
  fp2 n0 = f2_mul(t4, y3);
  fp2 n1 = f2_mul(t3, t1);
  fp2 n2 = f2_mul(y3, t0);
  fp2 n3 = f2_mul(t1, z3);
  fp2 n4 = f2_mul(t0, t3);
  fp2 n5 = f2_mul(z3, t4);
  G2 r;
  r.x = f2_sub(n1, n0);
  r.y = f2_add(n3, n2);
  r.z = f2_add(n5, n4);
  return r;
}

}  // namespace kt
