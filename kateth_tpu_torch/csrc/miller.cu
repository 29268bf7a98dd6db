// Kernel K4: the BLS12-381 Miller loop on the twist.
//
// Replaces kateth_tpu/pallas_pairing.py::_miller_flat
// (_make_miller_kernel).  It mirrors pairing.miller_loop's plain scan
// operation for operation: the tangent line at the projective twist point
// T (_line_dbl), the chord through T and Q (_line_add), both folded with
// the affine G1 point, merged into one sparse Fp12 factor (_merge_lines),
// T doubled and, where the bit of |x| is set, advanced by Q with the
// complete formulas of curves/ops.py, then f = f^2 * line; finally the
// conjugate for the negative x.  The raw Miller value is therefore
// bit-identical to the plain scan (same projective representatives).
//
// Bound: operations, but in practice latency: 63 dependent steps of about
// 50 Fp2 products for each of the 2 lanes of a verify, so one warp runs on
// one SM.  Design: one thread per lane; the Fp12 accumulator and the
// products above Fp2 live in local memory (the __noinline__ tower of
// tower.cuh), which keeps the build short and the code small; the loop
// over the bits of |x| is warp-uniform.

#include <cuda_runtime.h>

#include "g2.cuh"

using namespace kt;

namespace {

constexpr unsigned long long kXAbs = 0xd201000000010000ull;  // |x|, MSB first

struct Line {
  fp2 a, b, c;  // a + b w^2 + c w^3 (b, c folded with xP, yP)
};

// tangent at T: A = 3X^3 - 2Y^2 Z, B = -3X^2 Z, C = 2Y Z^2 (pairing._line_dbl)
__device__ __noinline__ Line line_dbl(const G2& t, const fp& xp, const fp& yp) {
  fp2 x2 = f2_mul(t.x, t.x);
  fp2 y2 = f2_mul(t.y, t.y);
  fp2 yz = f2_mul(t.y, t.z);
  fp2 x3 = f2_mul(x2, t.x);
  fp2 y2z = f2_mul(y2, t.z);
  fp2 yz2 = f2_mul(yz, t.z);
  fp2 x2z = f2_mul(x2, t.z);
  Line l;
  l.a = f2_sub(f2_mul_small(x3, 3), f2_mul_small(y2z, 2));
  l.b = f2_scale(f2_neg(f2_mul_small(x2z, 3)), xp);
  l.c = f2_scale(f2_mul_small(yz2, 2), yp);
  return l;
}

// chord through T and affine Q: N = yq Z - Y, D = xq Z - X,
// A = N xq - D yq, B = -N, C = D (pairing._line_add)
__device__ __noinline__ Line line_add(const G2& t, const fp2& xq, const fp2& yq,
                                      const fp& xp, const fp& yp) {
  fp2 n = f2_sub(f2_mul(yq, t.z), t.y);
  fp2 d = f2_sub(f2_mul(xq, t.z), t.x);
  Line l;
  l.a = f2_sub(f2_mul(n, xq), f2_mul(d, yq));
  l.b = f2_scale(f2_neg(n), xp);
  l.c = f2_scale(d, yp);
  return l;
}

// (a + b w^2 + c w^3)(a' + b' w^2 + c' w^3) as a dense Fp12
// (pairing._merge_lines)
__device__ __noinline__ fp12 merge_lines(const Line& l1, const Line& l2) {
  fp2 aa = f2_mul(l1.a, l2.a);
  fp2 bb = f2_mul(l1.b, l2.b);
  fp2 cc = f2_mul(l1.c, l2.c);
  fp2 ab = f2_sub(f2_mul(f2_add(l1.a, l1.b), f2_add(l2.a, l2.b)), f2_add(aa, bb));
  fp2 ac = f2_sub(f2_mul(f2_add(l1.a, l1.c), f2_add(l2.a, l2.c)), f2_add(aa, cc));
  fp2 bc = f2_sub(f2_mul(f2_add(l1.b, l1.c), f2_add(l2.b, l2.c)), f2_add(bb, cc));
  fp12 r;
  r.c[0].c[0] = f2_add(aa, f2_mul_by_xi(cc));
  r.c[0].c[1] = ab;
  r.c[0].c[2] = bb;
  r.c[1].c[0] = f2_zero();
  r.c[1].c[1] = ac;
  r.c[1].c[2] = bc;
  return r;
}

__global__ void miller_kernel(const int64_t* __restrict__ xp_d, const int64_t* __restrict__ yp_d,
                              const int64_t* __restrict__ xq_d, const int64_t* __restrict__ yq_d,
                              int64_t* __restrict__ out, int64_t lanes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  fp xp = f_load(xp_d + i * 24);
  fp yp = f_load(yp_d + i * 24);
  fp2 xq = f2_load(xq_d + i * 48);
  fp2 yq = f2_load(yq_d + i * 48);
  G2 q;
  q.x = xq;
  q.y = yq;
  q.z = f2_one();
  G2 t = q;
  fp12 f = f12_one();
  Line id;  // the identity line (1, 0, 0) for the steps without an addition
  id.a = f2_one();
  id.b = f2_zero();
  id.c = f2_zero();
  for (int k = 62; k >= 0; --k) {
    bool bit = (kXAbs >> k) & 1ull;
    Line l1 = line_dbl(t, xp, yp);
    t = g2_double(t);
    Line l2 = bit ? line_add(t, xq, yq, xp, yp) : id;
    fp12 line = merge_lines(l1, l2);
    if (bit) t = g2_add(t, q);
    f = f12_mul(f12_sqr(f), line);
  }
  f12_store(out + i * 288, f12_conj(f));
}

}  // namespace

extern "C" {

// xp, yp: (lanes, 24) affine G1; xq, yq: (lanes, 2, 24) affine twist point;
// out: (lanes, 2, 3, 2, 24) Fp12
int kateth_miller(const int64_t* xp, const int64_t* yp, const int64_t* xq, const int64_t* yq,
                  int64_t* out, int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  constexpr int threads = 32;
  unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
  miller_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(xp, yp, xq, yq, out, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
