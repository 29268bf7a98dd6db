// Kernels K1-K3: batched Montgomery multiply, pow chain and G1 ladder.
//
// Operands arrive in the PyTorch layout: int64 tensors of 16-bit digits,
// lane-major ((lanes, D), digits contiguous).  Each thread owns one lane,
// packs its digits into 32-bit limbs, computes, and unpacks on store.
//
// C interface, bound with ctypes by kateth_tpu_torch/cuda_lib.py: every
// launcher takes the device pointers and the CUDA stream, launches on that
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kt;

namespace {

constexpr int kThreads = 128;

inline unsigned int blocks_for(int64_t lanes) {
  return (unsigned int)((lanes + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K1 mont_mul.  Replaces kateth_tpu/fields/pallas_mont.py::_mont_mul_flat
// (the FieldVec.mul conv + REDC block kernel).
// Bound: bytes.  At the evaluate shape (64 x 4096 Fr lanes) it moves
// 3 x 16 x 8 B per lane (two int64 digit inputs, one output) and does
// 2 x 8^2 + 8 = 136 32x32->64-bit multiplies per lane: 0.35 per byte,
// where the card's integer multiply rate would bind only above ~2.5.
// Design: one thread per lane, no shared memory, the whole CIOS product in
// registers; reads and writes stay in the int64 digit layout so no
// repacking pass runs around it.
// ---------------------------------------------------------------------------

template <class F>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                    int64_t* __restrict__ out, int64_t lanes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  constexpr int D = 2 * F::N;
  uint32_t x[F::N], y[F::N];
  load_digits<F>(x, a + i * D);
  load_digits<F>(y, b + i * D);
  fmul<F>(x, x, y);
  store_digits<F>(out + i * D, x);
}

// ---------------------------------------------------------------------------
// K2 pow_chain.  Replaces pallas_mont.py::_pow_chain_flat.
// Bound: operations.  a^e for a static e by MSB-first square-and-multiply:
// (bits - 1) squarings plus (popcount - 1) multiplies per lane, each a
// dependent chain, on few lanes (2B = 128 at the verify batch), so the
// card is latency bound far below both rates.
// Design: the exponent rides in the kernel's parameter space (same for
// every lane, so the branch on each bit is warp-uniform), one thread per
// lane, the accumulator in registers.
// ---------------------------------------------------------------------------

struct Exponent {
  uint32_t w[16];  // little-endian 32-bit words, up to 512 bits
  int n_bits;      // bit n_bits - 1 is the leading one
};

template <class F>
__global__ void __launch_bounds__(kThreads)
    pow_chain_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out,
                     int64_t lanes, Exponent e) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  constexpr int D = 2 * F::N;
  uint32_t base[F::N], acc[F::N];
  load_digits<F>(base, a + i * D);
  fcopy<F>(acc, base);  // the leading bit
  for (int k = e.n_bits - 2; k >= 0; --k) {
    fmul<F>(acc, acc, acc);
    if ((e.w[k >> 5] >> (k & 31)) & 1u) fmul<F>(acc, acc, base);
  }
  store_digits<F>(out + i * D, acc);
}

// ---------------------------------------------------------------------------
// K3 g1_ladder.  Replaces pallas_mont.py::_g1_ladder_flat (G1Vec).
// Bound: operations.  256 MSB-first steps of a complete doubling
// (8 products) and a complete addition (12 products) per lane, all of them
// a dependent chain.  At the verify shape (5B + 1 = 321 lanes) only three
// blocks of 128 threads run, on 3 of the 132 SMs: the kernel is latency
// bound and leaves most of the card idle.
// Design: one thread per lane, the point in registers, the complete RCB16
// formulas of curves/ops.py (a = 0, 3b = 12) so the projective result is
// bit-identical to the plain ladder; the lane's scalar bit selects the sum.
// ---------------------------------------------------------------------------

using Fp = FpField;

struct G1 {
  uint32_t x[12], y[12], z[12];
};

__device__ __forceinline__ void mul12(uint32_t* r, const uint32_t* a) {
  uint32_t a2[12], a4[12], a8[12];
  fadd<Fp>(a2, a, a);
  fadd<Fp>(a4, a2, a2);
  fadd<Fp>(a8, a4, a4);
  fadd<Fp>(r, a8, a4);
}

// RCB16 Algorithm 9 (a = 0), the grouping of curves/ops.py::pdouble
__device__ __forceinline__ G1 g1_double(const G1& p) {
  uint32_t a[12], bb[12], c[12], d[12], e[12], t2[12], a8[12], t0[12], y3a[12];
  fmul<Fp>(a, p.y, p.y);
  fmul<Fp>(bb, p.y, p.z);
  fmul<Fp>(c, p.z, p.z);
  fmul<Fp>(d, p.x, p.y);
  mul12(e, c);
  fadd<Fp>(t2, e, e);
  fadd<Fp>(t2, t2, e);  // 3 b3 Z^2
  fadd<Fp>(a8, a, a);
  fadd<Fp>(a8, a8, a8);
  fadd<Fp>(a8, a8, a8);  // 8 Y^2
  fsub<Fp>(t0, a, t2);
  fadd<Fp>(y3a, a, e);
  uint32_t n0[12], n1[12], n2[12], n3[12];
  fmul<Fp>(n0, t0, d);
  fmul<Fp>(n1, e, a8);
  fmul<Fp>(n2, t0, y3a);
  fmul<Fp>(n3, bb, a8);
  G1 r;
  fadd<Fp>(r.x, n0, n0);
  fadd<Fp>(r.y, n1, n2);
  fcopy<Fp>(r.z, n3);
  return r;
}

// RCB16 Algorithm 7 (a = 0), the grouping of curves/ops.py::padd
__device__ __forceinline__ G1 g1_add(const G1& p, const G1& q) {
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

__global__ void __launch_bounds__(kThreads)
    g1_ladder_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                     const int64_t* __restrict__ pz, const int64_t* __restrict__ scalars,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                     int64_t* __restrict__ oz, int64_t lanes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  G1 base;
  load_digits<Fp>(base.x, px + i * 24);
  load_digits<Fp>(base.y, py + i * 24);
  load_digits<Fp>(base.z, pz + i * 24);
  uint32_t s[8];  // plain scalar, 16 digits -> 8 limbs
  load_digits<FrField>(s, scalars + i * 16);
  G1 acc;  // the identity (0 : 1 : 0)
  fzero<Fp>(acc.x);
  fone<Fp>(acc.y);
  fzero<Fp>(acc.z);
  for (int k = 255; k >= 0; --k) {
    acc = g1_double(acc);
    G1 sum = g1_add(acc, base);
    if ((s[k >> 5] >> (k & 31)) & 1u) acc = sum;
  }
  store_digits<Fp>(ox + i * 24, acc.x);
  store_digits<Fp>(oy + i * 24, acc.y);
  store_digits<Fp>(oz + i * 24, acc.z);
}

}  // namespace

extern "C" {

// field: 0 = Fr (16 digits), 1 = Fp (24 digits)
int kateth_mont_mul(int field, const int64_t* a, const int64_t* b, int64_t* out,
                    int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_mul_kernel<FrField><<<blocks_for(lanes), kThreads, 0, s>>>(a, b, out, lanes);
  else
    mont_mul_kernel<FpField><<<blocks_for(lanes), kThreads, 0, s>>>(a, b, out, lanes);
  return (int)cudaGetLastError();
}

// exp_words: host array of little-endian 32-bit words of e, n_bits <= 512
int kateth_pow_chain(int field, const int64_t* a, int64_t* out, int64_t lanes,
                     const uint32_t* exp_words, int n_bits, void* stream) {
  if (n_bits < 1 || n_bits > 512) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  Exponent e = {};
  for (int k = 0; k < (n_bits + 31) / 32; ++k) e.w[k] = exp_words[k];
  e.n_bits = n_bits;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    pow_chain_kernel<FrField><<<blocks_for(lanes), kThreads, 0, s>>>(a, out, lanes, e);
  else
    pow_chain_kernel<FpField><<<blocks_for(lanes), kThreads, 0, s>>>(a, out, lanes, e);
  return (int)cudaGetLastError();
}

int kateth_g1_ladder(const int64_t* px, const int64_t* py, const int64_t* pz,
                     const int64_t* scalars, int64_t* ox, int64_t* oy, int64_t* oz,
                     int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  g1_ladder_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, scalars, ox, oy, oz, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
