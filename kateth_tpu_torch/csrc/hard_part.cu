// Kernel K5: the hard part of the BLS12-381 final exponentiation.
//
// Replaces kateth_tpu/pallas_pairing.py::_hard_part_flat
// (_make_hard_part_kernel).  For f in the cyclotomic subgroup (after the
// easy part) it computes f^((x-1)^2 (x+p) (x^2+p^2-1) + 3) by the chain of
// pairing.final_exponentiation: five |x|-power loops of Granger-Scott
// squarings, Frobenius maps and conjugations.  powx walks all 64 bits of
// |x| from acc = 1 (the first step gives 1^2 * g = g exactly), then
// conjugates for the negative x.
//
// Bound: operations, but in practice latency: about 330 dependent
// cyclotomic squarings and 40 dense Fp12 products on the single lane of a
// verify, so one thread of one warp runs.  Design: one thread per lane,
// the Fp12 values in local memory through the __noinline__ tower of
// tower.cuh; every value is a canonical field element, so the result
// equals the plain chain bit for bit.

#include <cuda_runtime.h>

#include "tower.cuh"

using namespace kt;

namespace {

constexpr unsigned long long kXAbs = 0xd201000000010000ull;

// g^x = conj(g^|x|) on the cyclotomic subgroup
__device__ __noinline__ fp12 powx(const fp12& g) {
  fp12 acc = f12_one();
  for (int k = 63; k >= 0; --k) {
    acc = f12_cyc_sqr(acc);
    if ((kXAbs >> k) & 1ull) acc = f12_mul(acc, g);
  }
  return f12_conj(acc);
}

__global__ void hard_part_kernel(const int64_t* __restrict__ f_d, int64_t* __restrict__ out,
                                 int64_t lanes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  fp12 f = f12_load(f_d + i * 288);
  fp12 t0 = f12_mul(powx(f), f12_conj(f));                 // f^(x-1)
  fp12 t1 = f12_mul(powx(t0), f12_conj(t0));               // ^(x-1)
  fp12 t2 = f12_mul(powx(t1), f12_frob(t1));               // ^(x+p)
  fp12 t3 = f12_mul(f12_mul(powx(powx(t2)), f12_frob(f12_frob(t2))),
                    f12_conj(t2));                         // ^(x^2+p^2-1)
  fp12 r = f12_mul(t3, f12_mul(f12_cyc_sqr(f), f));        // * f^3
  f12_store(out + i * 288, r);
}

}  // namespace

extern "C" {

// f, out: (lanes, 2, 3, 2, 24) Fp12
int kateth_hard_part(const int64_t* f, int64_t* out, int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  constexpr int threads = 32;
  unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
  hard_part_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(f, out, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
