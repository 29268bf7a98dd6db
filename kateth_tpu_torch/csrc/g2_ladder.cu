// Kernel K6: the G2 double-and-add ladder.
//
// Replaces kateth_tpu/pallas_pairing.py::_g2_ladder_flat
// (_make_g2_ladder_kernel, driven by g2_scalar_mul).  Per lane: 256
// MSB-first steps of a complete doubling and a complete addition of the
// base point over projective Fp2 coordinates, the scalar's bit selecting
// the sum, from the identity (0 : 1 : 0): the plain ladder of
// curves/ops.py::scalar_mul with n_bits = 256, with the same formulas
// (g2.cuh), so the projective result is bit-identical to it.
//
// Bound: operations, but in practice latency: 256 dependent steps of 20
// Fp2 products on the single lane of verify_kzg_proof (z times -G2), so
// one thread of one warp runs.  Design: one thread per lane, the point in
// local memory through the __noinline__ Fp2 products of tower.cuh; the
// scalar's limbs stay in registers.

#include <cuda_runtime.h>

#include "g2.cuh"

using namespace kt;

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    g2_ladder_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                     const int64_t* __restrict__ pz, const int64_t* __restrict__ scalars,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                     int64_t* __restrict__ oz, int64_t lanes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  G2 base;
  base.x = f2_load(px + i * 48);
  base.y = f2_load(py + i * 48);
  base.z = f2_load(pz + i * 48);
  uint32_t s[8];  // plain scalar, 16 digits -> 8 limbs
  load_digits<FrField>(s, scalars + i * 16);
  G2 acc;  // the identity (0 : 1 : 0)
  acc.x = f2_zero();
  acc.y = f2_one();
  acc.z = f2_zero();
  for (int k = 255; k >= 0; --k) {
    acc = g2_double(acc);
    G2 sum = g2_add(acc, base);
    if ((s[k >> 5] >> (k & 31)) & 1u) acc = sum;
  }
  f2_store(ox + i * 48, acc.x);
  f2_store(oy + i * 48, acc.y);
  f2_store(oz + i * 48, acc.z);
}

}  // namespace

extern "C" {

// px, py, pz, ox, oy, oz: (lanes, 2, 24) projective Fp2 coordinates;
// scalars: (lanes, 16) plain Fr digits
int kateth_g2_ladder(const int64_t* px, const int64_t* py, const int64_t* pz,
                     const int64_t* scalars, int64_t* ox, int64_t* oy, int64_t* oz,
                     int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  unsigned int blocks = (unsigned int)((lanes + kThreads - 1) / kThreads);
  g2_ladder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(px, py, pz, scalars, ox, oy,
                                                                   oz, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
