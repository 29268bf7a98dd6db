// Kernels K7 and K8: the sequential point sums of the two commitment MSMs.
//
// Operands arrive in the PyTorch layout: int64 tensors of 16-bit digits,
// (rows, 24) per coordinate, digits contiguous.  A chain is g consecutive
// rows; each thread owns one chain, keeps its running sum in registers and
// adds the chain's points in order with the complete formulas of g1.cuh,
// so the projective results are bit-identical to the plain loops of
// curves/cuda_msm.py.
//
// C interface, bound with ctypes by kateth_tpu_torch/cuda_lib.py.

#include <cuda_runtime.h>

#include "g1.cuh"

using namespace kt;

namespace {

constexpr int kThreads = 64;

inline unsigned int blocks_for(int64_t chains) {
  return (unsigned int)((chains + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K7 prefix_scan.  Replaces kateth_tpu/curves/pallas_msm.py::
// _chunked_prefix_flat (the first level of prefix_scan_kernel): the
// inclusive prefix sums of each chain of g = 8 bucket-sorted points of the
// windowed Pippenger, acc = identity, acc += p_k, out_k = acc.
// Bound: operations.  At the mainnet commit (64 blobs x 4096 points,
// 32,768 chains) it does 8 complete additions of 12 Fp products per chain,
// about 0.94 G wide multiplies, against 0.30 GB read and written.
// Design: one thread per chain, 512 blocks of 64 threads over the 132 SMs;
// each thread reads and writes its rows whole (192 contiguous bytes per
// coordinate), so every sector it loads is used.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    chain_prefix_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                        const int64_t* __restrict__ pz, int64_t* __restrict__ ox,
                        int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t chains,
                        int g) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  G1 acc = g1_identity();
  for (int k = 0; k < g; ++k) {
    int64_t off = (c * g + k) * 24;
    acc = g1_add(acc, g1_load(px + off, py + off, pz + off));
    g1_store(ox + off, oy + off, oz + off, acc);
  }
}

// ---------------------------------------------------------------------------
// K8 comb_chain_sum.  Replaces kateth_tpu/curves/pallas_msm.py::
// _comb_chain_sum_flat: the sum of each chain of g = 32 gathered affine
// comb rows, a row with a zero flag being the identity, by the 11-product
// mixed addition (G1Vec.padd_mixed_flag).
// Bound: operations.  At the mainnet commit (64 blobs x 4096 rows, 8,192
// chains, once per comb column) it does 32 mixed additions per chain,
// about 0.87 G wide multiplies, against 0.11 GB read.
// Design: one thread per chain, 128 blocks of 64 threads; the affine rows
// and flags are read once, only the three chain totals are written.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    comb_chain_sum_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                          const int64_t* __restrict__ flags, int64_t* __restrict__ ox,
                          int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t chains,
                          int g) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  G1 acc = g1_identity();
  for (int k = 0; k < g; ++k) {
    int64_t row = c * g + k;
    uint32_t x2[12], y2[12];
    load_digits<FpField>(x2, x + row * 24);
    load_digits<FpField>(y2, y + row * 24);
    acc = g1_add_mixed_flag(acc, x2, y2, flags[row] != 0);
  }
  g1_store(ox + c * 24, oy + c * 24, oz + c * 24, acc);
}

}  // namespace

extern "C" {

// p*, o*: (chains * g, 24) projective coordinates, chain c = rows c g .. c g + g - 1
int kateth_chain_prefix(const int64_t* px, const int64_t* py, const int64_t* pz, int64_t* ox,
                        int64_t* oy, int64_t* oz, int64_t chains, int g, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  if (chains <= 0) return 0;
  chain_prefix_kernel<<<blocks_for(chains), kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, ox, oy, oz, chains, g);
  return (int)cudaGetLastError();
}

// x, y: (chains * g, 24) affine rows; flags: (chains * g,) nonzero = a point;
// ox, oy, oz: (chains, 24) projective chain sums
int kateth_comb_chain_sum(const int64_t* x, const int64_t* y, const int64_t* flags, int64_t* ox,
                          int64_t* oy, int64_t* oz, int64_t chains, int g, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  if (chains <= 0) return 0;
  comb_chain_sum_kernel<<<blocks_for(chains), kThreads, 0, (cudaStream_t)stream>>>(
      x, y, flags, ox, oy, oz, chains, g);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
