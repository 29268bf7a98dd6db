// Kernel K4: the BLS12-381 Miller loop on the twist.
//
// Replaces kateth_tpu/pallas_pairing.py::_miller_flat
// (_make_miller_kernel).  It computes what pairing.miller_loop's plain scan
// computes, bit for bit: over the 63 bits of |x| after its leading one, the
// tangent line at the projective twist point T (_line_dbl), T doubled and,
// where the bit is set, the chord through T and Q (_line_add) and T + Q
// with the complete formulas of curves/ops.py, both lines folded with the
// affine G1 point and merged into one sparse Fp12 factor (_merge_lines),
// then f = f^2 line; finally the conjugate for the negative x.
//
// Bound: operations, in practice the latency of dependent Fp products: a
// lane's 63 steps are one chain, and a verify has 2 lanes.  Design: one
// block of 64 threads per lane.  Each step is a round schedule of
// schedule_miller.cuh (team_schedule.py: the formulas above and fields/
// fp12.py's Karatsuba sqr and mul over Fp, 4 product rounds for a clear
// bit and 6 for a set one, at most 51 products a round), run by team.cuh's
// interpreter with the carry-chain product.  T, f, the operands and every
// temporary live in shared memory as Fp slots; rounds are separated by
// __syncthreads(), and the choice of program by the bit of |x| is
// block-uniform.  Every slot is a canonical field element computed by the
// plain formulas' algebra, so the raw Miller value (the same projective
// representatives) is bit-identical to the plain scan.

#include <cuda_runtime.h>

#include "schedule_miller.cuh"

using namespace kt;

namespace {

constexpr unsigned long long kXAbs = 0xd201000000010000ull;  // |x|, MSB first

__global__ void __launch_bounds__(sched_miller::kTeamThreads)
    miller_kernel(const int64_t* __restrict__ xp_d, const int64_t* __restrict__ yp_d,
                  const int64_t* __restrict__ xq_d, const int64_t* __restrict__ yq_d,
                  int64_t* __restrict__ out) {
  using namespace sched_miller;
  static_assert(kInputs <= kTeamThreads, "one input slot a thread");
  __shared__ __align__(16) Slot slot[kSlots];
  const int64_t i = blockIdx.x;  // one block per lane
  const int t = threadIdx.x;
  // the inputs: P, Q, T = (xq : yq : 1), f = 1 and the constants
  uint32_t v[12];
  if (t == kSlot_xp) load_digits<FpField>(v, xp_d + i * 24);
  else if (t == kSlot_yp) load_digits<FpField>(v, yp_d + i * 24);
  else if (t == kSlot_xq_0 || t == kSlot_tx_0) load_digits<FpField>(v, xq_d + i * 48);
  else if (t == kSlot_xq_1 || t == kSlot_tx_1) load_digits<FpField>(v, xq_d + i * 48 + 24);
  else if (t == kSlot_yq_0 || t == kSlot_ty_0) load_digits<FpField>(v, yq_d + i * 48);
  else if (t == kSlot_yq_1 || t == kSlot_ty_1) load_digits<FpField>(v, yq_d + i * 48 + 24);
  else if (t == kSlot_one || t == kSlot_tz_0 || t == kSlot_f_0) fone<FpField>(v);
  else fzero<FpField>(v);
  if (t < kInputs) slot_store(slot[t], v);
  __syncthreads();
  for (int k = 62; k >= 0; --k) run_program<Sched>(slot, (kXAbs >> k) & 1ull, t, false, BlockSync{});
  // f conjugated: the coefficients m = (w 3 + v) 2 + u with w = 1 negated
  if (t < 12) {
    uint32_t zero[12];
    slot_load(v, slot[kSlot_f_0 + t]);
    if (t >= 6) {
      fzero<FpField>(zero);
      fp_sub_cc(v, zero, v);
    }
    store_digits<FpField>(out + i * 288 + t * 24, v);
  }
}

}  // namespace

extern "C" {

// xp, yp: (lanes, 24) affine G1; xq, yq: (lanes, 2, 24) affine twist point;
// out: (lanes, 2, 3, 2, 24) Fp12
int kateth_miller(const int64_t* xp, const int64_t* yp, const int64_t* xq, const int64_t* yq,
                  int64_t* out, int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  miller_kernel<<<(unsigned int)lanes, sched_miller::kTeamThreads, 0, (cudaStream_t)stream>>>(
      xp, yp, xq, yq, out);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
