// Kernel K5: the hard part of the BLS12-381 final exponentiation.
//
// Replaces kateth_tpu/pallas_pairing.py::_hard_part_flat
// (_make_hard_part_kernel).  For f in the cyclotomic subgroup (after the
// easy part) it computes f^((x-1)^2 (x+p) (x^2+p^2-1) + 3), the chain of
// cuda_pairing.hard_part_plain: five |x|-powers of Granger-Scott
// squarings and products, with conjugations, Frobenius maps and dense
// products between them.
//
// Bound: operations, in practice the latency of dependent Fp products: a
// lane's 315 squarings are one chain, and a verify has 1 lane.  Design:
// one block of 64 threads per lane.  Each squaring, squaring-and-product
// (a set bit of |x|) and step between the powers is a round schedule of
// schedule_hard_part.cuh (team_schedule.py: fields/fp12.py's cyc_sqr,
// mul, conj and frob over Fp, one product round of 18 products for a
// squaring, two for a set bit, at most 64 products a round), run by
// team.cuh's interpreter with the carry-chain product.  The running power
// acc, its base g, f (later f^3), a saved factor s, the Frobenius
// constants and every temporary live in shared memory as Fp slots; rounds
// are separated by __syncthreads(), and the choice of program by the bit
// of |x| is block-uniform.  Every slot is a canonical field element, and
// the squarings see only cyclotomic values, so the result is bit-identical
// to the plain chain.

#include <cuda_runtime.h>

#include "schedule_hard_part.cuh"

using namespace kt;

namespace {

constexpr unsigned long long kXAbs = 0xd201000000010000ull;  // |x|, MSB first

__global__ void __launch_bounds__(sched_hard_part::kTeamThreads)
    hard_part_kernel(const int64_t* __restrict__ f_d, int64_t* __restrict__ out) {
  using namespace sched_hard_part;
  static_assert(kInputs <= kTeamThreads, "one input slot a thread");
  static_assert(kSlot_acc_11 == kSlot_acc_0 + 11 && kSlot_g_11 == kSlot_g_0 + 11 &&
                    kSlot_f_11 == kSlot_f_0 + 11,
                "an Fp12 input's 12 coefficients in consecutive slots");
  static_assert(kProg_glue4 == kProg_glue0 + 4, "the glue programs in order");
  __shared__ __align__(16) Slot slot[kSlots];
  const int64_t i = blockIdx.x;  // one block per lane
  const int t = threadIdx.x;
  // the inputs: acc = g = f, the constants (s is written before it is read)
  uint32_t v[12];
  const int64_t* f_lane = f_d + i * 288;  // coefficient m at m * 24
  if (t >= kSlot_acc_0 && t <= kSlot_acc_11) load_digits<FpField>(v, f_lane + (t - kSlot_acc_0) * 24);
  else if (t >= kSlot_g_0 && t <= kSlot_g_11) load_digits<FpField>(v, f_lane + (t - kSlot_g_0) * 24);
  else if (t >= kSlot_f_0 && t <= kSlot_f_11) load_digits<FpField>(v, f_lane + (t - kSlot_f_0) * 24);
  else if (t == kSlot_one) fone<FpField>(v);
  else if (t >= kConst0 && t < kConst0 + kConsts) {
#pragma unroll
    for (int j = 0; j < 12; ++j) v[j] = kConstLimbs[t - kConst0][j];
  } else fzero<FpField>(v);
  if (t < kInputs) slot_store(slot[t], v);
  __syncthreads();
  // five powers: acc = g, the bits of |x| after its leading one, the step
  // to the next power's base (glue0 .. glue4)
  for (int p = 0; p < 5; ++p) {
    for (int k = 62; k >= 0; --k)
      run_program<Sched>(slot, (kXAbs >> k) & 1ull ? kProg_sqr_mul : kProg_sqr, t, false, BlockSync{});
    run_program<Sched>(slot, kProg_glue0 + p, t, false, BlockSync{});
  }
  if (t < 12) {
    slot_load(v, slot[kSlot_acc_0 + t]);
    store_digits<FpField>(out + i * 288 + t * 24, v);
  }
}

}  // namespace

extern "C" {

// f, out: (lanes, 2, 3, 2, 24) Fp12
int kateth_hard_part(const int64_t* f, int64_t* out, int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  hard_part_kernel<<<(unsigned int)lanes, sched_hard_part::kTeamThreads, 0, (cudaStream_t)stream>>>(
      f, out);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
