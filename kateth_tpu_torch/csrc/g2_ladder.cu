// Kernel K6: the G2 double-and-add ladder.
//
// Replaces kateth_tpu/pallas_pairing.py::_g2_ladder_flat
// (_make_g2_ladder_kernel, driven by g2_scalar_mul).  Per lane: 256
// MSB-first steps of a complete doubling and a complete addition of the
// base point over projective Fp2 coordinates, the scalar's bit selecting
// the sum, from the identity (0 : 1 : 0): the plain ladder of
// curves/ops.py::scalar_mul with n_bits = 256.
//
// Bound: operations, in practice the latency of dependent Fp products:
// 256 steps of 20 Fp2 products on the single lane of verify_kzg_proof
// (z times -G2), a chain of about 15,000 Fp products on one thread.
// Design: a team of 32 threads (one warp) per lane, as K3 (kernels.cu) with
// a team of 8.  The step is the round schedule of schedule_g2.cuh
// (team_schedule.py traces curves/ops.py's pdouble and padd over Fp2,
// Karatsuba products written over Fp): 4 product rounds, the widest the
// addition's 18 Fp products, so every product round runs in one pass of
// the warp, and 23 linear rounds.  The lane's slots live in shared memory,
// team.cuh's interpreter runs them with the carry-chain Fp arithmetic and
// the warp syncs with __syncwarp.  Every slot holds a canonical value, so
// the projective result is bit-identical to the plain ladder's, the
// identity's doublings and the point at infinity included.  A block holds
// several lanes, one warp each, so the plural API's B-lane calls fill
// more SMs.

#include <cuda_runtime.h>

#include "schedule_g2.cuh"

using namespace kt;

namespace {

constexpr int kLanes = 4;  // lanes per block
constexpr int kThreads = kLanes * sched_g2_ladder::kTeamThreads;

// the input slot that thread t of a team fills: the base's six Fp
// components (t < 6), the constant one and acc's y_0 (the identity's
// y = one), then the zeros
__device__ __forceinline__ int input_slot(int t) {
  using namespace sched_g2_ladder;
  switch (t) {
    case 0: return kSlot_bx_0;
    case 1: return kSlot_bx_1;
    case 2: return kSlot_by_0;
    case 3: return kSlot_by_1;
    case 4: return kSlot_bz_0;
    case 5: return kSlot_bz_1;
    case 6: return kSlot_one;
    case 7: return kSlot_y_0;
    case 8: return kSlot_zero;
    case 9: return kSlot_x_0;
    case 10: return kSlot_x_1;
    case 11: return kSlot_y_1;
    case 12: return kSlot_z_0;
    default: return kSlot_z_1;
  }
}

// acc's six Fp components, in the (x, y, z) x (c0, c1) order of the output
__device__ __forceinline__ int state_slot(int t) {
  using namespace sched_g2_ladder;
  switch (t) {
    case 0: return kSlot_x_0;
    case 1: return kSlot_x_1;
    case 2: return kSlot_y_0;
    case 3: return kSlot_y_1;
    case 4: return kSlot_z_0;
    default: return kSlot_z_1;
  }
}

__global__ void __launch_bounds__(kThreads)
    g2_ladder_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                     const int64_t* __restrict__ pz, const int64_t* __restrict__ scalars,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                     int64_t* __restrict__ oz, int64_t lanes) {
  using namespace sched_g2_ladder;
  static_assert(kTeamThreads == 32, "a warp per lane");
  static_assert(kInputs == 14, "constants, acc and the base");
  __shared__ __align__(16) Slot slots[kLanes][kSlots];
  __shared__ uint32_t words[kLanes][8];  // the lane's plain scalar
  const int team = threadIdx.x / kTeamThreads, t = threadIdx.x % kTeamThreads;
  const int64_t i = (int64_t)blockIdx.x * kLanes + team;
  if (i >= lanes) return;  // whole warps leave together
  const TeamSync sync{~0u};
  Slot* slot = slots[team];
  // the inputs, one slot a thread: (x, y, z) are (lanes, 2, 24) planes
  if (t < kInputs) {
    uint32_t v[12];
    if (t < 6) {
      const int64_t* p = t < 2 ? px : t < 4 ? py : pz;
      load_digits<FpField>(v, p + i * 48 + (t & 1) * 24);
    } else if (t < 8) {
      fone<FpField>(v);
    } else {
      fzero<FpField>(v);
    }
    slot_store(slot[input_slot(t)], v);
  }
  if (t < 8)
    words[team][t] = (uint32_t)scalars[i * 16 + 2 * t] | ((uint32_t)scalars[i * 16 + 2 * t + 1] << 16);
  sync();
  for (int k = 255; k >= 0; --k) {
    const bool bit = (words[team][k >> 5] >> (k & 31)) & 1u;
    run_program<Sched>(slot, 0, t, bit, sync);
  }
  if (t < 6) {
    uint32_t v[12];
    slot_load(v, slot[state_slot(t)]);
    int64_t* o = t < 2 ? ox : t < 4 ? oy : oz;
    store_digits<FpField>(o + i * 48 + (t & 1) * 24, v);
  }
}

}  // namespace

extern "C" {

// px, py, pz, ox, oy, oz: (lanes, 2, 24) projective Fp2 coordinates;
// scalars: (lanes, 16) plain Fr digits
int kateth_g2_ladder(const int64_t* px, const int64_t* py, const int64_t* pz,
                     const int64_t* scalars, int64_t* ox, int64_t* oy, int64_t* oz,
                     int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  const unsigned int blocks = (unsigned int)((lanes + kLanes - 1) / kLanes);
  g2_ladder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(px, py, pz, scalars, ox, oy,
                                                                   oz, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
