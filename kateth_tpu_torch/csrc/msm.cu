// Kernels K7 and K8: the sequential point sums of the two commitment MSMs.
//
// Operands arrive in the PyTorch layout: int64 tensors of 16-bit digits,
// (rows, 24) per coordinate, digits contiguous.  A chain is g consecutive
// rows, added in order with the complete formulas of curves/ops.py by a
// team of 8 threads a chain that runs a round schedule (schedule_prefix.cuh,
// schedule_comb.cuh), so the projective results are bit-identical to the
// plain loops of curves/cuda_msm.py.
//
// C interface, bound with ctypes by kateth_tpu_torch/cuda_lib.py.

#include <cuda_runtime.h>

#include "schedule_comb.cuh"
#include "schedule_prefix.cuh"

using namespace kt;

namespace {

// ---------------------------------------------------------------------------
// K7 prefix_scan.  Replaces kateth_tpu/curves/pallas_msm.py::
// _chunked_prefix_flat (the first level of prefix_scan_kernel): the
// inclusive prefix sums of each chain of g = 8 bucket-sorted points of the
// windowed Pippenger, acc = identity, acc += p_k, out_k = acc.
// Bound: operations.  At the mainnet commit (64 blobs x 4096 points,
// 32,768 chains) it does 8 complete additions of 12 Fp products per chain,
// about 0.94 G wide multiplies, against 0.30 GB read and written.
// Design: K8's, a team of 8 threads per chain, 4 chains to a warp, 8 to a
// block.  A row's addition is the round schedule of schedule_prefix.cuh
// (team_schedule.py traces ops.padd with a projective second operand:
// 2 product rounds of 6 products), run by team.cuh's interpreter; the sum
// and the row live in shared memory as Fp slots.  A row is 36 pieces of
// 16 bytes (3 coordinates x 12 limbs, two int64 digits each); while the
// team adds row k, each thread has its pieces of row k + 1 in flight, and
// after the step it writes its pieces of the running sum with 16-byte
// stores, so a team reads and writes each row as whole 192-byte runs.
// ---------------------------------------------------------------------------

constexpr int kPrefixTeams = 8;  // chains per block
constexpr int kPrefixThreads = kPrefixTeams * sched_prefix::kTeamThreads;
constexpr int kRowPieces = 36;  // 3 coordinates x 12 limbs
constexpr int kThreadPieces = (kRowPieces + sched_prefix::kTeamThreads - 1) / sched_prefix::kTeamThreads;

// piece q of row `row` of (x, y, z): limb q % 12 of coordinate q / 12
template <class T>
__device__ __forceinline__ T* piece_ptr(T* x, T* y, T* z, int q, int64_t row) {
  return (q < 12 ? x : q < 24 ? y : z) + row * 24 + 2 * (q % 12);
}

__global__ void __launch_bounds__(kPrefixThreads)
    chain_prefix_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                        const int64_t* __restrict__ pz, int64_t* __restrict__ ox,
                        int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t chains,
                        int g) {
  using namespace sched_prefix;
  static_assert(kTeamThreads == 8, "four teams to a warp");
  static_assert(kSlot_zero == 0 && kSlot_one == 1 && kSlot_x == 2 && kSlot_y == 3 &&
                    kSlot_z == 4 && kSlot_x2 == 5 && kSlot_y2 == 6 && kSlot_z2 == 7,
                "slots 0-4 hold zero, one and acc = (0 : 1 : 0), slots 5-7 the row");
  __shared__ __align__(16) Slot slots[kPrefixTeams][kSlots];
  const int team = threadIdx.x / kTeamThreads, t = threadIdx.x % kTeamThreads;
  const int64_t c = (int64_t)blockIdx.x * kPrefixTeams + team;
  if (c >= chains) return;  // whole teams leave together
  const TeamSync sync{0xffu << (kTeamThreads * (team & 3))};
  Slot* slot = slots[team];
  uint32_t v[12];
  if (t == 1 || t == 3) fone<FpField>(v);
  else fzero<FpField>(v);
  if (t < kSlot_x2) slot_store(slot[t], v);
  uint32_t* row_limbs = slot[kSlot_x2];  // the row's 36 limbs, slots 5-7
  const uint32_t* acc_limbs = slot[kSlot_x];  // the sum's, slots 2-4
  const int64_t first = c * g;
  uint4 r[kThreadPieces];
#pragma unroll
  for (int j = 0; j < kThreadPieces; ++j) {
    const int q = t + kTeamThreads * j;
    if (q < kRowPieces) r[j] = __ldg(reinterpret_cast<const uint4*>(piece_ptr(px, py, pz, q, first)));
  }
  for (int k = 0; k < g; ++k) {
#pragma unroll
    for (int j = 0; j < kThreadPieces; ++j) {
      const int q = t + kTeamThreads * j;
      if (q < kRowPieces) row_limbs[q] = r[j].x | (r[j].z << 16);
    }
    sync();  // row k is in place
    if (k + 1 < g) {  // row k + 1 in flight while the team adds row k
#pragma unroll
      for (int j = 0; j < kThreadPieces; ++j) {
        const int q = t + kTeamThreads * j;
        if (q < kRowPieces)
          r[j] = __ldg(reinterpret_cast<const uint4*>(piece_ptr(px, py, pz, q, first + k + 1)));
      }
    }
    run_program<Sched>(slot, kProg_prefix_step, t, false, sync);
#pragma unroll
    for (int j = 0; j < kThreadPieces; ++j) {
      const int q = t + kTeamThreads * j;
      if (q < kRowPieces) {
        const uint32_t w = acc_limbs[q];
        *reinterpret_cast<longlong2*>(piece_ptr(ox, oy, oz, q, first + k)) =
            make_longlong2(w & 0xffffu, w >> 16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8 comb_chain_sum.  Replaces kateth_tpu/curves/pallas_msm.py::
// _comb_chain_sum_flat: the sum of each chain of g = 32 gathered affine
// comb rows, a row with a zero flag being the identity: ops.padd with
// Z2 = flag ? 1 : 0, in order.
// Bound: operations.  At the mainnet commit (all 22 comb columns of 64
// blobs x 4096 rows in one launch, 180,224 chains) it does 32 additions
// per chain, about 19 G wide multiplies, against 2.2 GB read.
// Design: a team of 8 threads per chain, 4 chains to a warp, 8 to a
// block, so each thread keeps few registers and an SM holds many warps
// to hide the carry chains' latency.  A row's addition is the round
// schedule of schedule_comb.cuh (team_schedule.py traces ops.padd with
// Z2 = SEL(one, zero) by the row's flag: 2 product rounds of 6 products),
// run by team.cuh's interpreter; the sum and the row live in shared memory
// as Fp slots.  While the team adds row k, each of its threads has its
// share of row k + 1 in flight (three 16-byte pieces of x or y) and
// stores it into the row's slots after the program.
// ---------------------------------------------------------------------------

constexpr int kCombTeams = 8;  // chains per block
constexpr int kCombThreads = kCombTeams * sched_comb::kTeamThreads;

__global__ void __launch_bounds__(kCombThreads)
    comb_chain_sum_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                          const int64_t* __restrict__ flags, int64_t* __restrict__ ox,
                          int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t chains,
                          int g) {
  using namespace sched_comb;
  static_assert(kTeamThreads == 8, "four teams to a warp");
  __shared__ __align__(16) Slot slots[kCombTeams][kSlots];
  const int team = threadIdx.x / kTeamThreads, t = threadIdx.x % kTeamThreads;
  const int64_t c = (int64_t)blockIdx.x * kCombTeams + team;
  if (c >= chains) return;  // whole teams leave together
  const TeamSync sync{0xffu << (kTeamThreads * (team & 3))};
  Slot* slot = slots[team];
  // acc = (0 : 1 : 0) and the constants
  uint32_t v[12];
  if (t == 1 || t == 3) fone<FpField>(v);
  else fzero<FpField>(v);
  if (t < kSlot_x2) slot_store(slot[t], v);
  static_assert(kSlot_zero == 0 && kSlot_one == 1 && kSlot_x == 2 && kSlot_y == 3 &&
                    kSlot_z == 4 && kSlot_x2 == 5,
                "slots 0-4 hold zero, one and acc = (0 : 1 : 0)");
  // thread t holds limbs 3q .. 3q + 2 of x2 (t < 4) or y2: digits 6q ..
  // 6q + 5, three 16-byte pieces of the int64 row
  const int q = t & 3;
  const uint4* piece = reinterpret_cast<const uint4*>((t < 4 ? x : y) + c * g * 24 + 6 * q);
  uint32_t* limbs = slot[t < 4 ? kSlot_x2 : kSlot_y2] + 3 * q;
  const int64_t* flag = flags + c * g;
  uint4 r[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) r[j] = __ldg(piece + j);
  bool bit = __ldg(flag) != 0;
  for (int k = 0; k < g; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) limbs[j] = r[j].x | (r[j].z << 16);
    sync();  // row k is in place
    const bool row_bit = bit;
    if (k + 1 < g) {  // row k + 1 in flight while the team adds row k
#pragma unroll
      for (int j = 0; j < 3; ++j) r[j] = __ldg(piece + (k + 1) * 12 + j);
      bit = __ldg(flag + k + 1) != 0;
    }
    run_program<Sched>(slot, kProg_comb_step, t, row_bit, sync);
  }
  if (t < 3) {
    slot_load(v, slot[kSlot_x + t]);
    store_digits<FpField>((t == 0 ? ox : t == 1 ? oy : oz) + c * 24, v);
  }
}

}  // namespace

extern "C" {

// p*, o*: (chains * g, 24) projective coordinates, 16-byte aligned, chain c
// = rows c g .. c g + g - 1
int kateth_chain_prefix(const int64_t* px, const int64_t* py, const int64_t* pz, int64_t* ox,
                        int64_t* oy, int64_t* oz, int64_t chains, int g, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  if (chains <= 0) return 0;
  const unsigned int blocks = (unsigned int)((chains + kPrefixTeams - 1) / kPrefixTeams);
  chain_prefix_kernel<<<blocks, kPrefixThreads, 0, (cudaStream_t)stream>>>(px, py, pz, ox, oy, oz,
                                                                          chains, g);
  return (int)cudaGetLastError();
}

// x, y: (chains * g, 24) affine rows, 16-byte aligned; flags: (chains * g,)
// nonzero = a point; ox, oy, oz: (chains, 24) projective chain sums
int kateth_comb_chain_sum(const int64_t* x, const int64_t* y, const int64_t* flags, int64_t* ox,
                          int64_t* oy, int64_t* oz, int64_t chains, int g, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  if (chains <= 0) return 0;
  const unsigned int blocks = (unsigned int)((chains + kCombTeams - 1) / kCombTeams);
  comb_chain_sum_kernel<<<blocks, kCombThreads, 0, (cudaStream_t)stream>>>(x, y, flags, ox, oy, oz,
                                                                           chains, g);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
