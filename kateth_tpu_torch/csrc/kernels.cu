// Kernels K1-K3: batched Montgomery multiply, pow chain and G1 ladder.
//
// Operands arrive in the PyTorch layout: int64 tensors of 16-bit digits,
// lane-major ((lanes, D), digits contiguous).  In K1 each thread owns one
// lane, through a tile staged in shared memory; in K2 a team of 4 or 6
// threads does (pow_team.cuh), in K3 a team of 8 (team.cuh).  Digits are packed into 32-bit limbs on load and
// unpacked on store.
//
// C interface, bound with ctypes by kateth_tpu_torch/cuda_lib.py: every
// launcher takes the device pointers and the CUDA stream, launches on that
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "pow_team.cuh"
#include "schedule_g1.cuh"

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
// Design: a block of 128 threads owns a tile of 128 lanes, which is one
// contiguous byte range of each operand (128 x D x 8 bytes).  The block
// stages the tiles of a and b into shared memory with coalesced 16-byte
// loads, neighbouring threads on neighbouring 16 bytes, each thread
// packing its digit pair into a 32-bit limb; a lane's row of limbs is
// padded to N + 1 words, an odd stride, so that the 32 threads of a warp
// read their own rows' limb j from 32 different banks.  Each thread then
// runs its lane's CIOS product in registers, writes the row back over a's
// tile, and the block stores the tile with coalesced 16-byte stores.  A
// ragged last tile stages only its lanes; a base pointer that is not
// 16-byte aligned takes the same kernel with two 8-byte accesses a chunk.
// ---------------------------------------------------------------------------

template <class F, bool kAligned16>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                    int64_t* __restrict__ out, int64_t lanes) {
  constexpr int N = F::N;
  constexpr int kRow = N + 1;  // words a row: odd, so no bank conflicts
  __shared__ uint32_t ta[kThreads * kRow], tb[kThreads * kRow];
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int64_t left = lanes - first;
  const int n = left < kThreads ? (int)left : kThreads;  // lanes of this tile
  const int64_t base = first * 2 * N;                    // its first digit
  // chunk c of the tile: digits 2c and 2c + 1, limb c % N of lane c / N,
  // which sits at word c + c / N of the padded tile
  for (int c = threadIdx.x; c < n * N; c += kThreads) {
    const int64_t d = base + 2 * c;
    int64_t a0, a1, b0, b1;
    if (kAligned16) {
      const longlong2 va = __ldg(reinterpret_cast<const longlong2*>(a + d));
      const longlong2 vb = __ldg(reinterpret_cast<const longlong2*>(b + d));
      a0 = va.x, a1 = va.y, b0 = vb.x, b1 = vb.y;
    } else {
      a0 = __ldg(a + d), a1 = __ldg(a + d + 1), b0 = __ldg(b + d), b1 = __ldg(b + d + 1);
    }
    const int w = c + c / N;
    ta[w] = (uint32_t)a0 | ((uint32_t)a1 << 16);
    tb[w] = (uint32_t)b0 | ((uint32_t)b1 << 16);
  }
  __syncthreads();
  if (threadIdx.x < n) {
    uint32_t* row = ta + threadIdx.x * kRow;
    const uint32_t* rb = tb + threadIdx.x * kRow;
    uint32_t x[N], y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = row[j], y[j] = rb[j];
    fmul<F>(x, x, y);
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = x[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n * N; c += kThreads) {
    const uint32_t v = ta[c + c / N];
    const int64_t lo = v & 0xffffu, hi = v >> 16;
    int64_t* o = out + base + 2 * c;
    if (kAligned16) {
      *reinterpret_cast<longlong2*>(o) = make_longlong2(lo, hi);
    } else {
      o[0] = lo, o[1] = hi;
    }
  }
}

template <class F>
void launch_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int64_t lanes,
                     cudaStream_t s) {
  const bool aligned = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15u) == 0;
  if (aligned)
    mont_mul_kernel<F, true><<<blocks_for(lanes), kThreads, 0, s>>>(a, b, out, lanes);
  else
    mont_mul_kernel<F, false><<<blocks_for(lanes), kThreads, 0, s>>>(a, b, out, lanes);
}

// ---------------------------------------------------------------------------
// K2 pow_chain.  Replaces pallas_mont.py::_pow_chain_flat.
// Bound: the latency of one dependent chain of products per lane.  Its
// rate bound (0.0028 ms at 128 Fp lanes for (p+1)/4) is far below what a
// chain of hundreds of dependent products on few lanes (2B = 128 at the
// verify batch, 1 in the easy part's inverse) can reach.
// Design: the chain is cuda_mont.pow_chain(e), a sliding window over the
// static exponent built in Python (457 products for (p+1)/4 against the
// bit-by-bit chain's 606), handed over in the kernel's parameter space; a
// team of threads runs each lane's products (pow_team.cuh: 6 threads
// spanning 8 lanes over Fp, 4 over Fr), the lane's odd powers in shared
// memory.  A block is one warp (4 Fp or 8 Fr lanes), so a 128-lane launch
// spreads over 32 SMs.
// ---------------------------------------------------------------------------

template <class F>
__global__ void __launch_bounds__(32)
    pow_chain_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, int64_t lanes,
                     PowChainArg chain) {
  constexpr int D = 2 * F::N;
  constexpr int kWidth = TeamField<F>::kWidth;
  constexpr int kLanes = 32 / kWidth;  // lanes a block of one warp
  __shared__ uint32_t table[kLanes][kPowMaxTable][F::N];
  __shared__ int64_t scratch[kLanes][D];
  const int team = threadIdx.x / kWidth;
  const int64_t i = (int64_t)blockIdx.x * kLanes + team;
  // a team past the last lane runs the last lane again (every thread of
  // the warp takes part in the team's shuffles) and stores nothing
  const int64_t src = i < lanes ? i : lanes - 1;
  int64_t* dst = i < lanes ? out + i * D : scratch[team];
  pow_chain_lane<F>(a + src * D, dst, chain, table[team],
                    PowTeam{(int)threadIdx.x % kWidth, team * kWidth});
}

template <class F>
void launch_pow_chain(const int64_t* a, int64_t* out, int64_t lanes, const PowChainArg& chain,
                      cudaStream_t s) {
  constexpr int kLanes = 32 / TeamField<F>::kWidth;
  const unsigned int blocks = (unsigned int)((lanes + kLanes - 1) / kLanes);
  pow_chain_kernel<F><<<blocks, 32, 0, s>>>(a, out, lanes, chain);
}

// ---------------------------------------------------------------------------
// K3 g1_ladder.  Replaces pallas_mont.py::_g1_ladder_flat (G1Vec).
// Bound: operations, in practice the latency of dependent Fp products.
// 256 MSB-first steps of a complete doubling (8 products) and a complete
// addition (12 products) per lane; at the verify shape (5B + 1 = 321 lanes)
// one thread per lane would walk a chain of 5,120 products on 3 SMs.
// Design: a team of 8 threads per lane, 4 lanes to a warp, 8 lanes to a
// block.  The step is the round schedule of schedule_g1.cuh (team_schedule.py:
// the formulas of curves/ops.py over Fp, 4 product rounds of at most 6
// products), run by team.cuh's interpreter with the carry-chain product;
// the accumulator, the base and the temporaries live in shared memory and
// the team syncs with __syncwarp over its 8 lanes.  The point doubles and
// adds every bit; the lane's scalar bit selects the sum (the SEL round), so
// the projective result is bit-identical to the plain ladder.
// ---------------------------------------------------------------------------

constexpr int kLadderTeams = 8;  // lanes per block
constexpr int kLadderThreads = kLadderTeams * sched_g1_ladder::kTeamThreads;

__global__ void __launch_bounds__(kLadderThreads)
    g1_ladder_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                     const int64_t* __restrict__ pz, const int64_t* __restrict__ scalars,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                     int64_t* __restrict__ oz, int64_t lanes) {
  using namespace sched_g1_ladder;
  static_assert(kTeamThreads == 8, "four teams to a warp");
  __shared__ __align__(16) Slot slots[kLadderTeams][kSlots];
  __shared__ uint32_t words[kLadderTeams][8];  // the lane's plain scalar
  const int team = threadIdx.x / kTeamThreads, t = threadIdx.x % kTeamThreads;
  const int64_t i = (int64_t)blockIdx.x * kLadderTeams + team;
  if (i >= lanes) return;  // whole teams leave together
  const TeamSync sync{0xffu << (kTeamThreads * (team & 3))};
  Slot* slot = slots[team];
  // the inputs: base, acc = (0 : 1 : 0), the constants; one slot a thread
  uint32_t v[12];
  if (t == 0) load_digits<FpField>(v, px + i * 24);
  else if (t == 1) load_digits<FpField>(v, py + i * 24);
  else if (t == 2) load_digits<FpField>(v, pz + i * 24);
  else if (t == 3 || t == 4) fone<FpField>(v);
  else fzero<FpField>(v);
  const int dst = t == 0   ? kSlot_bx
                  : t == 1 ? kSlot_by
                  : t == 2 ? kSlot_bz
                  : t == 3 ? kSlot_one
                  : t == 4 ? kSlot_y
                  : t == 5 ? kSlot_zero
                  : t == 6 ? kSlot_x
                           : kSlot_z;
  slot_store(slot[dst], v);
  words[team][t] = (uint32_t)scalars[i * 16 + 2 * t] | ((uint32_t)scalars[i * 16 + 2 * t + 1] << 16);
  sync();
  for (int k = 255; k >= 0; --k) {
    const bool bit = (words[team][k >> 5] >> (k & 31)) & 1u;
    run_program<Sched>(slot, 0, t, bit, sync);
  }
  if (t < 3) {
    slot_load(v, slot[t == 0 ? kSlot_x : t == 1 ? kSlot_y : kSlot_z]);
    store_digits<FpField>((t == 0 ? ox : t == 1 ? oy : oz) + i * 24, v);
  }
}

}  // namespace

extern "C" {

// field: 0 = Fr (16 digits), 1 = Fp (24 digits)
int kateth_mont_mul(int field, const int64_t* a, const int64_t* b, int64_t* out,
                    int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    launch_mont_mul<FrField>(a, b, out, lanes, s);
  else
    launch_mont_mul<FpField>(a, b, out, lanes, s);
  return (int)cudaGetLastError();
}

// chain: host copy of cuda_mont.pow_chain(e), n_steps <= kPowMaxSteps
int kateth_pow_chain(int field, const int64_t* a, int64_t* out, int64_t lanes,
                     const PowChainArg* chain, void* stream) {
  if (chain->n_steps < 0 || chain->n_steps > kPowMaxSteps || chain->table_max < 1 ||
      chain->table_max >= 2 * kPowMaxTable)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    launch_pow_chain<FrField>(a, out, lanes, *chain, s);
  else
    launch_pow_chain<FpField>(a, out, lanes, *chain, s);
  return (int)cudaGetLastError();
}

int kateth_g1_ladder(const int64_t* px, const int64_t* py, const int64_t* pz,
                     const int64_t* scalars, int64_t* ox, int64_t* oy, int64_t* oz,
                     int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  const unsigned int blocks = (unsigned int)((lanes + kLadderTeams - 1) / kLadderTeams);
  g1_ladder_kernel<<<blocks, kLadderThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, scalars, ox, oy, oz, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
