// Kernels K1-K3: batched Montgomery multiply, pow chain and G1 ladder.
//
// Operands arrive in the PyTorch layout: int64 tensors of 16-bit digits,
// lane-major ((lanes, D), digits contiguous).  In K1 and K2 each thread owns
// one lane (K1 through a tile staged in shared memory); in K3 a team of 8
// threads does (team.cuh).  Digits are packed into 32-bit limbs on load and
// unpacked on store.
//
// C interface, bound with ctypes by kateth_tpu_torch/cuda_lib.py: every
// launcher takes the device pointers and the CUDA stream, launches on that
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
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
  const unsigned int blocks = (unsigned int)((lanes + kLadderTeams - 1) / kLadderTeams);
  g1_ladder_kernel<<<blocks, kLadderThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, scalars, ox, oy, oz, lanes);
  return (int)cudaGetLastError();
}

const char* kateth_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
