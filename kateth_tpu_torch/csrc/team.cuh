// Team kernels: the interpreter of the round schedules that
// team_schedule.py writes (schedule_*.cuh).
//
// A team of threads works on one lane.  The lane's values live in shared
// memory as Fp slots of 12 32-bit limbs (Montgomery, canonical, the limbs
// of field.cuh); each round, thread t of the team runs instructions t,
// t + team, ... of the round, then the team syncs.  No instruction reads
// a slot that another one of its round writes, so the order inside a round
// does not matter.  The arithmetic is field.cuh's carry-chain Fp product,
// add and sub.

#pragma once

#include <cstdint>

#include "field.cuh"

namespace kt {

enum class TeamOp : uint32_t { MUL = 0, ADD, SUB, SMALL, SEL, COPY };

// one instruction: x = op | dst << 16, y = a | b << 16 (b is the constant
// of SMALL; COPY reads a only)
#define KT_INSTR(op, d, a, b)                                       \
  {                                                                 \
    (uint32_t)::kt::TeamOp::op | ((uint32_t)(d) << 16),             \
        (uint32_t)(a) | ((uint32_t)(b) << 16)                       \
  }

// k a mod p for a small constant k >= 1, by doubling and adding
__device__ __forceinline__ void fp_small_cc(uint32_t* r, const uint32_t* a, uint32_t k) {
  uint32_t acc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j] = a[j];
  for (int i = 30 - __clz(k); i >= 0; --i) {
    fp_add_cc(acc, acc, acc);
    if ((k >> i) & 1u) fp_add_cc(acc, acc, a);
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = acc[j];
}

// --- slots ------------------------------------------------------------------

using Slot = uint32_t[12];  // 48 bytes: three 16-byte words

__device__ __forceinline__ void slot_load(uint32_t* r, const Slot& s) {
  const uint4* p = reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = p[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void slot_store(Slot& s, const uint32_t* a) {
  uint4* p = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int q = 0; q < 3; ++q) p[q] = make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

// --- the interpreter ----------------------------------------------------------

__device__ __forceinline__ void team_mul(Slot* slot, uint2 ins) {
  uint32_t x[12], y[12];
  slot_load(x, slot[ins.y & 0xffffu]);
  slot_load(y, slot[ins.y >> 16]);
  fp_mul_cc(x, x, y);
  slot_store(slot[ins.x >> 16], x);
}

__device__ __forceinline__ void team_linear(Slot* slot, uint2 ins, bool bit) {
  const TeamOp op = (TeamOp)(ins.x & 0xffffu);
  const uint32_t b = ins.y >> 16;
  uint32_t x[12], y[12];
  slot_load(x, slot[ins.y & 0xffffu]);
  if (op == TeamOp::SMALL) {
    fp_small_cc(x, x, b);
  } else if (op != TeamOp::COPY) {
    slot_load(y, slot[b]);
    if (op == TeamOp::ADD) {
      fp_add_cc(x, x, y);
    } else if (op == TeamOp::SUB) {
      fp_sub_cc(x, x, y);
    } else {  // SEL
#pragma unroll
      for (int j = 0; j < 12; ++j) x[j] = bit ? x[j] : y[j];
    }
  }
  slot_store(slot[ins.x >> 16], x);
}

// the team's barrier: a block of threads, or a team of lanes of one warp
// (mask: the team's lanes; ~0u for a whole warp)
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct TeamSync {
  unsigned mask;
  __device__ __forceinline__ void operator()() const { __syncwarp(mask); }
};

// Run program `prog` of schedule S (a generated schedule_*.cuh) on the
// team's slots: thread t of S::kTeam, `bit` the lane's bit for SEL,
// `sync` the team's barrier after every round.
template <class S, class Sync>
__device__ __forceinline__ void run_program(Slot* slot, int prog, int t, bool bit, Sync sync) {
  const int r1 = S::program(prog + 1);
  for (int r = S::program(prog); r < r1; ++r) {
    const int end = S::round_start(r + 1);
    if (S::round_is_mul(r)) {
      for (int i = S::round_start(r) + t; i < end; i += S::kTeam) team_mul(slot, S::instr(i));
    } else {
      for (int i = S::round_start(r) + t; i < end; i += S::kTeam) team_linear(slot, S::instr(i), bit);
    }
    sync();
  }
}

}  // namespace kt
