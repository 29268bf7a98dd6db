// Round schedule of the team kernel prefix: generated by
// kateth_tpu_torch/team_schedule.py, which documents the format.
// Do not edit; rerun the generator.
//
// prefix_step: 7 rounds, 2 of them products (12 Fp products, at most 6 a round)

#pragma once

#include <cstdint>

#include "team.cuh"

namespace kt {
namespace sched_prefix {

constexpr int kSlots = 23;
constexpr int kTeamThreads = 8;
constexpr int kPrograms = 1;
constexpr int kRounds = 7;
// the Fp products of each program
constexpr int kProgramProducts[1] = {12};
// the product rounds of each program
constexpr int kProgramProductRounds[1] = {2};
// the programs by name
constexpr int kProg_prefix_step = 0;
// the named input slots [0, kInputs): constants, the step's state, operands
constexpr int kInputs = 8;
constexpr int kSlot_zero = 0;
constexpr int kSlot_one = 1;
constexpr int kSlot_x = 2;
constexpr int kSlot_y = 3;
constexpr int kSlot_z = 4;
constexpr int kSlot_x2 = 5;
constexpr int kSlot_y2 = 6;
constexpr int kSlot_z2 = 7;

// program p runs rounds [kProgram[p], kProgram[p + 1])
__constant__ uint16_t kProgram[2] = {0, 7};
// round r runs instructions [kRoundStart[r], kRoundStart[r + 1])
__constant__ uint16_t kRoundStart[8] = {
    0, 6, 12, 13, 18, 24, 30, 33,
};
// 1: a product round
__constant__ uint8_t kRoundIsMul[7] = {
    0, 1, 0, 0, 0, 1, 0,
};
__device__ const uint2 kInstr[33] = {
    // round 0
    KT_INSTR(ADD, 8, 2, 3), KT_INSTR(ADD, 9, 5, 6), KT_INSTR(ADD, 10, 3, 4),
    KT_INSTR(ADD, 11, 6, 7), KT_INSTR(ADD, 12, 2, 4), KT_INSTR(ADD, 13, 5, 7),
    // round 1
    KT_INSTR(MUL, 14, 2, 5), KT_INSTR(MUL, 15, 3, 6), KT_INSTR(MUL, 16, 4, 7),
    KT_INSTR(MUL, 17, 8, 9), KT_INSTR(MUL, 18, 10, 11), KT_INSTR(MUL, 19, 12, 13),
    // round 2
    KT_INSTR(ADD, 8, 14, 16),
    // round 3
    KT_INSTR(ADD, 9, 14, 15), KT_INSTR(ADD, 10, 15, 16), KT_INSTR(ADD, 11, 14, 14),
    KT_INSTR(SUB, 12, 19, 8), KT_INSTR(SMALL, 13, 16, 12),
    // round 4
    KT_INSTR(SUB, 8, 17, 9), KT_INSTR(SUB, 16, 18, 10), KT_INSTR(ADD, 19, 14, 11),
    KT_INSTR(ADD, 20, 15, 13), KT_INSTR(SUB, 21, 15, 13), KT_INSTR(SMALL, 22, 12, 12),
    // round 5
    KT_INSTR(MUL, 9, 16, 22), KT_INSTR(MUL, 10, 8, 21), KT_INSTR(MUL, 11, 19, 22),
    KT_INSTR(MUL, 12, 20, 21), KT_INSTR(MUL, 13, 8, 19), KT_INSTR(MUL, 14, 16, 20),
    // round 6
    KT_INSTR(SUB, 2, 10, 9), KT_INSTR(ADD, 3, 11, 12), KT_INSTR(ADD, 4, 13, 14),
};

// what run_program (team.cuh) reads
struct Sched {
  static constexpr int kTeam = kTeamThreads;
  __device__ __forceinline__ static int program(int p) { return kProgram[p]; }
  __device__ __forceinline__ static int round_start(int r) { return kRoundStart[r]; }
  __device__ __forceinline__ static bool round_is_mul(int r) { return kRoundIsMul[r]; }
  __device__ __forceinline__ static uint2 instr(int i) { return __ldg(&kInstr[i]); }
};

}  // namespace sched_prefix
}  // namespace kt
