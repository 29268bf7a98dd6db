// Round schedule of the team kernel comb: generated by
// kateth_tpu_torch/team_schedule.py, which documents the format.
// Do not edit; rerun the generator.
//
// comb_step: 8 rounds, 2 of them products (12 Fp products, at most 6 a round)

#pragma once

#include <cstdint>

#include "team.cuh"

namespace kt {
namespace sched_comb {

constexpr int kSlots = 22;
constexpr int kTeamThreads = 8;
constexpr int kPrograms = 1;
constexpr int kRounds = 8;
// the Fp products of each program
constexpr int kProgramProducts[1] = {12};
// the product rounds of each program
constexpr int kProgramProductRounds[1] = {2};
// the programs by name
constexpr int kProg_comb_step = 0;
// the named input slots [0, kInputs): constants, the step's state, operands
constexpr int kInputs = 7;
constexpr int kSlot_zero = 0;
constexpr int kSlot_one = 1;
constexpr int kSlot_x = 2;
constexpr int kSlot_y = 3;
constexpr int kSlot_z = 4;
constexpr int kSlot_x2 = 5;
constexpr int kSlot_y2 = 6;

// program p runs rounds [kProgram[p], kProgram[p + 1])
__constant__ uint16_t kProgram[2] = {0, 8};
// round r runs instructions [kRoundStart[r], kRoundStart[r + 1])
__constant__ uint16_t kRoundStart[9] = {
    0, 1, 7, 13, 14, 19, 25, 31, 34,
};
// 1: a product round
__constant__ uint8_t kRoundIsMul[8] = {
    0, 0, 1, 0, 0, 0, 1, 0,
};
__device__ const uint2 kInstr[34] = {
    // round 0
    KT_INSTR(SEL, 7, 1, 0),
    // round 1
    KT_INSTR(ADD, 8, 2, 3), KT_INSTR(ADD, 9, 5, 6), KT_INSTR(ADD, 10, 3, 4),
    KT_INSTR(ADD, 11, 6, 7), KT_INSTR(ADD, 12, 2, 4), KT_INSTR(ADD, 13, 5, 7),
    // round 2
    KT_INSTR(MUL, 14, 2, 5), KT_INSTR(MUL, 15, 3, 6), KT_INSTR(MUL, 16, 4, 7),
    KT_INSTR(MUL, 17, 8, 9), KT_INSTR(MUL, 18, 10, 11), KT_INSTR(MUL, 19, 12, 13),
    // round 3
    KT_INSTR(ADD, 7, 14, 16),
    // round 4
    KT_INSTR(ADD, 8, 14, 15), KT_INSTR(ADD, 9, 15, 16), KT_INSTR(ADD, 10, 14, 14),
    KT_INSTR(SUB, 11, 19, 7), KT_INSTR(SMALL, 12, 16, 12),
    // round 5
    KT_INSTR(SUB, 7, 17, 8), KT_INSTR(SUB, 13, 18, 9), KT_INSTR(ADD, 16, 14, 10),
    KT_INSTR(ADD, 19, 15, 12), KT_INSTR(SUB, 20, 15, 12), KT_INSTR(SMALL, 21, 11, 12),
    // round 6
    KT_INSTR(MUL, 8, 13, 21), KT_INSTR(MUL, 9, 7, 20), KT_INSTR(MUL, 10, 16, 21),
    KT_INSTR(MUL, 11, 19, 20), KT_INSTR(MUL, 12, 7, 16), KT_INSTR(MUL, 14, 13, 19),
    // round 7
    KT_INSTR(SUB, 2, 9, 8), KT_INSTR(ADD, 3, 10, 11), KT_INSTR(ADD, 4, 12, 14),
};

// what run_program (team.cuh) reads
struct Sched {
  static constexpr int kTeam = kTeamThreads;
  __device__ __forceinline__ static int program(int p) { return kProgram[p]; }
  __device__ __forceinline__ static int round_start(int r) { return kRoundStart[r]; }
  __device__ __forceinline__ static bool round_is_mul(int r) { return kRoundIsMul[r]; }
  __device__ __forceinline__ static uint2 instr(int i) { return __ldg(&kInstr[i]); }
};

}  // namespace sched_comb
}  // namespace kt
