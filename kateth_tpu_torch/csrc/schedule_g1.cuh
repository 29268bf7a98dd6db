// Round schedule of the team kernel g1_ladder: generated by
// kateth_tpu_torch/team_schedule.py, which documents the format.
// Do not edit; rerun the generator.
//
// g1_step: 13 rounds, 4 of them products (20 Fp products, at most 6 a round)

#pragma once

#include <cstdint>

#include "team.cuh"

namespace kt {
namespace sched_g1_ladder {

constexpr int kSlots = 26;
constexpr int kTeamThreads = 8;
constexpr int kPrograms = 1;
constexpr int kRounds = 13;
// the Fp products of each program
constexpr int kProgramProducts[1] = {20};
// the product rounds of each program
constexpr int kProgramProductRounds[1] = {4};
// the programs by name
constexpr int kProg_g1_step = 0;
// the named input slots [0, kInputs): constants, the step's state, operands
constexpr int kInputs = 8;
constexpr int kSlot_zero = 0;
constexpr int kSlot_one = 1;
constexpr int kSlot_x = 2;
constexpr int kSlot_y = 3;
constexpr int kSlot_z = 4;
constexpr int kSlot_bx = 5;
constexpr int kSlot_by = 6;
constexpr int kSlot_bz = 7;

// program p runs rounds [kProgram[p], kProgram[p + 1])
__constant__ uint16_t kProgram[2] = {0, 13};
// round r runs instructions [kRoundStart[r], kRoundStart[r + 1])
__constant__ uint16_t kRoundStart[14] = {
    0, 4, 6, 9, 13, 15, 21, 27, 28, 33, 39, 45, 48, 51,
};
// 1: a product round
__constant__ uint8_t kRoundIsMul[13] = {
    1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 0,
};
__device__ const uint2 kInstr[51] = {
    // round 0
    KT_INSTR(MUL, 8, 3, 3), KT_INSTR(MUL, 9, 3, 4), KT_INSTR(MUL, 10, 4, 4),
    KT_INSTR(MUL, 11, 2, 3),
    // round 1
    KT_INSTR(SMALL, 12, 10, 12), KT_INSTR(SMALL, 13, 10, 36),
    // round 2
    KT_INSTR(SMALL, 10, 8, 8), KT_INSTR(SUB, 14, 8, 13), KT_INSTR(ADD, 15, 8, 12),
    // round 3
    KT_INSTR(MUL, 8, 12, 10), KT_INSTR(MUL, 13, 9, 10), KT_INSTR(MUL, 16, 14, 15),
    KT_INSTR(MUL, 17, 11, 14),
    // round 4
    KT_INSTR(ADD, 9, 17, 17), KT_INSTR(ADD, 10, 8, 16),
    // round 5
    KT_INSTR(ADD, 8, 9, 10), KT_INSTR(ADD, 11, 5, 6), KT_INSTR(ADD, 12, 13, 10),
    KT_INSTR(ADD, 14, 6, 7), KT_INSTR(ADD, 15, 13, 9), KT_INSTR(ADD, 16, 5, 7),
    // round 6
    KT_INSTR(MUL, 17, 5, 9), KT_INSTR(MUL, 18, 6, 10), KT_INSTR(MUL, 19, 7, 13),
    KT_INSTR(MUL, 20, 8, 11), KT_INSTR(MUL, 21, 12, 14), KT_INSTR(MUL, 22, 15, 16),
    // round 7
    KT_INSTR(ADD, 8, 17, 19),
    // round 8
    KT_INSTR(ADD, 11, 17, 18), KT_INSTR(ADD, 12, 18, 19), KT_INSTR(ADD, 14, 17, 17),
    KT_INSTR(SUB, 15, 22, 8), KT_INSTR(SMALL, 16, 19, 12),
    // round 9
    KT_INSTR(SUB, 8, 20, 11), KT_INSTR(SUB, 19, 21, 12), KT_INSTR(ADD, 22, 17, 14),
    KT_INSTR(ADD, 23, 18, 16), KT_INSTR(SUB, 24, 18, 16), KT_INSTR(SMALL, 25, 15, 12),
    // round 10
    KT_INSTR(MUL, 11, 19, 25), KT_INSTR(MUL, 12, 8, 24), KT_INSTR(MUL, 14, 22, 25),
    KT_INSTR(MUL, 15, 23, 24), KT_INSTR(MUL, 16, 8, 22), KT_INSTR(MUL, 17, 19, 23),
    // round 11
    KT_INSTR(SUB, 8, 12, 11), KT_INSTR(ADD, 18, 14, 15), KT_INSTR(ADD, 19, 16, 17),
    // round 12
    KT_INSTR(SEL, 2, 8, 9), KT_INSTR(SEL, 3, 18, 10), KT_INSTR(SEL, 4, 19, 13),
};

// what run_program (team.cuh) reads
struct Sched {
  static constexpr int kTeam = kTeamThreads;
  __device__ __forceinline__ static int program(int p) { return kProgram[p]; }
  __device__ __forceinline__ static int round_start(int r) { return kRoundStart[r]; }
  __device__ __forceinline__ static bool round_is_mul(int r) { return kRoundIsMul[r]; }
  __device__ __forceinline__ static uint2 instr(int i) { return __ldg(&kInstr[i]); }
};

}  // namespace sched_g1_ladder
}  // namespace kt
