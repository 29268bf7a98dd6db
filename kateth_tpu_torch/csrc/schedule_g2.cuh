// Round schedule of the team kernel g2_ladder: generated by
// kateth_tpu_torch/team_schedule.py, which documents the format.
// Do not edit; rerun the generator.
//
// g2_step: 27 rounds, 4 of them products (60 Fp products, at most 18 a round)

#pragma once

#include <cstdint>

#include "team.cuh"

namespace kt {
namespace sched_g2_ladder {

constexpr int kSlots = 62;
constexpr int kTeamThreads = 32;
constexpr int kPrograms = 1;
constexpr int kRounds = 27;
// the Fp products of each program
constexpr int kProgramProducts[1] = {60};
// the product rounds of each program
constexpr int kProgramProductRounds[1] = {4};
// the programs by name
constexpr int kProg_g2_step = 0;
// the named input slots [0, kInputs): constants, the step's state, operands
constexpr int kInputs = 14;
constexpr int kSlot_zero = 0;
constexpr int kSlot_one = 1;
constexpr int kSlot_x_0 = 2;
constexpr int kSlot_x_1 = 3;
constexpr int kSlot_y_0 = 4;
constexpr int kSlot_y_1 = 5;
constexpr int kSlot_z_0 = 6;
constexpr int kSlot_z_1 = 7;
constexpr int kSlot_bx_0 = 8;
constexpr int kSlot_bx_1 = 9;
constexpr int kSlot_by_0 = 10;
constexpr int kSlot_by_1 = 11;
constexpr int kSlot_bz_0 = 12;
constexpr int kSlot_bz_1 = 13;

// program p runs rounds [kProgram[p], kProgram[p + 1])
__constant__ uint16_t kProgram[2] = {0, 27};
// round r runs instructions [kRoundStart[r], kRoundStart[r + 1])
__constant__ uint16_t kRoundStart[28] = {
    0, 3, 15, 16, 18, 21, 29, 39, 45, 57, 60, 67, 73, 85, 97, 115, 117, 122, 127, 135, 149,
    161, 167, 185, 191, 203, 209, 215,
};
// 1: a product round
__constant__ uint8_t kRoundIsMul[27] = {
    0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0,
};
__device__ const uint2 kInstr[215] = {
    // round 0
    KT_INSTR(ADD, 14, 4, 5), KT_INSTR(ADD, 15, 6, 7), KT_INSTR(ADD, 16, 2, 3),
    // round 1
    KT_INSTR(MUL, 17, 4, 4), KT_INSTR(MUL, 18, 5, 5), KT_INSTR(MUL, 19, 14, 14),
    KT_INSTR(MUL, 20, 4, 6), KT_INSTR(MUL, 21, 5, 7), KT_INSTR(MUL, 22, 14, 15),
    KT_INSTR(MUL, 23, 6, 6), KT_INSTR(MUL, 24, 7, 7), KT_INSTR(MUL, 25, 15, 15),
    KT_INSTR(MUL, 26, 2, 4), KT_INSTR(MUL, 27, 3, 5), KT_INSTR(MUL, 28, 14, 16),
    // round 2
    KT_INSTR(ADD, 14, 23, 24),
    // round 3
    KT_INSTR(SUB, 15, 23, 24), KT_INSTR(SUB, 16, 25, 14),
    // round 4
    KT_INSTR(ADD, 14, 17, 18), KT_INSTR(SUB, 23, 15, 16), KT_INSTR(ADD, 24, 15, 16),
    // round 5
    KT_INSTR(SUB, 15, 17, 18), KT_INSTR(SUB, 16, 19, 14), KT_INSTR(ADD, 25, 20, 21),
    KT_INSTR(ADD, 29, 26, 27), KT_INSTR(SMALL, 30, 23, 12), KT_INSTR(SMALL, 31, 24, 12),
    KT_INSTR(SMALL, 32, 23, 36), KT_INSTR(SMALL, 33, 24, 36),
    // round 6
    KT_INSTR(SUB, 14, 20, 21), KT_INSTR(SUB, 17, 22, 25), KT_INSTR(SUB, 18, 26, 27),
    KT_INSTR(SUB, 19, 28, 29), KT_INSTR(SMALL, 23, 15, 8), KT_INSTR(SMALL, 24, 16, 8),
    KT_INSTR(SUB, 34, 15, 32), KT_INSTR(SUB, 35, 16, 33), KT_INSTR(ADD, 36, 15, 30),
    KT_INSTR(ADD, 37, 16, 31),
    // round 7
    KT_INSTR(ADD, 15, 30, 31), KT_INSTR(ADD, 16, 23, 24), KT_INSTR(ADD, 20, 14, 17),
    KT_INSTR(ADD, 21, 34, 35), KT_INSTR(ADD, 22, 36, 37), KT_INSTR(ADD, 25, 18, 19),
    // round 8
    KT_INSTR(MUL, 26, 30, 23), KT_INSTR(MUL, 27, 31, 24), KT_INSTR(MUL, 28, 15, 16),
    KT_INSTR(MUL, 29, 14, 23), KT_INSTR(MUL, 32, 17, 24), KT_INSTR(MUL, 33, 16, 20),
    KT_INSTR(MUL, 38, 34, 36), KT_INSTR(MUL, 39, 35, 37), KT_INSTR(MUL, 40, 21, 22),
    KT_INSTR(MUL, 41, 18, 34), KT_INSTR(MUL, 42, 19, 35), KT_INSTR(MUL, 43, 21, 25),
    // round 9
    KT_INSTR(ADD, 14, 26, 27), KT_INSTR(ADD, 15, 38, 39), KT_INSTR(ADD, 16, 41, 42),
    // round 10
    KT_INSTR(SUB, 17, 26, 27), KT_INSTR(SUB, 18, 28, 14), KT_INSTR(ADD, 19, 29, 32),
    KT_INSTR(SUB, 20, 38, 39), KT_INSTR(SUB, 21, 40, 15), KT_INSTR(SUB, 22, 41, 42),
    KT_INSTR(SUB, 23, 43, 16),
    // round 11
    KT_INSTR(SUB, 14, 29, 32), KT_INSTR(SUB, 15, 33, 19), KT_INSTR(ADD, 16, 22, 22),
    KT_INSTR(ADD, 24, 23, 23), KT_INSTR(ADD, 25, 17, 20), KT_INSTR(ADD, 26, 18, 21),
    // round 12
    KT_INSTR(ADD, 17, 16, 25), KT_INSTR(ADD, 18, 24, 26), KT_INSTR(ADD, 19, 8, 10),
    KT_INSTR(ADD, 20, 9, 11), KT_INSTR(ADD, 21, 14, 25), KT_INSTR(ADD, 22, 15, 26),
    KT_INSTR(ADD, 23, 10, 12), KT_INSTR(ADD, 27, 11, 13), KT_INSTR(ADD, 28, 14, 16),
    KT_INSTR(ADD, 29, 15, 24), KT_INSTR(ADD, 30, 8, 12), KT_INSTR(ADD, 31, 9, 13),
    // round 13
    KT_INSTR(ADD, 32, 16, 24), KT_INSTR(ADD, 33, 8, 9), KT_INSTR(ADD, 34, 25, 26),
    KT_INSTR(ADD, 35, 10, 11), KT_INSTR(ADD, 36, 14, 15), KT_INSTR(ADD, 37, 12, 13),
    KT_INSTR(ADD, 38, 17, 18), KT_INSTR(ADD, 39, 19, 20), KT_INSTR(ADD, 40, 21, 22),
    KT_INSTR(ADD, 41, 23, 27), KT_INSTR(ADD, 42, 28, 29), KT_INSTR(ADD, 43, 30, 31),
    // round 14
    KT_INSTR(MUL, 44, 8, 16), KT_INSTR(MUL, 45, 9, 24), KT_INSTR(MUL, 46, 32, 33),
    KT_INSTR(MUL, 47, 10, 25), KT_INSTR(MUL, 48, 11, 26), KT_INSTR(MUL, 49, 34, 35),
    KT_INSTR(MUL, 50, 12, 14), KT_INSTR(MUL, 51, 13, 15), KT_INSTR(MUL, 52, 36, 37),
    KT_INSTR(MUL, 53, 17, 19), KT_INSTR(MUL, 54, 18, 20), KT_INSTR(MUL, 55, 38, 39),
    KT_INSTR(MUL, 56, 21, 23), KT_INSTR(MUL, 57, 22, 27), KT_INSTR(MUL, 58, 40, 41),
    KT_INSTR(MUL, 59, 28, 30), KT_INSTR(MUL, 60, 29, 31), KT_INSTR(MUL, 61, 42, 43),
    // round 15
    KT_INSTR(ADD, 17, 44, 45), KT_INSTR(ADD, 18, 50, 51),
    // round 16
    KT_INSTR(SUB, 19, 44, 45), KT_INSTR(SUB, 20, 46, 17), KT_INSTR(SUB, 21, 50, 51),
    KT_INSTR(SUB, 22, 52, 18), KT_INSTR(ADD, 23, 59, 60),
    // round 17
    KT_INSTR(ADD, 17, 47, 48), KT_INSTR(SUB, 18, 59, 60), KT_INSTR(SUB, 27, 61, 23),
    KT_INSTR(ADD, 28, 19, 21), KT_INSTR(ADD, 29, 20, 22),
    // round 18
    KT_INSTR(SUB, 23, 47, 48), KT_INSTR(SUB, 30, 49, 17), KT_INSTR(ADD, 31, 53, 54),
    KT_INSTR(ADD, 32, 56, 57), KT_INSTR(SUB, 33, 18, 28), KT_INSTR(SUB, 34, 27, 29),
    KT_INSTR(SUB, 35, 21, 22), KT_INSTR(ADD, 36, 21, 22),
    // round 19
    KT_INSTR(SUB, 17, 53, 54), KT_INSTR(SUB, 18, 55, 31), KT_INSTR(SUB, 27, 56, 57),
    KT_INSTR(SUB, 28, 58, 32), KT_INSTR(ADD, 29, 19, 23), KT_INSTR(ADD, 37, 20, 30),
    KT_INSTR(ADD, 38, 23, 21), KT_INSTR(ADD, 39, 30, 22), KT_INSTR(ADD, 40, 19, 19),
    KT_INSTR(ADD, 41, 20, 20), KT_INSTR(SMALL, 42, 35, 12), KT_INSTR(SMALL, 43, 36, 12),
    KT_INSTR(SUB, 44, 33, 34), KT_INSTR(ADD, 45, 33, 34),
    // round 20
    KT_INSTR(SUB, 21, 17, 29), KT_INSTR(SUB, 22, 18, 37), KT_INSTR(SUB, 31, 27, 38),
    KT_INSTR(SUB, 32, 28, 39), KT_INSTR(ADD, 33, 19, 40), KT_INSTR(ADD, 34, 20, 41),
    KT_INSTR(ADD, 35, 23, 42), KT_INSTR(ADD, 36, 30, 43), KT_INSTR(SUB, 46, 23, 42),
    KT_INSTR(SUB, 47, 30, 43), KT_INSTR(SMALL, 48, 44, 12), KT_INSTR(SMALL, 49, 45, 12),
    // round 21
    KT_INSTR(ADD, 17, 31, 32), KT_INSTR(ADD, 18, 48, 49), KT_INSTR(ADD, 19, 21, 22),
    KT_INSTR(ADD, 20, 46, 47), KT_INSTR(ADD, 23, 33, 34), KT_INSTR(ADD, 27, 35, 36),
    // round 22
    KT_INSTR(MUL, 28, 31, 48), KT_INSTR(MUL, 29, 32, 49), KT_INSTR(MUL, 30, 17, 18),
    KT_INSTR(MUL, 37, 21, 46), KT_INSTR(MUL, 38, 22, 47), KT_INSTR(MUL, 39, 19, 20),
    KT_INSTR(MUL, 40, 33, 48), KT_INSTR(MUL, 41, 34, 49), KT_INSTR(MUL, 42, 18, 23),
    KT_INSTR(MUL, 43, 35, 46), KT_INSTR(MUL, 44, 36, 47), KT_INSTR(MUL, 45, 20, 27),
    KT_INSTR(MUL, 50, 21, 33), KT_INSTR(MUL, 51, 22, 34), KT_INSTR(MUL, 52, 19, 23),
    KT_INSTR(MUL, 53, 31, 35), KT_INSTR(MUL, 54, 32, 36), KT_INSTR(MUL, 55, 17, 27),
    // round 23
    KT_INSTR(ADD, 17, 28, 29), KT_INSTR(ADD, 18, 37, 38), KT_INSTR(ADD, 19, 40, 41),
    KT_INSTR(ADD, 20, 43, 44), KT_INSTR(ADD, 21, 50, 51), KT_INSTR(ADD, 22, 53, 54),
    // round 24
    KT_INSTR(SUB, 23, 28, 29), KT_INSTR(SUB, 27, 30, 17), KT_INSTR(SUB, 31, 37, 38),
    KT_INSTR(SUB, 32, 39, 18), KT_INSTR(SUB, 33, 40, 41), KT_INSTR(SUB, 34, 42, 19),
    KT_INSTR(SUB, 35, 43, 44), KT_INSTR(SUB, 36, 45, 20), KT_INSTR(SUB, 46, 50, 51),
    KT_INSTR(SUB, 47, 52, 21), KT_INSTR(SUB, 48, 53, 54), KT_INSTR(SUB, 49, 55, 22),
    // round 25
    KT_INSTR(SUB, 17, 31, 23), KT_INSTR(SUB, 18, 32, 27), KT_INSTR(ADD, 19, 33, 35),
    KT_INSTR(ADD, 20, 34, 36), KT_INSTR(ADD, 21, 46, 48), KT_INSTR(ADD, 22, 47, 49),
    // round 26
    KT_INSTR(SEL, 2, 17, 16), KT_INSTR(SEL, 3, 18, 24), KT_INSTR(SEL, 4, 19, 25),
    KT_INSTR(SEL, 5, 20, 26), KT_INSTR(SEL, 6, 21, 14), KT_INSTR(SEL, 7, 22, 15),
};

// what run_program (team.cuh) reads
struct Sched {
  static constexpr int kTeam = kTeamThreads;
  __device__ __forceinline__ static int program(int p) { return kProgram[p]; }
  __device__ __forceinline__ static int round_start(int r) { return kRoundStart[r]; }
  __device__ __forceinline__ static bool round_is_mul(int r) { return kRoundIsMul[r]; }
  __device__ __forceinline__ static uint2 instr(int i) { return __ldg(&kInstr[i]); }
};

}  // namespace sched_g2_ladder
}  // namespace kt
