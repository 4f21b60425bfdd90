// One Tetris-piclim env step, with one env split over L lanes of a warp.
//
// Replaces env_step_once (tetris_piclim_tpu/ops/pallas_rollout.py:71), the
// step body shared by both Pallas kernels. The TPU version reads its piece
// tables through one-hot matmuls because Mosaic has no gather; here a group
// of L neighbouring lanes (L = 2, 4, 8 or 16, a compile-time constant) owns
// one env: lane g holds the C = ceil(10 / L) board columns C*g .. C*g+C-1 in
// registers and a copy of the env's scalars (cursor, lines, moves, status).
//
// Bound: a step is about two hundred integer instructions on ~60 bytes of
// state, and the state never leaves the registers during a launch, so the
// step is bound by instructions, not by bytes: with few lanes per env by the
// latency of one dependent chain per env, with many by the INT32 pipe (64
// lanes per clock per SM), because every lane repeats the scalar part of
// the step. What the design does about it:
//   * the lane split shortens the chain: the column work of the lanes runs
//     side by side, the drop height is a min and the full-row mask an AND
//     over the group (log2 L xor-shuffles), and the row-clear loop is
//     uniform over the group; L is the caller's choice (2 in the rollout, 8
//     in the actor, whose 256 threads own 32 envs);
//   * nothing on the chain waits for memory. What the next step needs is
//     known before this step's outcome, up to one bit (did the episode
//     end?): the next action, the piece after the current one, and the first
//     piece and the columns of the bank row a reset would go to. The callers
//     load both candidates ahead of the step and select at its end, so
//     a reset is a handful of selects: no copy, no branch. An env's pieces
//     stay where they are in device memory (its own row, or the bank row it
//     last reset to); the piece table is one 8-byte shared-memory word per
//     (piece, rotation);
//   * the rotation is `rot & 3` looked up in a table that already holds the
//     row of rot mod nrot (nrot is 1, 2 or 4), so there is no division;
//   * Philox is computed once per L steps: lane g draws for step k0 + g and
//     each step takes its packed draw by one shuffle. The counter stays
//     (env, step, 0, 0) and the key (seed, 0), so the draws do not depend on
//     L or on the block size.
//
// Budget: per lane C column words, 6 scalars, the piece-row pointer, C
// prefetched bank words, two table words and two draw words in registers
// (ptxas counts 56 registers for the rollout kernel at L = 2 and 180 for the
// actor kernel with its MLP; no spills); 256 bytes of shared memory per
// block for the table.
//
// Semantics are those of bitboard.step in the port (ops/bitboard.py) plus the
// bank auto-reset: rotation by floor-mod, location clipped to [0, 10 - w],
// current piece read at min(cursor, P - 1). Both kernels are held word for
// word against that plain version.
#pragma once

#include <stdint.h>

namespace tetris {

constexpr int kH = 20;
constexpr int kW = 10;
// Table layout (int32 pairs), built by ops/bitboard.py::kernel_tables: entry
// piece * 4 + (rot & 3) describes rotation rot mod nrot[piece]:
//   x: bits 4c..4c+3   the 4-row cell mask of piece column c (0 beyond w)
//      bits 16+4c..    rtopo of piece column c
//   y: bits 0..2 width w, bits 4..7 the row span (1 << h) - 1
constexpr int kTabEntries = 28;
constexpr int kTabWords = 2 * kTabEntries;
constexpr int kTabBytes = 256;  // shared-memory room for the table, padded
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

enum : int { kRunning = 0, kWin = 1, kLoss = 2 };

template <int L>
struct LaneEnv {
  static_assert(L == 2 || L == 4 || L == 8 || L == 16, "lanes per env");
  static constexpr int C = (kW + L - 1) / L;  // columns per lane
  uint32_t col[C];  // columns C*g + i; 0 where that is beyond the board
  int cursor, lines, moves, status, lg, ml;  // the same in every lane
};

struct StepOut {
  int done, won, lines_delta;
};

// One step's draws as the kernels pass them between lanes: act packs the
// rotation (bits 0-1), the column (bits 2-5) and the bank row (bits 6-21);
// ubits is the float32 pattern of the explore draw (the actor only).
struct Draw {
  uint32_t act, ubits;
};

__device__ __forceinline__ int ctz20(uint32_t x) {
  return __ffs((int)(x | (1u << kH))) - 1;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// rot enters the step only as rot & 3 (floor-mod by nrot = 1, 2 or 4 follows
// in the table) and loc only clipped to [0, 10 - w] with w >= 1, so packing
// them into 2 and 4 bits loses nothing.
__device__ __forceinline__ uint32_t pack_action(int rot, int loc, int idx) {
  return (uint32_t)(rot & 3) | ((uint32_t)clampi(loc, 0, kW - 1) << 2) |
         ((uint32_t)idx << 6);
}

__device__ __forceinline__ int action_bank_row(uint32_t act) {
  return (int)(act >> 6);
}

// Philox-4x32-10 (Salmon et al., SC'11): four 32-bit words from a 128-bit
// counter and a 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// uniform int in [0, n) by multiply-shift (bias below n / 2^32)
__device__ __forceinline__ int uniform_int(uint32_t bits, int n) {
  return (int)(((unsigned long long)bits * (unsigned)n) >> 32);
}

// uniform float in [0, 1) from the top 24 bits
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// The draws of (env, step) under `seed`: the kernels' contract, reproduced
// in plain PyTorch by ops/rollout.py::philox_draws. Word x gives the explore
// draw, y the rotation in [0, 4), z the column in [0, 10), w the bank row.
__device__ __forceinline__ Draw philox_draw(uint32_t env, uint32_t step,
                                            uint32_t seed, int bank) {
  const uint4 b = philox4x32_10(make_uint4(env, step, 0u, 0u), seed, 0u);
  Draw d;
  d.act = pack_action(uniform_int(b.y, 4), uniform_int(b.z, kW),
                      uniform_int(b.w, bank));
  d.ubits = __float_as_uint(uniform01(b.x));
  return d;
}

// Copy the piece table into shared memory (call before a block barrier).
__device__ __forceinline__ void load_table(uint2* tab, const int* tables) {
  int* words = reinterpret_cast<int*>(tab);
  for (int i = threadIdx.x; i < kTabWords; i += blockDim.x) words[i] = tables[i];
}

// Load env e into its group's registers. A group beyond the batch (`live`
// false) holds zeros and steps harmlessly.
template <int L>
__device__ __forceinline__ void load_lanes(
    LaneEnv<L>& s, int g, bool live, int e, const int* cols,
    const int* cursor, const int* lines, const int* moves,
    const int8_t* status, const int* lg, const int* ml) {
  constexpr int C = LaneEnv<L>::C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = C * g + i;
    s.col[i] = (live && j < kW) ? (uint32_t)cols[(size_t)e * kW + j] : 0u;
  }
  s.cursor = live ? cursor[e] : 0;
  s.lines = live ? lines[e] : 0;
  s.moves = live ? moves[e] : 0;
  s.status = live ? (int)status[e] : 0;
  s.lg = live ? lg[e] : 0;
  s.ml = live ? ml[e] : 0;
}

// `seq` is the env's current piece row: its own, or a bank row.
template <int L>
__device__ __forceinline__ void store_lanes(
    const LaneEnv<L>& s, int g, bool live, int e, int P, const int8_t* seq,
    int* cols, int8_t* pieces, int* cursor, int* lines, int* moves,
    int8_t* status) {
  constexpr int C = LaneEnv<L>::C;
  if (!live) return;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = C * g + i;
    if (j < kW) cols[(size_t)e * kW + j] = (int)s.col[i];
  }
  for (int q = g; q < P; q += L) pieces[(size_t)e * P + q] = seq[q];
  if (g == 0) {
    cursor[e] = s.cursor;
    lines[e] = s.lines;
    moves[e] = s.moves;
    status[e] = (int8_t)s.status;
  }
}

// The piece at position `at` of a row, clipped into the sequence.
__device__ __forceinline__ int piece_at(const int8_t* seq, int at, int P) {
  return __ldg(seq + clampi(at, 0, P - 1));
}

// The table entry of `piece` under the action's rotation.
__device__ __forceinline__ uint2 table_entry(const uint2* tab, int piece,
                                             uint32_t act) {
  return tab[piece * 4 + (int)(act & 3u)];
}

// This lane's columns of bank row idx: fetched at the start of a step so a
// reset at its end waits for nothing.
template <int L>
__device__ __forceinline__ void prefetch_bank(
    uint32_t (&fresh)[LaneEnv<L>::C], int g, int idx, const int* bank_cols) {
  constexpr int C = LaneEnv<L>::C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = C * g + i;
    fresh[i] = j < kW ? (uint32_t)__ldg(bank_cols + (idx * kW + j)) : 0u;
  }
}

// One step with the packed action `act`, whose table entry (current piece,
// act's rotation) is `t`; the state afterwards is the after-state (the
// replay's s'), not yet reset. All 32 lanes of the warp must call this
// together (the group reductions are full-warp shuffles whose xor offsets
// stay inside each group).
template <int L>
__device__ __forceinline__ StepOut step_lanes(LaneEnv<L>& s, int g,
                                              uint32_t act, uint2 t) {
  constexpr int C = LaneEnv<L>::C;
  const int j0 = C * g;
  const uint32_t mword = t.x & 0xFFFFu;
  const uint32_t rword = t.x >> 16;
  const int w = (int)(t.y & 7u);
  const int loc = min((int)((act >> 2) & 15u), kW - w);

  // piece column c = j - loc sits in nibble c of mword / rword; a column
  // outside the piece reads nibble 7, which is 0 in both
  const int sh0 = 4 * (j0 - loc);
  uint32_t m[C];
  int drop = 1 << 20;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint32_t sh = min((uint32_t)(sh0 + 4 * i), 28u);
    m[i] = (mword >> sh) & 15u;
    const int d = ctz20(s.col[i]) - (int)((rword >> sh) & 15u);
    drop = m[i] ? min(drop, d) : drop;
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1)
    drop = min(drop, __shfl_xor_sync(kAllLanes, drop, off));
  drop -= 1;
  const bool topout = drop < 0;
  const int dc = topout ? 0 : drop;

  uint32_t board[C];
  uint32_t full = kAllLanes;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    board[i] = s.col[i] | (m[i] << dc);
    full &= board[i] | (j0 + i < kW ? 0u : kAllLanes);  // beyond the board: full
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1)
    full &= __shfl_xor_sync(kAllLanes, full, off);
  uint32_t cm = full & (((t.y >> 4) & 15u) << dc);
  const int k = __popc(cm);
  // delete-and-shift each cleared row, topmost (lowest bit) first; cm is the
  // same in every lane of the group
  while (cm) {
    const uint32_t lsb = cm & (~cm + 1u);
    const uint32_t low = lsb - 1u;
    const uint32_t keep_hi = ~((lsb << 1) - 1u);
#pragma unroll
    for (int i = 0; i < C; ++i)
      board[i] = ((board[i] & low) << 1) | (board[i] & keep_hi);
    cm &= cm - 1u;
  }

  const int moves_n = s.moves + 1;
  const int lines_n = s.lines + k;
  const int st_nc = moves_n >= s.ml ? kLoss : s.status;
  const int st_c = lines_n >= s.lg ? kWin : st_nc;
  const int status_n = topout ? kLoss : (k > 0 ? st_c : st_nc);

  if (!topout) {
#pragma unroll
    for (int i = 0; i < C; ++i) s.col[i] = board[i];
    s.lines = lines_n;
    s.moves = moves_n;
  }
  s.cursor += 1;
  s.status = status_n;

  StepOut out;
  out.done = status_n != kRunning;
  out.won = status_n == kWin;
  out.lines_delta = topout ? 0 : k;
  return out;
}

// If the episode ended, restart the env from a bank row whose columns are
// `fresh` (prefetch_bank): selects only.
template <int L>
__device__ __forceinline__ void reset_lanes(
    LaneEnv<L>& s, bool done, const uint32_t (&fresh)[LaneEnv<L>::C]) {
  constexpr int C = LaneEnv<L>::C;
#pragma unroll
  for (int i = 0; i < C; ++i) s.col[i] = done ? fresh[i] : s.col[i];
  s.cursor = done ? 0 : s.cursor;
  s.lines = done ? 0 : s.lines;
  s.moves = done ? 0 : s.moves;
  s.status = done ? (int)kRunning : s.status;
}

// block-wide integer sums of two per-thread values into out[0], out[1]
__device__ __forceinline__ void add_block_counts(int a, int b, int* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kAllLanes, a, off);
    b += __shfl_down_sync(kAllLanes, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (a) atomicAdd(out, a);
    if (b) atomicAdd(out + 1, b);
  }
}

}  // namespace tetris
