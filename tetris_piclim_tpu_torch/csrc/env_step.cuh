// One Tetris-piclim env step for one env, held in one thread's registers.
//
// Replaces env_step_once (tetris_piclim_tpu/ops/pallas_rollout.py:71), the
// step body shared by both Pallas kernels. The TPU version reads its piece
// tables through one-hot matmuls because Mosaic has no gather; here each
// thread reads them from a small table in shared memory (tab, below), and
// the board is 10 column words in registers.
//
// Semantics are those of bitboard.step in the port (ops/bitboard.py) plus the
// bank auto-reset: rotation by floor-mod, location clipped to [0, 10 - w],
// current piece read at min(cursor, P - 1). The rollout and actor kernels
// are held word for word against that plain version.
//
// Bound: per env step a few hundred integer instructions on ~60 bytes of
// state; with the state in registers for the K steps of a launch the step is
// bound by instruction latency, not by memory.
#pragma once

#include <stdint.h>

namespace tetris {

constexpr int kH = 20;
constexpr int kW = 10;
// tab layout (int32), built by ops/bitboard.py::kernel_tables: for each of
// the 28 (piece * 4 + rot) rows colmask[4], rtopo[4], width, height; then
// nrot[7].
constexpr int kTabRow = 10;
constexpr int kTabNrot = 28 * kTabRow;
constexpr int kTabN = kTabNrot + 7;

enum : int { kRunning = 0, kWin = 1, kLoss = 2 };

struct EnvState {
  uint32_t cols[kW];
  int cursor, lines, moves, status, lg, ml;
  int prow;  // -1: the env's own piece row; else the bank row it reset to
};

struct StepInfo {
  int done, won, lines_delta;
  // after-state of the step, before the auto-reset (the replay's s')
  int pre_cursor, pre_lines, pre_moves, pre_status, pre_cur, pre_nxt;
};

__device__ __forceinline__ int ctz20(uint32_t x) {
  return x ? __ffs((int)x) - 1 : kH;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ const int8_t* piece_row(
    const EnvState& s, const int8_t* own, const int8_t* bank_pieces, int P) {
  return s.prow < 0 ? own : bank_pieces + (size_t)s.prow * P;
}

__device__ __forceinline__ void load_state(
    EnvState& s, int e, const int* cols, const int* cursor, const int* lines,
    const int* moves, const int8_t* status, const int* lg, const int* ml) {
#pragma unroll
  for (int j = 0; j < kW; ++j) s.cols[j] = (uint32_t)cols[(size_t)e * kW + j];
  s.cursor = cursor[e];
  s.lines = lines[e];
  s.moves = moves[e];
  s.status = status[e];
  s.lg = lg[e];
  s.ml = ml[e];
  s.prow = -1;
}

__device__ __forceinline__ void store_state(
    const EnvState& s, int e, int P, const int8_t* own,
    const int8_t* bank_pieces, int* cols, int8_t* pieces, int* cursor,
    int* lines, int* moves, int8_t* status) {
#pragma unroll
  for (int j = 0; j < kW; ++j) cols[(size_t)e * kW + j] = (int)s.cols[j];
  const int8_t* src = piece_row(s, own, bank_pieces, P);
  for (int i = 0; i < P; ++i) pieces[(size_t)e * P + i] = src[i];
  cursor[e] = s.cursor;
  lines[e] = s.lines;
  moves[e] = s.moves;
  status[e] = (int8_t)s.status;
}

// One step with action (rot_raw, loc_raw), then, if the episode ended, a
// reset to bank row reset_idx. `own` is the env's initial piece row. When
// pre_cols is not null the after-state columns (before the reset) are
// written there.
__device__ __forceinline__ StepInfo env_step(
    EnvState& s, int rot_raw, int loc_raw, int reset_idx, const int8_t* own,
    const int* bank_cols, const int8_t* bank_pieces, int P, const int* tab,
    int* pre_cols) {
  const int8_t* seq = piece_row(s, own, bank_pieces, P);
  const int piece = seq[clampi(s.cursor, 0, P - 1)];
  const int nrot = tab[kTabNrot + piece];
  int r = rot_raw % nrot;
  if (r < 0) r += nrot;  // floor-mod, as torch.remainder / jnp.mod
  const int* pt = tab + (piece * 4 + r) * kTabRow;
  const int w = pt[8];
  const int h = pt[9];
  const int loc = clampi(loc_raw, 0, kW - w);

  int drop = 1 << 20;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const int c = j - loc;
    if (c >= 0 && c < w) {
      const int d = ctz20(s.cols[j]) - pt[4 + c];
      drop = d < drop ? d : drop;
    }
  }
  drop -= 1;
  const bool topout = drop < 0;
  const int dc = topout ? 0 : drop;

  uint32_t board[kW];
  uint32_t full = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const int c = j - loc;
    const uint32_t m = (c >= 0 && c < w) ? (uint32_t)pt[c] : 0u;
    board[j] = s.cols[j] | (m << dc);
    full &= board[j];
  }
  uint32_t cm = full & (((1u << h) - 1u) << dc);
  const int k = __popc(cm);
  // delete-and-shift each cleared row, topmost (lowest bit) first
  while (cm) {
    const uint32_t lsb = cm & (~cm + 1u);
    const uint32_t low = lsb - 1u;
    const uint32_t keep_hi = ~((lsb << 1) - 1u);
#pragma unroll
    for (int j = 0; j < kW; ++j)
      board[j] = ((board[j] & low) << 1) | (board[j] & keep_hi);
    cm &= cm - 1u;
  }

  const int moves_n = s.moves + 1;
  const int lines_n = s.lines + k;
  const int st_nc = moves_n >= s.ml ? kLoss : s.status;
  const int st_c = lines_n >= s.lg ? kWin : st_nc;
  const int status_n = topout ? kLoss : (k > 0 ? st_c : st_nc);

  if (!topout) {
#pragma unroll
    for (int j = 0; j < kW; ++j) s.cols[j] = board[j];
    s.lines = lines_n;
    s.moves = moves_n;
  }
  s.cursor += 1;
  s.status = status_n;

  StepInfo info;
  info.done = status_n != kRunning;
  info.won = status_n == kWin;
  info.lines_delta = topout ? 0 : k;
  info.pre_cursor = s.cursor;
  info.pre_lines = s.lines;
  info.pre_moves = s.moves;
  info.pre_status = s.status;
  info.pre_cur = seq[clampi(s.cursor, 0, P - 1)];
  info.pre_nxt = seq[clampi(s.cursor + 1, 0, P - 1)];
  if (pre_cols) {
#pragma unroll
    for (int j = 0; j < kW; ++j) pre_cols[j] = (int)s.cols[j];
  }

  if (info.done) {
#pragma unroll
    for (int j = 0; j < kW; ++j)
      s.cols[j] = (uint32_t)bank_cols[(size_t)reset_idx * kW + j];
    s.prow = reset_idx;
    s.cursor = 0;
    s.lines = 0;
    s.moves = 0;
    s.status = kRunning;
  }
  return info;
}

// Philox-4x32-10 (Salmon et al., SC'11): four 32-bit words from a 128-bit
// counter and a 64-bit key. The kernels count (env, step, 0, 0) under the
// key (seed, 0): the draws of an env do not depend on the block size.
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

// block-wide integer sums of two per-thread values into out[0], out[1]
__device__ __forceinline__ void add_block_counts(int a, int b, int* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, off);
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (a) atomicAdd(out, a);
    if (b) atomicAdd(out + 1, b);
  }
}

}  // namespace tetris
