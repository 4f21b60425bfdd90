// K fused env steps per launch, random policy or scripted actions.
//
// Replaces rollout_fused / _kernel (tetris_piclim_tpu/ops/pallas_rollout.py:
// 204-415). The TPU kernel keeps a 1024-env tile in VMEM across K steps; here
// an env's state stays in the registers of a group of kLanes neighbouring
// lanes for the K steps (the lane-split step of env_step.cuh), so device
// memory sees one state load and one store per env per launch.
//
// Bound (H100): not bytes (~100 bytes of state per env per launch against K
// steps of a few hundred integer instructions) but instructions: the batch
// is fixed at N envs (8192 at the benchmark shape), 62 dependent chains per
// SM. One lane per env leaves most schedulers empty and each chain pays the
// full latency of every instruction; many lanes per env fill the schedulers
// but repeat the step's scalar part in every lane, and the INT32 pipe (64
// lanes per clock per SM) becomes the limit. What the design does about it:
// each env is split over kLanes lanes, which shortens the chain (the column
// work runs side by side, reduced by shuffles); the chain waits
// for no device memory, because step k + 1's action, both candidates for
// its piece (the next one of the row, or the first of the bank row a reset
// goes to) and the reset row's columns are loaded at the end of step k - 1
// and selected at the end of step k (loop-carried, so the loads have a
// whole step to arrive); Philox runs once per kLanes steps in the lanes of
// the group, each step taking its packed draw by one shuffle. kLanes was
// picked by time on the card among 2, 4, 8 and 16 (tools/rollout_lanes.py;
// PERF.md has the times): 2 and 4 tie, 8 and 16 are bound by the INT32 pipe.
//
// Budget: 128 threads per block; 256 bytes of shared memory (the piece
// table); 56 registers at 2 lanes per env (ptxas -v, in the build log), no
// spills.
//
// Actions come from scripted [K, N] streams or from Philox keyed on
// (seed, env, step). Per-block episode and win counts go to out_stats by
// atomics (blocks run in no fixed order; integer sums do not care).
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_step.cuh"

#ifndef TETRIS_ROLLOUT_LANES
#define TETRIS_ROLLOUT_LANES 2
#endif

namespace {

constexpr int kLanes = TETRIS_ROLLOUT_LANES;
constexpr int kBlock = 128;
constexpr int kEnvsPerBlock = kBlock / kLanes;

template <int L>
__global__ void __launch_bounds__(kBlock) rollout_kernel(
    const int* __restrict__ cols, const int8_t* __restrict__ pieces,
    const int* __restrict__ cursor, const int* __restrict__ lines,
    const int* __restrict__ moves, const int8_t* __restrict__ status,
    const int* __restrict__ lg, const int* __restrict__ ml,
    const int* __restrict__ bank_cols, const int8_t* __restrict__ bank_pieces,
    int bank, int n, int P, int n_steps, const int* __restrict__ rots,
    const int* __restrict__ locs, const int* __restrict__ idxs,
    uint32_t seed, const int* __restrict__ tables, int* out_cols,
    int8_t* out_pieces, int* out_cursor, int* out_lines, int* out_moves,
    int8_t* out_status, int* out_stats) {
  __shared__ uint2 tab[tetris::kTabBytes / sizeof(uint2)];
  const int slot = threadIdx.x / L;  // the env's place in the block
  const int g = threadIdx.x % L;     // this lane's place in the env's group

  tetris::load_table(tab, tables);
  const int e = blockIdx.x * (kBlock / L) + slot;
  const bool live = e < n;
  tetris::LaneEnv<L> s;
  tetris::load_lanes<L>(s, g, live, e, cols, cursor, lines, moves, status, lg, ml);
  const int8_t* seq = pieces + (size_t)(live ? e : 0) * P;  // current piece row
  __syncthreads();

  // lane g holds the packed action of one step of the current round of L
  auto draw = [&](int step) -> uint32_t {
    if (step >= n_steps) return 0u;
    if (!rots)
      return tetris::philox_draw((uint32_t)e, (uint32_t)step, seed, bank).act;
    if (!live) return 0u;
    const size_t o = (size_t)step * n + e;
    return tetris::pack_action(rots[o], locs[o], idxs[o]);
  };
  // What the step after the current one needs from device memory, for both
  // outcomes of the current step: loaded one step ahead of its use.
  struct Ahead {
    const int8_t* row;  // the bank row a reset goes to
    int p_stay, p_fresh;
    uint32_t fresh[tetris::LaneEnv<L>::C];
  } ah;
  auto look_ahead = [&](uint32_t act) {
    const int idx = tetris::action_bank_row(act);
    ah.row = bank_pieces + idx * P;
    ah.p_fresh = __ldg(ah.row);
    ah.p_stay = tetris::piece_at(seq, s.cursor + 1, P);
    tetris::prefetch_bank<L>(ah.fresh, g, idx, bank_cols);
  };
  uint32_t my_act = draw(g);
  uint32_t act = __shfl_sync(tetris::kAllLanes, my_act, 0, L);
  int piece = tetris::piece_at(seq, s.cursor, P);
  look_ahead(act);

  int episodes = 0, wins = 0;
#pragma unroll 1
  for (int k = 0; k < n_steps; ++k) {
    const int kn = k + 1;
    if (kn % L == 0) my_act = draw(kn + g);
    const uint32_t act_n = __shfl_sync(tetris::kAllLanes, my_act, kn % L, L);

    const tetris::StepOut out = tetris::step_lanes<L>(
        s, g, act, tetris::table_entry(tab, piece, act));
    const bool done = out.done != 0;
    tetris::reset_lanes<L>(s, done, ah.fresh);
    seq = done ? ah.row : seq;
    piece = done ? ah.p_fresh : ah.p_stay;
    episodes += out.done;
    wins += out.won;
    act = act_n;
    look_ahead(act);
  }
  tetris::store_lanes<L>(s, g, live, e, P, seq, out_cols, out_pieces,
                         out_cursor, out_lines, out_moves, out_status);
  const bool counts = live && g == 0;
  tetris::add_block_counts(counts ? episodes : 0, counts ? wins : 0, out_stats);
}

}  // namespace

extern "C" int rollout_launch(
    const int* cols, const int8_t* pieces, const int* cursor,
    const int* lines, const int* moves, const int8_t* status, const int* lg,
    const int* ml, const int* bank_cols, const int8_t* bank_pieces, int bank,
    int n, int P, int n_steps, const int* rots, const int* locs,
    const int* idxs, uint32_t seed, const int* tables, int* out_cols,
    int8_t* out_pieces, int* out_cursor, int* out_lines, int* out_moves,
    int8_t* out_status, int* out_stats, void* stream) {
  const int grid = (n + kEnvsPerBlock - 1) / kEnvsPerBlock;
  rollout_kernel<kLanes><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      cols, pieces, cursor, lines, moves, status, lg, ml, bank_cols,
      bank_pieces, bank, n, P, n_steps, rots, locs, idxs, seed, tables,
      out_cols, out_pieces, out_cursor, out_lines, out_moves, out_status,
      out_stats);
  return (int)cudaGetLastError();
}
