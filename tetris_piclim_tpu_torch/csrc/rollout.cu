// K fused env steps per launch, random policy or scripted actions.
//
// Replaces rollout_fused / _kernel (tetris_piclim_tpu/ops/pallas_rollout.py:
// 204-415). The TPU kernel keeps a 1024-env tile in VMEM across K steps; here
// one thread owns one env and keeps its state in registers across the K
// steps, so device memory sees one state load and one store per env per
// launch. Actions come from scripted [K, N] streams or from Philox keyed on
// (seed, env, step). Per-block episode and win counts go to out_stats by
// atomics (blocks run in no fixed order; integer sums do not care).
//
// Bound (H100): instruction latency of the step, not bytes: ~100 bytes of
// state per env per launch against K steps of a few hundred integer
// operations each; PERF.md lists the measured time beside that bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_step.cuh"

namespace {

constexpr int kBlock = 64;

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
  __shared__ int tab[tetris::kTabN];
  for (int i = threadIdx.x; i < tetris::kTabN; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  int episodes = 0, wins = 0;
  if (e < n) {
    tetris::EnvState s;
    tetris::load_state(s, e, cols, cursor, lines, moves, status, lg, ml);
    const int8_t* own = pieces + (size_t)e * P;
    for (int k = 0; k < n_steps; ++k) {
      int rot, loc, idx;
      if (rots) {
        const size_t o = (size_t)k * n + e;
        rot = rots[o];
        loc = locs[o];
        idx = idxs[o];
      } else {
        const uint4 b = tetris::philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)k, 0u, 0u), seed, 0u);
        rot = tetris::uniform_int(b.y, 4);
        loc = tetris::uniform_int(b.z, tetris::kW);
        idx = tetris::uniform_int(b.w, bank);
      }
      const tetris::StepInfo info = tetris::env_step(
          s, rot, loc, idx, own, bank_cols, bank_pieces, P, tab, nullptr);
      episodes += info.done;
      wins += info.won;
    }
    tetris::store_state(s, e, P, own, bank_pieces, out_cols, out_pieces,
                        out_cursor, out_lines, out_moves, out_status);
  }
  tetris::add_block_counts(episodes, wins, out_stats);
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
  const int grid = (n + kBlock - 1) / kBlock;
  rollout_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      cols, pieces, cursor, lines, moves, status, lg, ml, bank_cols,
      bank_pieces, bank, n, P, n_steps, rots, locs, idxs, seed, tables,
      out_cols, out_pieces, out_cursor, out_lines, out_moves, out_status,
      out_stats);
  return (int)cudaGetLastError();
}
