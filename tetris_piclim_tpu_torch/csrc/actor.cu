// Fused DQN actor: K steps of observation -> 217-128-128-128-128-head f32
// MLP -> epsilon-greedy -> env step -> bank auto-reset -> transition record.
//
// Replaces actor_rollout_fused / _kernel / _argmin_lane
// (tetris_piclim_tpu/ops/pallas_actor.py:86-404). The TPU kernel holds the
// ~315 KB of f32 weights in VMEM; that is more than a Hopper block's 227 KB
// of shared memory. Here one block of 128 threads owns a tile of 32 envs:
// the env state stays in the registers of threads 0..31 for the K steps, the
// observation and hidden activations of the tile live in shared memory, and
// each thread computes one output unit for all 32 envs, reading its column
// of the [in, out] weights (coalesced across the warp, L2-resident) once per
// layer. Sums run in fixed k order with fmaf, in true f32 (no TF32, no
// tensor cores in this version).
//
// Bound (H100): the MLP's FLOPs, 2 * (217*128 + 3*128*128 + 128*head) per
// env step, against the f32 peak; PERF.md lists the measured time beside it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_step.cuh"

namespace {

constexpr int kTile = 32;      // envs per block
constexpr int kThreads = 128;  // one per hidden unit
constexpr int kHid = 128;
constexpr int kObs = 217;
constexpr int kObsPad = 220;   // float4 rows; w1 is zero-padded to 220 rows
constexpr int kHeadMax = 40;
constexpr int kStage = 16;     // staged ints per env: cols[10], cur, nxt, ll, ml, status
constexpr int kTabPad = 288;
constexpr size_t kSmemBytes =
    sizeof(int) * (kTabPad + kTile * kStage) +
    sizeof(float) * (kTile * kObsPad + 2 * kTile * kHid + kTile * kHeadMax);

// out[e, j] = act(sum_k in[e, k] * W[k, j] + b[j]) for the tile's envs;
// thread j computes unit j, k ascending.
template <int IN, int OUT_STRIDE, bool RELU>
__device__ __forceinline__ void dense(const float* in,
                                      const float* __restrict__ W,
                                      const float* __restrict__ b,
                                      int out_dim, float* out) {
  const int j = threadIdx.x;
  if (j >= out_dim) return;
  float acc[kTile];
#pragma unroll
  for (int e = 0; e < kTile; ++e) acc[e] = 0.f;
  for (int k = 0; k < IN; k += 4) {
    const float w0 = __ldg(W + (size_t)(k + 0) * out_dim + j);
    const float w1 = __ldg(W + (size_t)(k + 1) * out_dim + j);
    const float w2 = __ldg(W + (size_t)(k + 2) * out_dim + j);
    const float w3 = __ldg(W + (size_t)(k + 3) * out_dim + j);
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      const float4 x = *reinterpret_cast<const float4*>(in + e * IN + k);
      acc[e] = fmaf(x.x, w0, acc[e]);
      acc[e] = fmaf(x.y, w1, acc[e]);
      acc[e] = fmaf(x.z, w2, acc[e]);
      acc[e] = fmaf(x.w, w3, acc[e]);
    }
  }
  const float bj = b[j];
#pragma unroll
  for (int e = 0; e < kTile; ++e) {
    const float v = acc[e] + bj;
    out[e * OUT_STRIDE + j] = RELU ? fmaxf(v, 0.f) : v;
  }
}

// first index of the maximum (jnp.argmax / torch.argmax tie-break)
__device__ __forceinline__ int argmax_first(const float* v, int n) {
  int best = 0;
  float m = v[0];
  for (int i = 1; i < n; ++i) {
    if (v[i] > m) {
      m = v[i];
      best = i;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads) actor_kernel(
    const int* __restrict__ cols, const int8_t* __restrict__ pieces,
    const int* __restrict__ cursor, const int* __restrict__ lines,
    const int* __restrict__ moves, const int8_t* __restrict__ status,
    const int* __restrict__ lg, const int* __restrict__ ml,
    const int* __restrict__ bank_cols, const int8_t* __restrict__ bank_pieces,
    int bank, int n, int P, int n_steps, int head,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3,
    const float* __restrict__ w4, const float* __restrict__ b4,
    const float* __restrict__ w5, const float* __restrict__ b5,
    int global_step, float eps_start, float eps_end, float eps_decay,
    uint32_t seed, const float* __restrict__ explore_u,
    const int* __restrict__ rand_rot, const int* __restrict__ rand_col,
    const int* __restrict__ reset_idx, const int* __restrict__ tables,
    int* out_cols, int8_t* out_pieces, int* out_cursor, int* out_lines,
    int* out_moves, int8_t* out_status, int* out_stats, int* t_cols,
    int* t_ncols, int* t_int, float* q_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  int* st = tab + kTabPad;
  float* obs = reinterpret_cast<float*>(st + kTile * kStage);
  float* ha = obs + kTile * kObsPad;
  float* hb = ha + kTile * kHid;
  float* q = hb + kTile * kHid;

  for (int i = threadIdx.x; i < tetris::kTabN; i += blockDim.x) tab[i] = tables[i];

  const int t = threadIdx.x;
  const int e = blockIdx.x * kTile + t;
  const bool owner = t < kTile;
  const bool live = owner && e < n;
  tetris::EnvState s;
  const int8_t* own = nullptr;
  if (live) {
    tetris::load_state(s, e, cols, cursor, lines, moves, status, lg, ml);
    own = pieces + (size_t)e * P;
  }
  int episodes = 0, wins = 0;
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    // stage the pre-action fields of each env for the whole block
    if (owner) {
      int* r = st + t * kStage;
      if (live) {
        const int8_t* seq = tetris::piece_row(s, own, bank_pieces, P);
#pragma unroll
        for (int j = 0; j < tetris::kW; ++j) r[j] = (int)s.cols[j];
        r[10] = seq[tetris::clampi(s.cursor, 0, P - 1)];
        r[11] = seq[tetris::clampi(s.cursor + 1, 0, P - 1)];
        r[12] = s.lg - s.lines;
        r[13] = s.ml - s.moves;
        r[14] = s.status;
      } else {
        for (int j = 0; j < kStage; ++j) r[j] = 0;
      }
    }
    __syncthreads();

    // observation (engine.observe encoding), built by all threads
    for (int i = t; i < kTile * kObsPad; i += kThreads) {
      const int ee = i / kObsPad;
      const int kk = i - ee * kObsPad;
      const int* r = st + ee * kStage;
      float v = 0.f;
      if (kk < 200) {
        v = (float)(((uint32_t)r[kk % tetris::kW] >> (kk / tetris::kW)) & 1u);
      } else if (kk < 207) {
        v = r[10] == kk - 200 ? 1.f : 0.f;
      } else if (kk < 214) {
        v = r[11] == kk - 207 ? 1.f : 0.f;
      } else if (kk == 214) {
        v = (float)r[12];
      } else if (kk == 215) {
        v = (float)r[13];
      } else if (kk == 216) {
        v = r[14] == tetris::kWin ? 1.f : (r[14] == tetris::kLoss ? -1.f : 0.f);
      }
      obs[i] = v;
    }
    __syncthreads();

    dense<kObsPad, kHid, true>(obs, w1, b1, kHid, ha);
    __syncthreads();
    dense<kHid, kHid, true>(ha, w2, b2, kHid, hb);
    __syncthreads();
    dense<kHid, kHid, true>(hb, w3, b3, kHid, ha);
    __syncthreads();
    dense<kHid, kHid, true>(ha, w4, b4, kHid, hb);
    __syncthreads();
    dense<kHid, kHeadMax, false>(hb, w5, b5, head, q);
    __syncthreads();

    if (live) {
      const size_t o = (size_t)k * n + e;
      const float* qe = q + t * kHeadMax;
      if (q_out) {
        for (int j = 0; j < head; ++j) q_out[o * head + j] = qe[j];
      }
      int rot_g, col_g;
      if (head == 14) {
        rot_g = argmax_first(qe, 4);
        col_g = argmax_first(qe + 4, 10);
      } else {
        const int a = argmax_first(qe, 40);
        rot_g = a / 10;
        col_g = a - rot_g * 10;
      }
      float u;
      int rr, rc, idx;
      if (explore_u) {
        u = explore_u[o];
        rr = rand_rot[o];
        rc = rand_col[o];
        idx = reset_idx[o];
      } else {
        const uint4 b = tetris::philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)k, 0u, 0u), seed, 0u);
        u = tetris::uniform01(b.x);
        rr = tetris::uniform_int(b.y, 4);
        rc = tetris::uniform_int(b.z, tetris::kW);
        idx = tetris::uniform_int(b.w, bank);
      }
      const float eps =
          eps_end + (eps_start - eps_end) *
                        expf(-(float)(global_step + k) / eps_decay);
      const bool explore = u < eps;
      const int rot = explore ? rr : rot_g;
      const int col = explore ? rc : col_g;

      const int* r = st + t * kStage;
#pragma unroll
      for (int j = 0; j < tetris::kW; ++j) t_cols[o * tetris::kW + j] = r[j];
      const tetris::StepInfo info =
          tetris::env_step(s, rot, col, idx, own, bank_cols, bank_pieces, P,
                           tab, t_ncols + o * tetris::kW);
      int* ti = t_int + o * 16;
      ti[0] = r[10];
      ti[1] = r[11];
      ti[2] = r[12];
      ti[3] = r[13];
      ti[4] = rot;
      ti[5] = col;
      ti[6] = info.lines_delta;
      ti[7] = info.done;
      ti[8] = info.won;
      ti[9] = info.pre_cur;
      ti[10] = info.pre_nxt;
      ti[11] = s.lg - info.pre_lines;
      ti[12] = s.ml - info.pre_moves;
      ti[13] = info.pre_status;
      ti[14] = 0;
      ti[15] = 0;
      episodes += info.done;
      wins += info.won;
    }
    __syncthreads();
  }
  if (live) {
    tetris::store_state(s, e, P, own, bank_pieces, out_cols, out_pieces,
                        out_cursor, out_lines, out_moves, out_status);
  }
  tetris::add_block_counts(episodes, wins, out_stats);
}

}  // namespace

extern "C" int actor_launch(
    const int* cols, const int8_t* pieces, const int* cursor,
    const int* lines, const int* moves, const int8_t* status, const int* lg,
    const int* ml, const int* bank_cols, const int8_t* bank_pieces, int bank,
    int n, int P, int n_steps, int head, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, const float* w5, const float* b5,
    int global_step, float eps_start, float eps_end, float eps_decay,
    uint32_t seed, const float* explore_u, const int* rand_rot,
    const int* rand_col, const int* reset_idx, const int* tables,
    int* out_cols, int8_t* out_pieces, int* out_cursor, int* out_lines,
    int* out_moves, int8_t* out_status, int* out_stats, int* t_cols,
    int* t_ncols, int* t_int, float* q_out, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        actor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int grid = (n + kTile - 1) / kTile;
  actor_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      cols, pieces, cursor, lines, moves, status, lg, ml, bank_cols,
      bank_pieces, bank, n, P, n_steps, head, w1, b1, w2, b2, w3, b3, w4, b4,
      w5, b5, global_step, eps_start, eps_end, eps_decay, seed, explore_u,
      rand_rot, rand_col, reset_idx, tables, out_cols, out_pieces, out_cursor,
      out_lines, out_moves, out_status, out_stats, t_cols, t_ncols, t_int,
      q_out);
  return (int)cudaGetLastError();
}
