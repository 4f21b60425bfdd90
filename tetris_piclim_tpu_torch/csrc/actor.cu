// Fused DQN actor: K steps of observation -> 217-128-128-128-128-head f32
// MLP -> epsilon-greedy -> env step -> bank auto-reset -> transition record.
//
// Replaces actor_rollout_fused / _kernel / _argmin_lane
// (tetris_piclim_tpu/ops/pallas_actor.py:86-404). The TPU kernel holds the
// ~315 KB of f32 weights in VMEM; a Hopper block has 227 KB of shared memory.
//
// Bound (H100): the MLP's multiply-adds, 217*128 + 3*128*128 + 128*head per
// env step. On the FP32 pipes that is 0.077 ms per launch at 4096 envs x 8
// steps. This kernel runs them on the tensor cores as 3xTF32 (each f32
// operand split into a TF32 high part and the rest; hi*lo + lo*hi + hi*hi,
// f32 accumulation), whose bound is three passes over the TF32 peak, 0.031
// ms. With weights that make every partial sum exact the result is
// bit-identical to any f32 order; with real weights Q stays within 2e-6 of
// the f32 reference. A version on the FP32 pipes (4 x 4 register tiles,
// 128-bit shared loads) was bound by shared-memory bandwidth at twice this
// kernel's time: a 32-env tile on 256 threads cannot hold the 8 x 8 register
// tiles that balance FMAs against loads (PERF.md has the numbers).
//
// A block of 256 threads owns a tile of 32 envs for the K steps, one block
// per SM at 4096 envs.
//   * Products: mma.sync m16n8k8. Warp w computes all 32 envs x units 16 w
//     .. 16 w + 15 (2 x 2 tiles); per 8 k a lane loads its 12 fragment words
//     (4-byte shared loads, conflict-free because every row stride is 4 mod
//     32 floats), splits them, and issues 12 mmas. Every 16 k the tensor
//     core's sum is added to the accumulator by a rounded f32 add, so its
//     truncating adder never sees a long sum.
//   * The weights are read in place, in nn.Linear's [out, in] layout: a
//     unit's weights are contiguous in k. Layer 1 (rows of 217 floats, 868
//     bytes, not 16-byte aligned) is copied once per launch with 4-byte
//     cp.async, zero-filled beyond k = 216, and stays resident for the K
//     steps: the ragged edge is handled here and the caller keeps no padded
//     copy. Layers 2-4 and the head stream through a ring of three 32-k
//     slabs filled by 16-byte cp.async, two slabs ahead of the products, and
//     the next step's first slabs arrive during the env phase and layer 1.
//   * The head's tiles (2 row tiles x 2 or 5 unit tiles) are spread over the
//     warps.
//   * The env phase runs on all threads: the lane-split step of
//     env_step.cuh with 8 lanes per env. The observation is written from the
//     lanes' registers (no division, no staging), and each lane writes its
//     own pair of words of every transition record, so a warp's stores cover
//     whole contiguous runs. The loads a step needs from device memory (the
//     piece two places ahead, the first two pieces and the columns of the
//     bank row a reset would go to) are issued before the MLP and used after
//     it.
//
// Shared memory (bytes): resident layer 1 128 x 228 x 4 = 116,736;
// activations A 32 x 228 x 4 = 29,184 (observation, later hidden) and
// B 32 x 132 x 4 = 16,896 (hidden, later Q); slab ring 3 x 128 x 36 x 4 =
// 55,296; biases 2,208; piece table 256. 220,576 of 232,448. Registers: 180
// (ptxas -v, in the build log), no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_step.cuh"

namespace {

constexpr int kTile = 32;    // envs per block
constexpr int kLanes = 8;    // lanes per env in the env phase
constexpr int kThreads = kTile * kLanes;
constexpr int kHid = 128;
constexpr int kObs = 217;
constexpr int kHeadMax = 40;
constexpr int kSlabK = 32;     // k per streamed slab
constexpr int kStages = 3;     // slabs in the ring
constexpr int kSlabsPerLayer = kHid / kSlabK;        // 4
constexpr int kSlabsPerStep = 4 * kSlabsPerLayer;    // layers 2-4 and the head
constexpr int kObsPad = 224;   // layer 1's k, padded to whole k8 chunks
constexpr int kStrideA = 228;  // >= kObsPad, = 4 (mod 32)
constexpr int kStrideB = 132;
constexpr int kStrideW1 = 228;  // resident layer-1 rows
constexpr int kStrideS = 36;    // slab rows
constexpr int kStageFloats = kHid * kStrideS;
constexpr int kBiasFloats = 4 * kHid + kHeadMax;
constexpr size_t kSmemBytes =
    sizeof(float) * (kHid * kStrideW1 + kTile * kStrideA + kTile * kStrideB +
                     kStages * kStageFloats + kBiasFloats) +
    tetris::kTabBytes;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// 4 bytes, or zeros when !valid (src must still be a readable address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` of this thread's newest groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// D += A * B for one 16 x 8 x 8 tile on the tensor cores, TF32 inputs and
// f32 accumulation. Lane (gid = lane / 4, tig = lane % 4) holds
// A[gid][tig], A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4],
// B[k = tig][n = gid], B[tig + 4][gid] and D[gid][2 tig], D[gid][2 tig + 1],
// D[gid + 8][2 tig], D[gid + 8][2 tig + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Weights {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4, *w5, *b5;
};

// Start the copy of slab s of a step's stream into `stage`: slabs 4l..4l+3
// are the four 32-k column blocks of layer 2 + l (l = 3: the head).
__device__ __forceinline__ void issue_slab(int s, float* stage,
                                           const Weights& wt, int head) {
  const int t = threadIdx.x;
  const int layer = s / kSlabsPerLayer;
  const float* w = layer == 0 ? wt.w2 : layer == 1 ? wt.w3
                 : layer == 2 ? wt.w4 : wt.w5;
  const int rows = layer == 3 ? head : kHid;
  const int k0 = (s % kSlabsPerLayer) * kSlabK;
  // rows x 8 chunks of 16 bytes
#pragma unroll
  for (int it = 0; it < kHid * 8 / kThreads; ++it) {
    const int c = it * kThreads + t;
    const int row = c >> 3, ch = c & 7;
    if (row < rows)
      cp_async16(stage + row * kStrideS + 4 * ch,
                 w + row * kHid + k0 + 4 * ch);
  }
}

// x = hi + lo exactly, hi on TF32's 10 mantissa bits. The tensor core reads
// only the TF32 bits of lo, which loses 2^-21 of x at most.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One warp's 32 envs x 16 units: acc[mt][nt] is the 16 x 8 tile of envs
// 16 mt .. and units 8 nt .. (fragment layout of mma_tf32). Adds the sum over
// 8 * K8 consecutive k of a[env][k] * w[unit][k] in 3xTF32: hi*lo + lo*hi +
// hi*hi, the small terms first. Every 16 k the tensor core's sum is added to
// acc by a rounded f32 add, so its truncating adder never sees a long sum.
// `a` points at A[gid][tig], `w` at W[first unit + gid][tig], at the first k.
template <int K8, int AS, int WS>
__device__ __forceinline__ void mma_tile(float (&acc)[2][2][4], const float* a,
                                         const float* w) {
  static_assert(K8 % 2 == 0, "two k8 chunks per rounded add");
#pragma unroll 2
  for (int c = 0; c < K8; c += 2) {
    float d[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * (c + h);
      uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(a[(16 * mt) * AS + k], ah[mt][0], al[mt][0]);
        split_tf32(a[(16 * mt + 8) * AS + k], ah[mt][1], al[mt][1]);
        split_tf32(a[(16 * mt) * AS + k + 4], ah[mt][2], al[mt][2]);
        split_tf32(a[(16 * mt + 8) * AS + k + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        split_tf32(w[(8 * nt) * WS + k], bh[nt][0], bl[nt][0]);
        split_tf32(w[(8 * nt) * WS + k + 4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_tf32(d[mt][nt], ah[mt], bl[nt]);
          mma_tf32(d[mt][nt], al[mt], bh[nt]);
          mma_tf32(d[mt][nt], ah[mt], bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[mt][nt][i];
  }
}

__device__ __forceinline__ void clear_tile(float (&acc)[2][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// out = relu(acc + bias) for the warp's tile; `out` points at
// out[gid][first unit + 2 tig], `bias` at bias[first unit + 2 tig].
template <int OS>
__device__ __forceinline__ void store_tile(const float (&acc)[2][2][4],
                                           const float* bias, float* out) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float b0 = bias[8 * nt], b1 = bias[8 * nt + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float2 lo, hi;
      lo.x = fmaxf(acc[mt][nt][0] + b0, 0.f);
      lo.y = fmaxf(acc[mt][nt][1] + b1, 0.f);
      hi.x = fmaxf(acc[mt][nt][2] + b0, 0.f);
      hi.y = fmaxf(acc[mt][nt][3] + b1, 0.f);
      *reinterpret_cast<float2*>(out + (16 * mt) * OS + 8 * nt) = lo;
      *reinterpret_cast<float2*>(out + (16 * mt + 8) * OS + 8 * nt) = hi;
    }
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

__global__ void __launch_bounds__(kThreads, 1) actor_kernel(
    const int* __restrict__ cols, const int8_t* __restrict__ pieces,
    const int* __restrict__ cursor, const int* __restrict__ lines,
    const int* __restrict__ moves, const int8_t* __restrict__ status,
    const int* __restrict__ lg, const int* __restrict__ ml,
    const int* __restrict__ bank_cols, const int8_t* __restrict__ bank_pieces,
    int bank, int n, int P, int n_steps, int head, Weights wt,
    int global_step, float eps_start, float eps_end, float eps_decay,
    uint32_t seed, const float* __restrict__ explore_u,
    const int* __restrict__ rand_rot, const int* __restrict__ rand_col,
    const int* __restrict__ reset_idx, const int* __restrict__ tables,
    int* out_cols, int8_t* out_pieces, int* out_cursor, int* out_lines,
    int* out_moves, int8_t* out_status, int* out_stats, int* t_cols,
    int* t_ncols, int* t_int, float* q_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wres = reinterpret_cast<float*>(smem);       // layer 1, resident
  float* bufA = wres + kHid * kStrideW1;
  float* bufB = bufA + kTile * kStrideA;
  float* ring = bufB + kTile * kStrideB;
  float* bias = ring + kStages * kStageFloats;
  uint2* tab = reinterpret_cast<uint2*>(bias + kBiasFloats);
  float* q = bufB;  // [kTile][kHeadMax], free once layer 4 has read B

  const int t = threadIdx.x;
  // product mapping: warp `wid` computes all 32 envs x units 16 wid ..
  // 16 wid + 15; gid and tig place the lane in the mma fragments
  const int lane = t & 31, wid = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = 16 * wid;
  // env mapping: 8 neighbouring lanes per env
  const int slot = t / kLanes, g = t % kLanes;
  const int e = blockIdx.x * kTile + slot;
  const bool live = e < n;
  // head: 2 row tiles x ceil(head / 8) unit tiles, tile p on warp p mod 8
  const int head_tiles = 2 * ((head + 7) / 8);

  // prologue: layer 1 (element by element: its 217-float rows are not
  // 16-byte aligned; zeros beyond k = 216) and the first two slabs start to
  // arrive
  for (int c = t; c < kHid * kObsPad; c += kThreads) {
    const int row = c / kObsPad, k = c - row * kObsPad;
    const bool valid = k < kObs;
    cp_async4(wres + row * kStrideW1 + k, wt.w1 + row * kObs + (valid ? k : 0),
              valid);
  }
  cp_async_commit();
  const int total_slabs = n_steps * kSlabsPerStep;
  issue_slab(0, ring, wt, head);
  cp_async_commit();
  issue_slab(1, ring + kStageFloats, wt, head);
  cp_async_commit();
  tetris::load_table(tab, tables);
  for (int i = t; i < kBiasFloats; i += kThreads) {
    const int layer = i >> 7, u = i & (kHid - 1);
    float v = 0.f;
    if (layer == 0) v = wt.b1[u];
    else if (layer == 1) v = wt.b2[u];
    else if (layer == 2) v = wt.b3[u];
    else if (layer == 3) v = wt.b4[u];
    else if (u < head) v = wt.b5[u];
    bias[i] = v;
  }
  tetris::LaneEnv<kLanes> s;
  tetris::load_lanes<kLanes>(s, g, live, e, cols, cursor, lines, moves,
                             status, lg, ml);
  const int8_t* seq = pieces + (size_t)(live ? e : 0) * P;  // current piece row
  int cur = tetris::piece_at(seq, s.cursor, P);
  int nxt = tetris::piece_at(seq, s.cursor + 1, P);
  cp_async_wait<2>();  // layer 1 has landed (two slabs may still be in flight)
  __syncthreads();

  int episodes = 0, wins = 0;
  int slabs_done = 0;  // slabs consumed so far; slab i lives in stage i % 3
  tetris::Draw mine = {0u, 0u};
  float acc[2][2][4];

  // Wait for the current slab (the older of the two in flight), then start
  // the slab two ahead into the stage that held the previous one, which
  // every thread has finished reading once it is past the barrier.
  auto advance = [&]() -> const float* {
    cp_async_wait<1>();
    __syncthreads();
    const int ahead = slabs_done + 2;
    if (ahead < total_slabs)
      issue_slab(ahead % kSlabsPerStep, ring + (ahead % kStages) * kStageFloats,
                 wt, head);
    cp_async_commit();
    const float* stage = ring + (slabs_done % kStages) * kStageFloats;
    ++slabs_done;
    return stage;
  };

  for (int k = 0; k < n_steps; ++k) {
    // draws: lane g prepares step k + g once per kLanes steps
    if (k % kLanes == 0) {
      const int step = k + g;
      mine.act = 0u;
      mine.ubits = 0u;
      if (step < n_steps) {
        if (explore_u) {
          if (live) {
            const size_t o = (size_t)step * n + e;
            mine.act = tetris::pack_action(rand_rot[o], rand_col[o], reset_idx[o]);
            mine.ubits = __float_as_uint(explore_u[o]);
          }
        } else {
          mine = tetris::philox_draw((uint32_t)e, (uint32_t)step, seed, bank);
        }
      }
    }
    const uint32_t draw_act =
        __shfl_sync(tetris::kAllLanes, mine.act, k % kLanes, kLanes);
    const float u = __uint_as_float(
        __shfl_sync(tetris::kAllLanes, mine.ubits, k % kLanes, kLanes));
    const int idx = tetris::action_bank_row(draw_act);
    // loads for the end of the step, issued ahead of the MLP
    uint32_t fresh[2];
    tetris::prefetch_bank<kLanes>(fresh, g, idx, bank_cols);
    const int8_t* row = bank_pieces + (size_t)idx * P;
    const int fresh_cur = tetris::piece_at(row, 0, P);
    const int fresh_nxt = tetris::piece_at(row, 1, P);
    const int n_nxt = tetris::piece_at(seq, s.cursor + 2, P);

    // pre-action fields and the observation (engine.observe encoding),
    // written from the lanes' registers: lanes 0-4 hold two columns each,
    // lanes 5-7 write the 17 scalar entries and the zero padding
    const size_t o = (size_t)k * n + e;
    const int lines_left = s.lg - s.lines;
    const int moves_left = s.ml - s.moves;
    float* obs = bufA + slot * kStrideA;
    if (g < 5) {
#pragma unroll
      for (int r = 0; r < tetris::kH; ++r) {
        float2 v;
        v.x = (float)((s.col[0] >> r) & 1u);
        v.y = (float)((s.col[1] >> r) & 1u);
        *reinterpret_cast<float2*>(obs + r * tetris::kW + 2 * g) = v;
      }
      if (live)
        *reinterpret_cast<int2*>(t_cols + o * tetris::kW + 2 * g) =
            make_int2((int)s.col[0], (int)s.col[1]);
    } else {
      const int first = 200 + (g - 5) * 10;
      const int last = min(first + 10, kStrideA);
      for (int kk = first; kk < last; ++kk) {
        float v = 0.f;
        if (kk < 207) v = cur == kk - 200 ? 1.f : 0.f;
        else if (kk < 214) v = nxt == kk - 207 ? 1.f : 0.f;
        else if (kk == 214) v = (float)lines_left;
        else if (kk == 215) v = (float)moves_left;
        else if (kk == 216)
          v = s.status == tetris::kWin ? 1.f
                                       : (s.status == tetris::kLoss ? -1.f : 0.f);
        obs[kk] = v;
      }
    }
    __syncthreads();

    // layer 1: A (observation) -> B, resident weights
    clear_tile(acc);
    mma_tile<kObsPad / 8, kStrideA, kStrideW1>(
        acc, bufA + gid * kStrideA + tig, wres + (n0 + gid) * kStrideW1 + tig);
    store_tile<kStrideB>(acc, bias + n0 + 2 * tig,
                         bufB + gid * kStrideB + n0 + 2 * tig);
    // layers 2-4, streamed: B -> A -> B -> A. The first slab's barrier
    // publishes the layer's input and retires the readers of its output.
#pragma unroll 1
    for (int layer = 0; layer < 3; ++layer) {
      const bool from_b = layer != 1;
      const float* in = from_b ? bufB + gid * kStrideB + tig
                               : bufA + gid * kStrideA + tig;
      clear_tile(acc);
      for (int sl = 0; sl < kSlabsPerLayer; ++sl) {
        const float* w = advance() + (n0 + gid) * kStrideS + tig;
        if (from_b)
          mma_tile<kSlabK / 8, kStrideB, kStrideS>(acc, in + sl * kSlabK, w);
        else
          mma_tile<kSlabK / 8, kStrideA, kStrideS>(acc, in + sl * kSlabK, w);
      }
      const float* b = bias + (layer + 1) * kHid + n0 + 2 * tig;
      if (from_b)
        store_tile<kStrideA>(acc, b, bufA + gid * kStrideA + n0 + 2 * tig);
      else
        store_tile<kStrideB>(acc, b, bufB + gid * kStrideB + n0 + 2 * tig);
    }

    // head: A -> q, streamed (the first slab's barrier publishes A). Tile p
    // = (row tile p % 2, unit tile p / 2) runs on warp p % 8, so head 14
    // uses four warps and head 40 all eight, two of them twice.
    float hacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[j][i] = 0.f;
    for (int sl = 0; sl < kSlabsPerLayer; ++sl) {
      const float* stage = advance();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = wid + 8 * j;
        if (p < head_tiles) {
          const float* a =
              bufA + (16 * (p & 1) + gid) * kStrideA + sl * kSlabK + tig;
          const float* w = stage + (8 * (p >> 1) + gid) * kStrideS + tig;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < kSlabK / 8; ++c) {
            uint32_t ah[4], al[4], bh[2], bl[2];
            split_tf32(a[8 * c], ah[0], al[0]);
            split_tf32(a[8 * kStrideA + 8 * c], ah[1], al[1]);
            split_tf32(a[8 * c + 4], ah[2], al[2]);
            split_tf32(a[8 * kStrideA + 8 * c + 4], ah[3], al[3]);
            split_tf32(w[8 * c], bh[0], bl[0]);
            split_tf32(w[8 * c + 4], bh[1], bl[1]);
            mma_tf32(d, ah, bl);
            mma_tf32(d, al, bh);
            mma_tf32(d, ah, bh);
            if (c & 1) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                hacc[j][i] += d[i];
                d[i] = 0.f;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = wid + 8 * j;
      if (p < head_tiles) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * (p & 1) + gid + 8 * (i >> 1);
          const int unit = 8 * (p >> 1) + 2 * tig + (i & 1);
          if (unit < head)
            q[row * kHeadMax + unit] = hacc[j][i] + bias[4 * kHid + unit];
        }
      }
    }
    __syncthreads();
    float* qe = q + slot * kHeadMax;
    if (q_out && live) {
      for (int unit = g; unit < head; unit += kLanes)
        q_out[o * head + unit] = qe[unit];
    }

    // epsilon-greedy, in every lane of the group
    int rot, col;
    if (head == 14) {
      rot = argmax_first(qe, 4);
      col = argmax_first(qe + 4, 10);
    } else {
      const int a = argmax_first(qe, 40);
      rot = a / 10;
      col = a - rot * 10;
    }
    const float eps =
        eps_end + (eps_start - eps_end) *
                      expf(-(float)(global_step + k) / eps_decay);
    if (u < eps) {
      rot = (int)(draw_act & 3u);
      col = (int)((draw_act >> 2) & 15u);
    }

    const uint32_t act = tetris::pack_action(rot, col, idx);
    const tetris::StepOut out = tetris::step_lanes<kLanes>(
        s, g, act, tetris::table_entry(tab, cur, act));

    if (live) {
      if (g < 5)
        *reinterpret_cast<int2*>(t_ncols + o * tetris::kW + 2 * g) =
            make_int2((int)s.col[0], (int)s.col[1]);
      // lane g writes words 2g, 2g + 1 of the 16-word record
      int v0 = 0, v1 = 0;
      switch (g) {
        case 0: v0 = cur; v1 = nxt; break;
        case 1: v0 = lines_left; v1 = moves_left; break;
        case 2: v0 = rot; v1 = col; break;
        case 3: v0 = out.lines_delta; v1 = out.done; break;
        case 4: v0 = out.won; v1 = nxt; break;  // the after-state's current piece
        case 5: v0 = n_nxt; v1 = s.lg - s.lines; break;
        case 6: v0 = s.ml - s.moves; v1 = s.status; break;
        default: break;
      }
      *reinterpret_cast<int2*>(t_int + o * 16 + 2 * g) = make_int2(v0, v1);
      if (g == 0) {
        episodes += out.done;
        wins += out.won;
      }
    }
    const bool done = out.done != 0;
    tetris::reset_lanes<kLanes>(s, done, fresh);
    seq = done ? row : seq;
    cur = done ? fresh_cur : nxt;
    nxt = done ? fresh_nxt : n_nxt;
  }
  tetris::store_lanes<kLanes>(s, g, live, e, P, seq, out_cols, out_pieces,
                              out_cursor, out_lines, out_moves, out_status);
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
  const Weights wt = {w1, b1, w2, b2, w3, b3, w4, b4, w5, b5};
  const int grid = (n + kTile - 1) / kTile;
  actor_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      cols, pieces, cursor, lines, moves, status, lg, ml, bank_cols,
      bank_pieces, bank, n, P, n_steps, head, wt, global_step, eps_start,
      eps_end, eps_decay, seed, explore_u, rand_rot, rand_col, reset_idx,
      tables, out_cols, out_pieces, out_cursor, out_lines, out_moves,
      out_status, out_stats, t_cols, t_ncols, t_int, q_out);
  return (int)cudaGetLastError();
}
