// Fused GATv2 attention backward for Hopper (sm_90a): four kernels.
//
// Replace the blockwise backward of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_fused_backward:
//   K2a  _bwd_dp_da_kernel   dp (B, N, E) and per-block partial sums of da
//   K2b  _bwd_dq_dv_kernel   dq (B, N, E) and dv (B, N, D)
//   K2c  _bwd_dbias_kernel   dbias (N, N) = sum_b ds, per-chunk partial sums
//   K2ab K2a and K2b in one launch for graphs that fit a block whole (the
//        model's: N = 38 and 100), each (i, j) pair scored once, and K2c's
//        dbias too where the call wants it; K2a, K2b and K2c stay as the
//        variant for large graphs (kernels/gat.gat_bwd_plan chooses). The
//        K2ab section below says more.
// Each recomputes its tile of attention weights from the forward's row stats
// (m, l) instead of reading an (N, N) tensor (_ds_tile, :417-451):
//
//   s_ij   = a . leakyrelu(p_i + q_j) + bias_ij
//   w_ij   = exp(s_ij - m_i) / l_i                 (0 for a key j >= N)
//   wa_ij  = keep_ij ? w_ij / (1 - rate) : 0       (w_ij without dropout)
//   ds_ij  = wa_ij (du_i . v_j) - w_ij dvec_i
//   dp_ie  = a_e sum_j ds_ij lr'(z_ije)   dq_je = a_e sum_i ds_ij lr'(z_ije)
//   da_e   = sum_bij ds_ij lr(z_ije)      dv_jd = sum_i wa_ij du_id
//
// with z_ije = p_ie + q_je, du = g . out (1 - out) and dvec_i = du_i . u_i
// computed by the caller, as JAX computes them outside its kernels. keep_ij
// is drop_hash over the global (seed, b, i, j), the mask the forward drew.
// K2ab sums the score as the whole-graph forward does and K2a-c as the tiled
// forward does, so each one's w equals the weights of the forward variant
// that runs at its graph sizes bit for bit, and is a few ulp from the other's.
//
// What bounds them on the card: like the forward, the score and the two
// (i, j, e) contractions are float32 work on the CUDA cores with no product
// structure (some 10 operations per (i, j, e) in K2a and K2b, 4 in K2c),
// far above the bytes they read at these graph sizes. Every operand of the
// inner loops sits in shared memory: the row tile's p and du, the key tile's
// q and v, at their full widths E and D, with odd row strides so that a warp
// reading one column per lane, or one row across lanes, meets no bank
// conflict. The score pass maps one key per lane and four rows per thread
// (as the forward); the contraction over keys maps one embedding lane per
// thread and loops over the tile's keys, so each thread owns its
// accumulators and nothing is reduced across threads. No (N, N) tensor is
// written except dbias itself.
//
// Reductions across blocks are deterministic: K2a writes one da row per
// block, K2c one dbias matrix per batch chunk and K2ab one per group of
// batch elements; the caller sums them in a second pass (JAX does the same
// for da, `da_part`, :651 and :669). K2c splits the batch into chunks so
// that the few (i, j) tiles of a small graph still fill the card.
//
// Layouts: p, q (B, N, E), v (B, N, D) in T (float32 or bfloat16); a (E,)
// in T; bias (N, N) float32 or null; m, l, dvec (B, N) and du (B, N, D)
// float32. dp, dq, dv are written in T; da_part and dbias in float32.

#include "gat_common.cuh"

namespace {

using namespace gat;

constexpr int BI = 16;                      // query rows per tile
constexpr int BJ = 32;                      // keys per tile: one per lane
constexpr int THREADS = 128;                // four warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BI / WARPS;            // query rows per thread

__host__ __device__ inline int odd(int x) { return x | 1; }

// Shared-memory layout of one (row tile, key tile) pair, full widths E, D.
struct Tile {
  float* p;      // [BI][odd(E)]
  float* q;      // [BJ][odd(E)]
  float* a;      // [E]
  float* v;      // [BJ][odd(D)]
  float* du;     // [BI][odd(D)]
  float* m;      // [BI]
  float* l;      // [BI]
  float* dvec;   // [BI]
  float* next;   // first float after the tile
};

__host__ __device__ inline size_t tile_floats(int E, int D) {
  return (size_t)(BI + BJ) * odd(E) + E + (size_t)(BI + BJ) * odd(D) + 3 * BI;
}

__device__ inline Tile carve(float* base, int E, int D) {
  Tile t;
  t.p = base;
  t.q = t.p + BI * odd(E);
  t.a = t.q + BJ * odd(E);
  t.v = t.a + E;
  t.du = t.v + BJ * odd(D);
  t.m = t.du + BI * odd(D);
  t.l = t.m + BI;
  t.dvec = t.l + BI;
  t.next = t.dvec + BI;
  return t;
}

struct Args {
  const float* bias;        // (N, N) or null
  const long long* seed;    // one value, or null without dropout
  const float* m;
  const float* l;
  const float* du;
  const float* dvec;
  int B, N, E, D;
  float alpha;
  uint32_t thresh;
  float scale;
};

// Row tile [i0, i0 + BI) of batch b: p, du and the row stats.
template <typename T>
__device__ void stage_rows(const Tile& t, const T* __restrict__ p, const Args& g, int b,
                           int i0) {
  const int E = g.E, D = g.D, N = g.N, EP = odd(E), DP = odd(D);
  for (int x = threadIdx.x; x < BI * E; x += THREADS) {
    const int r = x / E, e = x % E, i = i0 + r;
    t.p[r * EP + e] = i < N ? to_f(p[((size_t)b * N + i) * E + e]) : 0.f;
  }
  for (int x = threadIdx.x; x < BI * D; x += THREADS) {
    const int r = x / D, d = x % D, i = i0 + r;
    t.du[r * DP + d] = i < N ? g.du[((size_t)b * N + i) * D + d] : 0.f;
  }
  if (threadIdx.x < BI) {
    const int i = i0 + threadIdx.x;
    const bool in = i < N;
    t.m[threadIdx.x] = in ? g.m[(size_t)b * N + i] : 0.f;
    t.l[threadIdx.x] = in ? g.l[(size_t)b * N + i] : 1.f;
    t.dvec[threadIdx.x] = in ? g.dvec[(size_t)b * N + i] : 0.f;
  }
}

// Key tile [j0, j0 + BJ) of batch b: q and v.
template <typename T>
__device__ void stage_keys(const Tile& t, const T* __restrict__ q, const T* __restrict__ v,
                           const Args& g, int b, int j0) {
  const int E = g.E, D = g.D, N = g.N, EP = odd(E), DP = odd(D);
  for (int x = threadIdx.x; x < BJ * E; x += THREADS) {
    const int c = x / E, e = x % E, j = j0 + c;
    t.q[c * EP + e] = j < N ? to_f(q[((size_t)b * N + j) * E + e]) : 0.f;
  }
  for (int x = threadIdx.x; x < BJ * D; x += THREADS) {
    const int c = x / D, d = x % D, j = j0 + c;
    t.v[c * DP + d] = j < N ? to_f(v[((size_t)b * N + j) * D + d]) : 0.f;
  }
}

template <typename T>
__device__ void stage_a(const Tile& t, const T* __restrict__ a, int E) {
  for (int e = threadIdx.x; e < E; e += THREADS) t.a[e] = to_f(a[e]);
}

// ds and wa of this thread's ROWS rows (warp + r * WARPS) and key (lane) of
// the staged tile pair. Rows >= N and keys >= N give 0.
template <bool DROP>
__device__ void ds_tile(const Tile& t, const Args& g, uint32_t seed, int b, int i0, int j0,
                        float (&ds)[ROWS], float (&wa)[ROWS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int E = g.E, D = g.D, EP = odd(E), DP = odd(D);
  float s[ROWS], dot[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = dot[r] = 0.f;
  const float* qj = t.q + lane * EP;
  for (int e = 0; e < E; ++e) {
    const float qv = qj[e];
    const float av = t.a[e];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float z = t.p[(warp + r * WARPS) * EP + e] + qv;
      z = z >= 0.f ? z : g.alpha * z;
      s[r] = fmaf(av, z, s[r]);
    }
  }
  const float* vj = t.v + lane * DP;
  for (int d = 0; d < D; ++d) {
    const float vv = vj[d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dot[r] = fmaf(t.du[(warp + r * WARPS) * DP + d], vv, dot[r]);
  }
  const int j = j0 + lane;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rl = warp + r * WARPS;
    const int i = i0 + rl;
    ds[r] = wa[r] = 0.f;
    if (i < g.N && j < g.N) {
      float sv = s[r];
      if (g.bias != nullptr) sv += g.bias[(size_t)i * g.N + j];
      const float w = expf(sv - t.m[rl]) / t.l[rl];
      float w_agg = w;
      if constexpr (DROP) {
        w_agg = drop_hash(seed, (uint32_t)b, (uint32_t)i, (uint32_t)j) < g.thresh
                    ? w * g.scale : 0.f;
      }
      wa[r] = w_agg;
      ds[r] = w_agg * dot[r] - w * t.dvec[rl];
    }
  }
}

__device__ inline uint32_t read_seed(const Args& g) {
  return g.seed == nullptr ? 0u : (uint32_t)(unsigned long long)(*g.seed);
}

// ---- K2a: one block per (batch, row tile); loops over key tiles ----------

size_t dp_da_floats(int E, int D) {
  return tile_floats(E, D) + (size_t)BI * BJ + (size_t)BI * E + (size_t)WARPS * E;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_dp_da_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const T* __restrict__ v, Args g,
                       T* __restrict__ dp, float* __restrict__ da_part, int row_tiles) {
  extern __shared__ float smem[];
  const int E = g.E, N = g.N, EP = odd(E);
  const Tile t = carve(smem, E, g.D);
  float* ds_s = t.next;                     // [BI][BJ]
  float* dp_acc = ds_s + BI * BJ;           // [BI][E]
  float* da_w = dp_acc + BI * E;            // [WARPS][E]
  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * BI;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t seed = read_seed(g);

  stage_a(t, a, E);
  stage_rows(t, p, g, b, i0);
  for (int x = threadIdx.x; x < BI * E; x += THREADS) dp_acc[x] = 0.f;
  for (int x = threadIdx.x; x < WARPS * E; x += THREADS) da_w[x] = 0.f;

  for (int j0 = 0; j0 < N; j0 += BJ) {
    __syncthreads();  // readers of the previous key tile are done
    stage_keys(t, q, v, g, b, j0);
    __syncthreads();
    float ds[ROWS], wa[ROWS];
    ds_tile<DROP>(t, g, seed, b, i0, j0, ds, wa);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ds_s[(warp + r * WARPS) * BJ + lane] = ds[r];
    __syncthreads();
    // contract over the tile's keys: one embedding lane per thread
    const int jn = min(BJ, N - j0);
    for (int e = lane; e < E; e += 32) {
      float da = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int rl = warp + r * WARPS;
        const float pv = t.p[rl * EP + e];
        const float* dsr = ds_s + rl * BJ;
        float acc = 0.f;
        for (int c = 0; c < jn; ++c) {
          const float z = pv + t.q[c * EP + e];
          const float d = dsr[c];
          acc = fmaf(d, z >= 0.f ? 1.f : g.alpha, acc);
          da = fmaf(d, z >= 0.f ? z : g.alpha * z, da);
        }
        dp_acc[rl * E + e] += acc;
      }
      da_w[warp * E + e] += da;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < BI * E; x += THREADS) {
    const int r = x / E, e = x % E, i = i0 + r;
    if (i < N) dp[((size_t)b * N + i) * E + e] = from_f<T>(t.a[e] * dp_acc[x]);
  }
  for (int e = threadIdx.x; e < E; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += da_w[w * E + e];
    da_part[(size_t)blockIdx.x * E + e] = s;
  }
}

// ---- K2b: one block per (batch, key tile); loops over row tiles ----------

size_t dq_dv_floats(int E, int D) {
  return tile_floats(E, D) + 2 * (size_t)BI * BJ + (size_t)BJ * E + (size_t)BJ * D;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_dq_dv_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const T* __restrict__ v, Args g,
                       T* __restrict__ dq, T* __restrict__ dv, int col_tiles) {
  extern __shared__ float smem[];
  const int E = g.E, D = g.D, N = g.N, EP = odd(E), DP = odd(D);
  const Tile t = carve(smem, E, D);
  float* ds_s = t.next;                     // [BI][BJ]
  float* wa_s = ds_s + BI * BJ;             // [BI][BJ]
  float* dq_acc = wa_s + BI * BJ;           // [BJ][E]
  float* dv_acc = dq_acc + BJ * E;          // [BJ][D]
  const int b = blockIdx.x / col_tiles;
  const int j0 = (blockIdx.x % col_tiles) * BJ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t seed = read_seed(g);
  const int jn = min(BJ, N - j0);

  stage_a(t, a, E);
  stage_keys(t, q, v, g, b, j0);
  for (int x = threadIdx.x; x < BJ * E; x += THREADS) dq_acc[x] = 0.f;
  for (int x = threadIdx.x; x < BJ * D; x += THREADS) dv_acc[x] = 0.f;

  for (int i0 = 0; i0 < N; i0 += BI) {
    __syncthreads();  // readers of the previous row tile are done
    stage_rows(t, p, g, b, i0);
    __syncthreads();
    float ds[ROWS], wa[ROWS];
    ds_tile<DROP>(t, g, seed, b, i0, j0, ds, wa);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ds_s[(warp + r * WARPS) * BJ + lane] = ds[r];
      wa_s[(warp + r * WARPS) * BJ + lane] = wa[r];
    }
    __syncthreads();
    const int in = min(BI, N - i0);
    // dq: one embedding lane per thread, keys warp, warp + WARPS, ...
    for (int e = lane; e < E; e += 32) {
      for (int c = warp; c < jn; c += WARPS) {
        const float qv = t.q[c * EP + e];
        float acc = 0.f;
        for (int r = 0; r < in; ++r) {
          const float z = t.p[r * EP + e] + qv;
          acc = fmaf(ds_s[r * BJ + c], z >= 0.f ? 1.f : g.alpha, acc);
        }
        dq_acc[c * E + e] += acc;
      }
    }
    // dv: dropout-masked weights only (the aggregate's path)
    for (int x = threadIdx.x; x < jn * D; x += THREADS) {
      const int c = x / D, d = x % D;
      float acc = 0.f;
      for (int r = 0; r < in; ++r) acc = fmaf(wa_s[r * BJ + c], t.du[r * DP + d], acc);
      dv_acc[x] += acc;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < jn * E; x += THREADS) {
    const int c = x / E, e = x % E;
    dq[((size_t)b * N + j0 + c) * E + e] = from_f<T>(t.a[e] * dq_acc[x]);
  }
  for (int x = threadIdx.x; x < jn * D; x += THREADS) {
    const int c = x / D, d = x % D;
    dv[((size_t)b * N + j0 + c) * D + d] = from_f<T>(dv_acc[x]);
  }
}

// ---- K2c: one block per (row tile, key tile, batch chunk) ----------------

size_t dbias_floats(int E, int D) { return tile_floats(E, D); }

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_dbias_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const T* __restrict__ v, Args g,
                       float* __restrict__ dbias_part, int row_tiles, int col_tiles,
                       int chunk) {
  extern __shared__ float smem[];
  const int N = g.N;
  const Tile t = carve(smem, g.E, g.D);
  const int tiles = row_tiles * col_tiles;
  const int c = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) / col_tiles * BI;
  const int j0 = (blockIdx.x % col_tiles) * BJ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t seed = read_seed(g);

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  stage_a(t, a, g.E);
  const int b_end = min(g.B, (c + 1) * chunk);
  for (int b = c * chunk; b < b_end; ++b) {
    __syncthreads();  // readers of the previous batch's tiles are done
    stage_rows(t, p, g, b, i0);
    stage_keys(t, q, v, g, b, j0);
    __syncthreads();
    float ds[ROWS], wa[ROWS];
    ds_tile<DROP>(t, g, seed, b, i0, j0, ds, wa);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] += ds[r];
  }
  const int j = j0 + lane;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + warp + r * WARPS;
    if (i < N && j < N) dbias_part[(size_t)c * N * N + (size_t)i * N + j] = acc[r];
  }
}

// ---- K2ab: K2a and K2b fused (and K2c with DBIAS), a block per batch group --
//
// The graphs of the model are small (N = 38 and 100), so one block holds a
// batch element's whole graph in shared memory: p, q, v, du and the row
// stats in float32, then the (N, N) tiles ds and wa, each computed once.
// A block takes the batch elements of its group one after the other (a
// group of one without DBIAS); for each, three passes, two barriers:
//
// 1. the score: a thread owns a 4-row x 4-key micro-tile and every
//    G_SPLIT-th float4 group of the embedding, holds four p and four q
//    vectors in registers per group, so a float4 read from shared memory
//    feeds 16 (i, j) pairs; the same for du_i . v_j over D. The G_SPLIT
//    splits of a tile are neighbouring lanes and add their partial sums in a
//    fixed order through a reduce-scatter of shuffles, after which each split
//    owns 16 / G_SPLIT pairs of the tile and writes their ds and wa;
// 2. dv = wa^T du, a 4-key x 4-column register tile per thread, on the CUDA
//    cores in float32;
// 3. the contraction: a thread owns four embedding lanes (a float4 group) and
//    the rows rg, rg + RG, ... of the graph and walks the keys four at a
//    time, their q in registers: each z = p_ie + q_je is formed once and
//    feeds dp_ie (registers), dq_je and da_e. The RG row groups of a float4 group are
//    neighbouring lanes, so dq of four keys is summed over them by one
//    reduce-scatter of shuffles and written; dp needs no sum across threads,
//    da one at the end.
//
// With DBIAS the block also sums dbias = sum_b ds over its group, K2c's
// function, at no second pass over the graph: the thread that writes ds_ij
// to shared memory in pass 1 owns pair (i, j) for every element of the
// group (the item-to-thread mapping does not depend on b), so it adds ds_ij
// to the group's (N, N) float32 partial in device memory, which stays in L2
// (a few MB in all). The first element of a group writes its ds, the next
// ones add theirs in batch order; the caller sums the groups' partials
// (kernels/gat.dbias_groups sizes the groups). This costs no shared memory,
// so the block's layout and occupancy stay as without DBIAS. Measured on
// the H100 (PERF.md): the group loop alone costs nothing; reading the
// partial at the write beat loading it ahead of the score loop (8 more
// registers held there, and spills), a shared-memory accumulator, and a
// separate coalesced pass over ds.
//
// Every sum has a fixed order and there are no atomics: two launches give
// identical bits. The score is summed as the whole-graph K1-res sums it
// (G_SPLIT interleaved partial sums, gat_fwd.cu), so w matches that
// forward's weights bit for bit. Row and key padding is
// to a multiple of 4 (the micro-tile), not to the tiled kernels' 16 x 32:
// rows and keys >= N give w = ds = wa = 0 and write nothing.

constexpr int G_RMAX = 8;                   // most rows a thread owns in the contraction
constexpr int G_MIN_WARPS = 4;
constexpr int G_MAX_WARPS = 16;

// Row groups of the contraction (lanes that share a float4 group); 0 where
// the graph is too large for this kernel.
__host__ __device__ inline int graph_row_groups(int N) {
  return N <= 8 * G_RMAX ? 8 : N <= 16 * G_RMAX ? 16 : 0;
}

struct GraphLayout {
  int N4;       // rows and keys padded to the micro-tile
  int EP, DP;   // strides of p, q and of v, du
  int NSD;      // stride of ds, odd: the contraction reads it one float per lane
  int NSW;      // stride of wa, read as float4
  __host__ __device__ GraphLayout(int N, int E, int D)
      : N4(up4(N)), EP(stride4(E)), DP(stride4(D)), NSD(up4(N) + 1), NSW(stride4(up4(N))) {}
  __host__ __device__ size_t floats() const {
    return 2 * (size_t)N4 * EP + EP + 2 * (size_t)N4 * DP + 3 * (size_t)N4 +
           (size_t)N4 * NSD + (size_t)N4 * NSW;
  }
};

__host__ __device__ inline int graph_warps(int N, int E) {
  const int lanes_per_group = graph_row_groups(N);
  const int groups_per_warp = lanes_per_group ? 32 / lanes_per_group : 1;
  const int w = ((E + 3) / 4 + groups_per_warp - 1) / groups_per_warp;
  return w < G_MIN_WARPS ? G_MIN_WARPS : w > G_MAX_WARPS ? G_MAX_WARPS : w;
}

// Batch elements of one K2ab block that sums dbias, on a card of `sms`
// multiprocessors (kernels/gat.dbias_groups, which the launcher checks
// against this): one group a multiprocessor, as K2ab runs one block on each,
// and at least two elements a group, so the partials never grow to (B, N, N).
__host__ __device__ inline int graph_dbias_group(int B, int sms) {
  const int g = (B + sms - 1) / sms;
  const int at_least = g < 2 ? 2 : g;
  return at_least < B ? at_least : B;
}

template <typename T, bool DROP, int RG, bool DBIAS>
__global__ void __launch_bounds__(G_MAX_WARPS * 32, 1)
gatv2_bwd_graph_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const T* __restrict__ v, Args g,
                       T* __restrict__ dp, T* __restrict__ dq, T* __restrict__ dv,
                       float* __restrict__ da_part, float* __restrict__ dbias_part,
                       int group) {
  extern __shared__ float smem[];
  const int N = g.N, E = g.E, D = g.D;
  const GraphLayout L(N, E, D);
  float* p_s = smem;                        // [N4][EP]
  float* q_s = p_s + L.N4 * L.EP;           // [N4][EP]
  float* a_s = q_s + L.N4 * L.EP;           // [EP]
  float* v_s = a_s + L.EP;                  // [N4][DP]
  float* du_s = v_s + L.N4 * L.DP;          // [N4][DP]
  float* m_s = du_s + L.N4 * L.DP;          // [N4]
  float* l_s = m_s + L.N4;                  // [N4]
  float* dvec_s = l_s + L.N4;               // [N4]
  float* ds_s = dvec_s + L.N4;              // [N4][NSD]
  float* wa_s = ds_s + L.N4 * L.NSD;        // [N4][NSW]
  const int nt = blockDim.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = nt / 32;
  const int EG = (E + 3) / 4, DG = (D + 3) / 4, T4 = L.N4 / 4;
  const int b_first = blockIdx.x * group, b_end = min(g.B, b_first + group);
  float* part = DBIAS ? dbias_part + (size_t)blockIdx.x * N * N : nullptr;
  const uint32_t seed = read_seed(g);
  stage_padded(a_s, a, 1, E, 1, L.EP);

  for (int b = b_first; b < b_end; ++b) {
    if (b != b_first) __syncthreads();        // the previous element's readers are done
    const size_t bNE = (size_t)b * N * E, bND = (size_t)b * N * D;
    stage_padded(p_s, p + bNE, N, E, L.N4, L.EP);
    stage_padded(q_s, q + bNE, N, E, L.N4, L.EP);
    stage_padded(v_s, v + bND, N, D, L.N4, L.DP);
    stage_padded(du_s, g.du + bND, N, D, L.N4, L.DP);
    for (int x = threadIdx.x; x < L.N4; x += nt) {
      const bool in = x < N;
      m_s[x] = in ? g.m[(size_t)b * N + x] : 0.f;
      l_s[x] = in ? g.l[(size_t)b * N + x] : 1.f;
      dvec_s[x] = in ? g.dvec[(size_t)b * N + x] : 0.f;
    }
    __syncthreads();

    // 1. ds and wa: items (micro-tile, split), a tile's splits on neighbouring
    // lanes; every lane of a warp runs each round, for the shuffles.
    const int items = T4 * T4 * G_SPLIT;
    for (int base = warp * 32; base < items; base += nt) {
      const int item = base + lane;
      const int tile = item < items ? item / G_SPLIT : 0;
      const int sp = lane % G_SPLIT;
      const int i0 = tile / T4 * 4, j0 = tile % T4 * 4;
      float s[16], dot[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) s[x] = dot[x] = 0.f;
      for (int eg = sp; eg < EG; eg += G_SPLIT) {
        float4 pr[4], qc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = load4(p_s + (i0 + r) * L.EP + 4 * eg);
          qc[r] = load4(q_s + (j0 + r) * L.EP + 4 * eg);
        }
        const float4 av = load4(a_s + 4 * eg);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[r * 4 + c] = score4(pr[r], qc[c], av, s[r * 4 + c], g.alpha);
      }
      for (int dg = sp; dg < DG; dg += G_SPLIT) {
        float4 ur[4], vc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ur[r] = load4(du_s + (i0 + r) * L.DP + 4 * dg);
          vc[r] = load4(v_s + (j0 + r) * L.DP + 4 * dg);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& d = dot[r * 4 + c];
            d = fmaf(ur[r].x, vc[c].x, d);
            d = fmaf(ur[r].y, vc[c].y, d);
            d = fmaf(ur[r].z, vc[c].z, d);
            d = fmaf(ur[r].w, vc[c].w, d);
          }
      }
      // split sp now holds pairs sp * 16 / G_SPLIT + x (row-major in the tile)
      reduce_scatter<16, G_SPLIT>(s, lane);
      reduce_scatter<16, G_SPLIT>(dot, lane);
      if (item < items) {
#pragma unroll
        for (int x = 0; x < 16 / G_SPLIT; ++x) {
          const int pair = sp * (16 / G_SPLIT) + x;
          const int i = i0 + pair / 4, j = j0 + pair % 4;
          float dsv = 0.f, wav = 0.f;
          if (i < N && j < N) {
            float sv = s[x];
            if (g.bias != nullptr) sv += g.bias[(size_t)i * N + j];
            const float w = expf(sv - m_s[i]) / l_s[i];
            float w_agg = w;
            if constexpr (DROP) {
              w_agg = drop_hash(seed, (uint32_t)b, (uint32_t)i, (uint32_t)j) < g.thresh
                          ? w * g.scale : 0.f;
            }
            wav = w_agg;
            dsv = w_agg * dot[x] - w * dvec_s[i];
            if constexpr (DBIAS) {
              float& acc = part[(size_t)i * N + j];
              acc = b != b_first ? acc + dsv : dsv;
            }
          }
          ds_s[i * L.NSD + j] = dsv;
          wa_s[i * L.NSW + j] = wav;
        }
      }
    }
    __syncthreads();

    // 2. dv_jd = sum_i wa_ij du_id: a thread owns 4 keys x 4 columns.
    for (int item = threadIdx.x; item < T4 * DG; item += nt) {
      const int j0 = item / DG * 4, d0 = item % DG * 4;
      float acc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[c][k] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float4 w4 = load4(wa_s + i * L.NSW + j0);
        const float4 u4 = load4(du_s + i * L.DP + d0);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[c][k] = fmaf(wv[c], uv[k], acc[c][k]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + c < N && d0 + k < D)
            dv[bND + (size_t)(j0 + c) * D + d0 + k] = from_f<T>(acc[c][k]);
    }

    // 3. dp, dq, da: a thread owns float4 group eg and rows rg + RG r; the RG
    // row groups of a float4 group are neighbouring lanes.
    constexpr int EL = 32 / RG;               // float4 groups per warp
    const int rg = lane % RG, egl = lane / RG;
    const float alpha = g.alpha;
    for (int eb = 0; eb < EG; eb += warps * EL) {
      const int eg = eb + warp * EL + egl;
      const bool live = eg < EG;
      const int e0 = live ? 4 * eg : 0;
      float dpa[G_RMAX][4], da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < G_RMAX; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) dpa[r][k] = 0.f;
      for (int j0 = 0; j0 < L.N4; j0 += 4) {
        // the chunk's four q vectors stay in registers and a row's p is read
        // once a chunk (one float4 read for 16 (i, j, e)): holding every row's
        // p instead spilled at 128 registers and was slower (PERF.md)
        float qv[4][4], dqa[16];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 q4 = load4(q_s + (j0 + c) * L.EP + e0);
          qv[c][0] = q4.x, qv[c][1] = q4.y, qv[c][2] = q4.z, qv[c][3] = q4.w;
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) dqa[x] = 0.f;
#pragma unroll
        for (int r = 0; r < G_RMAX; ++r) {
          const int i = rg + RG * r;
          if (RG * r < L.N4) {                // warp-uniform: some row of the group is real
            const bool in = i < L.N4;
            const float4 p4 = in ? load4(p_s + i * L.EP + e0) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float d = in ? ds_s[i * L.NSD + j0 + c] : 0.f;
              const float ad = alpha * d;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float z = pv[k] + qv[c][k];
                const float gk = z >= 0.f ? d : ad;
                dpa[r][k] += gk;
                dqa[c * 4 + k] += gk;
                da[k] = fmaf(gk, z, da[k]);
              }
            }
          }
        }
        reduce_scatter<16, RG>(dqa, lane);
#pragma unroll
        for (int x = 0; x < 16 / RG; ++x) {
          const int idx = rg * (16 / RG) + x;
          const int j = j0 + idx / 4, e = e0 + idx % 4;
          if (live && j < N && e < E) dq[bNE + (size_t)j * E + e] = from_f<T>(a_s[e] * dqa[x]);
        }
      }
#pragma unroll
      for (int r = 0; r < G_RMAX; ++r) {
        const int i = rg + RG * r;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (live && i < N && e0 + k < E)
            dp[bNE + (size_t)i * E + e0 + k] = from_f<T>(a_s[e0 + k] * dpa[r][k]);
      }
#pragma unroll
      for (int o = 1; o < RG; o *= 2)
#pragma unroll
        for (int k = 0; k < 4; ++k) da[k] += __shfl_xor_sync(0xffffffffu, da[k], o);
      if (live && rg == 0)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e0 + k < E) da_part[(size_t)b * E + e0 + k] = da[k];
    }
  }  // batch element b
}

// ---- launch ---------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t floats) {
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

Args make_args(const void* bias, const void* seed, const void* m, const void* l,
               const void* du, const void* dvec, int B, int N, int E, int D, float alpha,
               unsigned int thresh, float scale) {
  return Args{(const float*)bias, (const long long*)seed, (const float*)m, (const float*)l,
              (const float*)du, (const float*)dvec, B, N, E, D, alpha, thresh, scale};
}

template <typename T, bool DROP>
int dp_da(const void* p, const void* q, const void* a, const void* v, const Args& g,
          void* dp, void* da_part, void* stream) {
  auto kernel = gatv2_bwd_dp_da_kernel<T, DROP>;
  const size_t floats = dp_da_floats(g.E, g.D);
  if (int err = prepare(kernel, floats)) return err;
  const int row_tiles = (g.N + BI - 1) / BI;
  kernel<<<g.B * row_tiles, THREADS, floats * sizeof(float), (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const T*)v, g, (T*)dp, (float*)da_part,
      row_tiles);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
int dq_dv(const void* p, const void* q, const void* a, const void* v, const Args& g,
          void* dq, void* dv, void* stream) {
  auto kernel = gatv2_bwd_dq_dv_kernel<T, DROP>;
  const size_t floats = dq_dv_floats(g.E, g.D);
  if (int err = prepare(kernel, floats)) return err;
  const int col_tiles = (g.N + BJ - 1) / BJ;
  kernel<<<g.B * col_tiles, THREADS, floats * sizeof(float), (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const T*)v, g, (T*)dq, (T*)dv, col_tiles);
  return (int)cudaGetLastError();
}

// K2ab's outputs and its batch groups: one launch's pointers.
struct GraphOut {
  void *dp, *dq, *dv, *da_part, *dbias_part;
  int group;
};

// Launches K2ab, or with occupancy non-null only reads how many of its
// blocks a multiprocessor holds at once.
template <typename T, bool DROP, int RG, bool DBIAS>
int graph_launch(const void* p, const void* q, const void* a, const void* v, const Args& g,
                 const GraphOut& o, void* stream, int* occupancy) {
  auto kernel = gatv2_bwd_graph_kernel<T, DROP, RG, DBIAS>;
  const size_t floats = GraphLayout(g.N, g.E, g.D).floats();
  if (int err = prepare(kernel, floats)) return err;
  const int threads = graph_warps(g.N, g.E) * 32;
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, threads,
                                                              floats * sizeof(float));
  kernel<<<(g.B + o.group - 1) / o.group, threads, floats * sizeof(float),
           (cudaStream_t)stream>>>((const T*)p, (const T*)q, (const T*)a, (const T*)v, g,
                                   (T*)o.dp, (T*)o.dq, (T*)o.dv, (float*)o.da_part,
                                   (float*)o.dbias_part, o.group);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP, bool DBIAS>
int graph_db(const void* p, const void* q, const void* a, const void* v, const Args& g,
             const GraphOut& o, void* stream, int* occupancy) {
  switch (graph_row_groups(g.N)) {
    case 8: return graph_launch<T, DROP, 8, DBIAS>(p, q, a, v, g, o, stream, occupancy);
    case 16: return graph_launch<T, DROP, 16, DBIAS>(p, q, a, v, g, o, stream, occupancy);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dbias is summed where the caller gives it a partial (K2c's function too),
// not otherwise: then the kernel is K2a and K2b alone.
template <typename T>
int graph(const void* p, const void* q, const void* a, const void* v, const Args& g,
          const GraphOut& o, void* stream, int* occupancy = nullptr) {
  if (o.group < 1) return (int)cudaErrorInvalidValue;
  const bool drop = g.seed != nullptr, dbias = o.dbias_part != nullptr;
  return drop ? (dbias ? graph_db<T, true, true>(p, q, a, v, g, o, stream, occupancy)
                       : graph_db<T, true, false>(p, q, a, v, g, o, stream, occupancy))
              : (dbias ? graph_db<T, false, true>(p, q, a, v, g, o, stream, occupancy)
                       : graph_db<T, false, false>(p, q, a, v, g, o, stream, occupancy));
}

template <typename T, bool DROP>
int dbias(const void* p, const void* q, const void* a, const void* v, const Args& g,
          void* part, int n_chunks, void* stream) {
  auto kernel = gatv2_bwd_dbias_kernel<T, DROP>;
  const size_t floats = dbias_floats(g.E, g.D);
  if (int err = prepare(kernel, floats)) return err;
  const int row_tiles = (g.N + BI - 1) / BI, col_tiles = (g.N + BJ - 1) / BJ;
  const int chunk = (g.B + n_chunks - 1) / n_chunks;
  kernel<<<row_tiles * col_tiles * n_chunks, THREADS, floats * sizeof(float),
           (cudaStream_t)stream>>>((const T*)p, (const T*)q, (const T*)a, (const T*)v, g,
                                   (float*)part, row_tiles, col_tiles, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

#define GAT_BWD_ARGS                                                                  \
  const void *p, const void *q, const void *a, const void *bias, const void *v,      \
      const void *seed, const void *m, const void *l, const void *du, const void *dvec
#define GAT_BWD_SIZES int B, int N, int E, int D
#define GAT_BWD_DROP float alpha, unsigned int thresh, float scale, void *stream
#define GAT_BWD_G make_args(bias, seed, m, l, du, dvec, B, N, E, D, alpha, thresh, scale)

extern "C" {

// Bytes of shared memory one block of kernel `which` (0 K2a, 1 K2b, 2 K2c,
// 3 K2ab) needs at graph size N (K2ab only) and widths E and D.
long gatv2_bwd_smem_bytes(int which, int N, int E, int D) {
  const size_t f = which == 0   ? dp_da_floats(E, D)
                   : which == 1 ? dq_dv_floats(E, D)
                   : which == 2 ? dbias_floats(E, D)
                                : GraphLayout(N, E, D).floats();
  return (long)(f * sizeof(float));
}

// K2ab's embedding splits of the score pass, its row groups of the
// contraction at graph size N (0 where N is too large for it), and the batch
// elements a block sums dbias over at batch B on a card of `sms`
// multiprocessors.
int gatv2_bwd_graph_split() { return G_SPLIT; }
int gatv2_bwd_graph_row_groups(int N) { return graph_row_groups(N); }
int gatv2_bwd_graph_dbias_group(int B, int sms) { return graph_dbias_group(B, sms); }

// K2ab: dp, dq (B, N, E) and dv (B, N, D) in T; da_part is (B, E) float32,
// one row per batch element: the caller sums its rows. With dbias_part
// non-null a block takes `group` batch elements and writes their sum of ds
// into its (N, N) float32 slice of dbias_part (ceil(B / group), N, N): the
// caller sums the slices. Without it, pass group 1.
int gatv2_bwd_graph_f32(GAT_BWD_ARGS, void* dp, void* dq, void* dv, void* da_part,
                        void* dbias_part, GAT_BWD_SIZES, int group, GAT_BWD_DROP) {
  return graph<float>(p, q, a, v, GAT_BWD_G, GraphOut{dp, dq, dv, da_part, dbias_part, group},
                      stream);
}
int gatv2_bwd_graph_bf16(GAT_BWD_ARGS, void* dp, void* dq, void* dv, void* da_part,
                         void* dbias_part, GAT_BWD_SIZES, int group, GAT_BWD_DROP) {
  return graph<__nv_bfloat16>(p, q, a, v, GAT_BWD_G,
                              GraphOut{dp, dq, dv, da_part, dbias_part, group}, stream);
}

// Blocks of the K2ab instantiation for (bf16, dropout, dbias) that one
// multiprocessor holds at once at graph size N and widths E, D (CUDA's
// occupancy calculator: shared memory, registers, threads); negative on a
// CUDA error.
int gatv2_bwd_graph_occupancy(int N, int E, int D, int bf16, int drop, int dbias) {
  long long one = 0;
  float part = 0.f;
  const Args g = make_args(nullptr, drop ? &one : nullptr, nullptr, nullptr, nullptr, nullptr,
                           1, N, E, D, 0.f, 0u, 1.f);
  const GraphOut o{nullptr, nullptr, nullptr, nullptr, dbias ? &part : nullptr, 1};
  int blocks = 0;
  const int err = bf16 ? graph<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, g, o,
                                              nullptr, &blocks)
                       : graph<float>(nullptr, nullptr, nullptr, nullptr, g, o, nullptr,
                                      &blocks);
  return err ? -err : blocks;
}

// K2a. da_part is (B * ceil(N / 16), E) float32: the caller sums its rows.
int gatv2_bwd_dp_da_f32(GAT_BWD_ARGS, void* dp, void* da_part, GAT_BWD_SIZES,
                        GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dp_da<float, true>(p, q, a, v, g, dp, da_part, stream)
              : dp_da<float, false>(p, q, a, v, g, dp, da_part, stream);
}
int gatv2_bwd_dp_da_bf16(GAT_BWD_ARGS, void* dp, void* da_part, GAT_BWD_SIZES,
                         GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dp_da<__nv_bfloat16, true>(p, q, a, v, g, dp, da_part, stream)
              : dp_da<__nv_bfloat16, false>(p, q, a, v, g, dp, da_part, stream);
}

// K2b.
int gatv2_bwd_dq_dv_f32(GAT_BWD_ARGS, void* dq, void* dv, GAT_BWD_SIZES, GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dq_dv<float, true>(p, q, a, v, g, dq, dv, stream)
              : dq_dv<float, false>(p, q, a, v, g, dq, dv, stream);
}
int gatv2_bwd_dq_dv_bf16(GAT_BWD_ARGS, void* dq, void* dv, GAT_BWD_SIZES, GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dq_dv<__nv_bfloat16, true>(p, q, a, v, g, dq, dv, stream)
              : dq_dv<__nv_bfloat16, false>(p, q, a, v, g, dq, dv, stream);
}

// K2c. part is (n_chunks, N, N) float32: the caller sums over chunks (with
// one chunk it is dbias itself).
int gatv2_bwd_dbias_f32(GAT_BWD_ARGS, void* part, GAT_BWD_SIZES, int n_chunks,
                        GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dbias<float, true>(p, q, a, v, g, part, n_chunks, stream)
              : dbias<float, false>(p, q, a, v, g, part, n_chunks, stream);
}
int gatv2_bwd_dbias_bf16(GAT_BWD_ARGS, void* part, GAT_BWD_SIZES, int n_chunks,
                         GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return seed ? dbias<__nv_bfloat16, true>(p, q, a, v, g, part, n_chunks, stream)
              : dbias<__nv_bfloat16, false>(p, q, a, v, g, part, n_chunks, stream);
}

}  // extern "C"
