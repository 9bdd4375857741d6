// Fused GATv2 attention backward for Hopper (sm_90a): three kernels.
//
// Replace the blockwise backward of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_fused_backward:
//   K2a  _bwd_dp_da_kernel   dp (B, N, E) and per-block partial sums of da
//   K2b  _bwd_dq_dv_kernel   dq (B, N, E) and dv (B, N, D)
//   K2c  _bwd_dbias_kernel   dbias (N, N) = sum_b ds, per-chunk partial sums
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
// The score is summed in the forward's order, so w equals the forward's
// weights bit for bit.
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
// block and K2c one dbias matrix per batch chunk; the caller sums them in a
// second pass (JAX does the same for da, `da_part`, :651 and :669). K2c
// splits the batch into chunks so that the few (i, j) tiles of a small
// graph still fill the card.
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

// Bytes of shared memory one block of kernel `which` (0 K2a, 1 K2b, 2 K2c)
// needs at widths E and D.
long gatv2_bwd_smem_bytes(int which, int E, int D) {
  const size_t f = which == 0 ? dp_da_floats(E, D)
                   : which == 1 ? dq_dv_floats(E, D) : dbias_floats(E, D);
  return (long)(f * sizeof(float));
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
