// Fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the forward kernels of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_kernel (K1, launched by
// _fused_forward) and ::_kernel_res (K1-res, the training forward). For
// each destination node i of a complete graph it computes
//
//     out_i = sigmoid( sum_j softmax_j( a . leakyrelu(p_i + q_j) + bias_ij ) v_j )
//
// so that no (N, N) tensor ever exists in device memory. Two variants,
// chosen by the caller from the graph's size (kernels/gat.py::gat_fwd_plan):
//
// - gatv2_fwd_graph_kernel, for graphs a block holds (the model's: N = 38
//   and 100): one block holds a batch element's whole graph, or the half of
//   its rows that lets two blocks share a multiprocessor (row_blocks), in
//   float32 shared memory; its section below says more;
// - gatv2_fwd_kernel, the tiled variant for larger graphs: a block owns 16
//   query rows, streams key tiles of 32 (one key per lane) past them with an
//   online softmax, and keeps the running max, sum and aggregate in shared
//   memory.
//
// Two compile-time flags make the training variant of either; with both off
// (K1, the scoring path) the code is that of the forward alone:
// - RES writes the residuals of the backward: u (the pre-sigmoid
//   aggregate, float32), m (the row max) and l (the row sum);
// - DROP applies attention dropout to the aggregate only: a weight is kept
//   when drop_hash(seed, b, i, j) < thresh and then scaled by 1/(1-rate);
//   the row sum l accumulates the unmasked weights (gat_pallas.py:196-206,
//   the reference's placement: no renormalisation). The seed is read from
//   device memory, where the caller drew it, so no host sync is needed.
//
// What bounds it on the card: the additive GATv2 score has no product
// structure (a . leakyrelu(p_i + q_j) is not a matrix product), so it is
// float32 work on the CUDA cores, about 4 operations per (i, j, e); at the
// model's graph sizes (N = 38 and 100) that work and the bytes of p, q and v
// are of the same order.
//
// Layouts are those of gatv2_attention_fused: p, q (B, N, E), v (B, N, D),
// a (E,), bias (N, N) float32 or null, out (B, N, D) in v's type; u
// (B, N, D), m and l (B, N) float32. p, q, a and v share one type (float32
// or bfloat16); all arithmetic is float32.

#include "gat_common.cuh"

namespace {

using namespace gat;

// ---- the tiled forward: one block per (batch element, 16-row tile) -------

constexpr int BI = 16;                      // query rows per block
constexpr int BJ = 32;                      // keys per tile: one per lane
constexpr int EC = 32;                      // embedding lanes staged per pass
constexpr int THREADS = 128;                // four warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BI / WARPS;            // query rows per thread
constexpr int QT_STRIDE = BJ + 1;           // padded: conflict-free transpose

struct Residuals {
  float* u;                                 // (B, N, D)
  float* m;                                 // (B, N)
  float* l;                                 // (B, N)
  const long long* seed;                    // one value, low 32 bits used
  uint32_t thresh;                          // keep when hash < thresh
  float scale;                              // 1 / (1 - rate)
};

size_t smem_floats(int D) {
  return (size_t)BI * EC + (size_t)EC * QT_STRIDE + EC + (size_t)BI * BJ +
         3 * BI + (size_t)BJ * D + (size_t)BI * D;
}

template <typename T, bool RES, bool DROP>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_kernel(const T* __restrict__ p, const T* __restrict__ q,
                 const T* __restrict__ a, const float* __restrict__ bias,
                 const T* __restrict__ v, T* __restrict__ out,
                 int N, int E, int D, int row_tiles, float alpha, Residuals res) {
  extern __shared__ float smem[];
  float* p_s = smem;                        // [BI][EC]
  float* qT_s = p_s + BI * EC;              // [EC][QT_STRIDE]
  float* a_s = qT_s + EC * QT_STRIDE;       // [EC]
  float* w_s = a_s + EC;                    // [BI][BJ] softmax numerators
  float* m_s = w_s + BI * BJ;               // [BI] running max
  float* l_s = m_s + BI;                    // [BI] running sum
  float* c_s = l_s + BI;                    // [BI] rescale of this key tile
  float* v_s = c_s + BI;                    // [BJ][D]
  float* acc_s = v_s + BJ * D;              // [BI][D]

  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * BI;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t pq_base = (size_t)b * N * E;
  const size_t v_base = (size_t)b * N * D;
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)(unsigned long long)(*res.seed);

  for (int x = tid; x < BI * D; x += THREADS) acc_s[x] = 0.f;
  if (tid < BI) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }

  for (int j0 = 0; j0 < N; j0 += BJ) {
    // s[r] = sum_e a_e * leakyrelu(p_(row r), e + q_(j0 + lane), e)
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int e0 = 0; e0 < E; e0 += EC) {
      __syncthreads();  // earlier readers of the staging buffers are done
      for (int x = tid; x < BI * EC; x += THREADS) {
        const int i = i0 + x / EC, e = e0 + x % EC;
        p_s[x] = (i < N && e < E) ? to_f(p[pq_base + (size_t)i * E + e]) : 0.f;
      }
      for (int x = tid; x < BJ * EC; x += THREADS) {
        const int jr = x / EC, c = x % EC;
        const int j = j0 + jr, e = e0 + c;
        qT_s[c * QT_STRIDE + jr] =
            (j < N && e < E) ? to_f(q[pq_base + (size_t)j * E + e]) : 0.f;
      }
      if (tid < EC) a_s[tid] = (e0 + tid < E) ? to_f(a[e0 + tid]) : 0.f;
      __syncthreads();
      const int ec = min(EC, E - e0);
      for (int c = 0; c < ec; ++c) {
        const float qv = qT_s[c * QT_STRIDE + lane];
        const float av = a_s[c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float z = p_s[(warp + r * WARPS) * EC + c] + qv;
          z = z >= 0.f ? z : alpha * z;
          s[r] = fmaf(av, z, s[r]);
        }
      }
    }

    // online softmax: each warp owns rows warp, warp + WARPS, ...
    const int j = j0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int rl = warp + r * WARPS;
      const int i = i0 + rl;
      float sv = s[r];
      if (j >= N) {
        sv = NEG_BIG;
      } else if (bias != nullptr && i < N) {
        sv += bias[(size_t)i * N + j];
      }
      const float m_prev = m_s[rl];
      const float l_prev = l_s[rl];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float ex = expf(sv - m_new);
      const float tile_sum = warp_sum(ex);
      const float corr = expf(m_prev - m_new);
      float ex_agg = ex;
      if constexpr (DROP) {
        ex_agg = drop_hash(seed, (uint32_t)b, (uint32_t)i, (uint32_t)j) < res.thresh
                     ? ex * res.scale : 0.f;
      }
      w_s[rl * BJ + lane] = ex_agg;
      if (lane == 0) {
        m_s[rl] = m_new;
        l_s[rl] = l_prev * corr + tile_sum;
        c_s[rl] = corr;
      }
    }

    for (int x = tid; x < BJ * D; x += THREADS) {
      const int jj = j0 + x / D;
      v_s[x] = jj < N ? to_f(v[v_base + (size_t)jj * D + x % D]) : 0.f;
    }
    __syncthreads();

    // acc = acc * corr + w . v over this key tile
    for (int x = tid; x < BI * D; x += THREADS) {
      const int rl = x / D, d = x % D;
      const float* w = w_s + rl * BJ;
      float acc = acc_s[x] * c_s[rl];
#pragma unroll 8
      for (int jr = 0; jr < BJ; ++jr) acc = fmaf(w[jr], v_s[jr * D + d], acc);
      acc_s[x] = acc;
    }
  }
  __syncthreads();

  for (int x = tid; x < BI * D; x += THREADS) {
    const int rl = x / D;
    const int i = i0 + rl;
    if (i < N) {
      const float u = acc_s[x] / l_s[rl];
      out[v_base + (size_t)i * D + x % D] = from_f<T>(1.f / (1.f + expf(-u)));
      if constexpr (RES) res.u[v_base + (size_t)i * D + x % D] = u;
    }
  }
  if constexpr (RES) {
    if (tid < BI && i0 + tid < N) {
      res.m[(size_t)b * N + i0 + tid] = m_s[tid];
      res.l[(size_t)b * N + i0 + tid] = l_s[tid];
    }
  }
}

// ---- the whole-graph forward: one block per (batch element, row block) ----
//
// p of the block's rows, q, v and a are staged once with 16-byte loads into
// padded strides (stride4: odd 16-byte units), then three passes, two
// barriers:
//
// 1. the score: a thread owns a 4-row x 4-key micro-tile and every
//    G_SPLIT-th float4 group of the embedding and holds four p and four q
//    vectors in registers per group, so a float4 read feeds 16 (i, j)
//    pairs; the G_SPLIT splits of a tile are neighbouring lanes and add their
//    partial sums by a reduce-scatter of shuffles. This is K2ab's score pass
//    (gat_bwd.cu) term for term, so the backward recomputes these scores,
//    and the weights exp(s - m) / l, bit for bit;
// 2. an exact softmax: a warp per row takes the row's max and the sum of
//    exp(s - m) over all N keys (the whole row is on chip, so nothing is
//    rescaled), and leaves the aggregate's weights (dropout applied) in place
//    of the scores;
// 3. the aggregate u = w . v / l: a thread owns 4 rows x 4 columns of v in
//    registers and walks the keys four at a time, float4 reads of w and v.
//
// With row_blocks = 2 two blocks split a graph's rows (each holds q, v, and
// its half of p and of the scores), so that a graph too large for two blocks
// a multiprocessor (the temporal layer, 119.5 KB) runs as two that fit. Keys
// and rows are padded to 4 (the micro-tile); padded keys weigh 0 and padded
// rows write nothing. Every sum has a fixed order and there are no atomics.

constexpr int G_MAX_THREADS = 512;          // 256 a block where two blocks share a multiprocessor

struct FwdLayout {
  int N4;       // keys padded to the micro-tile
  int RB;       // rows a block owns, padded to the micro-tile
  int EP, DP;   // strides of p, q and of v
  int NSW;      // stride of the scores, read as float4
  __host__ __device__ FwdLayout(int N, int E, int D, int row_blocks)
      : N4(up4(N)), RB(up4((N + row_blocks - 1) / row_blocks)), EP(stride4(E)),
        DP(stride4(D)), NSW(stride4(up4(N))) {}
  __host__ __device__ int blocks_per_graph(int N) const { return (N + RB - 1) / RB; }
  __host__ __device__ size_t floats() const {
    return (size_t)RB * EP + (size_t)N4 * EP + EP + (size_t)N4 * DP + (size_t)RB * NSW +
           2 * (size_t)RB;
  }
};

template <typename T, bool RES, bool DROP>
__global__ void __launch_bounds__(G_MAX_THREADS, 1)
gatv2_fwd_graph_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const float* __restrict__ bias,
                       const T* __restrict__ v, T* __restrict__ out, int N, int E, int D,
                       int row_blocks, float alpha, Residuals res) {
  extern __shared__ __align__(16) float gsm[];
  const FwdLayout L(N, E, D, row_blocks);
  float* p_s = gsm;                         // [RB][EP], the block's rows
  float* q_s = p_s + L.RB * L.EP;           // [N4][EP]
  float* a_s = q_s + L.N4 * L.EP;           // [EP]
  float* v_s = a_s + L.EP;                  // [N4][DP]
  float* w_s = v_s + L.N4 * L.DP;           // [RB][NSW] scores, then weights
  float* m_s = w_s + L.RB * L.NSW;          // [RB]
  float* l_s = m_s + L.RB;                  // [RB]
  const int nrb = L.blocks_per_graph(N);
  const int b = blockIdx.x / nrb, i0 = blockIdx.x % nrb * L.RB;
  const int rows = min(L.RB, N - i0);
  const int nt = blockDim.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bNE = (size_t)b * N * E, bND = (size_t)b * N * D;
  const int EG = (E + 3) / 4, DG = (D + 3) / 4, TR = L.RB / 4, TC = L.N4 / 4;

  stage_padded(p_s, p + bNE + (size_t)i0 * E, rows, E, L.RB, L.EP);
  stage_padded(q_s, q + bNE, N, E, L.N4, L.EP);
  stage_padded(a_s, a, 1, E, 1, L.EP);
  stage_padded(v_s, v + bND, N, D, L.N4, L.DP);
  __syncthreads();

  // 1. scores: items (micro-tile, split), a tile's splits on neighbouring
  // lanes; every lane of a warp runs each round, for the shuffles
  const int items = TR * TC * G_SPLIT;
  for (int base = warp * 32; base < items; base += nt) {
    const int item = base + lane;
    const int tile = item < items ? item / G_SPLIT : 0;
    const int sp = lane % G_SPLIT;
    const int r0 = tile / TC * 4, j0 = tile % TC * 4;
    float s[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = 0.f;
    for (int eg = sp; eg < EG; eg += G_SPLIT) {
      float4 pr[4], qc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = load4(p_s + (r0 + r) * L.EP + 4 * eg);
        qc[r] = load4(q_s + (j0 + r) * L.EP + 4 * eg);
      }
      const float4 av = load4(a_s + 4 * eg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r * 4 + c] = score4(pr[r], qc[c], av, s[r * 4 + c], alpha);
    }
    // split sp now holds pairs sp * 16 / G_SPLIT + x (row-major in the tile)
    reduce_scatter<16, G_SPLIT>(s, lane);
    if (item < items) {
#pragma unroll
      for (int x = 0; x < 16 / G_SPLIT; ++x) {
        const int pair = sp * (16 / G_SPLIT) + x;
        const int rl = r0 + pair / 4, j = j0 + pair % 4;
        float sv = 0.f;
        if (rl < rows && j < N) {
          sv = s[x];
          if (bias != nullptr) sv += bias[(size_t)(i0 + rl) * N + j];
        }
        w_s[rl * L.NSW + j] = sv;
      }
    }
  }
  __syncthreads();

  // 2. softmax rows: max and sum over all N keys; the aggregate's weights
  // (dropout applied, not normalised) replace the scores
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)(unsigned long long)(*res.seed);
  for (int rl = warp; rl < L.RB; rl += nt / 32) {
    float* wr = w_s + rl * L.NSW;
    if (rl >= rows) {                       // a padded row: its scores are 0
      if (lane == 0) m_s[rl] = 0.f, l_s[rl] = 1.f;
      continue;
    }
    const int i = i0 + rl;
    float mx = NEG_BIG;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, wr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L.N4; j += 32) {
      float ex = 0.f, agg = 0.f;
      if (j < N) {
        ex = expf(wr[j] - mx);
        agg = ex;
        if constexpr (DROP) {
          agg = drop_hash(seed, (uint32_t)b, (uint32_t)i, (uint32_t)j) < res.thresh
                    ? ex * res.scale : 0.f;
        }
      }
      sum += ex;
      wr[j] = agg;
    }
    sum = warp_sum(sum);
    if (lane == 0) m_s[rl] = mx, l_s[rl] = sum;
  }
  __syncthreads();

  // 3. u = (sum_j w_ij v_j) / l_i: a thread owns 4 rows x 4 columns
  for (int item = threadIdx.x; item < TR * DG; item += nt) {
    const int r0 = item / DG * 4, d0 = item % DG * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
    for (int j0 = 0; j0 < L.N4; j0 += 4) {
      float w[4][4], vv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 w4 = load4(w_s + (r0 + r) * L.NSW + j0);
        w[r][0] = w4.x, w[r][1] = w4.y, w[r][2] = w4.z, w[r][3] = w4.w;
        const float4 v4 = load4(v_s + (j0 + r) * L.DP + d0);
        vv[r][0] = v4.x, vv[r][1] = v4.y, vv[r][2] = v4.z, vv[r][3] = v4.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(w[r][c], vv[c][k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rl = r0 + r;
      if (rl >= rows) continue;
      const size_t o = bND + (size_t)(i0 + rl) * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (d0 + k >= D) continue;
        const float u = acc[r][k] / l_s[rl];
        out[o + d0 + k] = from_f<T>(1.f / (1.f + expf(-u)));
        if constexpr (RES) res.u[o + d0 + k] = u;
      }
    }
  }
  if constexpr (RES) {
    for (int rl = threadIdx.x; rl < rows; rl += nt) {
      res.m[(size_t)b * N + i0 + rl] = m_s[rl];
      res.l[(size_t)b * N + i0 + rl] = l_s[rl];
    }
  }
}

template <typename T, bool RES, bool DROP>
int launch_graph(const void* p, const void* q, const void* a, const void* bias,
                 const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                 float alpha, Residuals res, void* stream) {
  auto kernel = gatv2_fwd_graph_kernel<T, RES, DROP>;
  const FwdLayout L(N, E, D, row_blocks);
  const size_t bytes = L.floats() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sm_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;
  // two blocks a multiprocessor where their shared memory (and 1 KB each the
  // system reserves) fits: 256 threads each, else one of 512
  const int threads = (size_t)sm_bytes >= 2 * (bytes + 1024) ? G_MAX_THREADS / 2 : G_MAX_THREADS;
  kernel<<<B * L.blocks_per_graph(N), threads, bytes, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const float*)bias, (const T*)v, (T*)out, N, E,
      D, row_blocks, alpha, res);
  return (int)cudaGetLastError();
}

// row_blocks >= 1: the whole-graph kernel, the graph's rows over that many
// blocks; 0: the tiled kernel.
template <typename T, bool RES, bool DROP>
int launch(const void* p, const void* q, const void* a, const void* bias,
           const void* v, void* out, int B, int N, int E, int D, int row_blocks, float alpha,
           Residuals res, void* stream) {
  if (row_blocks > 0)
    return launch_graph<T, RES, DROP>(p, q, a, bias, v, out, B, N, E, D, row_blocks, alpha,
                                      res, stream);
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gatv2_fwd_kernel<T, RES, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_tiles = (N + BI - 1) / BI;
  gatv2_fwd_kernel<T, RES, DROP><<<B * row_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const float*)bias, (const T*)v,
      (T*)out, N, E, D, row_tiles, alpha, res);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_res(const void* p, const void* q, const void* a, const void* bias,
               const void* v, void* out, void* u, void* m, void* l, const void* seed,
               int B, int N, int E, int D, int row_blocks, float alpha, unsigned int thresh,
               float scale, void* stream) {
  const Residuals res{(float*)u, (float*)m, (float*)l, (const long long*)seed, thresh, scale};
  if (seed == nullptr)
    return launch<T, true, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks, alpha, res,
                                  stream);
  return launch<T, true, true>(p, q, a, bias, v, out, B, N, E, D, row_blocks, alpha, res,
                               stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the tiled kernel needs at value width D.
long gatv2_fwd_smem_bytes(int D) { return (long)(smem_floats(D) * sizeof(float)); }

// Bytes of shared memory one block of the whole-graph kernel needs, and the
// embedding splits of its score pass.
long gatv2_fwd_graph_smem_bytes(int N, int E, int D, int row_blocks) {
  return (long)(FwdLayout(N, E, D, row_blocks).floats() * sizeof(float));
}
int gatv2_fwd_graph_split() { return G_SPLIT; }

// K1: the forward alone (scoring). row_blocks as launch() takes it.
int gatv2_fwd_f32(const void* p, const void* q, const void* a, const void* bias,
                  const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                  float alpha, void* stream) {
  return launch<float, false, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks, alpha,
                                     Residuals{}, stream);
}

int gatv2_fwd_bf16(const void* p, const void* q, const void* a, const void* bias,
                   const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                   float alpha, void* stream) {
  return launch<__nv_bfloat16, false, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                             alpha, Residuals{}, stream);
}

// K1-res: the forward with residuals; dropout when seed is not null.
int gatv2_fwd_res_f32(const void* p, const void* q, const void* a, const void* bias,
                      const void* v, void* out, void* u, void* m, void* l,
                      const void* seed, int B, int N, int E, int D, int row_blocks,
                      float alpha, unsigned int thresh, float scale, void* stream) {
  return launch_res<float>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D, row_blocks,
                           alpha, thresh, scale, stream);
}

int gatv2_fwd_res_bf16(const void* p, const void* q, const void* a, const void* bias,
                       const void* v, void* out, void* u, void* m, void* l,
                       const void* seed, int B, int N, int E, int D, int row_blocks,
                       float alpha, unsigned int thresh, float scale, void* stream) {
  return launch_res<__nv_bfloat16>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D,
                                   row_blocks, alpha, thresh, scale, stream);
}

}  // extern "C"
