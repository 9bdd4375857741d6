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
// - gatv2_fwd_tiled_kernel, the tiled variant for larger graphs and any
//   width: 64 x 64 score tiles of 4 x 4 register micro-tiles, an online
//   softmax, the key loop cut into slices whose partials
//   gatv2_fwd_merge_kernel combines; its section below says more.
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
// are of the same order, and above them the work dominates.
//
// Layouts are those of gatv2_attention_fused: p, q (B, N, E), v (B, N, D),
// a (E,), bias (N, N) float32 or null, out (B, N, D) in v's type; u
// (B, N, D), m and l (B, N) float32. p, q, a and v share one type (float32
// or bfloat16; float32 for the tiled kernel, whose wrapper widens bfloat16);
// all arithmetic is float32.
//
// The entity axis (fleet serving and training, the counterpart of JAX's
// batching rule for pallas_call under vmap): the B batch elements form G =
// B / rows_per_group groups of consecutive elements, and element b reads the
// attention vector a + g E and the bias + g N N of its group g = b /
// rows_per_group, so a is (G, E) and bias (G, N, N). With dropout it reads
// its group's seed, seed[g] (G values), and hashes its batch index within
// the group, b - g rows_per_group, so each group's mask is that of its own
// ungrouped launch (the JAX kernel's program_id(0) under vmap is the
// entity's own). Both kernels take it in K1 and K1-res (the tiled K1-res
// since fleet training at long windows); the merge does not change: it
// works row by row. The group arithmetic is a
// compile-time flag (GROUPED): at rows_per_group = B (G = 1) the launch runs
// the ungrouped instantiation, whose code is the kernel's without the axis
// (the same registers and bits).

#include "gat_common.cuh"

namespace {

using namespace gat;

struct Residuals {
  float* u;                                 // (B, N, D)
  float* m;                                 // (B, N)
  float* l;                                 // (B, N)
  const long long* seed;                    // one value, low 32 bits used
  uint32_t thresh;                          // keep when hash < thresh
  float scale;                              // 1 / (1 - rate)
};

// ---- the tiled forward: 64 x 64 score tiles, slices of the key loop --------
//
// A block owns 64 query rows of one batch element and walks a slice of the
// key tiles of 64; 256 threads, each a 4 x 4 register micro-tile of pairs
// (rows ti + 16 r, keys tj + 16 c). The design is the tiled K2a and K2b's
// (gat_bwd.cu; PERF.md, section 6):
//
// - the score: score_tile (gat_common.cuh), the routine K2a and K2b call, so
//   the backward recomputes these scores bit for bit: float4 reads of p, q
//   and a from shared memory, one read feeding 4 pairs, each pair one fmaf
//   chain over e in order. The embedding is staged in chunks of at most
//   FWD_EC_MAX floats; up to that width it is one chunk and the block's rows
//   of p are staged once. The chain runs on across chunks, so any width is
//   taken and w does not depend on the chunking;
// - an online softmax in registers: the 16 threads of a row (a half warp)
//   take the tile's row max and sum by xor shuffles, each first over its own
//   4 keys in order; m and l run per row, exp is taken once per pair, and the
//   hash dropout mask (drop_hash of the global (seed, b, i, j)) applies to
//   the aggregate's weights only while l sums the unmasked ones;
// - the aggregate as a register tile: the same thread owns rows ti + 16 r
//   and columns 4 tj .. 4 tj + 3 of a 64-column chunk of D, fed per 4 keys
//   by four float4 reads of the weights and four of v, 64 fmaf per 8 reads,
//   the keys in order. A tile's weights are computed once into shared memory
//   and applied to each staged D chunk of v. With one chunk (D <= 64) the
//   running aggregate stays in registers; with more it lives in the block's
//   rows of the float32 partial, each element read and written by its one
//   owner thread, as the WIDE backward tile keeps its sums;
// - batch 1 fills the card: the key loop is cut into `slices` blocks of its
//   own (kernels/gat.gat_tiled_fwd_plan), each writing its rows' (m, l,
//   aggregate) partials; gatv2_fwd_merge_kernel combines them in slice order
//   (m = max_s m_s, l = sum_s l_s e^(m_s - m), u = sum_s acc_s e^(m_s - m) / l)
//   and writes out, u, m and l. No atomics: two launches give identical bits;
// - staging by cp.async with zero fill (ragged rows and keys, padded widths),
//   one buffer each: the first D chunk of v is copied beside the tile's q and
//   lands while the score runs. Two blocks a multiprocessor (16 warps), as
//   measured best for the tiled backward; no second buffer, which cost the
//   backward a block a multiprocessor.

constexpr int FWD_RI = 64, FWD_KJ = 64;                  // rows and keys of a score tile
constexpr int FWD_THREADS = FWD_RI * FWD_KJ / 16;        // one 4 x 4 micro-tile each
constexpr int FWD_RG = FWD_RI / 4, FWD_KG = FWD_KJ / 4;  // threads along rows and keys
constexpr int FWD_EC_MAX = 128;       // most embedding columns staged at once
constexpr int FWD_DC = 4 * FWD_KG;    // columns of D an aggregate chunk: 4 a thread
constexpr int FWD_WS = FWD_KJ + 16;   // stride of the weights: a warp's two rows 16 banks apart

static_assert(FWD_RI == FWD_KJ, "the row tiles are the key tiles");

struct TiledFwdLayout {
  int EC;    // embedding columns a chunk, a multiple of 4: E up to FWD_EC_MAX, else E split evenly
  int NE;    // chunks of E
  int ECP;   // stride of p and q: an odd number of 16-byte units
  int ND;    // chunks of D, FWD_DC columns each
  __host__ __device__ TiledFwdLayout(int E, int D) {
    const int n = (E + FWD_EC_MAX - 1) / FWD_EC_MAX;
    EC = up4((E + n - 1) / n);
    NE = (E + EC - 1) / EC;
    ECP = stride4(EC);
    ND = (D + FWD_DC - 1) / FWD_DC;
  }
  // p [RI][ECP], q [KJ][ECP], a [ECP], v [KJ][DC], the weights [RI][WS]
  __host__ __device__ size_t floats() const {
    return (size_t)(FWD_RI + FWD_KJ + 1) * ECP + (size_t)FWD_KJ * FWD_DC +
           (size_t)FWD_RI * FWD_WS;
  }
};

struct TiledFwdArgs {
  const float* bias;        // (G, N, N) or null
  const long long* seed;    // one value (G with the entity axis), or null without dropout
  int B, N, E, D;
  float alpha;
  uint32_t thresh;
  float scale;
  int rows_per_group;       // batch elements a group of a and bias: B / G
};

// The max and the sum over the 16 lanes of a half warp (a row's threads).
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A block per (slice, batch element, row tile). Partials: acc (S, B, N, D),
// m and l (S, B, N), float32.
template <bool DROP, bool GROUPED>
__global__ void __launch_bounds__(FWD_THREADS, 2)
gatv2_fwd_tiled_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ a, const float* __restrict__ v, TiledFwdArgs g,
                       float* __restrict__ acc_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int slices) {
  extern __shared__ __align__(16) float smem[];
  const TiledFwdLayout L(g.E, g.D);
  float* p_s = smem;                        // [RI][ECP], the block's rows, a chunk of E
  float* q_s = p_s + FWD_RI * L.ECP;        // [KJ][ECP], the key tile, the same chunk
  float* a_s = q_s + FWD_KJ * L.ECP;        // [ECP]
  float* v_s = a_s + L.ECP;                 // [KJ][DC], the key tile, a chunk of D
  float* w_s = v_s + FWD_KJ * FWD_DC;       // [RI][WS], the tile's aggregate weights
  const int N = g.N, E = g.E, D = g.D;
  const int tiles = (N + FWD_RI - 1) / FWD_RI;
  const int rt = blockIdx.x % tiles, sb = blockIdx.x / tiles;
  const int b = sb % g.B, sl = sb / g.B;
  const int grp = GROUPED ? b / g.rows_per_group : 0;
  const int i0 = rt * FWD_RI;
  const int t_begin = slice_begin(sl, tiles, slices), t_end = slice_begin(sl + 1, tiles, slices);
  const int ti = threadIdx.x / FWD_KG, tj = threadIdx.x % FWD_KG;
  const float* pb = p + (size_t)b * N * E;
  const float* qb = q + (size_t)b * N * E;
  const float* vb = v + (size_t)b * N * D;
  const size_t row0 = (size_t)(sl * g.B + b) * N;   // row 0 of this slice and batch element
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(a);
  const bool vec_d = D % 4 == 0 && aligned16(v);
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)(unsigned long long)(GROUPED ? g.seed[grp] : *g.seed);
  // the hash's batch index: within the group (GROUPED), else the call's
  const int bh = GROUPED ? b - grp * g.rows_per_group : b;
  const int dw0 = min(FWD_DC, D);

  float m[4], l[4], acc[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = NEG_BIG, l[r] = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * FWD_KJ;
    // 1. the score, chunk by chunk of E; the first chunk of v lands meanwhile
    float s[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = 0.f;
    for (int c = 0; c < L.NE; ++c) {
      const int e0 = c * L.EC, ew = min(L.EC, E - e0), groups = (ew + 3) / 4;
      if (c > 0) __syncthreads();  // the last chunk's readers are done
      if (L.NE > 1 || t == t_begin) {
        copy_tile_async(p_s, L.ECP, groups, pb + e0, E, i0, FWD_RI, N, ew, vec_e, FWD_THREADS);
        copy_tile_async(a_s, L.ECP, groups, (GROUPED ? a + (size_t)grp * E : a) + e0, E, 0,
                        1, 1, ew, vec_e, FWD_THREADS);
      }
      copy_tile_async(q_s, L.ECP, groups, qb + e0, E, j0, FWD_KJ, N, ew, vec_e, FWD_THREADS);
      cp_async_commit();
      if (c == 0) {
        copy_tile_async(v_s, FWD_DC, (dw0 + 3) / 4, vb, D, j0, FWD_KJ, N, dw0, vec_d,
                        FWD_THREADS);
        cp_async_commit();
        cp_async_wait_one();  // the chunk of E has arrived; v may still be on its way
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      score_tile<FWD_RG, FWD_KG>(p_s, L.ECP, q_s, L.ECP, a_s, groups, ti, tj, g.alpha, s);
    }

    // 2. the online softmax of the tile, in registers; the aggregate's weights
    // (dropout applied, not normalised) to shared memory
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ti + FWD_RG * r;
      float mx = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tj + FWD_KG * c;
        float sv = s[4 * r + c];
        if (j >= N)
          sv = NEG_BIG;
        else if (g.bias != nullptr && i < N)
          sv += __ldg(g.bias + (GROUPED ? ((size_t)grp * N + i) * N : (size_t)i * N) + j);
        s[4 * r + c] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      corr[r] = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tj + FWD_KG * c;
        const float ex = expf(s[4 * r + c] - m_new);
        sum += ex;
        float agg = ex;
        if constexpr (DROP) {
          agg = drop_hash(seed, (uint32_t)bh, (uint32_t)i, (uint32_t)j) < g.thresh
                    ? ex * g.scale : 0.f;
        }
        w_s[(ti + FWD_RG * r) * FWD_WS + tj + FWD_KG * c] = agg;
      }
      l[r] = l[r] * corr[r] + half_warp_sum(sum);
      m[r] = m_new;
    }
    cp_async_wait_all();
    __syncthreads();  // the weights and the first chunk of v are complete

    // 3. acc = acc * corr + w . v, chunk by chunk of D
    const int kn4 = up4(min(FWD_KJ, N - j0));
    for (int dc = 0; dc < L.ND; ++dc) {
      const int d0 = dc * FWD_DC, dw = min(FWD_DC, D - d0);
      if (dc > 0) {
        __syncthreads();  // the last chunk's readers are done
        copy_tile_async(v_s, FWD_DC, (dw + 3) / 4, vb + d0, D, j0, FWD_KJ, N, dw, vec_d,
                        FWD_THREADS);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      if (4 * tj >= dw) continue;
      float* part = acc_part + (row0 + i0) * D + d0 + 4 * tj;  // + row * D + k
      if (L.ND > 1) {  // this chunk's running aggregate lives in the partial
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int rl = ti + FWD_RG * r;
            acc[4 * r + k] = t > t_begin && i0 + rl < N && 4 * tj + k < dw
                                 ? part[(size_t)rl * D + k] : 0.f;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[4 * r + k] *= corr[r];
      for (int j = 0; j < kn4; j += 4) {
        float4 wr[4], vc[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          wr[x] = load4(w_s + (ti + FWD_RG * x) * FWD_WS + j);
          vc[x] = load4(v_s + (j + x) * FWD_DC + 4 * tj);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float vk[4] = {vc[c].x, vc[c].y, vc[c].z, vc[c].w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = c == 0 ? wr[r].x : c == 1 ? wr[r].y : c == 2 ? wr[r].z : wr[r].w;
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[4 * r + k] = fmaf(w, vk[k], acc[4 * r + k]);
          }
        }
      }
      if (L.ND > 1 || t == t_end - 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int rl = ti + FWD_RG * r;
            if (i0 + rl < N && 4 * tj + k < dw) part[(size_t)rl * D + k] = acc[4 * r + k];
          }
      }
    }
    if (t + 1 < t_end) __syncthreads();  // the readers of w and v are done before the next copies
  }
  if (tj == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ti + FWD_RG * r;
      if (i < N) m_part[row0 + i] = m[r], l_part[row0 + i] = l[r];
    }
  }
}

// out (and with RES u, m, l) of every row from the S slices' partials, the
// slices in order: m = max_s m_s, l = sum_s l_s e^(m_s - m), u = sum_s acc_s
// e^(m_s - m) / l. With one slice u = acc / l exactly.
template <typename T, bool RES>
__global__ void gatv2_fwd_merge_kernel(const float* __restrict__ acc_part,
                                       const float* __restrict__ m_part,
                                       const float* __restrict__ l_part, T* __restrict__ out,
                                       Residuals res, long long rows, int D, int S) {
  const long long n = rows * D;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < n;
       x += (long long)gridDim.x * blockDim.x) {
    const long long r = x / D;
    float m = NEG_BIG;
    for (int s = 0; s < S; ++s) m = fmaxf(m, m_part[s * rows + r]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float c = expf(m_part[s * rows + r] - m);
      l = fmaf(l_part[s * rows + r], c, l);
      acc = fmaf(acc_part[s * n + x], c, acc);
    }
    const float u = acc / l;
    out[x] = from_f<T>(1.f / (1.f + expf(-u)));
    if constexpr (RES) {
      res.u[x] = u;
      if (x % D == 0) res.m[r] = m, res.l[r] = l;
    }
  }
}

template <bool DROP, bool GROUPED>
int tiled_launch(const float* p, const float* q, const float* a, const float* v,
                 const TiledFwdArgs& g, float* acc_part, float* m_part, float* l_part,
                 int slices, void* stream, int* occupancy) {
  auto kernel = gatv2_fwd_tiled_kernel<DROP, GROUPED>;
  const size_t bytes = TiledFwdLayout(g.E, g.D).floats() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, FWD_THREADS,
                                                              bytes);
  const long long blocks = (long long)slices * g.B * ((g.N + FWD_RI - 1) / FWD_RI);
  if (slices < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, FWD_THREADS, bytes, (cudaStream_t)stream>>>(
      p, q, a, v, g, acc_part, m_part, l_part, slices);
  return (int)cudaGetLastError();
}

template <typename T>
int merge(const void* acc_part, const void* m_part, const void* l_part, void* out, void* u,
          void* m, void* l, int B, int N, int D, int S, void* stream) {
  const long long rows = (long long)B * N, n = rows * D;
  const long long blocks = (n + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 65536 ? blocks : 65536);
  const Residuals res{(float*)u, (float*)m, (float*)l, nullptr, 0u, 1.f};
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (u != nullptr)
    gatv2_fwd_merge_kernel<T, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)acc_part, (const float*)m_part, (const float*)l_part, (T*)out, res, rows,
        D, S);
  else
    gatv2_fwd_merge_kernel<T, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)acc_part, (const float*)m_part, (const float*)l_part, (T*)out, res, rows,
        D, S);
  return (int)cudaGetLastError();
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

template <typename T, bool RES, bool DROP, bool GROUPED>
__global__ void __launch_bounds__(G_MAX_THREADS, 1)
gatv2_fwd_graph_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const float* __restrict__ bias,
                       const T* __restrict__ v, T* __restrict__ out, int N, int E, int D,
                       int row_blocks, int rows_per_group, float alpha, Residuals res) {
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
  const int grp = GROUPED ? b / rows_per_group : 0;
  if constexpr (GROUPED) {
    if (bias != nullptr) bias += (size_t)grp * N * N;
  }
  const int rows = min(L.RB, N - i0);
  const int nt = blockDim.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bNE = (size_t)b * N * E, bND = (size_t)b * N * D;
  const int EG = (E + 3) / 4, DG = (D + 3) / 4, TR = L.RB / 4, TC = L.N4 / 4;

  stage_padded(p_s, p + bNE + (size_t)i0 * E, rows, E, L.RB, L.EP);
  stage_padded(q_s, q + bNE, N, E, L.N4, L.EP);
  stage_padded(a_s, GROUPED ? a + (size_t)grp * E : a, 1, E, 1, L.EP);
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
  if constexpr (DROP && GROUPED) seed = (uint32_t)(unsigned long long)res.seed[grp];
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
        if constexpr (DROP && GROUPED) {      // the batch index within the group
          agg = drop_hash(seed, (uint32_t)(b - grp * rows_per_group), (uint32_t)i, (uint32_t)j)
                        < res.thresh ? ex * res.scale : 0.f;
        } else if constexpr (DROP) {
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

template <typename T, bool RES, bool DROP, bool GROUPED>
int launch_graph(const void* p, const void* q, const void* a, const void* bias,
                 const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                 int rows_per_group, float alpha, Residuals res, void* stream) {
  auto kernel = gatv2_fwd_graph_kernel<T, RES, DROP, GROUPED>;
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
      D, row_blocks, rows_per_group, alpha, res);
  return (int)cudaGetLastError();
}

// The whole-graph kernel, the graph's rows over row_blocks >= 1 blocks, the
// batch in groups of rows_per_group elements (B: one group, the ungrouped
// instantiation).
template <typename T, bool RES, bool DROP>
int launch(const void* p, const void* q, const void* a, const void* bias,
           const void* v, void* out, int B, int N, int E, int D, int row_blocks,
           int rows_per_group, float alpha, Residuals res, void* stream) {
  if (row_blocks < 1 || rows_per_group < 1 || B % rows_per_group != 0)
    return (int)cudaErrorInvalidValue;
  if (rows_per_group != B)
    return launch_graph<T, RES, DROP, true>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                            rows_per_group, alpha, res, stream);
  return launch_graph<T, RES, DROP, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                           rows_per_group, alpha, res, stream);
}

template <typename T>
int launch_res(const void* p, const void* q, const void* a, const void* bias,
               const void* v, void* out, void* u, void* m, void* l, const void* seed,
               int B, int N, int E, int D, int row_blocks, int rows_per_group, float alpha,
               unsigned int thresh, float scale, void* stream) {
  const Residuals res{(float*)u, (float*)m, (float*)l, (const long long*)seed, thresh, scale};
  if (seed == nullptr)
    return launch<T, true, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                  rows_per_group, alpha, res, stream);
  return launch<T, true, true>(p, q, a, bias, v, out, B, N, E, D, row_blocks, rows_per_group,
                               alpha, res, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the whole-graph kernel needs, and the
// embedding splits of its score pass.
long gatv2_fwd_graph_smem_bytes(int N, int E, int D, int row_blocks) {
  return (long)(FwdLayout(N, E, D, row_blocks).floats() * sizeof(float));
}
int gatv2_fwd_graph_split() { return G_SPLIT; }

// K1: the forward alone (scoring), the whole-graph kernel on row_blocks >= 1
// blocks a graph; a (B / rows_per_group, E) and bias (B / rows_per_group, N,
// N), one of each a group of rows_per_group batch elements.
int gatv2_fwd_f32(const void* p, const void* q, const void* a, const void* bias,
                  const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                  int rows_per_group, float alpha, void* stream) {
  return launch<float, false, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                     rows_per_group, alpha, Residuals{}, stream);
}

int gatv2_fwd_bf16(const void* p, const void* q, const void* a, const void* bias,
                   const void* v, void* out, int B, int N, int E, int D, int row_blocks,
                   int rows_per_group, float alpha, void* stream) {
  return launch<__nv_bfloat16, false, false>(p, q, a, bias, v, out, B, N, E, D, row_blocks,
                                             rows_per_group, alpha, Residuals{}, stream);
}

// K1-res: the whole-graph forward with residuals; dropout when seed is not
// null (B / rows_per_group values, one a group); a and bias grouped as K1's.
int gatv2_fwd_res_f32(const void* p, const void* q, const void* a, const void* bias,
                      const void* v, void* out, void* u, void* m, void* l,
                      const void* seed, int B, int N, int E, int D, int row_blocks,
                      int rows_per_group, float alpha, unsigned int thresh, float scale,
                      void* stream) {
  return launch_res<float>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D, row_blocks,
                           rows_per_group, alpha, thresh, scale, stream);
}

int gatv2_fwd_res_bf16(const void* p, const void* q, const void* a, const void* bias,
                       const void* v, void* out, void* u, void* m, void* l,
                       const void* seed, int B, int N, int E, int D, int row_blocks,
                       int rows_per_group, float alpha, unsigned int thresh, float scale,
                       void* stream) {
  return launch_res<__nv_bfloat16>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D,
                                   row_blocks, rows_per_group, alpha, thresh, scale, stream);
}

// The tiled forward's layout at widths E and D, for the planner's check
// (kernels/gat._tiled_fwd_plan): out = rows, keys, threads, embedding chunk,
// D chunk, shared-memory bytes of a block.
void gatv2_fwd_tiled_layout(int E, int D, long* out) {
  const TiledFwdLayout L(E, D);
  out[0] = FWD_RI, out[1] = FWD_KJ, out[2] = FWD_THREADS, out[3] = L.EC, out[4] = FWD_DC;
  out[5] = (long)(L.floats() * sizeof(float));
}

// Blocks of the tiled forward (with dropout or not) one multiprocessor holds
// at once at widths E, D (CUDA's occupancy calculator); negative on an error.
int gatv2_fwd_tiled_occupancy(int E, int D, int drop) {
  long long one = 0;
  const TiledFwdArgs g{nullptr, drop ? &one : nullptr, 1, 1, E, D, 0.f, 0u, 1.f, 1};
  int blocks = 0;
  const int err = drop ? tiled_launch<true, false>(nullptr, nullptr, nullptr, nullptr, g,
                                                   nullptr, nullptr, nullptr, 1, nullptr,
                                                   &blocks)
                       : tiled_launch<false, false>(nullptr, nullptr, nullptr, nullptr, g,
                                                    nullptr, nullptr, nullptr, 1, nullptr,
                                                    &blocks);
  return err ? -err : blocks;
}

// The tiled K1 and K1-res before their merge: p, q, a, v float32 (the caller
// widens bfloat16), dropout when seed is not null (B / rows_per_group values,
// one a group); a and bias grouped as K1's, rows_per_group = B for one group;
// writes the slices' partials acc_part (slices, B, N, D), m_part and l_part
// (slices, B, N).
int gatv2_fwd_tiled(const void* p, const void* q, const void* a, const void* bias,
                    const void* v, const void* seed, void* acc_part, void* m_part,
                    void* l_part, int B, int N, int E, int D, int slices, int rows_per_group,
                    float alpha, unsigned int thresh, float scale, void* stream) {
  if (rows_per_group < 1 || B % rows_per_group != 0) return (int)cudaErrorInvalidValue;
  const TiledFwdArgs g{(const float*)bias, (const long long*)seed, B, N, E, D, alpha, thresh,
                       scale, rows_per_group};
  const float *pf = (const float*)p, *qf = (const float*)q, *af = (const float*)a,
              *vf = (const float*)v;
  float *acc = (float*)acc_part, *mp = (float*)m_part, *lp = (float*)l_part;
  if (rows_per_group != B)   // the entity axis
    return seed ? tiled_launch<true, true>(pf, qf, af, vf, g, acc, mp, lp, slices, stream,
                                           nullptr)
                : tiled_launch<false, true>(pf, qf, af, vf, g, acc, mp, lp, slices, stream,
                                            nullptr);
  return seed ? tiled_launch<true, false>(pf, qf, af, vf, g, acc, mp, lp, slices, stream,
                                          nullptr)
              : tiled_launch<false, false>(pf, qf, af, vf, g, acc, mp, lp, slices, stream,
                                           nullptr);
}

// The merge of the tiled forward's partials: out (B, N, D) in T, and where u
// is not null u (B, N, D), m and l (B, N) float32.
int gatv2_fwd_merge_f32(const void* acc_part, const void* m_part, const void* l_part,
                        void* out, void* u, void* m, void* l, int B, int N, int D, int slices,
                        void* stream) {
  return merge<float>(acc_part, m_part, l_part, out, u, m, l, B, N, D, slices, stream);
}
int gatv2_fwd_merge_bf16(const void* acc_part, const void* m_part, const void* l_part,
                         void* out, void* u, void* m, void* l, int B, int N, int D, int slices,
                         void* stream) {
  return merge<__nv_bfloat16>(acc_part, m_part, l_part, out, u, m, l, B, N, D, slices, stream);
}

}  // extern "C"
