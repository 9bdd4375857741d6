// The streamed attention backward for Hopper (sm_90a): K2a and K2b, with
// K2c's dbias, for wide feature layers, in two passes.
//
// Replaces, where kernels/gat.gat_bwd_route names "streamed" (the tiled plan
// would run the CHUNKED tile of gat_bwd.cu and the graph has N <= NMAX
// nodes: the SMD, MSL and SMAP feature layers, N 38, 55 and 25, from window
// 236 on), the CHUNKED K2a and K2b, which port the JAX package's
// mtad_gat_tpu/kernels/gat_pallas.py::_bwd_dp_da_kernel (:454) and
// _bwd_dq_dv_kernel (:497), and _bwd_dbias_kernel's (:540) sum, all launched
// from _fused_backward (:596-743). The functions are gat_bwd.cu's (its
// header has the formulas): dp, dq (B, N, E), dv (B, N, D), da (E,) and
// dbias (N, N) = sum_b ds.
//
// A feature layer is a small graph of very wide rows: at lookback 1024 a
// batch element's ds is 38 x 38 floats (5.8 KB), its p and q 311 KB each.
// The CHUNKED tile cut the pairs into 16 x 32 tiles, one warp a block, and
// streamed E and D through each tile twice (score, then contraction), with
// every chunk's copy exposed and the running sums in a global partial. Here
// each pair is scored once and the contraction is split over E and D:
//
// - the score pass (gatv2_streamed_score_kernel): a block per (batch
//   element, row tile of `rows` rows) against all of its keys, a thread per
//   key and MR rows (2 from row tiles of 8, sharing the key's staged q and
//   v, else 1), so that the pairs and the batch, not a split of E, fill the
//   card: the row tile leaves the busiest multiprocessor the least work
//   (kernels/gat.streamed_rows: 10 rows, 256 blocks, two a multiprocessor at
//   lookback 1024). E, then D, is staged 64 floats at a time through a ring
//   of RING buffers by cp.async, chunk k + 1 copying while chunk k is
//   scored. Each pair's score is one fmaf chain over e in order through
//   score4 (gat_common.cuh), continued across chunks, so w equals the tiled
//   K1-res's bit for bit; du . v is one chain over d. ds and wa come from
//   pair_ds, as in the tiled K2a and K2b, and are written as (B, N, N)
//   float32, 5.8 KB each a batch element. (A 2 x 2 micro-tile a thread, the
//   first design, left a warp a multiprocessor at batch 8: PERF.md.)
// - the contraction pass (gatv2_streamed_contract_kernel): a block per
//   (batch element, 128 columns of E) holds that element's ds in shared
//   memory, a thread per column e with q_je and the running dq_je of every
//   key in registers (KEYS of them, N up to a multiple of 8) and its column
//   of p copied into shared memory by cp.async at the start, all rows in
//   flight at once: for row i in order, z = p_ie + q_je and t = lo ds_ij
//   with z's sign bit flipped in (one logic op; lo = (1 - alpha) / 2, hi =
//   (1 + alpha) / 2, so ds lr'(z) = hi ds + t), dp_ie = a_e (hi R_i + sum_j
//   t), dq_je = a_e (hi C_j + sum_i t) with R and C the row and column sums
//   of ds, and da_e = sum_i p_ie hi R_i + sum_j q_je hi C_j + lo sum_ij ds_ij
//   |z_ije| (ds lr(z) = hi ds z + lo ds |z|): five operations an (i, j, e)
//   and p, q read once. Blocks per (batch element, 128 columns of D) write
//   dv_jd = sum_i wa_ij du_id the same way, and with dbias a few blocks sum
//   ds over the batch in order of b, an entry a thread. dp, dq and dv are
//   written once, in their type, by their one owner thread; da_part (B, E)
//   float32 holds one row a batch element, which the caller sums.
//
// No atomics, no partial sums of the outputs in device memory and no
// reduce: two launches give the same bits. What bounds it on the card:
// reading p, q, v and du and writing dp, dq and dv once (about 110 MB at
// lookback 1024, 0.033 ms at 3.35 TB/s), with its float32 operations close
// behind (8E + 4D + 5 a pair on the CUDA cores, no product structure for
// the tensor cores: 0.028 ms). Each input crosses device memory once here
// (the keys' q and v once a row tile, from L2), each output once; only ds
// and wa make a round trip: scratch of (B, N, N) float32 each and da_part
// (B, E), 1.3 MB at lookback 1024.
//
// Layouts: p, q (B, N, E), a (E,), v and du (B, N, D), bias (N, N) or
// null, m, l, dvec (B, N), all float32 (the wrapper widens bfloat16 inputs,
// exactly); dp, dq, dv written in T (float32 or bfloat16).

#include "gat_common.cuh"

namespace {

using namespace gat;

constexpr int SC = 64;                // floats of E or D a score block stages at once
constexpr int SCP = stride4(SC);      // a staged row's stride: an odd number of 16-byte units
constexpr int RING = 2;               // staging buffers of the score pass
constexpr int ROWS_MAX = 16;          // the largest row tile of the score pass
constexpr int CW = 128;               // columns of E or D a contraction block owns, a thread each
constexpr int NMAX = 64;              // most keys a contraction thread holds in registers
constexpr int KEY_STEP = 8;           // they come in steps of 8

// The score pass's threads, one a key and MR rows of its row tile, up to
// whole warps; its shared memory: RING buffers of a chunk of the row tile's
// p or du [rows][SCP], of the keys' q or v [N][SCP] and of a [SCP], then m,
// l and dvec [rows].
__host__ __device__ inline int score_threads(int N, int rows, int mr) {
  return (rows / mr * N + 31) / 32 * 32;
}
__host__ __device__ inline size_t score_floats(int N, int rows) {
  return (size_t)RING * (rows + N + 1) * SCP + 3 * (size_t)rows;
}

// Keys a contraction thread holds (N up to a multiple of KEY_STEP; 0 above
// NMAX) and the contraction block's shared memory: ds or wa [N][KEYS], lo ds
// [N][KEYS], hi R [N], hi C [KEYS], the block's columns of p or du [N][CW].
__host__ __device__ inline int key_regs(int N) {
  return N < 1 || N > NMAX ? 0 : (N + KEY_STEP - 1) / KEY_STEP * KEY_STEP;
}
__host__ __device__ inline size_t contract_floats(int N) {
  const int nr = key_regs(N);
  return (size_t)2 * N * nr + N + nr + (size_t)N * CW;
}

// The score pass: a block per (batch element, row tile), grid B x
// ceil(N / rows), a thread per key j = x % N and MR rows x / N + k rows / MR
// (k < MR) of the row tile: MR pairs sharing the key's staged q and v.
// ds_out and wa_out (B, N, N) float32.
template <bool DROP, int MR>
__global__ void __launch_bounds__(1024)
gatv2_streamed_score_kernel(const float* __restrict__ p, const float* __restrict__ q,
                            const float* __restrict__ a, const float* __restrict__ v,
                            Args g, float* __restrict__ ds_out,
                            float* __restrict__ wa_out, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D, nt = blockDim.x;
  const int row_tiles = (N + rows - 1) / rows;
  const int b = blockIdx.x / row_tiles, i0 = blockIdx.x % row_tiles * rows;
  const int buf_floats = (rows + N + 1) * SCP;
  const float* m_s = smem + RING * buf_floats;   // m, l, dvec of the row tile
  const float* l_s = m_s + rows;
  const float* dvec_s = l_s + rows;
  const int rg = threadIdx.x / N, j = threadIdx.x % N, span = rows / MR;
  const bool live = rg < span && i0 + rg < N;
  int rl[MR];
  bool in[MR];
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    rl[k] = rg + k * span;
    in[k] = live && i0 + rl[k] < N;
  }
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(a);
  const bool vec_d = D % 4 == 0 && aligned16(v) && aligned16(g.du);
  const float* pb = p + (size_t)b * N * E;
  const float* qb = q + (size_t)b * N * E;
  const float* dub = g.du + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * D;
  const int ne = (E + SC - 1) / SC, nc = ne + (D + SC - 1) / SC;
  // chunk c (E chunks, then D chunks) into buffer c % RING, one commit
  // group; a ragged last chunk's columns beyond the width read as zero
  auto stage = [&](int c) {
    float* x_s = smem + (c % RING) * buf_floats;
    float* y_s = x_s + rows * SCP;
    if (c < ne) {
      const int e0 = c * SC, ew = min(SC, E - e0);
      copy_tile_async(x_s, SCP, SC / 4, pb + e0, E, i0, rows, N, ew, vec_e, nt);
      copy_tile_async(y_s, SCP, SC / 4, qb + e0, E, 0, N, N, ew, vec_e, nt);
      copy_tile_async(y_s + N * SCP, SCP, SC / 4, a + e0, E, 0, 1, 1, ew, vec_e, nt);
    } else {
      const int d0 = (c - ne) * SC, dw = min(SC, D - d0);
      copy_tile_async(x_s, SCP, SC / 4, dub + d0, D, i0, rows, N, dw, vec_d, nt);
      copy_tile_async(y_s, SCP, SC / 4, vb + d0, D, 0, N, N, dw, vec_d, nt);
    }
    if (c == 0) {
      float* st = smem + RING * buf_floats;
      copy_vec_async(st, g.m + (size_t)b * N, i0, rows, N, nt);
      copy_vec_async(st + rows, g.l + (size_t)b * N, i0, rows, N, nt);
      copy_vec_async(st + 2 * rows, g.dvec + (size_t)b * N, i0, rows, N, nt);
    }
    cp_async_commit();
  };

  float s[MR], dot[MR], bv[MR];
  // the bias, loaded first: its latency hides behind the chunks
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    s[k] = dot[k] = 0.f;
    bv[k] = g.bias != nullptr && in[k] ? __ldg(g.bias + (size_t)(i0 + rl[k]) * N + j) : 0.f;
  }
  stage(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage(c + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c has arrived
    const float* x_s = smem + (c % RING) * buf_floats;
    const float* y_s = x_s + (rows + j) * SCP;
    if (live && c < ne) {
      const int groups = (min(SC, E - c * SC) + 3) / 4;
      const float* a_s = x_s + (rows + N) * SCP;
#pragma unroll 4
      for (int eg = 0; eg < groups; ++eg) {
        const float4 qv = load4(y_s + 4 * eg), av = load4(a_s + 4 * eg);
#pragma unroll
        for (int k = 0; k < MR; ++k)
          s[k] = score4(load4(x_s + rl[k] * SCP + 4 * eg), qv, av, s[k], g.alpha);
      }
    } else if (live) {
      const int groups = (min(SC, D - (c - ne) * SC) + 3) / 4;
#pragma unroll 4
      for (int dg = 0; dg < groups; ++dg) {
        const float4 w = load4(y_s + 4 * dg);
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          const float4 u = load4(x_s + rl[k] * SCP + 4 * dg);
          dot[k] = fmaf(u.x, w.x, dot[k]);
          dot[k] = fmaf(u.y, w.y, dot[k]);
          dot[k] = fmaf(u.z, w.z, dot[k]);
          dot[k] = fmaf(u.w, w.w, dot[k]);
        }
      }
    }
    __syncthreads();  // the chunk's readers are done before its buffer is restaged
  }
  const uint32_t seed = read_seed(g);
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    if (!in[k]) continue;
    const int r = rl[k], i = i0 + r;
    float dsv, wav;
    pair_ds<DROP>(s[k], dot[k], bv[k], g.bias != nullptr, m_s[r], l_s[r], dvec_s[r], seed,
                  g.thresh, g.scale, b, i, j, dsv, wav);
    const size_t o = ((size_t)b * N + i) * N + j;
    ds_out[o] = dsv;
    wa_out[o] = wav;
  }
}

// The contraction pass, KEYS = key_regs(N): blocks [0, B (ne + nd)) by
// (batch element, ne chunks of E then nd chunks of D, CW columns each), then
// with dbias ceil(N^2 / CW) blocks that sum ds over the batch. A thread
// copies its column of p (E blocks) or du (D blocks) into shared memory by
// cp.async first, all N rows at once, so that its reads overlap the staging
// of ds and its sums.
template <typename T, int KEYS>
__global__ void __launch_bounds__(CW)
gatv2_streamed_contract_kernel(const float* __restrict__ p, const float* __restrict__ q,
                               const float* __restrict__ a, Args g,
                               const float* __restrict__ ds, const float* __restrict__ wa,
                               T* __restrict__ dp, T* __restrict__ dq, T* __restrict__ dv,
                               float* __restrict__ da_part, float* __restrict__ dbias) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D, B = g.B;
  const int ne = (E + CW - 1) / CW, nd = (D + CW - 1) / CW;
  const int tid = threadIdx.x;
  if (blockIdx.x >= B * (ne + nd)) {
    // dbias: entry x of (N, N), sum_b ds in order of b
    const int x = (blockIdx.x - B * (ne + nd)) * CW + tid;
    if (x < N * N) {
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc += ds[(size_t)b * N * N + x];
      dbias[x] = acc;
    }
    return;
  }
  const int b = blockIdx.x / (ne + nd), c = blockIdx.x % (ne + nd);
  const bool is_e = c < ne;
  const int W = is_e ? E : D, col = (is_e ? c : c - ne) * CW + tid;
  float* x_s = smem;                // [N][KEYS]: ds (E blocks) or wa (D blocks), 0 past N
  float* lo_s = x_s + N * KEYS;     // [N][KEYS]: lo ds
  float* hr_s = lo_s + N * KEYS;    // [N]: hi R_i
  float* hc_s = hr_s + N;           // [KEYS]: hi C_j
  float* col_s = hc_s + KEYS;       // [N][CW]: the block's columns of p or du
  const float* src_col = (is_e ? p + (size_t)b * N * E : g.du + (size_t)b * N * D) + col;
  if (col < W)
    for (int i = 0; i < N; ++i) cp_async4(col_s + i * CW + tid, src_col + (size_t)i * W, true);
  cp_async_commit();
  const float* src = (is_e ? ds : wa) + (size_t)b * N * N;
  for (int x = tid; x < N * KEYS; x += CW) {
    const int i = x / KEYS, j = x % KEYS;
    x_s[x] = j < N ? src[i * N + j] : 0.f;
  }
  __syncthreads();
  if (!is_e) {
    // dv_jd = sum_i wa_ij du_id, one fmaf chain a key in order of i
    if (col >= D) return;
    float acc[KEYS];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) acc[j] = 0.f;
    cp_async_wait_all();            // this thread's own column of du
    for (int i = 0; i < N; ++i) {
      const float u = col_s[i * CW + tid];
#pragma unroll
      for (int j = 0; j < KEYS; j += 4) {
        const float4 w4 = load4(x_s + i * KEYS + j);
        acc[j] = fmaf(w4.x, u, acc[j]);
        acc[j + 1] = fmaf(w4.y, u, acc[j + 1]);
        acc[j + 2] = fmaf(w4.z, u, acc[j + 2]);
        acc[j + 3] = fmaf(w4.w, u, acc[j + 3]);
      }
    }
    T* out = dv + (size_t)b * N * D + col;
#pragma unroll
    for (int j = 0; j < KEYS; ++j)
      if (j < N) out[(size_t)j * D] = from_f<T>(acc[j]);
    return;
  }
  const float hi = 0.5f * (1.f + g.alpha), lo = 0.5f * (1.f - g.alpha);
  for (int x = tid; x < N * KEYS; x += CW) lo_s[x] = lo * x_s[x];
  if (tid < N) {                    // hi R_i, in order of j
    float r = 0.f;
    for (int j = 0; j < N; ++j) r = fmaf(hi, x_s[tid * KEYS + j], r);
    hr_s[tid] = r;
  } else if (tid >= CW / 2 && tid - CW / 2 < KEYS) {   // hi C_j, in order of i
    const int j = tid - CW / 2;
    float sum = 0.f;
    if (j < N)
      for (int i = 0; i < N; ++i) sum = fmaf(hi, x_s[i * KEYS + j], sum);
    hc_s[j] = sum;
  }
  __syncthreads();
  const int e = col;
  if (e >= E) return;
  const float* qc = q + (size_t)b * N * E + e;
  float qv[KEYS], dqa[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    qv[j] = j < N ? qc[(size_t)j * E] : 0.f;
    dqa[j] = 0.f;
  }
  const float ae = a[e];
  T* dpo = dp + (size_t)b * N * E + e;
  float da_abs = 0.f, da_p = 0.f;
  cp_async_wait_all();              // this thread's own column of p
  for (int i = 0; i < N; ++i) {
    const float pe = col_s[i * CW + tid];
    const float* lrow = lo_s + i * KEYS;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; j += 4) {
      const float4 l4 = load4(lrow + j);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float z = pe + qv[j + k];
        // lo ds_ij, negated where z < 0 (the sign bit of z flipped in)
        const float t = __uint_as_float(__float_as_uint(lv[k]) ^ (__float_as_uint(z) & 0x80000000u));
        acc += t;
        dqa[j + k] += t;
        da_abs = fmaf(fabsf(z), lv[k], da_abs);
      }
    }
    const float hr = hr_s[i];
    dpo[(size_t)i * E] = from_f<T>(ae * (acc + hr));
    da_p = fmaf(pe, hr, da_p);
  }
  T* dqo = dq + (size_t)b * N * E + e;
  float da_q = 0.f;
#pragma unroll
  for (int j = 0; j < KEYS; ++j)
    if (j < N) {
      dqo[(size_t)j * E] = from_f<T>(ae * (dqa[j] + hc_s[j]));
      da_q = fmaf(qv[j], hc_s[j], da_q);
    }
  da_part[(size_t)b * E + e] = da_abs + (da_p + da_q);
}

// ---- launch ---------------------------------------------------------------

// A row tile the score pass takes with MR rows a thread: even, 2 to
// ROWS_MAX; MR 1 or 2.
bool bad_tile(int rows, int mr) {
  return rows < 2 || rows > ROWS_MAX || rows % 2 != 0 || (mr != 1 && mr != 2);
}

// The score pass, or (occupancy non-null) only the blocks of it one
// multiprocessor holds at once.
template <bool DROP, int MR>
int score_mr(const float* p, const float* q, const float* a, const float* v,
             const Args& g, float* ds, float* wa, int rows, void* stream,
             int* occupancy) {
  auto kernel = gatv2_streamed_score_kernel<DROP, MR>;
  const size_t floats = score_floats(g.N, rows);
  if (int err = prepare(kernel, floats)) return err;
  const int threads = score_threads(g.N, rows, MR);
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, threads,
                                                              floats * sizeof(float));
  const long long blocks = (long long)g.B * ((g.N + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, floats * sizeof(float), (cudaStream_t)stream>>>(
      p, q, a, v, g, ds, wa, rows);
  return (int)cudaGetLastError();
}

int score_launch(const float* p, const float* q, const float* a, const float* v,
                 const Args& g, float* ds, float* wa, int rows, int mr, void* stream,
                 int* occupancy) {
  const bool drop = g.seed != nullptr;
  if (mr == 2)
    return drop ? score_mr<true, 2>(p, q, a, v, g, ds, wa, rows, stream, occupancy)
                : score_mr<false, 2>(p, q, a, v, g, ds, wa, rows, stream, occupancy);
  return drop ? score_mr<true, 1>(p, q, a, v, g, ds, wa, rows, stream, occupancy)
              : score_mr<false, 1>(p, q, a, v, g, ds, wa, rows, stream, occupancy);
}

struct ContractOut {
  void *dp, *dq, *dv;
  float *da_part, *dbias;
};

template <typename T, int KEYS>
int contract_keys(const float* p, const float* q, const float* a, const Args& g,
                  const float* ds, const float* wa, const ContractOut& o, void* stream,
                  int* occupancy) {
  auto kernel = gatv2_streamed_contract_kernel<T, KEYS>;
  const size_t floats = contract_floats(g.N);
  if (int err = prepare(kernel, floats)) return err;
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, CW,
                                                              floats * sizeof(float));
  const long long blocks = (long long)g.B * ((g.E + CW - 1) / CW + (g.D + CW - 1) / CW) +
                           (o.dbias != nullptr ? ((long long)g.N * g.N + CW - 1) / CW : 0);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, CW, floats * sizeof(float), (cudaStream_t)stream>>>(
      p, q, a, g, ds, wa, (T*)o.dp, (T*)o.dq, (T*)o.dv, o.da_part, o.dbias);
  return (int)cudaGetLastError();
}

template <typename T>
int contract(const float* p, const float* q, const float* a, const Args& g,
             const float* ds, const float* wa, const ContractOut& o, void* stream,
             int* occupancy) {
  switch (key_regs(g.N)) {
#define GAT_KEYS(K) \
    case K: return contract_keys<T, K>(p, q, a, g, ds, wa, o, stream, occupancy);
    GAT_KEYS(8) GAT_KEYS(16) GAT_KEYS(24) GAT_KEYS(32)
    GAT_KEYS(40) GAT_KEYS(48) GAT_KEYS(56) GAT_KEYS(64)
#undef GAT_KEYS
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both passes on one stream: the score pass writes ds and wa, the
// contraction pass reads them.
template <typename T>
int streamed(const float* p, const float* q, const float* a, const float* v,
             const Args& g, float* ds, float* wa, const ContractOut& o, int rows,
             int mr, void* stream) {
  if (key_regs(g.N) == 0 || bad_tile(rows, mr) || g.B < 1 || g.E < 1 || g.D < 1)
    return (int)cudaErrorInvalidValue;
  if (int err = score_launch(p, q, a, v, g, ds, wa, rows, mr, stream, nullptr)) return err;
  return contract<T>(p, q, a, g, ds, wa, o, stream, nullptr);
}

}  // namespace

#define GAT_STREAMED_ARGS                                                             \
  const void *p, const void *q, const void *a, const void *bias, const void *v,      \
      const void *seed, const void *m, const void *l, const void *du, const void *dvec, \
      void *ds, void *wa, void *dp, void *dq, void *dv, void *da_part, void *dbias,    \
      int B, int N, int E, int D, int rows, int mr, float alpha, unsigned int thresh,   \
      float scale, void *stream
#define GAT_STREAMED_CALL(T)                                                           \
  streamed<T>((const float*)p, (const float*)q, (const float*)a, (const float*)v,      \
              make_args(bias, seed, m, l, du, dvec, B, N, E, D, alpha, thresh, scale), \
              (float*)ds, (float*)wa,                                                  \
              ContractOut{dp, dq, dv, (float*)da_part, (float*)dbias}, rows, mr, stream)

extern "C" {

// The streamed backward, both passes: dp, dq (B, N, E) and dv (B, N, D) in
// T; da_part (B, E) float32, one row a batch element, which the caller
// sums; with dbias non-null dbias (N, N) float32 = sum_b ds. ds and wa are
// (B, N, N) float32 scratch. p, q, a and v are float32 whatever T. rows and
// mr: the score pass's row tile (even, 2 to 16) and rows a thread (1 or 2),
// kernels/gat.streamed_rows.
int gatv2_streamed_f32(GAT_STREAMED_ARGS) { return GAT_STREAMED_CALL(float); }
int gatv2_streamed_bf16(GAT_STREAMED_ARGS) { return GAT_STREAMED_CALL(__nv_bfloat16); }

// The layout, for the planner's check (kernels/gat._streamed_plan): the
// score pass's threads and shared-memory bytes at graph size N, row tile
// `rows` and mr rows a thread, the keys a contraction thread holds (0 above
// NMAX), the contraction block's threads and bytes, the score pass's chunk,
// NMAX and the staging buffers.
void gatv2_streamed_layout(int N, int rows, int mr, long* out) {
  out[0] = score_threads(N, rows, mr);
  out[1] = (long)(score_floats(N, rows) * sizeof(float));
  out[2] = key_regs(N);
  out[3] = CW;
  out[4] = (long)(contract_floats(N) * sizeof(float));
  out[5] = SC;
  out[6] = NMAX;
  out[7] = RING;
}

// Blocks of the score pass (which 0; with dropout or not) or of the
// contraction pass (1; T bfloat16 or not) that one multiprocessor holds at
// once at graph size N, row tile `rows` and mr rows a thread (CUDA's
// occupancy calculator); negative on a CUDA error.
int gatv2_streamed_occupancy(int which, int N, int rows, int mr, int bf16, int drop) {
  if (key_regs(N) == 0 || bad_tile(rows, mr)) return -(int)cudaErrorInvalidValue;
  long long one = 0;
  const Args g = make_args(nullptr, drop ? &one : nullptr, nullptr, nullptr, nullptr,
                                 nullptr, 1, N, 1, 1, 0.f, 0u, 1.f);
  int blocks = 0, err;
  if (which == 0)
    err = score_launch(nullptr, nullptr, nullptr, nullptr, g, nullptr, nullptr, rows, mr,
                       nullptr, &blocks);
  else {
    const ContractOut o{nullptr, nullptr, nullptr, nullptr, nullptr};
    err = bf16 ? contract<__nv_bfloat16>(nullptr, nullptr, nullptr, g, nullptr, nullptr, o,
                                         nullptr, &blocks)
               : contract<float>(nullptr, nullptr, nullptr, g, nullptr, nullptr, o, nullptr,
                                 &blocks);
  }
  return err ? -err : blocks;
}

}  // extern "C"
