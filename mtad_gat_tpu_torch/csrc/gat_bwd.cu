// Fused GATv2 attention backward for Hopper (sm_90a): four kernels.
//
// Replace the blockwise backward of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_fused_backward:
//   K2a  _bwd_dp_da_kernel   dp (B, N, E) and per-block partial sums of da
//   K2b  _bwd_dq_dv_kernel   dq (B, N, E) and dv (B, N, D)
//   K2c  _bwd_dbias_kernel   dbias (N, N) = sum_b ds, per-chunk partial sums
//   K2ab K2a and K2b in one launch for graphs that fit a block whole (the
//        model's: N = 38 and 100), each (i, j) pair scored once, and K2c's
//        dbias too where the call wants it; K2a and K2b stay as the variant
//        for large graphs (kernels/gat.gat_bwd_plan chooses), K2b summing
//        K2c's dbias there in the same pass (DBIAS, add_dbias). The K2ab
//        section below says more, and the tiled K2a and K2b section how
//        those two fill the card at batch 1 (slices of the streamed loop,
//        register tiles, cp.async staging). The standalone K2c launches on
//        no path: it stays as the yardstick the fold is timed against.
//        Where the tiled plan names the CHUNKED tile on a graph of at most
//        64 nodes (a wide feature layer), gat_streamed.cu's streamed
//        backward runs instead (kernels/gat.gat_bwd_route); the CHUNKED
//        K2a and K2b stay for larger graphs and as its yardstick.
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
// far above the bytes they read at these graph sizes. K2c keeps its operands
// in shared memory at their full widths E and D where they fit a block, in
// chunks of 64 of each beyond (the feature layer above window 400), with odd
// row strides so that a warp reading one column per lane, or one row across
// lanes, meets no bank conflict; its score pass maps one key per lane and
// four rows per thread (the first tiled design). K2ab, the tiled K2a and K2b
// and the tiled forward hold 4 x 4 register tiles instead. No (N, N) tensor is written except dbias itself.
//
// Reductions across blocks are deterministic: K2a writes one da row per
// block and K2a and K2b one float32 partial per slice of their loop, summed
// in slice order by a second kernel; K2c writes one dbias matrix per batch
// chunk and K2ab and K2b one per group of batch elements; the caller sums
// those (JAX does the same for da, `da_part`, :651 and :669). K2c splits the
// batch into chunks so that the few (i, j) tiles of a small graph still fill
// the card; K2b's groups are as large as its fill allows
// (tiled_dbias_group).
//
// Layouts: p, q (B, N, E), v (B, N, D) in T (float32 or bfloat16; float32
// for the tiled K2a and K2b, whose wrappers widen bfloat16); a (E,) in T;
// bias (N, N) float32 or null; m, l, dvec (B, N) and du (B, N, D) float32.
// dp, dq, dv are written in T; da_part and dbias in float32.

#include "gat_common.cuh"

namespace {

using namespace gat;

constexpr int BI = 16;                      // query rows per tile
constexpr int BJ = 32;                      // keys per tile: one per lane
constexpr int THREADS = 128;                // four warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BI / WARPS;            // query rows per thread

__host__ __device__ inline int odd(int x) { return x | 1; }

// K2c's widths staged at once: E and D whole where its full-width tile fits
// a block (chunk 0), else chunks of `chunk` floats of each
// (kernels/gat.dbias_chunk chooses).
__host__ __device__ inline int dbias_width(int W, int chunk) {
  return chunk > 0 && chunk < W ? chunk : W;
}

// Shared-memory layout of one K2c block: a (row tile, key tile) pair at
// staged widths EC of E and DC of D.
struct Tile {
  float* p;      // [BI][odd(EC)]
  float* q;      // [BJ][odd(EC)]
  float* a;      // [EC]
  float* v;      // [BJ][odd(DC)]
  float* du;     // [BI][odd(DC)]
  float* m;      // [BI]
  float* l;      // [BI]
  float* dvec;   // [BI]
  float* next;   // first float after the tile
};

__host__ __device__ inline size_t tile_floats(int EC, int DC) {
  return (size_t)(BI + BJ) * odd(EC) + EC + (size_t)(BI + BJ) * odd(DC) + 3 * BI;
}

__device__ inline Tile carve(float* base, int EC, int DC) {
  Tile t;
  t.p = base;
  t.q = t.p + BI * odd(EC);
  t.a = t.q + BJ * odd(EC);
  t.v = t.a + EC;
  t.du = t.v + BJ * odd(DC);
  t.m = t.du + BI * odd(DC);
  t.l = t.m + BI;
  t.dvec = t.l + BI;
  t.next = t.dvec + BI;
  return t;
}

// Row tile [i0, i0 + BI) of batch b: columns [e0, e0 + ew) of p and [d0, d0 +
// dw) of du, from column 0 of the tile at strides odd(EC) and odd(DC).
template <typename T>
__device__ __forceinline__ void stage_rows(const Tile& t, const T* __restrict__ p, const Args& g, int b,
                           int i0, int EC, int e0, int ew, int DC, int d0, int dw) {
  const int E = g.E, D = g.D, N = g.N, EP = odd(EC), DP = odd(DC);
  for (int x = threadIdx.x; x < BI * ew; x += THREADS) {
    const int r = x / ew, e = x % ew, i = i0 + r;
    t.p[r * EP + e] = i < N ? to_f(p[((size_t)b * N + i) * E + e0 + e]) : 0.f;
  }
  for (int x = threadIdx.x; x < BI * dw; x += THREADS) {
    const int r = x / dw, d = x % dw, i = i0 + r;
    t.du[r * DP + d] = i < N ? g.du[((size_t)b * N + i) * D + d0 + d] : 0.f;
  }
}

// The row tile's m, l and dvec.
__device__ __forceinline__ void stage_stats(const Tile& t, const Args& g, int b, int i0) {
  if (threadIdx.x < BI) {
    const int i = i0 + threadIdx.x;
    const bool in = i < g.N;
    t.m[threadIdx.x] = in ? g.m[(size_t)b * g.N + i] : 0.f;
    t.l[threadIdx.x] = in ? g.l[(size_t)b * g.N + i] : 1.f;
    t.dvec[threadIdx.x] = in ? g.dvec[(size_t)b * g.N + i] : 0.f;
  }
}

// Key tile [j0, j0 + BJ) of batch b: columns [e0, e0 + ew) of q and [d0, d0 +
// dw) of v.
template <typename T>
__device__ __forceinline__ void stage_keys(const Tile& t, const T* __restrict__ q, const T* __restrict__ v,
                           const Args& g, int b, int j0, int EC, int e0, int ew, int DC, int d0,
                           int dw) {
  const int E = g.E, D = g.D, N = g.N, EP = odd(EC), DP = odd(DC);
  for (int x = threadIdx.x; x < BJ * ew; x += THREADS) {
    const int c = x / ew, e = x % ew, j = j0 + c;
    t.q[c * EP + e] = j < N ? to_f(q[((size_t)b * N + j) * E + e0 + e]) : 0.f;
  }
  for (int x = threadIdx.x; x < BJ * dw; x += THREADS) {
    const int c = x / dw, d = x % dw, j = j0 + c;
    t.v[c * DP + d] = j < N ? to_f(v[((size_t)b * N + j) * D + d0 + d]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage_a(const Tile& t, const T* __restrict__ a, int e0, int ew) {
  for (int e = threadIdx.x; e < ew; e += THREADS) t.a[e] = to_f(a[e0 + e]);
}

// Adds the staged columns to the score s and to du . v of this thread's ROWS
// rows (warp + r * WARPS) and key (lane): ew columns of the embedding, dw of
// the values, each one fmaf chain in order, so chunks continue it.
__device__ __forceinline__ void tile_sums(const Tile& t, float alpha, int EC, int ew, int DC, int dw,
                          float (&s)[ROWS], float (&dot)[ROWS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int EP = odd(EC), DP = odd(DC);
  const float* qj = t.q + lane * EP;
  for (int e = 0; e < ew; ++e) {
    const float qv = qj[e];
    const float av = t.a[e];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float z = t.p[(warp + r * WARPS) * EP + e] + qv;
      z = z >= 0.f ? z : alpha * z;
      s[r] = fmaf(av, z, s[r]);
    }
  }
  const float* vj = t.v + lane * DP;
  for (int d = 0; d < dw; ++d) {
    const float vv = vj[d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dot[r] = fmaf(t.du[(warp + r * WARPS) * DP + d], vv, dot[r]);
  }
}

// ds and wa of this thread's ROWS rows and key from their score s and du . v
// over the whole widths. Rows >= N and keys >= N give 0.
template <bool DROP>
__device__ __forceinline__ void ds_tile(const Tile& t, const Args& g, uint32_t seed, int b, int i0, int j0,
                        const float (&s)[ROWS], const float (&dot)[ROWS], float (&ds)[ROWS],
                        float (&wa)[ROWS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
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

// ---- K2a and K2b: the tiled backward, for graphs K2ab cannot hold ---------
//
// A graph above N 128 (the dense route's, or --attention_impl pallas on a
// long window) is cut into score tiles of RI rows x KJ keys. K2b owns a key
// tile and streams row tiles past it (dq, dv sum over rows); K2a owns a row
// tile and streams key tiles (dp, da sum over keys). The work is bound by
// float32 operations on the CUDA cores (the score has no product structure),
// so the design keeps every thread busy on register-held operands:
//
// - the score (tiled_score: score_tile of gat_common.cuh, the routine the
//   tiled forward calls too): a thread owns a 4-row x 4-key micro-tile, rows
//   ti + RG r and keys tj + KG c (RG = RI / 4, KG = KJ / 4, so neighbouring
//   lanes read neighbouring q rows, no bank conflict), and reads p, q and a
//   as float4: one read feeds 4 pairs. Each pair's score is one fmaf chain
//   over e = 0..E-1 in order, so w equals the tiled K1-res's weights bit for
//   bit; du . v the same over D, with the tile's bias loaded before it
//   so that its latency hides behind it. The dropout mask is drop_hash of
//   the global (seed, b, i, j);
// - the contractions, register tiles that read two float4 for 16 updates:
//   K2b's dq item is 4 keys x a float4 group of e (q of the 4 keys in
//   registers; per row one float4 of p and one of ds), its dv item 4 keys x
//   4 columns (per row one float4 of wa and one of du); K2a's dp item is 4
//   rows x a float4 group of e (p in registers; per key one float4 of q and
//   one of ds), with da in registers beside it;
// - the card filled at batch 1: the streamed loop is cut into `slices`
//   blocks of its own (kernels/gat.gat_tiled_bwd_plan chooses), each writing
//   float32 partial sums, (slices, B, N, E + D) for K2b and (slices, B, N, E)
//   for K2a; gatv2_bwd_slice_reduce_kernel sums them in slice order, scales
//   by a_e and casts to T. No atomics: two launches give identical bits. A
//   block's running sums stay in shared memory (acc_smem) or in its own rows
//   of the partial, which keeps K2b's block small enough for two a
//   multiprocessor (kernels/gat.TILED_CHOICES, by measurement); each element
//   has one owner thread, which writes it at the first tile, adds at the
//   next ones and writes the total at the last;
// - K2c's dbias in K2b's pass (DBIAS): each thread adds the ds of its
//   micro-tile, already in registers after the score, into a float32 (N, N)
//   partial of its batch group (add_dbias: one owner a pair, no atomics, no
//   barrier, no shared memory, so the block's layout and occupancy stay as
//   without it). The block then walks the G batch elements of its group,
//   batch outer and its slice's row tiles inner, restaging the key tile for
//   each, its running sums starting anew each element; at batch 1 the one
//   partial is dbias itself. Where K2c read p, q, v, du, m, l and dvec a
//   third time and scored every pair again, the fold adds N^2 float32
//   writes (and reads, G > 1) to K2b;
// - staging by cp.async with zero fill (ragged rows, padded widths), one
//   buffer for the streamed tile. Three barriers a tile: the tile has
//   arrived, its ds is complete (the contraction reads other threads' ds),
//   its readers are done before the next tile is copied in. A second buffer,
//   the next tile loading during this one, was measured: it costs a block a
//   multiprocessor at the route's widths (8 warps instead of 16) and ran
//   20-40% slower there (PERF.md), so occupancy hides the copies instead.
//
// The inputs p, q, a, v are float32 (the wrapper casts bfloat16 ones, an
// exact widening); m, l, du, dvec float32 as elsewhere. Three tile shapes:
// FAST for the widths the model uses, WIDE (fewer rows and keys, one warp)
// for the widest ones the first design of these kernels accepted, and
// CHUNKED (WIDE's shape, E and D streamed in chunks; its section below)
// beyond them.

constexpr int TILE_FAST_RI = 64, TILE_FAST_KJ = 64;
constexpr int TILE_WIDE_RI = 16, TILE_WIDE_KJ = 32;
// Blocks a multiprocessor the register budget allows: 128 registers a thread.
#define TILED_BOUNDS(RI, KJ) __launch_bounds__((RI) * (KJ) / 16, 8192 / ((RI) * (KJ)))

struct TiledLayout {
  int EP, DP;   // strides of p, q, a and of du, v: odd multiples of 16 bytes
  int EA, DA;   // strides of the running sums: E and D up to a multiple of 4
  int EG, DG;   // float4 groups of E and of D
  __host__ __device__ TiledLayout(int E, int D)
      : EP(stride4(E)), DP(stride4(D)), EA(up4(E)), DA(up4(D)), EG((E + 3) / 4),
        DG((D + 3) / 4) {}
};

// Shared memory of one K2b block: a [EP]; the key tile's q [KJ][EP], v
// [KJ][DP]; the row tile's p [RI][EP], du [RI][DP], m, l, dvec [RI];
// ds and wa [RI][KJ]; with acc_smem the running dq [KJ][EA] and dv [KJ][DA].
template <int RI, int KJ>
__host__ __device__ inline size_t dq_dv_floats(const TiledLayout& L, bool acc_smem) {
  return (size_t)L.EP + (size_t)KJ * (L.EP + L.DP) + (size_t)RI * (L.EP + L.DP + 3) +
         2 * (size_t)RI * KJ + (acc_smem ? (size_t)KJ * (L.EA + L.DA) : 0);
}

// Shared memory of one K2a block: a [EP]; the row tile's p [RI][EP], du
// [RI][DP], m, l, dvec [RI]; the key tile's q [KJ][EP], v [KJ][DP];
// ds by key [KJ][stride4(RI)]; da by row group [RI / 4][EA]; with acc_smem the
// running dp [RI][EA].
template <int RI, int KJ>
__host__ __device__ inline size_t dp_da_floats(const TiledLayout& L, bool acc_smem) {
  return (size_t)L.EP + (size_t)RI * (L.EP + L.DP + 3) + (size_t)KJ * (L.EP + L.DP) +
         (size_t)KJ * stride4(RI) + (size_t)(RI / 4) * L.EA +
         (acc_smem ? (size_t)RI * L.EA : 0);
}

// du . v of a thread's micro-tile, as score_tile: rows ti + RG r of du_s
// [.][us] against keys tj + KG c of v_s [.][vs] over float4 groups [0, groups),
// one fmaf chain a pair in order of d.
template <int RG, int KG>
__device__ __forceinline__ void dot_tile(const float* du_s, int us, const float* v_s, int vs,
                                         int groups, int ti, int tj, float (&dot)[16]) {
  for (int dg = 0; dg < groups; ++dg) {
    float4 ur[4], vc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ur[r] = load4(du_s + (ti + RG * r) * us + 4 * dg);
      vc[r] = load4(v_s + (tj + KG * r) * vs + 4 * dg);
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
}

// The bias of a thread's micro-tile (0 outside the graph or without one),
// loaded before du . v so that its latency hides behind it.
template <int RG, int KG>
__device__ __forceinline__ void tile_bias(const Args& g, int i0, int j0, int ti, int tj,
                                          float (&bv)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + ti + RG * r, j = j0 + tj + KG * c;
      bv[r * 4 + c] = g.bias != nullptr && i < g.N && j < g.N
                          ? __ldg(g.bias + (size_t)i * g.N + j) : 0.f;
    }
}

// ds and wa of a micro-tile from its scores s, du . v and bias, with the
// row tile's m, l and dvec staged by row: 0 for a row or key >= N.
template <int RG, int KG, bool DROP>
__device__ __forceinline__ void tile_ds(const float (&s)[16], const float (&dot)[16],
                                        const float (&bv)[16], const float* m_s,
                                        const float* l_s, const float* dvec_s, const Args& g,
                                        uint32_t seed, int b, int i0, int j0, int ti, int tj,
                                        float (&ds)[16], float (&wa)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rl = ti + RG * r, i = i0 + rl;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tj + KG * c;
      float dsv = 0.f, wav = 0.f;
      if (i < g.N && j < g.N)
        pair_ds<DROP>(s[r * 4 + c], dot[r * 4 + c], bv[r * 4 + c], g.bias != nullptr, m_s[rl],
                      l_s[rl], dvec_s[rl], seed, g.thresh, g.scale, b, i, j, dsv, wav);
      ds[r * 4 + c] = dsv;
      wa[r * 4 + c] = wav;
    }
  }
}

// ds and wa of this thread's micro-tile, pair (r, c) at [4 r + c]: rows
// i0 + ti + RG r of the staged row tile (p, du, m, l, dvec) against keys
// j0 + tj + KG c of the staged key tile (q, v); 0 for a row or key >= N.
template <int RI, int KJ, bool DROP>
__device__ __forceinline__ void tiled_score(const float* p_s, const float* du_s,
                                            const float* m_s, const float* l_s,
                                            const float* dvec_s, const float* q_s,
                                            const float* v_s, const float* a_s,
                                            const TiledLayout& L, const Args& g, uint32_t seed,
                                            int b, int i0, int j0, float (&ds)[16],
                                            float (&wa)[16]) {
  constexpr int RG = RI / 4, KG = KJ / 4;
  const int ti = threadIdx.x / KG, tj = threadIdx.x % KG;
  float s[16], dot[16], bv[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) s[x] = dot[x] = 0.f;
  score_tile<RG, KG>(p_s, L.EP, q_s, L.EP, a_s, L.EG, ti, tj, g.alpha, s);
  tile_bias<RG, KG>(g, i0, j0, ti, tj, bv);
  dot_tile<RG, KG>(du_s, L.DP, v_s, L.DP, L.DG, ti, tj, dot);
  tile_ds<RG, KG, DROP>(s, dot, bv, m_s, l_s, dvec_s, g, seed, b, i0, j0, ti, tj, ds, wa);
}

// dq's sums of one item of K2b's contraction: keys kg + KG c of q_keys
// [.][qs] by a float4 group c0 of e, over rows [0, in) of p_rows [.][ps] and
// of ds_s [.][KJ] (keys by micro-tile): acc[4 c + k] = sum_i ds_ij lr'(p_ie +
// q_je), without the factor a_e. As (1 + alpha) / 2 sum_i ds_ij plus (1 -
// alpha) / 2 sum_i ds_ij with the sign of z_ije flipped into it (one logic
// op, not a compare and a select: 8% of K2b at the route's shape, PERF.md; a
// z of -0 takes alpha, where the select takes 1).
template <int KG, int KJ>
__device__ __forceinline__ void dq_sums(const float* p_rows, int ps, const float* q_keys, int qs,
                                        const float* ds_s, int kg, int c0, int in, float alpha,
                                        float (&acc)[16]) {
  float qv[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 q4 = load4(q_keys + (kg + KG * c) * qs + c0);
    qv[c][0] = q4.x, qv[c][1] = q4.y, qv[c][2] = q4.z, qv[c][3] = q4.w;
  }
  const float hi = 0.5f * (1.f + alpha), lo = 0.5f * (1.f - alpha);
  float cst[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int i = 0; i < in; ++i) {
    const float4 p4 = load4(p_rows + i * ps + c0);
    const float4 d4 = load4(ds_s + i * KJ + 4 * kg);
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cst[c] = fmaf(hi, dd[c], cst[c]);
      const unsigned h = __float_as_uint(lo * dd[c]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[c * 4 + k] +=
            __uint_as_float(h ^ (__float_as_uint(pv[k] + qv[c][k]) & 0x80000000u));
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[c * 4 + k] += cst[c];
}

// dv's sums of one item: acc[4 c + k] = sum_i wa_ij du_id over rows [0, in)
// of wa_s [.][KJ] (keys kg + KG c by micro-tile) and du_rows [.][us] at
// columns c0 + k.
template <int KJ>
__device__ __forceinline__ void dv_sums(const float* wa_s, const float* du_rows, int us, int kg,
                                        int c0, int in, float (&acc)[16]) {
#pragma unroll 2
  for (int i = 0; i < in; ++i) {
    const float4 w4 = load4(wa_s + i * KJ + 4 * kg);
    const float4 u4 = load4(du_rows + i * us + c0);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[c * 4 + k] = fmaf(wv[c], uv[k], acc[c * 4 + k]);
  }
}

// dp's and da's sums of one item of K2a's contraction, split sp of ks: rows h
// + RG r of p_rows [.][ps] by a float4 group c0 of e, over keys sp, sp + ks,
// ... below kn of q_keys [.][qs] and dsT_s [.][rs] (rows by micro-tile):
// dp[4 r + e] = sum_j ds_ij lr'(z), da[e] = sum ds_ij lr(z), each from 0.
template <int RG>
__device__ __forceinline__ void dp_da_sums(const float* p_rows, int ps, const float* q_keys,
                                           int qs, const float* dsT_s, int rs, int h, int c0,
                                           int sp, int ks, int kn, float alpha, float (&dp)[16],
                                           float (&da)[4]) {
  float pv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 p4 = load4(p_rows + (h + RG * r) * ps + c0);
    pv[r][0] = p4.x, pv[r][1] = p4.y, pv[r][2] = p4.z, pv[r][3] = p4.w;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) dp[k] = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) da[e] = 0.f;
#pragma unroll 2
  for (int k = sp; k < kn; k += ks) {
    const float4 q4 = load4(q_keys + k * qs + c0);
    const float4 d4 = load4(dsT_s + k * rs + 4 * h);
    const float qv[4] = {q4.x, q4.y, q4.z, q4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = dd[r], ad = alpha * d;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = pv[r][e] + qv[e];
        const float gk = z >= 0.f ? d : ad;
        dp[r * 4 + e] += gk;
        da[e] = fmaf(gk, z, da[e]);
      }
    }
  }
}

// A running sum's element with one owner thread: written at the first tile of
// the block's slice, added to at the next ones (in shared memory, or in the
// partial itself without acc_smem), the total written to the partial at the
// last.
__device__ __forceinline__ void accumulate(float* part_x, float* smem_x, float val, bool first,
                                           bool last, bool acc_smem) {
  if (!first) val += acc_smem ? *smem_x : *part_x;
  if (last || !acc_smem)
    *part_x = val;
  else
    *smem_x = val;
}

// K2c's function inside K2b (DBIAS): the thread that scores pair (i, j) of a
// tile adds its ds_ij into the block's batch group's (N, N) float32 partial,
// writing it at the group's first batch element and adding at the next ones
// in batch order. The pair has one owner thread in one block for every
// batch element of the group (the block's slice holds row i's tile, its key
// tile key j, and the micro-tile mapping does not depend on b), so there are
// no atomics and no barrier; rows and keys >= N are not written.
template <int RG, int KG>
__device__ __forceinline__ void add_dbias(float* __restrict__ db, int N, int i0, int j0, int ti,
                                          int tj, const float (&ds)[16], bool add) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ti + RG * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tj + KG * c;
      if (i < N && j < N) {
        float& x = db[(size_t)i * N + j];
        x = add ? x + ds[r * 4 + c] : ds[r * 4 + c];
      }
    }
  }
}

// K2b: a block per (slice, batch group, key tile), walking the batch elements
// of its group in order and, for each, its slice's row tiles (a group of one
// element without DBIAS). part (slices, B, N, E + D): dq's sums without the
// factor a_e, then dv's; with DBIAS dbias_part (ceil(B / group), N, N), one
// group's sum of ds each.
template <int RI, int KJ, bool DROP, bool DBIAS>
__global__ void TILED_BOUNDS(RI, KJ)
gatv2_bwd_dq_dv_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ a, const float* __restrict__ v, Args g,
                       float* __restrict__ part, float* __restrict__ dbias_part, int slices,
                       int acc_smem, int group) {
  constexpr int NT = RI * KJ / 16, RG = RI / 4, KG = KJ / 4;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D, W = E + D;
  const TiledLayout L(E, D);
  const int key_tiles = (N + KJ - 1) / KJ, row_tiles = (N + RI - 1) / RI;
  const int n_groups = (g.B + group - 1) / group;
  const int kt = blockIdx.x % key_tiles, sb = blockIdx.x / key_tiles;
  const int gr = sb % n_groups, sl = sb / n_groups;
  const int b_first = gr * group, b_end = min(g.B, b_first + group);
  const int j0 = kt * KJ, kn = min(KJ, N - j0);
  const int t_begin = slice_begin(sl, row_tiles, slices);
  const int t_end = slice_begin(sl + 1, row_tiles, slices);
  float* a_s = smem;                        // [EP]
  float* q_s = a_s + L.EP;                  // [KJ][EP]
  float* v_s = q_s + KJ * L.EP;             // [KJ][DP]
  float* st = v_s + KJ * L.DP;              // the row tile: p, du, m, l, dvec
  float* ds_s = st + RI * (L.EP + L.DP + 3);  // [RI][KJ], keys by micro-tile
  float* wa_s = ds_s + RI * KJ;             // [RI][KJ]
  float* dq_s = wa_s + RI * KJ;             // [KJ][EA] with acc_smem
  float* dv_s = dq_s + KJ * L.EA;           // [KJ][DA] with acc_smem
  float* db = DBIAS ? dbias_part + (size_t)gr * N * N : nullptr;
  const uint32_t seed = read_seed(g);
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q);
  const bool vec_d = D % 4 == 0 && aligned16(v) && aligned16(g.du);
  float* du_t = st + RI * L.EP;
  float* stats = du_t + RI * L.DP;
  for (int e = threadIdx.x; e < L.EP; e += NT) a_s[e] = e < E ? a[e] : 0.f;
  const int ti = threadIdx.x / KG, tj = threadIdx.x % KG;
  const int n_dq = KG * L.EG, items = n_dq + KG * L.DG;

  for (int b = b_first; b < b_end; ++b) {
    if (b != b_first) __syncthreads();  // the previous element's readers are done
    float* out = part + ((size_t)(sl * g.B + b) * N + j0) * W;
    const float* pb = p + (size_t)b * N * E;
    const float* dub = g.du + (size_t)b * N * D;
    auto stage = [&](int t) {
      const int i0 = t * RI;
      copy_rows_async(st, L.EP, pb, i0, RI, N, E, vec_e, NT);
      copy_rows_async(du_t, L.DP, dub, i0, RI, N, D, vec_d, NT);
      copy_vec_async(stats, g.m + (size_t)b * N, i0, RI, N, NT);
      copy_vec_async(stats + RI, g.l + (size_t)b * N, i0, RI, N, NT);
      copy_vec_async(stats + 2 * RI, g.dvec + (size_t)b * N, i0, RI, N, NT);
      cp_async_commit();
    };
    copy_rows_async(q_s, L.EP, q + (size_t)b * N * E, j0, KJ, N, E, vec_e, NT);
    copy_rows_async(v_s, L.DP, v + (size_t)b * N * D, j0, KJ, N, D, vec_d, NT);
    stage(t_begin);

    for (int t = t_begin; t < t_end; ++t) {
      cp_async_wait_all();
      __syncthreads();  // this tile has arrived
      const int i0 = t * RI;
      {
        float ds[16], wa[16];
        tiled_score<RI, KJ, DROP>(st, du_t, stats, stats + RI, stats + 2 * RI, q_s, v_s, a_s,
                                  L, g, seed, b, i0, j0, ds, wa);
        if constexpr (DBIAS) add_dbias<RG, KG>(db, N, i0, j0, ti, tj, ds, b != b_first);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = (ti + RG * r) * KJ + 4 * tj;
          *reinterpret_cast<float4*>(ds_s + o) =
              make_float4(ds[4 * r], ds[4 * r + 1], ds[4 * r + 2], ds[4 * r + 3]);
          *reinterpret_cast<float4*>(wa_s + o) =
              make_float4(wa[4 * r], wa[4 * r + 1], wa[4 * r + 2], wa[4 * r + 3]);
        }
      }
      __syncthreads();  // the tile's ds and wa are complete
      const int in = min(RI, N - i0);
      const bool first = t == t_begin, last = t == t_end - 1;
      for (int x = threadIdx.x; x < items; x += NT) {
        const bool is_dq = x < n_dq;
        const int y = is_dq ? x : x - n_dq, groups = is_dq ? L.EG : L.DG;
        const int kg = y / groups, c0 = y % groups * 4;
        float acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = 0.f;
        if (is_dq)
          dq_sums<KG, KJ>(st, L.EP, q_s, L.EP, ds_s, kg, c0, in, g.alpha, acc);
        else
          dv_sums<KJ>(wa_s, du_t, L.DP, kg, c0, in, acc);
        const int width = is_dq ? E : D, sstride = is_dq ? L.EA : L.DA, goff = is_dq ? 0 : E;
        float* sm = is_dq ? dq_s : dv_s;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kg + KG * c;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (key < kn && c0 + k < width)
              accumulate(out + (size_t)key * W + goff + c0 + k, sm + key * sstride + c0 + k,
                         acc[c * 4 + k], first, last, acc_smem);
        }
      }
      if (t + 1 < t_end) {
        __syncthreads();  // the contraction's readers of the tile are done
        stage(t + 1);
      }
    }
  }
}

// Lanes (1, 2 or 4) that share one item of K2a's contraction, each taking
// every ks-th key: the split whose items x splits fill the block's nt threads
// the best round for round (the fewest on a tie). 16 row groups x 19 float4
// groups of E 76 are 304 items, 1.19 rounds of 256 threads; split 4 ways,
// 4.75. (K2b's dq items split by rows the same way ran 36% slower at the
// route's shape: PERF.md.)
__host__ __device__ inline int key_splits(int items, int nt) {
  int best = 1;
  long long best_num = 0, best_den = 1;
  for (int ks = 1; ks <= 4; ks *= 2) {
    const long long num = (long long)items * ks;
    const long long den = (num + nt - 1) / nt * nt;
    if (num * best_den > best_num * den) best = ks, best_num = num, best_den = den;
  }
  return best;
}

// K2a: a block per (slice, batch element, row tile), walking its slice's key
// tiles. part (slices, B, N, E): dp's sums without the factor a_e; da_part
// one row of E per block: its rows' and keys' sum of ds lr(z).
template <int RI, int KJ, bool DROP>
__global__ void TILED_BOUNDS(RI, KJ)
gatv2_bwd_dp_da_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ a, const float* __restrict__ v, Args g,
                       float* __restrict__ part, float* __restrict__ da_part, int slices,
                       int acc_smem) {
  constexpr int NT = RI * KJ / 16, RG = RI / 4, KG = KJ / 4, RS = (RI / 4) % 2 ? RI : RI + 4;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D;
  const TiledLayout L(E, D);
  const int row_tiles = (N + RI - 1) / RI, key_tiles = (N + KJ - 1) / KJ;
  const int rt = blockIdx.x % row_tiles, sb = blockIdx.x / row_tiles;
  const int b = sb % g.B, sl = sb / g.B;
  const int i0 = rt * RI, in = min(RI, N - i0);
  const int t_begin = slice_begin(sl, key_tiles, slices);
  const int t_end = slice_begin(sl + 1, key_tiles, slices);
  float* a_s = smem;                        // [EP]
  float* p_s = a_s + L.EP;                  // [RI][EP]
  float* du_s = p_s + RI * L.EP;            // [RI][DP]
  float* m_s = du_s + RI * L.DP;            // [RI]
  float* l_s = m_s + RI;                    // [RI]
  float* dvec_s = l_s + RI;                 // [RI]
  float* q_t = dvec_s + RI;                 // the key tile: q [KJ][EP], v [KJ][DP]
  float* dsT_s = q_t + KJ * (L.EP + L.DP);  // [KJ][RS], rows by micro-tile
  float* da_s = dsT_s + KJ * RS;            // [RG][EA]
  float* dp_s = da_s + RG * L.EA;           // [RI][EA] with acc_smem
  float* out = part + ((size_t)(sl * g.B + b) * N + i0) * E;
  const uint32_t seed = read_seed(g);
  const float* qb = q + (size_t)b * N * E;
  const float* vb = v + (size_t)b * N * D;
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q);
  const bool vec_d = D % 4 == 0 && aligned16(v) && aligned16(g.du);
  auto stage = [&](int t) {
    copy_rows_async(q_t, L.EP, qb, t * KJ, KJ, N, E, vec_e, NT);
    copy_rows_async(q_t + KJ * L.EP, L.DP, vb, t * KJ, KJ, N, D, vec_d, NT);
    cp_async_commit();
  };

  for (int e = threadIdx.x; e < L.EP; e += NT) a_s[e] = e < E ? a[e] : 0.f;
  copy_rows_async(p_s, L.EP, p + (size_t)b * N * E, i0, RI, N, E, vec_e, NT);
  copy_rows_async(du_s, L.DP, g.du + (size_t)b * N * D, i0, RI, N, D, vec_d, NT);
  copy_vec_async(m_s, g.m + (size_t)b * N, i0, RI, N, NT);
  copy_vec_async(l_s, g.l + (size_t)b * N, i0, RI, N, NT);
  copy_vec_async(dvec_s, g.dvec + (size_t)b * N, i0, RI, N, NT);
  stage(t_begin);

  const int ti = threadIdx.x / KG, tj = threadIdx.x % KG;
  const int items = RG * L.EG, ks = key_splits(items, NT);
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait_all();
    __syncthreads();  // this tile has arrived
    const int j0 = t * KJ;
    {
      float ds[16], wa[16];
      tiled_score<RI, KJ, DROP>(p_s, du_s, m_s, l_s, dvec_s, q_t, q_t + KJ * L.EP, a_s, L, g,
                                seed, b, i0, j0, ds, wa);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(dsT_s + (tj + KG * c) * RS + 4 * ti) =
            make_float4(ds[c], ds[4 + c], ds[8 + c], ds[12 + c]);
    }
    __syncthreads();  // the tile's ds is complete
    const int kn = min(KJ, N - j0);
    const bool first = t == t_begin, last = t == t_end - 1;
    for (int base = 0; base < items * ks; base += NT) {
      // dp_ie: sum_j ds_ij lr'(z), da_e: sum ds_ij lr(z), p of the item's 4
      // rows held; split sp of an item takes keys sp, sp + ks, ...
      const int x = base + threadIdx.x;
      const bool live = x < items * ks;
      const int item = live ? x / ks : 0, sp = x % ks;
      const int h = item / L.EG, c0 = item % L.EG * 4;
      float dp[16], da[4];
      dp_da_sums<RG>(p_s, L.EP, q_t, L.EP, dsT_s, RS, h, c0, sp, ks, kn, g.alpha, dp, da);
      // the splits of an item are neighbouring lanes: a butterfly, a fixed order
      for (int o = 1; o < ks; o *= 2) {
#pragma unroll
        for (int k = 0; k < 16; ++k) dp[k] += __shfl_xor_sync(0xffffffffu, dp[k], o);
#pragma unroll
        for (int e = 0; e < 4; ++e) da[e] += __shfl_xor_sync(0xffffffffu, da[e], o);
      }
      if (!live || sp != 0) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = h + RG * r;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (row < in && c0 + e < E)
            accumulate(out + (size_t)row * E + c0 + e, dp_s + row * L.EA + c0 + e, dp[r * 4 + e],
                       first, last, acc_smem);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& s = da_s[h * L.EA + c0 + e];
        s = first ? da[e] : s + da[e];
      }
    }
    if (t + 1 < t_end) {
      __syncthreads();  // the contraction's readers of the tile are done
      stage(t + 1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += NT) {
    float s = 0.f;
    for (int h = 0; h < RG; ++h) s += da_s[h * L.EA + e];
    da_part[(size_t)blockIdx.x * E + e] = s;
  }
}

// ---- the CHUNKED tile: K2a and K2b at any width ---------------------------
//
// Above the widths the first design of these kernels accepted (the feature
// layer above window 235), whole rows of p, q, v and du no longer fit a
// block beside the tile (kernels/gat.gat_tiled_bwd_plan). There K2a and K2b
// take the WIDE tile's shape (16 x 32, one warp) with their running sums in
// the partial, and stream E and D through shared memory in chunks of
// TILE_CHUNK floats instead of holding whole rows:
// - the score (chunked_score): p, q and a staged chunk by chunk in order of
//   e, score_tile called once a chunk, so each pair's fmaf chain over
//   e = 0..E-1 runs on in order and w is bit for bit what the tiled forward
//   writes; du . v the same over D chunks; the row tile's m, l and dvec ride
//   with the first chunk;
// - the contractions restage their operands by chunk: K2a's dp and da and
//   K2b's dq restage p and q by E chunk, K2b's dv du by D chunk, each chunk
//   one pass of the same item code as the FAST and WIDE tiles (dq_sums,
//   dv_sums, dp_da_sums). K2a's key splits are 1, and its da runs in the
//   block's RG rows of da_part, one a row group, as dp runs in the partial:
//   nothing in shared memory grows with E or D.
// Every element of a running sum has one owner thread, the slices' partials
// are summed by the same reduce, and there are no atomics. The block holds
// 17.6 KB (K2b) or 16.1 KB (K2a) at any width.

constexpr int TILE_CHUNK = 64;              // floats of E or D staged at once
constexpr int CHUNK_RI = TILE_WIDE_RI, CHUNK_KJ = TILE_WIDE_KJ;
constexpr int CHUNK_NT = CHUNK_RI * CHUNK_KJ / 16;
constexpr int CHUNK_RG = CHUNK_RI / 4, CHUNK_KG = CHUNK_KJ / 4;
constexpr int CHUNK_CP = stride4(TILE_CHUNK);   // stride of a staged chunk
constexpr int CHUNK_RS = stride4(CHUNK_RI);     // stride of K2a's ds by key

// Shared memory of a CHUNKED block: a chunk of the row tile's p or du
// [RI][CP], of the key tile's q or v [KJ][CP], of a [CP]; the row tile's m,
// l and dvec [RI]; then K2b's ds and wa [RI][KJ] (which 1) or K2a's ds by
// key [KJ][RS] (which 0).
__host__ __device__ constexpr size_t chunked_floats(int which) {
  return (size_t)(CHUNK_RI + CHUNK_KJ + 1) * CHUNK_CP + 3 * CHUNK_RI +
         (which ? 2 * CHUNK_RI * CHUNK_KJ : CHUNK_KJ * CHUNK_RS);
}

struct ChunkBufs {
  float* x;      // [RI][CP]: p or du of the row tile
  float* y;      // [KJ][CP]: q or v of the key tile
  float* a;      // [CP]
  float* stats;  // m, l, dvec of the row tile, [RI] each
  float* next;   // first float after them
};

__device__ inline ChunkBufs carve_chunk(float* smem) {
  ChunkBufs c;
  c.x = smem;
  c.y = c.x + CHUNK_RI * CHUNK_CP;
  c.a = c.y + CHUNK_KJ * CHUNK_CP;
  c.stats = c.a + CHUNK_CP;
  c.next = c.stats + 3 * CHUNK_RI;
  return c;
}

// ds and wa of this thread's micro-tile of row tile i0 against key tile j0
// of batch element b, as tiled_score computes them, staging the operands by
// chunk. Every chunk starts with a barrier, so the block's earlier readers
// of the buffers are done.
template <bool DROP>
__device__ void chunked_score(const ChunkBufs& c, const float* __restrict__ p,
                              const float* __restrict__ q, const float* __restrict__ a,
                              const float* __restrict__ v, const Args& g, uint32_t seed, int b,
                              int i0, int j0, bool vec_e, bool vec_d, float (&ds)[16],
                              float (&wa)[16]) {
  constexpr int RI = CHUNK_RI, KJ = CHUNK_KJ, NT = CHUNK_NT, CP = CHUNK_CP;
  const int N = g.N, E = g.E, D = g.D;
  const int ti = threadIdx.x / CHUNK_KG, tj = threadIdx.x % CHUNK_KG;
  const float* pb = p + (size_t)b * N * E;
  const float* qb = q + (size_t)b * N * E;
  const float* vb = v + (size_t)b * N * D;
  const float* dub = g.du + (size_t)b * N * D;
  float s[16], dot[16], bv[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) s[x] = dot[x] = 0.f;
  for (int e0 = 0; e0 < E; e0 += TILE_CHUNK) {
    const int ew = min(TILE_CHUNK, E - e0), groups = (ew + 3) / 4;
    __syncthreads();  // the buffers' readers are done
    copy_tile_async(c.x, CP, groups, pb + e0, E, i0, RI, N, ew, vec_e, NT);
    copy_tile_async(c.y, CP, groups, qb + e0, E, j0, KJ, N, ew, vec_e, NT);
    copy_tile_async(c.a, CP, groups, a + e0, E, 0, 1, 1, ew, vec_e, NT);
    if (e0 == 0) {
      copy_vec_async(c.stats, g.m + (size_t)b * N, i0, RI, N, NT);
      copy_vec_async(c.stats + RI, g.l + (size_t)b * N, i0, RI, N, NT);
      copy_vec_async(c.stats + 2 * RI, g.dvec + (size_t)b * N, i0, RI, N, NT);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the chunk has arrived
    score_tile<CHUNK_RG, CHUNK_KG>(c.x, CP, c.y, CP, c.a, groups, ti, tj, g.alpha, s);
  }
  tile_bias<CHUNK_RG, CHUNK_KG>(g, i0, j0, ti, tj, bv);
  for (int d0 = 0; d0 < D; d0 += TILE_CHUNK) {
    const int dw = min(TILE_CHUNK, D - d0), groups = (dw + 3) / 4;
    __syncthreads();
    copy_tile_async(c.x, CP, groups, dub + d0, D, i0, RI, N, dw, vec_d, NT);
    copy_tile_async(c.y, CP, groups, vb + d0, D, j0, KJ, N, dw, vec_d, NT);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    dot_tile<CHUNK_RG, CHUNK_KG>(c.x, CP, c.y, CP, groups, ti, tj, dot);
  }
  tile_ds<CHUNK_RG, CHUNK_KG, DROP>(s, dot, bv, c.stats, c.stats + RI, c.stats + 2 * RI, g,
                                    seed, b, i0, j0, ti, tj, ds, wa);
}

// After a barrier (the buffer's readers are done), start copying rows [r0,
// r0 + rows) of src (n_rows x ld) at columns [c0, c0 + cw) into dst [rows][CP].
__device__ inline void stage_chunk(float* dst, const float* __restrict__ src, int ld, int r0,
                                   int rows, int n_rows, int c0, int cw, bool vec) {
  __syncthreads();
  copy_tile_async(dst, CHUNK_CP, (cw + 3) / 4, src + c0, ld, r0, rows, n_rows, cw, vec,
                  CHUNK_NT);
}

// K2b CHUNKED: a block (one warp) per (slice, batch group, key tile of 32),
// walking the batch elements of its group and, for each, its slice's row
// tiles of 16. part and dbias_part as the FAST and WIDE K2b's.
template <bool DROP, bool DBIAS>
__global__ void __launch_bounds__(CHUNK_NT)
gatv2_bwd_dq_dv_chunked_kernel(const float* __restrict__ p, const float* __restrict__ q,
                               const float* __restrict__ a, const float* __restrict__ v, Args g,
                               float* __restrict__ part, float* __restrict__ dbias_part,
                               int slices, int group) {
  constexpr int RI = CHUNK_RI, KJ = CHUNK_KJ, NT = CHUNK_NT, RG = CHUNK_RG, KG = CHUNK_KG;
  constexpr int CP = CHUNK_CP;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D, W = E + D;
  const int key_tiles = (N + KJ - 1) / KJ, row_tiles = (N + RI - 1) / RI;
  const int n_groups = (g.B + group - 1) / group;
  const int kt = blockIdx.x % key_tiles, sb = blockIdx.x / key_tiles;
  const int gr = sb % n_groups, sl = sb / n_groups;
  const int b_first = gr * group, b_end = min(g.B, b_first + group);
  const int j0 = kt * KJ, kn = min(KJ, N - j0);
  const int t_begin = slice_begin(sl, row_tiles, slices);
  const int t_end = slice_begin(sl + 1, row_tiles, slices);
  const ChunkBufs c = carve_chunk(smem);
  float* ds_s = c.next;                     // [RI][KJ], keys by micro-tile
  float* wa_s = ds_s + RI * KJ;             // [RI][KJ]
  float* db = DBIAS ? dbias_part + (size_t)gr * N * N : nullptr;
  const uint32_t seed = read_seed(g);
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(a);
  const bool vec_d = D % 4 == 0 && aligned16(v) && aligned16(g.du);
  const int ti = threadIdx.x / KG, tj = threadIdx.x % KG;
  // every chunk of the score starts with a barrier: nothing to wait for
  // between batch elements
  for (int b = b_first; b < b_end; ++b) {
    float* out = part + ((size_t)(sl * g.B + b) * N + j0) * W;
    const float* pb = p + (size_t)b * N * E;
    const float* qb = q + (size_t)b * N * E;
    const float* dub = g.du + (size_t)b * N * D;
    for (int t = t_begin; t < t_end; ++t) {
      const int i0 = t * RI;
      {
        float ds[16], wa[16];
        chunked_score<DROP>(c, p, q, a, v, g, seed, b, i0, j0, vec_e, vec_d, ds, wa);
        if constexpr (DBIAS) add_dbias<RG, KG>(db, N, i0, j0, ti, tj, ds, b != b_first);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = (ti + RG * r) * KJ + 4 * tj;
          *reinterpret_cast<float4*>(ds_s + o) =
              make_float4(ds[4 * r], ds[4 * r + 1], ds[4 * r + 2], ds[4 * r + 3]);
          *reinterpret_cast<float4*>(wa_s + o) =
              make_float4(wa[4 * r], wa[4 * r + 1], wa[4 * r + 2], wa[4 * r + 3]);
        }
      }
      const int in = min(RI, N - i0);
      const bool first = t == t_begin, last = t == t_end - 1;
      // dq by E chunk, p and q restaged; the first chunk's barrier also
      // completes the tile's ds and wa
      for (int e0 = 0; e0 < E; e0 += TILE_CHUNK) {
        const int ew = min(TILE_CHUNK, E - e0), groups = (ew + 3) / 4;
        stage_chunk(c.x, pb, E, i0, RI, N, e0, ew, vec_e);
        copy_tile_async(c.y, CP, groups, qb + e0, E, j0, KJ, N, ew, vec_e, NT);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        for (int x = threadIdx.x; x < KG * groups; x += NT) {
          const int kg = x / groups, c0 = x % groups * 4;
          float acc[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[k] = 0.f;
          dq_sums<KG, KJ>(c.x, CP, c.y, CP, ds_s, kg, c0, in, g.alpha, acc);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int key = kg + KG * cc;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (key < kn && e0 + c0 + k < E)
                accumulate(out + (size_t)key * W + e0 + c0 + k, nullptr, acc[cc * 4 + k], first,
                           last, false);
          }
        }
      }
      // dv by D chunk, du restaged
      for (int d0 = 0; d0 < D; d0 += TILE_CHUNK) {
        const int dw = min(TILE_CHUNK, D - d0), groups = (dw + 3) / 4;
        stage_chunk(c.x, dub, D, i0, RI, N, d0, dw, vec_d);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        for (int x = threadIdx.x; x < KG * groups; x += NT) {
          const int kg = x / groups, c0 = x % groups * 4;
          float acc[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[k] = 0.f;
          dv_sums<KJ>(wa_s, c.x, CP, kg, c0, in, acc);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int key = kg + KG * cc;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (key < kn && d0 + c0 + k < D)
                accumulate(out + (size_t)key * W + E + d0 + c0 + k, nullptr, acc[cc * 4 + k],
                           first, last, false);
          }
        }
      }
    }
  }
}

// K2a CHUNKED: a block (one warp) per (slice, batch element, row tile of 16),
// walking its slice's key tiles of 32. part as the FAST and WIDE K2a's;
// da_part RG rows of E a block, one a row group: the caller sums them all.
template <bool DROP>
__global__ void __launch_bounds__(CHUNK_NT)
gatv2_bwd_dp_da_chunked_kernel(const float* __restrict__ p, const float* __restrict__ q,
                               const float* __restrict__ a, const float* __restrict__ v, Args g,
                               float* __restrict__ part, float* __restrict__ da_part,
                               int slices) {
  constexpr int RI = CHUNK_RI, KJ = CHUNK_KJ, NT = CHUNK_NT, RG = CHUNK_RG, KG = CHUNK_KG;
  constexpr int CP = CHUNK_CP, RS = CHUNK_RS;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, E = g.E, D = g.D;
  const int row_tiles = (N + RI - 1) / RI, key_tiles = (N + KJ - 1) / KJ;
  const int rt = blockIdx.x % row_tiles, sb = blockIdx.x / row_tiles;
  const int b = sb % g.B, sl = sb / g.B;
  const int i0 = rt * RI, in = min(RI, N - i0);
  const int t_begin = slice_begin(sl, key_tiles, slices);
  const int t_end = slice_begin(sl + 1, key_tiles, slices);
  const ChunkBufs c = carve_chunk(smem);
  float* dsT_s = c.next;                    // [KJ][RS], rows by micro-tile
  float* out = part + ((size_t)(sl * g.B + b) * N + i0) * E;
  float* da_rows = da_part + (size_t)blockIdx.x * RG * E;
  const uint32_t seed = read_seed(g);
  const bool vec_e = E % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(a);
  const bool vec_d = D % 4 == 0 && aligned16(v) && aligned16(g.du);
  const float* pb = p + (size_t)b * N * E;
  const float* qb = q + (size_t)b * N * E;
  const int ti = threadIdx.x / KG, tj = threadIdx.x % KG;
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * KJ;
    {
      float ds[16], wa[16];
      chunked_score<DROP>(c, p, q, a, v, g, seed, b, i0, j0, vec_e, vec_d, ds, wa);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        *reinterpret_cast<float4*>(dsT_s + (tj + KG * cc) * RS + 4 * ti) =
            make_float4(ds[cc], ds[4 + cc], ds[8 + cc], ds[12 + cc]);
    }
    const int kn = min(KJ, N - j0);
    const bool first = t == t_begin, last = t == t_end - 1;
    // dp and da by E chunk, p and q restaged; the first chunk's barrier also
    // completes the tile's ds
    for (int e0 = 0; e0 < E; e0 += TILE_CHUNK) {
      const int ew = min(TILE_CHUNK, E - e0), groups = (ew + 3) / 4;
      stage_chunk(c.x, pb, E, i0, RI, N, e0, ew, vec_e);
      copy_tile_async(c.y, CP, groups, qb + e0, E, j0, KJ, N, ew, vec_e, NT);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int item = threadIdx.x; item < RG * groups; item += NT) {
        const int h = item / groups, c0 = item % groups * 4;
        float dp[16], da[4];
        dp_da_sums<RG>(c.x, CP, c.y, CP, dsT_s, RS, h, c0, 0, 1, kn, g.alpha, dp, da);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = h + RG * r;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (row < in && e0 + c0 + e < E)
              accumulate(out + (size_t)row * E + e0 + c0 + e, nullptr, dp[r * 4 + e], first,
                         last, false);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e0 + c0 + e < E)
            accumulate(da_rows + (size_t)h * E + e0 + c0 + e, nullptr, da[e], first, last,
                       false);
      }
    }
  }
}

// out_a[r][c] = a_c sum_s part[s][r][c] for c < E and out_b[r][c - E] =
// sum_s part[s][r][c] for the DB columns after (W = E + DB a row), s in
// order: no atomics, the same bits every launch; cast to T.
template <typename T>
__global__ void gatv2_bwd_slice_reduce_kernel(const float* __restrict__ part,
                                              const float* __restrict__ a, T* __restrict__ out_a,
                                              T* __restrict__ out_b, long long rows, int E,
                                              int DB, int S) {
  const int W = E + DB;
  const long long n = rows * W;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < n;
       x += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + x];
    const long long r = x / W;
    const int c = (int)(x % W);
    if (c < E)
      out_a[r * E + c] = from_f<T>(a[c] * acc);
    else
      out_b[r * DB + c - E] = from_f<T>(acc);
  }
}

// ---- K2c: one block per (row tile, key tile, batch chunk) ----------------
//
// Off every path, since K2ab and K2b sum dbias in their own pass: the
// wrapper launches it only when a caller asks for it, as the yardstick those
// are timed against (chip_smoke.py, bench_gat_tiled_torch.py).
//
// Where its full-width tile does not fit a block (the feature layer above
// window 400), K2c stages E and D in chunks (dbias_width): each round stages
// the next chunk of each, and the score and du . v run on as one fmaf chain
// each, so the chunked kernel's ds is the full-width one's bit for bit. Sums:
// a block's batch elements in order, then the caller sums the chunks'
// partials in a fixed order.

size_t dbias_floats(int E, int D, int chunk) {
  return tile_floats(dbias_width(E, chunk), dbias_width(D, chunk));
}

// CHUNKED: the widths staged in chunks of `chunk` floats; without it whole,
// in one round (the loop below then compiles to the first design's staging).
template <typename T, bool DROP, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_dbias_kernel(const T* __restrict__ p, const T* __restrict__ q,
                       const T* __restrict__ a, const T* __restrict__ v, Args g,
                       float* __restrict__ dbias_part, int row_tiles, int col_tiles,
                       int batch_chunk, int chunk) {
  extern __shared__ float smem[];
  const int N = g.N, E = g.E, D = g.D;
  const int EC = CHUNKED ? dbias_width(E, chunk) : E;
  const int DC = CHUNKED ? dbias_width(D, chunk) : D;
  const int rounds = CHUNKED ? max((E + EC - 1) / EC, (D + DC - 1) / DC) : 1;
  const Tile t = carve(smem, EC, DC);
  const int tiles = row_tiles * col_tiles;
  const int c = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) / col_tiles * BI;
  const int j0 = (blockIdx.x % col_tiles) * BJ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t seed = read_seed(g);

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  if (!CHUNKED) stage_a(t, a, 0, E);
  const int b_end = min(g.B, (c + 1) * batch_chunk);
  for (int b = c * batch_chunk; b < b_end; ++b) {
    float s[ROWS], dot[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dot[r] = 0.f;
    for (int rd = 0; rd < rounds; ++rd) {
      const int e0 = rd * EC, ew = CHUNKED ? max(0, min(EC, E - e0)) : E;
      const int d0 = rd * DC, dw = CHUNKED ? max(0, min(DC, D - d0)) : D;
      __syncthreads();  // readers of the previous chunk or batch element are done
      stage_rows(t, p, g, b, i0, EC, e0, ew, DC, d0, dw);
      stage_keys(t, q, v, g, b, j0, EC, e0, ew, DC, d0, dw);
      if (CHUNKED) stage_a(t, a, e0, ew);
      if (rd == 0) stage_stats(t, g, b, i0);
      __syncthreads();
      tile_sums(t, g.alpha, EC, ew, DC, dw, s, dot);
    }
    float ds[ROWS], wa[ROWS];
    ds_tile<DROP>(t, g, seed, b, i0, j0, s, dot, ds, wa);
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

// The three tile shapes: 0 FAST, 1 WIDE, 2 CHUNKED.
__host__ __device__ inline bool tile_dims(int tile, int* ri, int* kj) {
  if (tile == 0) return *ri = TILE_FAST_RI, *kj = TILE_FAST_KJ, true;
  if (tile == 1) return *ri = TILE_WIDE_RI, *kj = TILE_WIDE_KJ, true;
  if (tile == 2) return *ri = CHUNK_RI, *kj = CHUNK_KJ, true;
  return false;
}

// Batch groups of the tiled K2b with dbias (kernels/gat.tiled_dbias_groups,
// which the launcher checks against this): the most batch elements G a block
// takes such that ceil(B / G) groups x key tiles x the most slices still give
// TILED_FILL blocks a multiprocessor, so the fold never costs the card its
// fill; 1 where even one element a group does not reach it, and all of B
// where one group does. G is 1 at B 1 and grows with B; the partials,
// ceil(B / G) of (N, N), stay a few where N is large. kernels/gat mirrors
// these three constants (TILED_FILL, TILED_MIN_TILES, TILED_MAX_SLICES),
// which set the slices there.
constexpr int TILED_FILL = 16, TILED_MIN_TILES = 4, TILED_MAX_SLICES = 64;

inline int tiled_dbias_group(int B, int N, int tile, int sms) {
  int ri = 0, kj = 0;
  if (B < 1 || N < 1 || sms < 1 || !tile_dims(tile, &ri, &kj)) return 0;
  const long long own = (N + kj - 1) / kj, stream = (N + ri - 1) / ri;
  long long most = stream / TILED_MIN_TILES;
  most = most < 1 ? 1 : most > TILED_MAX_SLICES ? TILED_MAX_SLICES : most;
  const long long target = (long long)TILED_FILL * sms, cap = most * own;
  const long long need = (target + cap - 1) / cap;  // groups the fill needs
  if (need <= 1) return B;
  const long long g = (B + need - 2) / (need - 1) - 1;
  return g < 1 ? 1 : (int)g;
}

// Shared memory of one block of K2a (which 0) or K2b (1) at tile shape
// `tile`, widths E, D and running sums in shared memory or not; 0 for a bad
// argument.
size_t tiled_floats(int which, int tile, int E, int D, bool acc_smem) {
  const TiledLayout L(E, D);
  if (which < 0 || which > 1) return 0;
  if (tile == 0)
    return which ? dq_dv_floats<TILE_FAST_RI, TILE_FAST_KJ>(L, acc_smem)
                 : dp_da_floats<TILE_FAST_RI, TILE_FAST_KJ>(L, acc_smem);
  if (tile == 1)
    return which ? dq_dv_floats<TILE_WIDE_RI, TILE_WIDE_KJ>(L, acc_smem)
                 : dp_da_floats<TILE_WIDE_RI, TILE_WIDE_KJ>(L, acc_smem);
  if (tile == 2 && !acc_smem) return chunked_floats(which);
  return 0;
}

// One tiled launch's choices (kernels/gat.gat_tiled_bwd_plan): K2b's batch
// group is 1 without dbias.
struct TiledPlan {
  int tile, slices, acc_smem, group;
};

template <typename T>
int slice_reduce(const float* part, const float* a, void* out_a, void* out_b, const Args& g,
                 int DB, int S, void* stream) {
  const long long n = (long long)g.B * g.N * (g.E + DB);
  const long long blocks = (n + 255) / 256;
  gatv2_bwd_slice_reduce_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                                      (cudaStream_t)stream>>>(
      part, a, (T*)out_a, (T*)out_b, (long long)g.B * g.N, g.E, DB, S);
  return (int)cudaGetLastError();
}

// K2b and its reduce: dq (B, N, E) and dv (B, N, D) in T, part (slices, B,
// N, E + D) float32 scratch; with DBIAS dbias_part (ceil(B / group), N, N).
template <typename T, int RI, int KJ, bool DROP, bool DBIAS>
int dq_dv_shape(const float* p, const float* q, const float* a, const float* v, const Args& g,
                void* dq, void* dv, float* dbias_part, float* part, const TiledPlan& pl,
                void* stream, int* occupancy) {
  auto kernel = gatv2_bwd_dq_dv_kernel<RI, KJ, DROP, DBIAS>;
  const size_t floats = dq_dv_floats<RI, KJ>(TiledLayout(g.E, g.D), pl.acc_smem);
  if (int err = prepare(kernel, floats)) return err;
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, RI * KJ / 16,
                                                              floats * sizeof(float));
  const long long groups = (g.B + pl.group - 1) / pl.group;
  const long long blocks = (long long)pl.slices * groups * ((g.N + KJ - 1) / KJ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, RI * KJ / 16, floats * sizeof(float), (cudaStream_t)stream>>>(
      p, q, a, v, g, part, dbias_part, pl.slices, pl.acc_smem, pl.group);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  return slice_reduce<T>(part, a, dq, dv, g, g.D, pl.slices, stream);
}

// K2a and its reduce: dp (B, N, E) in T, da_part one float32 row of E per
// block, part (slices, B, N, E) float32 scratch.
template <typename T, int RI, int KJ, bool DROP>
int dp_da_shape(const float* p, const float* q, const float* a, const float* v, const Args& g,
                void* dp, float* da_part, float* part, const TiledPlan& pl, void* stream,
                int* occupancy) {
  auto kernel = gatv2_bwd_dp_da_kernel<RI, KJ, DROP>;
  const size_t floats = dp_da_floats<RI, KJ>(TiledLayout(g.E, g.D), pl.acc_smem);
  if (int err = prepare(kernel, floats)) return err;
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, RI * KJ / 16,
                                                              floats * sizeof(float));
  const long long blocks = (long long)pl.slices * g.B * ((g.N + RI - 1) / RI);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, RI * KJ / 16, floats * sizeof(float), (cudaStream_t)stream>>>(
      p, q, a, v, g, part, da_part, pl.slices, pl.acc_smem);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  return slice_reduce<T>(part, a, dp, nullptr, g, 0, pl.slices, stream);
}

// The FAST or WIDE K2a (which 0) or K2b (1), K2b with dbias where dbias_part
// is non-null.
template <typename T, int RI, int KJ, bool DROP>
int tiled_shape(int which, const float* p, const float* q, const float* a, const float* v,
                const Args& g, void* out0, void* out1, float* dbias_part, float* part,
                const TiledPlan& pl, void* stream, int* occupancy) {
  if (which == 0)
    return dp_da_shape<T, RI, KJ, DROP>(p, q, a, v, g, out0, (float*)out1, part, pl, stream,
                                        occupancy);
  return dbias_part != nullptr
             ? dq_dv_shape<T, RI, KJ, DROP, true>(p, q, a, v, g, out0, out1, dbias_part, part,
                                                  pl, stream, occupancy)
             : dq_dv_shape<T, RI, KJ, DROP, false>(p, q, a, v, g, out0, out1, nullptr, part,
                                                   pl, stream, occupancy);
}

// The CHUNKED K2a (which 0) or K2b (1, with dbias where dbias_part is
// non-null) and its reduce; occupancy as tiled().
template <typename T, bool DROP>
int chunked(int which, const float* p, const float* q, const float* a, const float* v,
            const Args& g, void* out0, void* out1, float* dbias_part, float* part,
            const TiledPlan& pl, void* stream, int* occupancy) {
  const size_t bytes = chunked_floats(which) * sizeof(float);
  auto k2a = gatv2_bwd_dp_da_chunked_kernel<DROP>;
  auto k2b = dbias_part != nullptr ? gatv2_bwd_dq_dv_chunked_kernel<DROP, true>
                                   : gatv2_bwd_dq_dv_chunked_kernel<DROP, false>;
  if (occupancy != nullptr)
    return (int)(which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, k2b, CHUNK_NT,
                                                                       bytes)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, k2a, CHUNK_NT,
                                                                       bytes));
  const long long own = which ? (g.N + CHUNK_KJ - 1) / CHUNK_KJ : (g.N + CHUNK_RI - 1) / CHUNK_RI;
  const long long batches = which ? (g.B + pl.group - 1) / pl.group : g.B;
  const long long blocks = (long long)pl.slices * batches * own;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (which)
    k2b<<<(unsigned)blocks, CHUNK_NT, bytes, (cudaStream_t)stream>>>(p, q, a, v, g, part,
                                                                     dbias_part, pl.slices,
                                                                     pl.group);
  else
    k2a<<<(unsigned)blocks, CHUNK_NT, bytes, (cudaStream_t)stream>>>(p, q, a, v, g, part,
                                                                     (float*)out1, pl.slices);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  return which ? slice_reduce<T>(part, a, out0, out1, g, g.D, pl.slices, stream)
               : slice_reduce<T>(part, a, out0, nullptr, g, 0, pl.slices, stream);
}

// K2a (which 0) or K2b (1, summing dbias into dbias_part where it is
// non-null) with its reduce, or (occupancy non-null) only the blocks of its
// kernel one multiprocessor holds at once.
template <typename T>
int tiled(int which, const void* p, const void* q, const void* a, const void* v,
          const Args& g, void* out0, void* out1, void* dbias_part, void* part,
          const TiledPlan& pl, void* stream, int* occupancy = nullptr) {
  if (pl.slices < 1 || pl.group < 1 || tiled_floats(which, pl.tile, g.E, g.D, pl.acc_smem) == 0)
    return (int)cudaErrorInvalidValue;
  if (which == 0 && (dbias_part != nullptr || pl.group != 1)) return (int)cudaErrorInvalidValue;
  if (dbias_part == nullptr && pl.group != 1) return (int)cudaErrorInvalidValue;
  const float *pf = (const float*)p, *qf = (const float*)q, *af = (const float*)a,
              *vf = (const float*)v;
  float *pt = (float*)part, *db = (float*)dbias_part;
  const bool drop = g.seed != nullptr;
  if (pl.tile == 2)
    return drop ? chunked<T, true>(which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream,
                                   occupancy)
                : chunked<T, false>(which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream,
                                    occupancy);
  if (pl.tile == 0)
    return drop ? tiled_shape<T, TILE_FAST_RI, TILE_FAST_KJ, true>(
                      which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream, occupancy)
                : tiled_shape<T, TILE_FAST_RI, TILE_FAST_KJ, false>(
                      which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream, occupancy);
  return drop ? tiled_shape<T, TILE_WIDE_RI, TILE_WIDE_KJ, true>(
                    which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream, occupancy)
              : tiled_shape<T, TILE_WIDE_RI, TILE_WIDE_KJ, false>(
                    which, pf, qf, af, vf, g, out0, out1, db, pt, pl, stream, occupancy);
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

template <typename T, bool DROP, bool CHUNKED>
int dbias(const void* p, const void* q, const void* a, const void* v, const Args& g,
          void* part, int n_chunks, int chunk, void* stream) {
  auto kernel = gatv2_bwd_dbias_kernel<T, DROP, CHUNKED>;
  const size_t floats = dbias_floats(g.E, g.D, chunk);
  if (int err = prepare(kernel, floats)) return err;
  const int row_tiles = (g.N + BI - 1) / BI, col_tiles = (g.N + BJ - 1) / BJ;
  const int batch_chunk = (g.B + n_chunks - 1) / n_chunks;
  kernel<<<row_tiles * col_tiles * n_chunks, THREADS, floats * sizeof(float),
           (cudaStream_t)stream>>>((const T*)p, (const T*)q, (const T*)a, (const T*)v, g,
                                   (float*)part, row_tiles, col_tiles, batch_chunk, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dbias_dispatch(const void* p, const void* q, const void* a, const void* v, const Args& g,
                   void* part, int n_chunks, int chunk, void* stream) {
  const bool drop = g.seed != nullptr;
  if (chunk > 0)
    return drop ? dbias<T, true, true>(p, q, a, v, g, part, n_chunks, chunk, stream)
                : dbias<T, false, true>(p, q, a, v, g, part, n_chunks, chunk, stream);
  return drop ? dbias<T, true, false>(p, q, a, v, g, part, n_chunks, 0, stream)
              : dbias<T, false, false>(p, q, a, v, g, part, n_chunks, 0, stream);
}

}  // namespace

#define GAT_BWD_ARGS                                                                  \
  const void *p, const void *q, const void *a, const void *bias, const void *v,      \
      const void *seed, const void *m, const void *l, const void *du, const void *dvec
#define GAT_BWD_SIZES int B, int N, int E, int D
#define GAT_BWD_DROP float alpha, unsigned int thresh, float scale, void *stream
#define GAT_BWD_G make_args(bias, seed, m, l, du, dvec, B, N, E, D, alpha, thresh, scale)

extern "C" {

// Bytes of shared memory one block of K2ab (which 3) needs at graph size N
// and widths E and D; -1 for another kernel (gatv2_bwd_tiled_smem_bytes and
// gatv2_bwd_dbias_smem_bytes give the tiled K2a and K2b's and K2c's).
long gatv2_bwd_smem_bytes(int which, int N, int E, int D) {
  if (which == 3) return (long)(GraphLayout(N, E, D).floats() * sizeof(float));
  return -1;
}

// Bytes of shared memory one K2c block needs at widths E and D, staged whole
// (chunk 0) or in chunks of `chunk` floats.
long gatv2_bwd_dbias_smem_bytes(int E, int D, int chunk) {
  return (long)(dbias_floats(E, D, chunk) * sizeof(float));
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

// The tiled K2a and K2b's layout, for the planner's check
// (kernels/gat._tiled_plan): rows and keys of tile shape `tile`
// (out[0], out[1]; 0 for a bad tile), and the shared-memory bytes of one
// block of K2a (which 0) or K2b (1), 0 for a bad argument.
void gatv2_bwd_tiled_tile(int tile, int* out) {
  out[0] = out[1] = 0;
  tile_dims(tile, out, out + 1);
}
long gatv2_bwd_tiled_smem_bytes(int which, int tile, int E, int D, int acc_smem) {
  return (long)(tiled_floats(which, tile, E, D, acc_smem != 0) * sizeof(float));
}
// Key splits of K2a's contraction at `items` (row groups x float4 groups of
// E) on `threads` threads.
int gatv2_bwd_tiled_key_splits(int items, int threads) { return key_splits(items, threads); }
// Batch elements a block of the tiled K2b with dbias sums over, at batch B,
// N nodes, tile shape `tile` on a card of `sms` multiprocessors; 0 for a bad
// argument.
int gatv2_bwd_tiled_dbias_group(int B, int N, int tile, int sms) {
  return tiled_dbias_group(B, N, tile, sms);
}

// Blocks of the tiled K2a (which 0) or K2b (1), float32, with dropout or not
// and (K2b) with dbias or not, that one multiprocessor holds at once (CUDA's
// occupancy calculator); negative on a CUDA error.
int gatv2_bwd_tiled_occupancy(int which, int tile, int E, int D, int acc_smem, int drop,
                              int dbias) {
  long long one = 0;
  float part = 0.f;
  const Args g = make_args(nullptr, drop ? &one : nullptr, nullptr, nullptr, nullptr, nullptr,
                           1, 1, E, D, 0.f, 0u, 1.f);
  int blocks = 0;
  const int err = tiled<float>(which, nullptr, nullptr, nullptr, nullptr, g, nullptr, nullptr,
                               dbias ? &part : nullptr, nullptr,
                               TiledPlan{tile, 1, acc_smem, 1}, nullptr, &blocks);
  return err ? -err : blocks;
}

// K2a: dp (B, N, E) in T and da_part (blocks, E) float32, one row a block
// (slices x B x ceil(N / RI) rows; RG = 4 rows a block with the CHUNKED
// tile): the caller sums them. K2b: dq (B, N, E) and dv (B, N, D) in T and,
// with dbias_part non-null, K2c's dbias: a block takes `group` batch
// elements and writes their sum of ds into its (N, N) float32 slice of
// dbias_part (ceil(B / group), N, N), which the caller sums (with one group
// it is dbias itself); without it, pass group 1. p, q, a and v are float32
// whatever T; part is the float32 scratch of the slices' partial sums,
// (slices, B, N, E) for K2a and (slices, B, N, E + D) for K2b.
#define GAT_TILED_TAIL int tile, int slices, int acc_smem
int gatv2_bwd_dp_da_f32(GAT_BWD_ARGS, void* dp, void* da_part, void* part, GAT_BWD_SIZES,
                        GAT_TILED_TAIL, GAT_BWD_DROP) {
  return tiled<float>(0, p, q, a, v, GAT_BWD_G, dp, da_part, nullptr, part,
                      TiledPlan{tile, slices, acc_smem, 1}, stream);
}
int gatv2_bwd_dp_da_bf16(GAT_BWD_ARGS, void* dp, void* da_part, void* part, GAT_BWD_SIZES,
                         GAT_TILED_TAIL, GAT_BWD_DROP) {
  return tiled<__nv_bfloat16>(0, p, q, a, v, GAT_BWD_G, dp, da_part, nullptr, part,
                              TiledPlan{tile, slices, acc_smem, 1}, stream);
}
int gatv2_bwd_dq_dv_f32(GAT_BWD_ARGS, void* dq, void* dv, void* dbias_part, void* part,
                        GAT_BWD_SIZES, GAT_TILED_TAIL, int group, GAT_BWD_DROP) {
  return tiled<float>(1, p, q, a, v, GAT_BWD_G, dq, dv, dbias_part, part,
                      TiledPlan{tile, slices, acc_smem, group}, stream);
}
int gatv2_bwd_dq_dv_bf16(GAT_BWD_ARGS, void* dq, void* dv, void* dbias_part, void* part,
                         GAT_BWD_SIZES, GAT_TILED_TAIL, int group, GAT_BWD_DROP) {
  return tiled<__nv_bfloat16>(1, p, q, a, v, GAT_BWD_G, dq, dv, dbias_part, part,
                              TiledPlan{tile, slices, acc_smem, group}, stream);
}

// K2c. part is (n_chunks, N, N) float32, one (N, N) sum a batch chunk: the
// caller sums over chunks (with one chunk it is dbias itself). chunk: the
// widths staged at once, 0 for E and D whole.
int gatv2_bwd_dbias_f32(GAT_BWD_ARGS, void* part, GAT_BWD_SIZES, int n_chunks, int chunk,
                        GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return dbias_dispatch<float>(p, q, a, v, g, part, n_chunks, chunk, stream);
}
int gatv2_bwd_dbias_bf16(GAT_BWD_ARGS, void* part, GAT_BWD_SIZES, int n_chunks, int chunk,
                         GAT_BWD_DROP) {
  const Args g = GAT_BWD_G;
  return dbias_dispatch<__nv_bfloat16>(p, q, a, v, g, part, n_chunks, chunk, stream);
}

}  // extern "C"
