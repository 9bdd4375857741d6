// Fused GRU scan backward (BPTT) for Hopper (sm_90a).
//
// Replaces the backward kernel of the JAX package's fused GRU scan,
// mtad_gat_tpu/kernels/gru_pallas.py::_gru_bwd_kernel (launched by
// _gru_scan_bwd): reverse-time BPTT of torch's cell
//
//     r = sigmoid(gi_r + h W_hr + b_hr)
//     z = sigmoid(gi_z + h W_hz + b_hz)
//     n = tanh(gi_n + r * (h W_hn + b_hn))
//     h' = (1 - z) n + z h
//
// from the saved hidden states: at step t the gates are recomputed from
// h_{t-1}, dh = carry + dhseq_t, and
//
//     dn_pre = dh (1 - z) (1 - n^2)      dz_pre = dh (h_{t-1} - n) z (1 - z)
//     dr_pre = dn_pre (h W_hn + b_hn) r (1 - r)      dghn = dn_pre r
//     dgi_t  = (dr_pre, dz_pre, dn_pre)
//     carry  = dh z + (dr_pre, dz_pre, dghn) . W_hh^T
//     dW_hh += h_{t-1}^T (dr_pre, dz_pre, dghn)      db_hh += sum_b of the same
//
// The TPU kernel accumulates dW_hh and db_hh inside its serial grid. Here
// that sum crosses blocks (and one block's 150 x 450 partial would not fit
// its shared memory), so the work is three kernels:
//
// 1. The serial chain, which walks the steps backwards and writes dgi and
//    dghn. Only dg . W_hh^T is on the chain; the gate recompute of step t-1
//    reads saved states. Two variants, chosen by the caller from the width
//    (kernels/gru.py::gru_plan):
//    a. gru_bwd_cluster_kernel, for the widths whose two W_hh slices fit on
//       chip: a batch tile of CL_BB rows belongs to a thread-block cluster of
//       C blocks, and block c owns its hidden units U_c twice: as gate columns
//       (its columns of W_hh, for the gate recompute) and as rows e of
//       dg . W_hh^T (its columns of the transposed copy), both in shared
//       memory for all T steps (gru_cluster.cuh has the split and the step
//       product). A step: the block forms dr_pre, dz_pre, dn_pre and dghn of
//       its units, writes its 3 |U_c| values of dg per row into every block's
//       dg buffer through distributed shared memory (two buffers, one
//       cluster barrier a step), and after the barrier sums dg . W_hh^T for
//       its own units. Between the barrier's two halves, where no peer
//       waits for it, it stores dgi and dghn, loads gi and dhseq of the next
//       step into registers, and recomputes h_{t-2} . W_hh for its columns
//       (h_{t-2} was loaded during the gate update); the recompute and the
//       carry product run on different warps, side by side.
//    b. gru_bwd_scan_kernel, the streaming variant for wider H: one block
//       per tile of BB batch rows with the carry in shared memory; one loop
//       over the hidden units computes both products (two independent chains
//       of multiply-adds per thread) from W_hh and its transposed copy in L2
//       (270 KB each at hidden 150), and a step costs two block barriers.
// 2. gru_bwd_weights_kernel, off the chain: dW_hh = hprev^T . dgh over all
//    B * T rows as a tiled product, split over row chunks so that the small
//    (H, 3H) output still fills the card; each block writes its partial tile
//    (and, for the first tile row, the partial column sums that are db_hh).
// 3. gru_bwd_reduce_kernel sums the partials in a fixed order, so two runs
//    give the same bits. No float atomics anywhere, and the chain's sums run
//    in a fixed order in both variants.
//
// What bounds it on the card: the chain is latency-bound like the forward
// (per step a gate update, a cluster barrier and a product from shared
// memory; or two block barriers and 2 x H dependent loads from L2); the
// weights product is bound by float32 operations outside the tensor cores.
//
// Layouts: gi (B, T, 3H) float32 or bfloat16; w_hh (H, 3H) and w_hh_t
// (3H, H) float32; b_hh (3H,); hseq, dhseq (B, T, H) float32; dgi (B, T, 3H)
// float32; dghn (B, T, H) float32 scratch; gate order (r, z, n). h_{-1} is
// zero and is never read from memory; the ragged last batch tile is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

namespace {

constexpr int BB = 8;              // batch rows per block of the streaming scan
constexpr int SCAN_THREADS = 512;
constexpr int CL_BB = 12;           // batch rows per cluster of the cluster scan

constexpr int TK = 64;             // weights product: tile of hidden units
constexpr int TC = 64;             // tile of gate columns
constexpr int RM = 16;             // rows of (b, t) per stage
constexpr int W_THREADS = 256;     // each thread owns a 4 x 4 patch of the tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// hT (two buffers), gh, dgT, part: (2 + 3 + 3 + 3) H BB; dhz: H BB.
size_t scan_smem_bytes(int H) { return (size_t)12 * H * BB * sizeof(float); }

// acc[0..8) += (v0, v1) * s for two float4 halves of a column of BB rows
__device__ __forceinline__ void fma8(float (&acc)[BB], const float4& v0, const float4& v1,
                                     float s) {
  acc[0] = fmaf(v0.x, s, acc[0]);
  acc[1] = fmaf(v0.y, s, acc[1]);
  acc[2] = fmaf(v0.z, s, acc[2]);
  acc[3] = fmaf(v0.w, s, acc[3]);
  acc[4] = fmaf(v1.x, s, acc[4]);
  acc[5] = fmaf(v1.y, s, acc[5]);
  acc[6] = fmaf(v1.z, s, acc[6]);
  acc[7] = fmaf(v1.w, s, acc[7]);
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
gru_bwd_scan_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
                    const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                    const float* __restrict__ hseq, const float* __restrict__ dhseq,
                    float* __restrict__ dgi, float* __restrict__ dghn,
                    int B, int n_steps, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* h_cur = smem;                  // [H][BB]: h_{t-1} transposed
  float* h_nxt = h_cur + H * BB;        // [H][BB]: h_{t-2}, for the next step
  float* gh = h_nxt + H * BB;           // [BB][3H]: h_{t-1} . W_hh + b_hh
  float* dgT = gh + BB * H3;            // [3H][BB]: (dr_pre, dz_pre, dghn) transposed
  float* part = dgT + H3 * BB;          // [BB][3H]: dg . W_hh^T, one third per gate
  float* dhz = part + BB * H3;          // [BB][H]: dh . z
  const int b0 = blockIdx.x * BB;

  // carry = 0; h_cur = h_{T-2}; gh of the last step
  for (int x = threadIdx.x; x < BB * H3; x += blockDim.x) {
    part[x] = 0.f;
    dgT[x] = 0.f;
  }
  for (int x = threadIdx.x; x < BB * H; x += blockDim.x) {
    const int r = x / H, k = x % H;
    const int row = b0 + r;
    dhz[x] = 0.f;
    h_cur[k * BB + r] = (n_steps > 1 && row < B)
        ? hseq[((size_t)row * n_steps + n_steps - 2) * H + k] : 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H3; c += blockDim.x) {
    const float bias = b_hh[c];
    float acc[BB];
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = bias;
    const float* wc = w_hh + c;
#pragma unroll 4
    for (int e = 0; e < H; ++e) {
      const float w = __ldg(wc + (size_t)e * H3);
      const float4 h0 = *reinterpret_cast<const float4*>(h_cur + e * BB);
      const float4 h1 = *reinterpret_cast<const float4*>(h_cur + e * BB + 4);
      fma8(acc, h0, h1, w);
    }
#pragma unroll
    for (int r = 0; r < BB; ++r) gh[r * H3 + c] = acc[r];
  }
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    // gates and gate gradients of step t; stage h_{t-2} for the next step
    for (int x = threadIdx.x; x < BB * H; x += blockDim.x) {
      const int r = x / H, k = x % H;
      const int row = b0 + r;
      const bool live = row < B;
      if (t > 0)
        h_nxt[k * BB + r] = (t > 1 && live)
            ? hseq[((size_t)row * n_steps + t - 2) * H + k] : 0.f;
      if (live) {
        const size_t bt = (size_t)row * n_steps + t;
        const T* g = gi + bt * H3;
        const float* ghr = gh + r * H3;
        const float* pr = part + r * H3;
        const float hp = h_cur[k * BB + r];
        const float ghn = ghr[2 * H + k];
        const float rg = sigmoid(to_f(g[k]) + ghr[k]);
        const float zg = sigmoid(to_f(g[H + k]) + ghr[H + k]);
        const float ng = tanhf(to_f(g[2 * H + k]) + rg * ghn);
        const float dh = dhz[x] + pr[k] + pr[H + k] + pr[2 * H + k] + dhseq[bt * H + k];
        const float dn_pre = dh * (1.f - zg) * (1.f - ng * ng);
        const float dz_pre = dh * (hp - ng) * zg * (1.f - zg);
        const float dr_pre = dn_pre * ghn * rg * (1.f - rg);
        const float dgn = dn_pre * rg;
        float* dg = dgi + bt * H3;
        dg[k] = dr_pre;
        dg[H + k] = dz_pre;
        dg[2 * H + k] = dn_pre;
        dghn[bt * H + k] = dgn;
        dgT[k * BB + r] = dr_pre;
        dgT[(H + k) * BB + r] = dz_pre;
        dgT[(2 * H + k) * BB + r] = dgn;
        dhz[x] = dh * zg;
      }
    }
    if (t == 0) break;
    __syncthreads();

    // thread c = (gate, e): part[:, c] = sum_k dg[:, gate H + k] W_hh[e, gate H + k]
    // and gh[:, c] = b_hh[c] + sum_k h_{t-2}[:, k] W_hh[k, c], for the next step
    for (int c = threadIdx.x; c < H3; c += blockDim.x) {
      const int gate = c / H, e = c % H;
      float acc_d[BB], acc_h[BB];
      const float bias = b_hh[c];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        acc_d[r] = 0.f;
        acc_h[r] = bias;
      }
      const float* wt = w_hh_t + (size_t)gate * H * H + e;
      const float* dgp = dgT + gate * H * BB;
      const float* wc = w_hh + c;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const float w_t = __ldg(wt + (size_t)k * H);
        const float w_f = __ldg(wc + (size_t)k * H3);
        const float4 d0 = *reinterpret_cast<const float4*>(dgp + k * BB);
        const float4 d1 = *reinterpret_cast<const float4*>(dgp + k * BB + 4);
        const float4 h0 = *reinterpret_cast<const float4*>(h_nxt + k * BB);
        const float4 h1 = *reinterpret_cast<const float4*>(h_nxt + k * BB + 4);
        fma8(acc_d, d0, d1, w_t);
        fma8(acc_h, h0, h1, w_f);
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        part[r * H3 + c] = acc_d[r];
        gh[r * H3 + c] = acc_h[r];
      }
    }
    __syncthreads();
    float* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
}

constexpr int CL_SPLIT = 4;        // most partial sums per column, cluster scan

__device__ __forceinline__ float colsum(const float* part, int stride, int split, int j,
                                        int r) {
  return gru_cluster::column_sum<CL_BB, CL_SPLIT>(part, stride, split, j, r);
}

// Bytes of shared memory of one block of the cluster scan.
size_t cluster_smem_bytes(int H, int C) {
  const gru_cluster::Tiling tl = gru_cluster::tiling(H, C, CL_SPLIT);
  return (size_t)(2 * H * CL_BB + 2 * 3 * H * CL_BB + 2 * tl.split * CL_BB * tl.stride +
                  2 * H * tl.stride + tl.stride) * sizeof(float);
}

// RB is CL_BB: the batch rows of the cluster.
template <typename T, int RB>
__global__ void __launch_bounds__(gru_cluster::THREADS)
gru_bwd_cluster_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
                       const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                       const float* __restrict__ hseq, const float* __restrict__ dhseq,
                       float* __restrict__ dgi, float* __restrict__ dghn,
                       int B, int n_steps, int H) {
  namespace gc = gru_cluster;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const gc::Tiling tl = gc::tiling(H, C, CL_SPLIT);
  const int k0 = gc::unit_start(H, C, rank), nu = gc::unit_count(H, C, rank);
  const int H3 = 3 * H;
  const int b0 = (blockIdx.x / C) * RB;

  // every block lays its shared memory out alike, so a peer's dg buffers sit
  // at the same offset as this block's
  extern __shared__ __align__(16) float smem[];
  float* h_cur = smem;                               // [H][RB]: h_{t-1} transposed
  float* h_nxt = h_cur + H * RB;                     // [H][RB]: h_{t-2}
  float* dgT = h_nxt + H * RB;                       // [2][3H][RB]: (dr_pre, dz_pre, dghn)
  float* ghp = dgT + 2 * H3 * RB;                    // [split][RB][stride]: h_{t-1} . W_hh
  float* pd = ghp + tl.split * RB * tl.stride;       // [split][RB][stride]: dg . W_hh^T
  float* ws = pd + tl.split * RB * tl.stride;        // [H][stride]: W_hh[:, gate H + u]
  float* wt = ws + H * tl.stride;                    // [H][stride]: W_hh[u, gate H + :]
  float* bias = wt + H * tl.stride;                  // [stride]

  gc::load_slice(ws, w_hh, H, H3, H, k0, nu, tl);
  gc::load_slice(wt, w_hh_t, H, H, H * H, k0, nu, tl);
  gc::load_slice(bias, b_hh, 1, 0, H, k0, nu, tl);
  for (int x = threadIdx.x; x < tl.split * RB * tl.stride; x += blockDim.x) pd[x] = 0.f;

  // h_cur = h_{T-2}. Element x of a (H, RB) buffer is (unit x / RB, row x % RB).
  for (int x = threadIdx.x; x < H * RB; x += blockDim.x) {
    const bool there = b0 + x % RB < B && n_steps > 1;
    h_cur[x] = there
        ? hseq[((size_t)(b0 + x % RB) * n_steps + n_steps - 2) * H + x / RB] : 0.f;
  }

  // the step products: column group pg (all of one gate), partial sum ps.
  // Where the block has the threads, other warps take the carry product than
  // the gate recompute, so the two run side by side.
  const int pg = threadIdx.x % tl.groups_pad;
  const bool two_teams = 2 * tl.split * tl.groups_pad <= gc::THREADS;
  const int team = threadIdx.x / tl.groups_pad / tl.split;
  const int ps = threadIdx.x / tl.groups_pad % tl.split;
  const bool in_recompute = 4 * pg < tl.stride && team == 0;
  const bool in_carry = 4 * pg < tl.stride && team == (two_teams ? 1 : 0);
  const int p_gate = min(4 * pg / tl.gate_cols, 2);
  // the gate update: batch row r (fastest) and own unit u
  const int r = threadIdx.x % RB, u = threadIdx.x / RB;
  const bool in_gates = u < nu;
  const bool live = in_gates && b0 + r < B;
  const int k = k0 + u;
  const size_t row0 = (size_t)(b0 + r) * n_steps;
  float g_cur[3], dh_in, dhz = 0.f;
#pragma unroll
  for (int g = 0; g < 3; ++g)
    g_cur[g] = live ? to_f(gi[(row0 + n_steps - 1) * H3 + g * H + k]) : 0.f;
  dh_in = live ? dhseq[(row0 + n_steps - 1) * H + k] : 0.f;
  __syncthreads();
  if (in_recompute) gc::partial_product<RB>(h_cur, ws, ghp, H, tl.stride, tl.split, pg, ps);
  // no block writes into a peer before every block of the cluster runs
  cluster.sync();

  for (int t = n_steps - 1; t >= 0; --t) {
    float* dg_buf = dgT + (t & 1) * H3 * RB;
    // h_{t-2} for the coming gate recompute: in flight during the gate update
    float h_reg[gc::STAGE];
#pragma unroll
    for (int i = 0; i < gc::STAGE; ++i) {
      const int x = threadIdx.x + i * gc::THREADS;
      const bool there = x < H * RB && b0 + x % RB < B && t > 1;
      h_reg[i] = there
          ? hseq[((size_t)(b0 + x % RB) * n_steps + t - 2) * H + x / RB] : 0.f;
    }
    // gates and gate gradients of step t for the own units
    float dr_pre = 0.f, dz_pre = 0.f, dn_pre = 0.f, dgn = 0.f;
    if (in_gates) {
      const int gw = tl.gate_cols;
      const float ghr = bias[u] + colsum(ghp, tl.stride, tl.split, u, r);
      const float ghz = bias[gw + u] + colsum(ghp, tl.stride, tl.split, gw + u, r);
      const float ghn = bias[2 * gw + u] + colsum(ghp, tl.stride, tl.split, 2 * gw + u, r);
      const float carry = colsum(pd, tl.stride, tl.split, u, r) +
                          colsum(pd, tl.stride, tl.split, gw + u, r) +
                          colsum(pd, tl.stride, tl.split, 2 * gw + u, r);
      const float hp = h_cur[k * RB + r];
      const float rg = sigmoid(g_cur[0] + ghr);
      const float zg = sigmoid(g_cur[1] + ghz);
      const float ng = tanhf(g_cur[2] + rg * ghn);
      const float dh = dhz + carry + dh_in;
      dn_pre = dh * (1.f - zg) * (1.f - ng * ng);
      dz_pre = dh * (hp - ng) * zg * (1.f - zg);
      dr_pre = dn_pre * ghn * rg * (1.f - rg);
      dgn = dn_pre * rg;
      dhz = dh * zg;
      if (t > 0) {
        for (int c = 0; c < C; ++c) {
          float* dst = cluster.map_shared_rank(dg_buf, c);
          dst[k * RB + r] = dr_pre;
          dst[(H + k) * RB + r] = dz_pre;
          dst[(2 * H + k) * RB + r] = dgn;
        }
      }
    }
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < gc::STAGE; ++i) {
        const int x = threadIdx.x + i * gc::THREADS;
        if (x < H * RB) h_nxt[x] = h_reg[i];
      }
      gc::cluster_arrive();
    }
    // off the chain: this step's outputs, the coming steps' inputs
    if (live) {
      float* dg = dgi + (row0 + t) * H3 + k;
      dg[0] = dr_pre;
      dg[H] = dz_pre;
      dg[2 * H] = dn_pre;
      dghn[(row0 + t) * H + k] = dgn;
    }
    // the last step sends nothing: no block writes into a peer after the
    // barrier of step 1, so the blocks leave on their own
    if (t == 0) break;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      g_cur[g] = live ? to_f(gi[(row0 + t - 1) * H3 + g * H + k]) : 0.f;
    dh_in = live ? dhseq[(row0 + t - 1) * H + k] : 0.f;
    __syncthreads();
    // h_{t-2} . W_hh for the own columns, while the peers' dg arrives
    if (in_recompute)
      gc::partial_product<RB>(h_nxt, ws, ghp, H, tl.stride, tl.split, pg, ps);
    gc::cluster_wait();
    // column (gate, e): sum_k dg[:, gate H + k] W_hh[e, gate H + k]
    if (in_carry)
      gc::partial_product<RB>(dg_buf + p_gate * H * RB, wt, pd, H, tl.stride, tl.split, pg,
                              ps);
    __syncthreads();
    float* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
}

// Row m = b * T + t of the two operands: hprev (zero at t = 0, else row m - 1
// of hseq) and dgh = (dgi[:, :2H], dghn).
__global__ void __launch_bounds__(W_THREADS)
gru_bwd_weights_kernel(const float* __restrict__ hseq, const float* __restrict__ dgi,
                       const float* __restrict__ dghn, float* __restrict__ part,
                       float* __restrict__ dbpart, int M, int n_steps, int H, int chunk) {
  __shared__ __align__(16) float As[RM][TK];
  __shared__ __align__(16) float Bs[RM][TC];
  const int H3 = 3 * H;
  const int c0 = blockIdx.x * TC, k0 = blockIdx.y * TK, s = blockIdx.z;
  const int m_begin = s * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool sums = blockIdx.y == 0 && ty == 0;

  float acc[4][4];
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += RM) {
    for (int x = threadIdx.x; x < RM * TK; x += W_THREADS) {
      const int mm = x / TK, kk = x % TK;
      const int m = m0 + mm, k = k0 + kk;
      float a = 0.f;
      if (m < m_end && k < H && m % n_steps != 0) a = hseq[(size_t)(m - 1) * H + k];
      As[mm][kk] = a;
    }
    for (int x = threadIdx.x; x < RM * TC; x += W_THREADS) {
      const int mm = x / TC, cc = x % TC;
      const int m = m0 + mm, c = c0 + cc;
      float b = 0.f;
      if (m < m_end && c < H3)
        b = c < 2 * H ? dgi[(size_t)m * H3 + c] : dghn[(size_t)m * H + c - 2 * H];
      Bs[mm][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < RM; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[mm][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[mm][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (sums) {
#pragma unroll
        for (int j = 0; j < 4; ++j) colsum[j] += b[j];
      }
    }
    __syncthreads();
  }

  float* out = part + (size_t)s * H * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < H3) out[(size_t)k * H3 + c] = acc[i][j];
    }
  }
  if (sums) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < H3) dbpart[(size_t)s * H3 + c] = colsum[j];
    }
  }
}

// dw[x] = sum_s part[s][x] and db[c] = sum_s dbpart[s][c], s in order.
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ dbpart,
                                      float* __restrict__ dw, float* __restrict__ db,
                                      int n_w, int n_b, int S) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < n_w) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[(size_t)s * n_w + x];
    dw[x] = acc;
  } else if (x < n_w + n_b) {
    const int c = x - n_w;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += dbpart[(size_t)s * n_b + c];
    db[c] = acc;
  }
}

template <typename T>
int launch_scan(const void* gi, const void* w_hh, const void* w_hh_t, const void* b_hh,
                const void* hseq, const void* dhseq, void* dgi, void* dghn,
                int B, int n_steps, int H, void* stream) {
  const size_t bytes = scan_smem_bytes(H);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > SCAN_THREADS) threads = SCAN_THREADS;
  const int blocks = (B + BB - 1) / BB;
  gru_bwd_scan_kernel<T><<<blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)gi, (const float*)w_hh, (const float*)w_hh_t, (const float*)b_hh,
      (const float*)hseq, (const float*)dhseq, (float*)dgi, (float*)dghn, B, n_steps, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cluster_scan(const void* gi, const void* w_hh, const void* w_hh_t,
                        const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                        void* dghn, int B, int n_steps, int H, int C, void* stream) {
  if (!gru_cluster::supported(H, C, CL_BB)) return (int)cudaErrorInvalidValue;
  const int clusters = (B + CL_BB - 1) / CL_BB;
  return (int)gru_cluster::launch(
      gru_bwd_cluster_kernel<T, CL_BB>, clusters, C, cluster_smem_bytes(H, C),
      (cudaStream_t)stream, (const T*)gi, (const float*)w_hh, (const float*)w_hh_t,
      (const float*)b_hh, (const float*)hseq, (const float*)dhseq, (float*)dgi,
      (float*)dghn, B, n_steps, H);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the scan needs at hidden width H: in a
// cluster of `cluster` blocks, or (cluster 0) in the streaming variant.
long gru_bwd_smem_bytes(int H, int cluster) {
  return (long)(cluster > 0 ? cluster_smem_bytes(H, cluster) : scan_smem_bytes(H));
}

// Clusters of `cluster` blocks that the card holds at once at hidden width
// H, or the negated CUDA error.
int gru_bwd_max_active_clusters(int H, int cluster) {
  return gru_cluster::max_active_clusters(gru_bwd_cluster_kernel<float, CL_BB>, cluster,
                                          cluster_smem_bytes(H, cluster));
}

// Batch rows of one cluster of the cluster scan.
int gru_bwd_batch_tile() { return CL_BB; }

// cluster > 0: the cluster scan with that many blocks per batch tile;
// cluster 0: the streaming scan.
int gru_bwd_scan_f32(const void* gi, const void* w_hh, const void* w_hh_t,
                     const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                     void* dghn, int B, int n_steps, int H, int cluster, void* stream) {
  if (cluster > 0)
    return launch_cluster_scan<float>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B,
                                      n_steps, H, cluster, stream);
  return launch_scan<float>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B, n_steps,
                            H, stream);
}

int gru_bwd_scan_bf16(const void* gi, const void* w_hh, const void* w_hh_t,
                      const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                      void* dghn, int B, int n_steps, int H, int cluster, void* stream) {
  if (cluster > 0)
    return launch_cluster_scan<__nv_bfloat16>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi,
                                              dghn, B, n_steps, H, cluster, stream);
  return launch_scan<__nv_bfloat16>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B,
                                    n_steps, H, stream);
}

// dw (H, 3H) and db (3H,) from the scan's dgi and dghn, through S row chunks:
// part (S, H, 3H) and dbpart (S, 3H) are scratch.
int gru_bwd_weights(const void* hseq, const void* dgi, const void* dghn, void* part,
                    void* dbpart, void* dw, void* db, int B, int n_steps, int H, int S,
                    void* stream) {
  const int M = B * n_steps, H3 = 3 * H;
  const int chunk = ((M + S - 1) / S + RM - 1) / RM * RM;
  const dim3 grid((H3 + TC - 1) / TC, (H + TK - 1) / TK, S);
  gru_bwd_weights_kernel<<<grid, W_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)hseq, (const float*)dgi, (const float*)dghn, (float*)part,
      (float*)dbpart, M, n_steps, H, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * H3 + H3;
  gru_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const float*)dbpart, (float*)dw, (float*)db, H * H3, H3, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
