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
//    B * T rows, with db_hh as one more row of the same product, split over
//    row chunks so that the small (H + 1, 3H) output still fills the card:
//    8 x 8 register tiles fed by a cp.async ring (its section below says more);
//    each block writes its partial tile.
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
//
// The entity axis (fleet training, the counterpart of JAX's batching rule
// for pallas_call under vmap), as in gru_fwd.cu: the B rows form G = B /
// rows_per_group groups of consecutive rows, and group g's rows read
// w_hh + g H 3H, w_hh_t + g 3H H and b_hh + g 3H. A batch tile (a block of
// the streaming scan, a cluster of the cluster scan) holds rows of one group
// only: the grid is G x ceil(rows_per_group / tile). The weights product
// splits each group's rows_per_group T rows into S chunks of its own
// (partial g S + s), so no chunk spans two groups, and the reduce sums group g's
// S partials in chunk order into dw + g H 3H and db + g 3H. The group
// arithmetic is a compile-time flag (GROUPED): at rows_per_group = B (G = 1)
// every launch runs the ungrouped instantiation, the kernels' code without
// the axis. A grouped launch gives each group the bits of an ungrouped
// launch on its rows with the same S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

namespace {

constexpr int BB = 8;              // batch rows per block of the streaming scan
constexpr int SCAN_THREADS = 512;
constexpr int CL_BB = 12;           // batch rows per cluster of the cluster scan

// The weights product (gru_bwd_weights_kernel): a thread's 8 x 8 register
// tile, the most such tiles along a block tile's rows and along its
// columns, the reduction rows of one cp.async stage and the stages of the
// ring.
constexpr int W_MICRO = 8;
constexpr int W_SIDE_M = 20;
constexpr int W_SIDE_N = 20;
constexpr int W_RM = 16;
constexpr int W_STAGES = 3;
constexpr int W_MAX_THREADS = (W_SIDE_M * W_SIDE_N + 31) / 32 * 32;
// launch bounds of 512 threads cap a thread at 128 registers, which
// kernels/gru.py::weight_grad_chunks counts on to fit blocks on a multiprocessor
constexpr int W_BOUND_THREADS = 512;
static_assert(W_MAX_THREADS <= W_BOUND_THREADS, "a block tile needs more threads than allowed");

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

// GROUPED: B is the rows of one group (the kernel needs no other count), so
// the ungrouped instantiation keeps the parameters, and the code, of the
// kernel without the axis.
template <typename T, bool GROUPED>
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
  // GROUPED: the block's group and its first row within the group
  const int tiles = GROUPED ? (B + BB - 1) / BB : 1;
  const int grp = GROUPED ? blockIdx.x / tiles : 0;
  const int r0 = GROUPED ? blockIdx.x % tiles * BB : 0;
  const int b0 = GROUPED ? grp * B + r0 : blockIdx.x * BB;
  if constexpr (GROUPED) {
    w_hh += (size_t)grp * H * H3;
    w_hh_t += (size_t)grp * H3 * H;
    b_hh += (size_t)grp * H3;
  }

  // carry = 0; h_cur = h_{T-2}; gh of the last step
  for (int x = threadIdx.x; x < BB * H3; x += blockDim.x) {
    part[x] = 0.f;
    dgT[x] = 0.f;
  }
  for (int x = threadIdx.x; x < BB * H; x += blockDim.x) {
    const int r = x / H, k = x % H;
    const int row = b0 + r;
    dhz[x] = 0.f;
    h_cur[k * BB + r] = (n_steps > 1 && (GROUPED ? r0 + r < B : row < B))
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
      const bool live = GROUPED ? r0 + r < B : row < B;
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
template <typename T, int RB, bool GROUPED>
__global__ void __launch_bounds__(gru_cluster::THREADS)
gru_bwd_cluster_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
                       const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                       const float* __restrict__ hseq, const float* __restrict__ dhseq,
                       float* __restrict__ dgi, float* __restrict__ dghn,
                       int B, int n_steps, int H, int rows_per_group) {
  namespace gc = gru_cluster;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const gc::Tiling tl = gc::tiling(H, C, CL_SPLIT);
  const int k0 = gc::unit_start(H, C, rank), nu = gc::unit_count(H, C, rank);
  const int H3 = 3 * H;
  // GROUPED: the cluster's group and its first row within the group
  const int tiles = GROUPED ? (rows_per_group + RB - 1) / RB : 1;
  const int grp = GROUPED ? (blockIdx.x / C) / tiles : 0;
  const int r0 = GROUPED ? (blockIdx.x / C) % tiles * RB : 0;
  const int b0 = GROUPED ? grp * rows_per_group + r0 : (blockIdx.x / C) * RB;
  // whether row rr of the tile exists (the last tile of a group, or of B, is ragged)
  auto row_live = [&](int rr) { return GROUPED ? r0 + rr < rows_per_group : b0 + rr < B; };

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

  if constexpr (GROUPED) {
    w_hh += (size_t)grp * H * H3;
    w_hh_t += (size_t)grp * H3 * H;
    b_hh += (size_t)grp * H3;
  }
  gc::load_slice(ws, w_hh, H, H3, H, k0, nu, tl);
  gc::load_slice(wt, w_hh_t, H, H, H * H, k0, nu, tl);
  gc::load_slice(bias, b_hh, 1, 0, H, k0, nu, tl);
  for (int x = threadIdx.x; x < tl.split * RB * tl.stride; x += blockDim.x) pd[x] = 0.f;

  // h_cur = h_{T-2}. Element x of a (H, RB) buffer is (unit x / RB, row x % RB).
  for (int x = threadIdx.x; x < H * RB; x += blockDim.x) {
    const bool there = row_live(x % RB) && n_steps > 1;
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
  const bool live = in_gates && row_live(r);
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
      const bool there = x < H * RB && row_live(x % RB) && t > 1;
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

// ---- the weights product ---------------------------------------------------
//
// dW_hh[k][c] = sum over the rows m = b T + t with t >= 1 of
// hseq[m - 1][k] dgh[m][c], and db_hh[c] = sum over every row m of dgh[m][c],
// dgh = (dgi[:, :2H], dghn): a product of (H, M) by (M, 3H) with M = B T
// reduction rows (25,600 at the flagship), bound by float32 operations on
// the CUDA cores. db_hh is the product's row H: column H of the staged first
// operand is 1 on every row, t = 0 included, so the t = 0 mask, which zeroes
// the first operand's row, leaves db whole and one loop forms both.
//
// Split K: block (column tile, row tile, chunk s) sums the rows of chunk s
// for a tile of 8 TY rows of (dW; db) by 8 TX columns of one gate; a
// column tile never straddles a gate, so its column source (dgi with row
// stride 3H for r and z, dghn with stride H for n) is fixed per tile. TY and
// TX (WTiling) cover the H + 1 rows and the H columns of a gate with as few
// tiles as W_SIDE_M and W_SIDE_N allow: at H = 150 one 152 x 152 tile a
// gate, 97% of it used. The chunk count (kernels/gru.py::weight_grad_chunks)
// fills the card in one wave with as many blocks a multiprocessor as fit:
// one at H = 150 (384 threads of 128 registers); two blocks of half the
// rows each were slower there (PERF.md).
//
// A thread owns 8 rows (4 TY apart in two groups of four) by 8 columns (the
// same for 4 TX) and reads them as float4 from shared memory: 64 FMAs for
// four 16-byte reads, neighbouring threads on neighbouring addresses, the
// next row's reads in flight during this row's FMAs. Rows are 600 or 1,800
// bytes long, so only 8-byte aligned (4-byte at an odd H) and TMA cannot
// describe them: a stage of W_RM rows comes in through 8-byte (4-byte)
// cp.async, zero-filled where a row is masked (t = 0, or past the chunk), into
// a ring of W_STAGES buffers, so the next stages' loads are in flight during
// this stage's FMAs; one block barrier a stage. Each copying thread owns one
// column pair and every step-th row of a stage, so its source address and
// the seam are worked out once, and the t = 0 test costs a compare per row.
// The columns no copy writes (A's column H, the padding) are set once.
//
// Partials (S, H + 1, 3H) are summed in chunk order by
// gru_bwd_reduce_kernel: no atomics, identical bits from run to run.

struct WTiling {
  int ty, tx;       // micro-tiles along the rows (k) and the columns (c) of a block tile
  int rt, ct;       // block tiles along the H + 1 rows, and along one gate's H columns
  int threads;      // at least one per micro-tile and one per column a stage copies
  __host__ __device__ explicit WTiling(int H) {
    const int mr = (H + 1 + W_MICRO - 1) / W_MICRO;
    rt = (mr + W_SIDE_M - 1) / W_SIDE_M;
    ty = (mr + rt - 1) / rt;
    const int mc = (H + W_MICRO - 1) / W_MICRO;
    ct = (mc + W_SIDE_N - 1) / W_SIDE_N;
    tx = (mc + ct - 1) / ct;
    int n = ty * tx;
    const int copy = W_MICRO * (ty > tx ? ty : tx);
    if (copy > n) n = copy;
    threads = (n + 31) / 32 * 32;
  }
  __host__ __device__ int bm() const { return W_MICRO * ty; }
  __host__ __device__ int bn() const { return W_MICRO * tx; }
  __host__ __device__ size_t smem_floats() const {
    return (size_t)W_STAGES * W_RM * (bm() + bn());
  }
};

// Copy V floats (4 or 8 bytes) into shared memory, or write zeros there
// when full is false.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void unpack8(float (&x)[8], const float* lo, const float* hi) {
  const float4 a = *reinterpret_cast<const float4*>(lo);
  const float4 b = *reinterpret_cast<const float4*>(hi);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// V floats a copy: 2 where H is even (every row, gate and column pair is
// then 8-byte aligned), else 1. GROUPED: M is the rows of one group (a
// multiple of n_steps), blockIdx.y runs over the groups' row tiles (group
// blockIdx.y / rt) and block (y, z) writes partial g S + z, S = gridDim.z;
// so the ungrouped instantiation keeps the parameters, and the code, of the
// kernel without the axis.
template <int V, bool GROUPED>
__global__ void __launch_bounds__(W_BOUND_THREADS, 1)
gru_bwd_weights_kernel(const float* __restrict__ hseq, const float* __restrict__ dgi,
                       const float* __restrict__ dghn, float* __restrict__ part, int M,
                       int n_steps, int H, int chunk) {
  extern __shared__ __align__(16) float wsm[];
  const WTiling tl(H);
  const int BM = tl.bm(), BN = tl.bn(), H3 = 3 * H;
  float* As = wsm;                              // [W_STAGES][W_RM][BM]
  float* Bs = wsm + W_STAGES * W_RM * BM;       // [W_STAGES][W_RM][BN]
  const int gate = blockIdx.x / tl.ct, j0 = blockIdx.x % tl.ct * BN;
  const int grp = GROUPED ? blockIdx.y / tl.rt : 0;
  const int k0 = (GROUPED ? blockIdx.y % tl.rt : blockIdx.y) * BM;
  const int s = GROUPED ? grp * gridDim.z + blockIdx.z : blockIdx.z;
  const int base = GROUPED ? grp * M : 0;
  const int m_begin = base + blockIdx.z * chunk, m_end = min(base + M, m_begin + chunk);
  const int tid = threadIdx.x, nt = blockDim.x;

  // the columns no copy writes: A's column H is the db row's 1, the rest 0
  for (int x = tid; x < W_STAGES * W_RM * BM; x += nt) {
    const int k = k0 + x % BM;
    if (k >= H) As[x] = k == H ? 1.f : 0.f;
  }
  for (int x = tid; x < W_STAGES * W_RM * BN; x += nt)
    if (j0 + x % BN >= H) Bs[x] = 0.f;

  // a copying thread's V columns and first row; it takes every step-th row
  const int a_c = tid % (BM / V) * V, a_r = tid / (BM / V), a_step = nt / (BM / V);
  const bool a_live = k0 + a_c < H && a_r < a_step;
  const float* a_src = hseq + (k0 + a_live * a_c);
  const int b_c = tid % (BN / V) * V, b_r = tid / (BN / V), b_step = nt / (BN / V);
  const bool b_live = j0 + b_c < H && b_r < b_step;
  const float* b_src = (gate < 2 ? dgi + gate * H : dghn) + j0 + b_live * b_c;
  const int b_ld = gate < 2 ? H3 : H;

  auto load = [&](int slot, int m0) {
    if (a_live) {
      float* dst = As + slot * W_RM * BM + a_c;
      int t = (m0 + a_r) % n_steps;
      for (int r = a_r; r < W_RM; r += a_step) {
        const int m = m0 + r;
        const bool ok = m < m_end && t != 0;    // pairs with t = 0 take no dW term
        cp_async<V>(dst + r * BM, ok ? a_src + (size_t)(m - 1) * H : a_src, ok);
        t += a_step;
        while (t >= n_steps) t -= n_steps;
      }
    }
    if (b_live) {
      float* dst = Bs + slot * W_RM * BN + b_c;
      for (int r = b_r; r < W_RM; r += b_step) {
        const int m = m0 + r;
        const bool ok = m < m_end;
        cp_async<V>(dst + r * BN, ok ? b_src + (size_t)m * b_ld : b_src, ok);
      }
    }
  };

  const int n_stage = m_end > m_begin ? (m_end - m_begin + W_RM - 1) / W_RM : 0;
#pragma unroll
  for (int st = 0; st < W_STAGES - 1; ++st) {
    if (st < n_stage) load(st, m_begin + st * W_RM);
    cp_async_commit();
  }

  const bool computes = tid < tl.ty * tl.tx;
  const int ty = computes ? tid / tl.tx : 0, tx = computes ? tid % tl.tx : 0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int st = 0; st < n_stage; ++st) {
    cp_async_wait<W_STAGES - 2>();
    __syncthreads();  // stage st has landed, and every thread is done with st - 1
    const int next = st + W_STAGES - 1;
    if (next < n_stage) load(next % W_STAGES, m_begin + next * W_RM);
    cp_async_commit();
    if (computes) {
      const float* as = As + st % W_STAGES * W_RM * BM + 4 * ty;
      const float* bs = Bs + st % W_STAGES * W_RM * BN + 4 * tx;
      // two register fragments: row r + 1's reads are in flight during row r's FMAs
      float a[2][8], b[2][8];
      unpack8(a[0], as, as + BM / 2);
      unpack8(b[0], bs, bs + BN / 2);
#pragma unroll
      for (int r = 0; r < W_RM; ++r) {
        if (r + 1 < W_RM) {
          const float* an = as + (r + 1) * BM;
          const float* bn = bs + (r + 1) * BN;
          unpack8(a[(r + 1) % 2], an, an + BM / 2);
          unpack8(b[(r + 1) % 2], bn, bn + BN / 2);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[r % 2][i], b[r % 2][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  if (!computes) return;
  float* out = part + (size_t)s * (H + 1) * H3 + gate * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
    if (k > H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j0 + (j < 4 ? 4 * tx + j : BN / 2 + 4 * tx + j - 4);
      if (c < H) out[(size_t)k * H3 + c] = acc[i][j];
    }
  }
}

// (dw; db)[x] = sum_s part[s][x], s in order: x < n_w is dw, the rest db.
// GROUPED: group g = blockIdx.y sums its own S partials into dw + g n_w and
// db + g n_b.
template <bool GROUPED>
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                      float* __restrict__ db, int n_w, int n_b, int S) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_w + n_b;
  if (x >= n) return;
  if constexpr (GROUPED) {
    part += (size_t)blockIdx.y * S * n;
    dw += (size_t)blockIdx.y * n_w;
    db += (size_t)blockIdx.y * n_b;
  }
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + x];
  if (x < n_w)
    dw[x] = acc;
  else
    db[x - n_w] = acc;
}

// Tiles of `tile` rows that cover B rows in groups of rows_per_group, no
// tile holding rows of two groups; 0 where the groups do not divide B.
long group_tiles(int B, int rows_per_group, int tile) {
  if (rows_per_group < 1 || B % rows_per_group != 0) return 0;
  return (long)(B / rows_per_group) * ((rows_per_group + tile - 1) / tile);
}

template <typename T>
int launch_scan(const void* gi, const void* w_hh, const void* w_hh_t, const void* b_hh,
                const void* hseq, const void* dhseq, void* dgi, void* dghn,
                int B, int n_steps, int H, int rows_per_group, void* stream) {
  const long blocks = group_tiles(B, rows_per_group, BB);
  if (blocks < 1 || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = rows_per_group == B ? gru_bwd_scan_kernel<T, false>
                                    : gru_bwd_scan_kernel<T, true>;
  const size_t bytes = scan_smem_bytes(H);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > SCAN_THREADS) threads = SCAN_THREADS;
  kernel<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)gi, (const float*)w_hh, (const float*)w_hh_t, (const float*)b_hh,
      (const float*)hseq, (const float*)dhseq, (float*)dgi, (float*)dghn,
      rows_per_group, n_steps, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cluster_scan(const void* gi, const void* w_hh, const void* w_hh_t,
                        const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                        void* dghn, int B, int n_steps, int H, int C, int rows_per_group,
                        void* stream) {
  if (!gru_cluster::supported(H, C, CL_BB)) return (int)cudaErrorInvalidValue;
  const long clusters = group_tiles(B, rows_per_group, CL_BB);
  if (clusters < 1 || clusters * C > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = rows_per_group == B ? gru_bwd_cluster_kernel<T, CL_BB, false>
                                    : gru_bwd_cluster_kernel<T, CL_BB, true>;
  return (int)gru_cluster::launch(
      kernel, (int)clusters, C, cluster_smem_bytes(H, C),
      (cudaStream_t)stream, (const T*)gi, (const float*)w_hh, (const float*)w_hh_t,
      (const float*)b_hh, (const float*)hseq, (const float*)dhseq, (float*)dgi,
      (float*)dghn, B, n_steps, H, rows_per_group);
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
  return gru_cluster::max_active_clusters(gru_bwd_cluster_kernel<float, CL_BB, false>,
                                          cluster, cluster_smem_bytes(H, cluster));
}

// Batch rows of one cluster of the cluster scan.
int gru_bwd_batch_tile() { return CL_BB; }

// Batch tiles of a scan of B rows in groups of rows_per_group: clusters of
// the cluster scan (cluster > 0) or blocks of the streaming one (0).
long gru_bwd_tiles(int B, int rows_per_group, int cluster) {
  return group_tiles(B, rows_per_group, cluster > 0 ? CL_BB : BB);
}

// cluster > 0: the cluster scan with that many blocks per batch tile;
// cluster 0: the streaming scan. The B rows form B / rows_per_group groups,
// group g's weights at w_hh + g H 3H, w_hh_t + g 3H H and b_hh + g 3H;
// rows_per_group = B is the ungrouped kernel.
int gru_bwd_scan_f32(const void* gi, const void* w_hh, const void* w_hh_t,
                     const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                     void* dghn, int B, int n_steps, int H, int cluster, int rows_per_group,
                     void* stream) {
  if (cluster > 0)
    return launch_cluster_scan<float>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B,
                                      n_steps, H, cluster, rows_per_group, stream);
  return launch_scan<float>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B, n_steps,
                            H, rows_per_group, stream);
}

int gru_bwd_scan_bf16(const void* gi, const void* w_hh, const void* w_hh_t,
                      const void* b_hh, const void* hseq, const void* dhseq, void* dgi,
                      void* dghn, int B, int n_steps, int H, int cluster, int rows_per_group,
                      void* stream) {
  if (cluster > 0)
    return launch_cluster_scan<__nv_bfloat16>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi,
                                              dghn, B, n_steps, H, cluster, rows_per_group,
                                              stream);
  return launch_scan<__nv_bfloat16>(gi, w_hh, w_hh_t, b_hh, hseq, dhseq, dgi, dghn, B,
                                    n_steps, H, rows_per_group, stream);
}

// The weights product's tiling at hidden width H, for the planner's check:
// out = (TY, TX, row tiles, column tiles a gate, threads, shared memory bytes).
void gru_bwd_weights_tiling(int H, int* out) {
  const WTiling tl(H);
  out[0] = tl.ty, out[1] = tl.tx, out[2] = tl.rt, out[3] = tl.ct, out[4] = tl.threads;
  out[5] = (int)(tl.smem_floats() * sizeof(float));
}

// dw (H, 3H) and db (3H,) from the scan's dgi and dghn, through S row chunks:
// part (S, H + 1, 3H) is scratch. With B / rows_per_group = G groups: dw
// (G, H, 3H) and db (G, 3H), S chunks a group, part (G S, H + 1, 3H);
// rows_per_group = B is the ungrouped kernel.
int gru_bwd_weights(const void* hseq, const void* dgi, const void* dghn, void* part,
                    void* dw, void* db, int B, int n_steps, int H, int S, int rows_per_group,
                    void* stream) {
  if (rows_per_group < 1 || B % rows_per_group != 0) return (int)cudaErrorInvalidValue;
  const WTiling tl(H);
  const int G = B / rows_per_group, H3 = 3 * H;
  const int group_rows = rows_per_group * n_steps;   // B n_steps when ungrouped
  if ((long)tl.rt * G > 65535 || S > 65535) return (int)cudaErrorInvalidValue;
  const int chunk = ((group_rows + S - 1) / S + W_RM - 1) / W_RM * W_RM;
  const size_t bytes = tl.smem_floats() * sizeof(float);
  const bool grouped = G > 1;
  auto kernel = H % 2 == 0 ? (grouped ? gru_bwd_weights_kernel<2, true>
                                      : gru_bwd_weights_kernel<2, false>)
                           : (grouped ? gru_bwd_weights_kernel<1, true>
                                      : gru_bwd_weights_kernel<1, false>);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(3 * tl.ct, tl.rt * G, S);
  kernel<<<grid, tl.threads, bytes, (cudaStream_t)stream>>>(
      (const float*)hseq, (const float*)dgi, (const float*)dghn, (float*)part, group_rows,
      n_steps, H, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (H + 1) * H3;
  const dim3 rgrid((n + 255) / 256, G);
  if (grouped)
    gru_bwd_reduce_kernel<true><<<rgrid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)dw, (float*)db, H * H3, H3, S);
  else
    gru_bwd_reduce_kernel<false><<<rgrid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)dw, (float*)db, H * H3, H3, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
