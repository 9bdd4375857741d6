// Fused GRU scan forward for Hopper (sm_90a).
//
// Replaces the forward kernel of the JAX package's fused GRU scan,
// mtad_gat_tpu/kernels/gru_pallas.py::_gru_fwd_kernel (launched by
// _fwd_launch): the whole recurrence in one launch, with torch's cell
//
//     r = sigmoid(gi_r + h W_hr + b_hr)
//     z = sigmoid(gi_z + h W_hz + b_hz)
//     n = tanh(gi_n + r * (h W_hn + b_hn))
//     h' = (1 - z) n + z h
//
// where gi = x W_ih + b_ih is computed before the launch by a matrix product.
//
// What bounds it on the card: the T steps are serial, so a step's latency,
// not the card's throughput, sets the time. Each step is a (BB, H) x (H, 3H)
// product; at H = 150, W_hh is 150 x 450 float32 = 270 KB, more than the
// 227 KB of shared memory a block may use. Two variants, chosen by the
// caller from the width (kernels/gru.py::gru_plan):
//
// 1. gru_fwd_cluster_kernel, for the widths whose W_hh fits on chip when it
//    is split: a batch tile of CL_BB rows belongs to a thread-block cluster
//    of C blocks, and block c holds the columns of W_hh of its own hidden
//    units, all three gates, in shared memory for all T steps (gru_cluster.cuh
//    has the split and the step product). W_hh is read from device memory
//    once per launch. Every block holds the whole h_{t-1} of its rows (two
//    buffers), computes h . W_hh for its own columns, updates its own units
//    in its own next-step buffer, and copies that slice into the next-step
//    buffer of every peer through distributed shared memory, 16 bytes a
//    store; one cluster barrier ends the step. The step's slice of hseq goes
//    to device memory between the barrier's two halves, and gi of step t + 1
//    is loaded while step t computes: neither is on the chain. A step is two
//    block barriers and one cluster barrier. What a step costs now: the
//    product is bound by shared-memory reads (h is the same for every lane,
//    so a warp's 16-byte read of it uses a fraction of the bandwidth), and
//    the release of the peers' copies at the barrier costs about as much as
//    the gate update.
// 2. gru_fwd_kernel, the streaming variant for wider H: one block per tile
//    of BB batch rows walks all T steps with its hidden state in shared
//    memory, one thread per gate column, reading W_hh on every step from
//    device memory, where it stays resident in the 50 MB L2. A step costs a
//    chain of H dependent loads from L2.
//
// Tensor cores for the step product and W_hh in bfloat16 are later work:
// they would not hold the float32 tolerance against the plain version.
//
// Layouts are those of gru_scan_fused: gi (B, T, 3H) float32 or bfloat16,
// w_hh (H, 3H) float32, b_hh (3H,) float32, gate order (r, z, n); hseq
// (B, T, H) float32. All arithmetic is float32.
//
// The entity axis (fleet serving, the counterpart of JAX's batching rule
// for pallas_call under vmap): the B rows form G = B / rows_per_group
// groups of consecutive rows, and group g's rows read w_hh + g H 3H and
// b_hh + g 3H, so w_hh is (G, H, 3H) and b_hh (G, 3H). A batch tile (a
// block of the streaming variant, a cluster of the cluster variant) holds
// rows of one group only: the grid is G x ceil(rows_per_group / tile), and
// each tile loads its own group's W_hh. The group arithmetic is a
// compile-time flag (GROUPED), so at rows_per_group = B (G = 1) the launch
// runs the ungrouped instantiation, whose code is the kernel's without the
// axis: the same grid, tiles, registers and bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

namespace {

constexpr int BB = 8;             // batch rows per block, streaming variant
constexpr int MAX_THREADS = 1024;
constexpr int CL_BB = 12;          // batch rows per cluster, cluster variant

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

size_t smem_bytes(int H) { return (size_t)(H * BB + BB * 3 * H) * sizeof(float); }

template <typename T, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
gru_fwd_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ hseq,
               int B, int n_steps, int H, int rows_per_group) {
  extern __shared__ float smem[];
  float* hT = smem;               // [H][BB]: h transposed, float4-readable
  float* gh = hT + H * BB;        // [BB][3H]: h . W_hh + b_hh of this step
  const int H3 = 3 * H;
  // GROUPED: the block's group and its first row within the group
  const int tiles = GROUPED ? (rows_per_group + BB - 1) / BB : 1;
  const int grp = GROUPED ? blockIdx.x / tiles : 0;
  const int r0 = GROUPED ? blockIdx.x % tiles * BB : 0;
  const int b0 = GROUPED ? grp * rows_per_group + r0 : blockIdx.x * BB;
  if constexpr (GROUPED) {
    w_hh += (size_t)grp * H * H3;
    b_hh += (size_t)grp * H3;
  }

  for (int x = threadIdx.x; x < H * BB; x += blockDim.x) hT[x] = 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    for (int c = threadIdx.x; c < H3; c += blockDim.x) {
      const float bias = b_hh[c];
      float acc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] = bias;
      const float* wc = w_hh + c;
#pragma unroll 4
      for (int e = 0; e < H; ++e) {
        const float w = __ldg(wc + (size_t)e * H3);
        const float4 h0 = *reinterpret_cast<const float4*>(hT + e * BB);
        const float4 h1 = *reinterpret_cast<const float4*>(hT + e * BB + 4);
        acc[0] = fmaf(h0.x, w, acc[0]);
        acc[1] = fmaf(h0.y, w, acc[1]);
        acc[2] = fmaf(h0.z, w, acc[2]);
        acc[3] = fmaf(h0.w, w, acc[3]);
        acc[4] = fmaf(h1.x, w, acc[4]);
        acc[5] = fmaf(h1.y, w, acc[5]);
        acc[6] = fmaf(h1.z, w, acc[6]);
        acc[7] = fmaf(h1.w, w, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) gh[r * H3 + c] = acc[r];
    }
    __syncthreads();

    for (int x = threadIdx.x; x < BB * H; x += blockDim.x) {
      const int r = x / H, k = x % H;
      const int row = b0 + r;
      if (GROUPED ? r0 + r < rows_per_group : row < B) {
        const T* g = gi + ((size_t)row * n_steps + t) * H3;
        const float* ghr = gh + r * H3;
        const float rg = sigmoid(to_f(g[k]) + ghr[k]);
        const float zg = sigmoid(to_f(g[H + k]) + ghr[H + k]);
        const float ng = tanhf(to_f(g[2 * H + k]) + rg * ghr[2 * H + k]);
        const float h_new = (1.f - zg) * ng + zg * hT[k * BB + r];
        hT[k * BB + r] = h_new;
        hseq[((size_t)row * n_steps + t) * H + k] = h_new;
      }
    }
    __syncthreads();
  }
}

constexpr int CL_SPLIT = 8;       // most partial sums per column, cluster variant

__device__ __forceinline__ float colsum(const float* part, int stride, int split, int j,
                                        int r) {
  return gru_cluster::column_sum<CL_BB, CL_SPLIT>(part, stride, split, j, r);
}

// Bytes of shared memory of one block of the cluster variant.
size_t cluster_smem_bytes(int H, int C) {
  const gru_cluster::Tiling tl = gru_cluster::tiling(H, C, CL_SPLIT);
  return (size_t)(2 * H * CL_BB + tl.split * CL_BB * tl.stride + H * tl.stride + tl.stride) *
         sizeof(float);
}

// RB is CL_BB: the batch rows of the cluster.
template <typename T, int RB, bool GROUPED>
__global__ void __launch_bounds__(gru_cluster::THREADS)
gru_fwd_cluster_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
                       const float* __restrict__ b_hh, float* __restrict__ hseq,
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

  // every block lays its shared memory out alike, so a peer's h buffer sits
  // at the same offset as this block's
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;                               // [2][H][RB]: h transposed
  float* part = hT + 2 * H * RB;                  // [split][RB][stride]
  float* ws = part + tl.split * RB * tl.stride;   // [H][stride]: this block's W_hh
  float* bias = ws + H * tl.stride;               // [stride]

  for (int x = threadIdx.x; x < 2 * H * RB; x += blockDim.x) hT[x] = 0.f;
  if constexpr (GROUPED) {
    w_hh += (size_t)grp * H * H3;
    b_hh += (size_t)grp * H3;
  }
  gc::load_slice(ws, w_hh, H, H3, H, k0, nu, tl);
  gc::load_slice(bias, b_hh, 1, 0, H, k0, nu, tl);

  // the step product: column group pg, partial sum ps
  const int pg = threadIdx.x % tl.groups_pad, ps = threadIdx.x / tl.groups_pad;
  const bool in_product = 4 * pg < tl.stride && ps < tl.split;
  // the gate update: batch row r (fastest) and own unit u
  const int r = threadIdx.x % RB, u = threadIdx.x / RB;
  const bool in_gates = u < nu;
  const bool live = in_gates && (GROUPED ? r0 + r < rows_per_group : b0 + r < B);
  const int at = (k0 + u) * RB + r;                      // (unit, row) in an h buffer
  const T* gi_at = gi + (size_t)(b0 + r) * n_steps * H3 + k0 + u;
  float* hseq_at = hseq + (size_t)(b0 + r) * n_steps * H + k0 + u;
  float g_cur[3], g_nxt[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) g_cur[g] = live ? to_f(gi_at[g * H]) : 0.f;
  // no block writes into a peer before every block of the cluster runs
  cluster.sync();

  for (int t = 0; t < n_steps; ++t) {
    const float* cur = hT + (t & 1) * H * RB;
    float* nxt = hT + ((t + 1) & 1) * H * RB;
    // the next step's gi, in flight during the product
#pragma unroll
    for (int g = 0; g < 3; ++g)
      g_nxt[g] = (live && t + 1 < n_steps) ? to_f(gi_at[(size_t)(t + 1) * H3 + g * H]) : 0.f;
    if (in_product) gc::partial_product<RB>(cur, ws, part, H, tl.stride, tl.split, pg, ps);
    __syncthreads();

    float h_new = 0.f;
    if (in_gates) {
      const int gw = tl.gate_cols;
      const float ghr = bias[u] + colsum(part, tl.stride, tl.split, u, r);
      const float ghz = bias[gw + u] + colsum(part, tl.stride, tl.split, gw + u, r);
      const float ghn = bias[2 * gw + u] + colsum(part, tl.stride, tl.split, 2 * gw + u, r);
      const float rg = sigmoid(g_cur[0] + ghr);
      const float zg = sigmoid(g_cur[1] + ghz);
      const float ng = tanhf(g_cur[2] + rg * ghn);
      h_new = (1.f - zg) * ng + zg * cur[at];
      nxt[at] = h_new;
    }
    __syncthreads();
    gc::send_to_peers(cluster, nxt, k0 * RB, nu * RB);
    gc::cluster_arrive();
    if (live) hseq_at[(size_t)t * H] = h_new;
#pragma unroll
    for (int g = 0; g < 3; ++g) g_cur[g] = g_nxt[g];
    // also the last step's: no block exits while a peer writes into it
    gc::cluster_wait();
  }
}

// Tiles of `tile` rows that cover B rows in groups of rows_per_group, no
// tile holding rows of two groups; 0 where the groups do not divide B.
long group_tiles(int B, int rows_per_group, int tile) {
  if (rows_per_group < 1 || B % rows_per_group != 0) return 0;
  return (long)(B / rows_per_group) * ((rows_per_group + tile - 1) / tile);
}

template <typename T>
int launch_cluster(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
                   int B, int n_steps, int H, int C, int rows_per_group, void* stream) {
  if (!gru_cluster::supported(H, C, CL_BB)) return (int)cudaErrorInvalidValue;
  const long clusters = group_tiles(B, rows_per_group, CL_BB);
  if (clusters < 1 || clusters * C > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = rows_per_group == B ? gru_fwd_cluster_kernel<T, CL_BB, false>
                                    : gru_fwd_cluster_kernel<T, CL_BB, true>;
  return (int)gru_cluster::launch(
      kernel, (int)clusters, C, cluster_smem_bytes(H, C), (cudaStream_t)stream,
      (const T*)gi, (const float*)w_hh, (const float*)b_hh, (float*)hseq, B, n_steps, H,
      rows_per_group);
}

template <typename T>
int launch(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
           int B, int n_steps, int H, int rows_per_group, void* stream) {
  const long blocks = group_tiles(B, rows_per_group, BB);
  if (blocks < 1 || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = rows_per_group == B ? gru_fwd_kernel<T, false> : gru_fwd_kernel<T, true>;
  const size_t bytes = smem_bytes(H);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  kernel<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)gi, (const float*)w_hh, (const float*)b_hh, (float*)hseq, B, n_steps, H,
      rows_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs at hidden width H: in a cluster of
// `cluster` blocks, or (cluster 0) in the streaming variant.
long gru_fwd_smem_bytes(int H, int cluster) {
  return (long)(cluster > 0 ? cluster_smem_bytes(H, cluster) : smem_bytes(H));
}

// Clusters of `cluster` blocks that the card holds at once at hidden width
// H, or the negated CUDA error.
int gru_fwd_max_active_clusters(int H, int cluster) {
  return gru_cluster::max_active_clusters(gru_fwd_cluster_kernel<float, CL_BB, false>,
                                          cluster, cluster_smem_bytes(H, cluster));
}

// Batch rows of one cluster of the cluster variant.
int gru_fwd_batch_tile() { return CL_BB; }

// Batch tiles of a launch of B rows in groups of rows_per_group: clusters of
// the cluster variant (cluster > 0) or blocks of the streaming one (0).
long gru_fwd_tiles(int B, int rows_per_group, int cluster) {
  return group_tiles(B, rows_per_group, cluster > 0 ? CL_BB : BB);
}

// cluster > 0: the cluster variant with that many blocks per batch tile;
// cluster 0: the streaming variant. The B rows form B / rows_per_group
// groups, group g's weights at w_hh + g H 3H and b_hh + g 3H; rows_per_group
// = B is the ungrouped kernel.
int gru_fwd_f32(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
                int B, int n_steps, int H, int cluster, int rows_per_group, void* stream) {
  if (cluster > 0)
    return launch_cluster<float>(gi, w_hh, b_hh, hseq, B, n_steps, H, cluster,
                                 rows_per_group, stream);
  return launch<float>(gi, w_hh, b_hh, hseq, B, n_steps, H, rows_per_group, stream);
}

int gru_fwd_bf16(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
                 int B, int n_steps, int H, int cluster, int rows_per_group, void* stream) {
  if (cluster > 0)
    return launch_cluster<__nv_bfloat16>(gi, w_hh, b_hh, hseq, B, n_steps, H, cluster,
                                         rows_per_group, stream);
  return launch<__nv_bfloat16>(gi, w_hh, b_hh, hseq, B, n_steps, H, rows_per_group, stream);
}

}  // extern "C"
