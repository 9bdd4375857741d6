// What the two cluster GRU kernels (gru_fwd.cu, gru_bwd.cu) share: how the
// hidden units are split over the blocks of a thread-block cluster, how a
// block loads its slice of W_hh into shared memory, the step product from
// that slice, the copy of a slice to the peers, the cluster barrier in its
// two halves, and the launch.
//
// A batch tile of BB rows belongs to one cluster of C blocks. Block c owns
// the hidden units [unit_start, unit_start + unit_count) for all three gates
// (r, z, n), so a gate update of a unit needs nothing of another block. The
// first H % C blocks own one unit more than the rest. A block's slice of a
// (rows, 3H) weight matrix is stored as [row][gate * gate_cols + unit] with
// rows `stride` floats apart: gate_cols is the most units of a block rounded
// up to 4 and the padding holds zeros, so four neighbouring columns always
// belong to one gate.
//
// The step product is x (BB, H) times a slice (H, stride). Thread (g, s)
// owns the four columns 4g .. 4g + 3 and the rows e = s, s + split, ... of
// the sum, for all BB batch rows at once: per e it reads its four weights
// (neighbouring lanes, neighbouring float4) and the BB values x[e][:] (one
// address for the whole warp) and does 4 BB multiply-adds from registers,
// which keeps the shared-memory reads well below the arithmetic. The `split`
// partial sums of a column are added in order by the gate update, so the
// result does not depend on timing. stride / 4 is odd, which spreads the
// gate update's reads of the partial sums (rows fastest) over the banks.
// mtad_gat_tpu_torch/kernels/gru.py::cluster_tiling mirrors `tiling`.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gru_cluster {

constexpr int THREADS = 512;      // threads of a block, whatever the width
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int STAGE = 8;          // registers that stage one (H, BB) buffer

struct Tiling {
  int units;       // most units of a block: ceil(H / C)
  int gate_cols;   // units rounded up to 4
  int stride;      // floats between rows of a slice: >= 3 * gate_cols, stride / 4 odd
  int groups_pad;  // column groups (stride / 4) rounded up to whole warps
  int split;       // partial sums per column
};

__host__ __device__ inline Tiling tiling(int H, int C, int max_split) {
  Tiling t;
  t.units = (H + C - 1) / C;
  t.gate_cols = (t.units + 3) / 4 * 4;
  t.stride = 3 * t.gate_cols;
  if (t.stride / 4 % 2 == 0) t.stride += 4;
  t.groups_pad = (t.stride / 4 + 31) / 32 * 32;
  int s = THREADS / t.groups_pad;
  if (s > max_split) s = max_split;
  if (s > H) s = H;
  t.split = s;
  return t;
}

// One thread per (batch row, own unit) in the gate update; one block's
// (H, BB) buffer staged through STAGE registers a thread.
inline bool supported(int H, int C, int bb) {
  return H >= 1 && C >= 1 && C <= MAX_CLUSTER && bb * ((H + C - 1) / C) <= THREADS &&
         H * bb <= STAGE * THREADS;
}

__host__ __device__ inline int unit_count(int H, int C, int c) {
  return H / C + (c < H % C ? 1 : 0);
}

__host__ __device__ inline int unit_start(int H, int C, int c) {
  const int rem = H % C;
  return c * (H / C) + (c < rem ? c : rem);
}

// dst[row][gate * gate_cols + u] = src[row * row_stride + gate * gate_stride + start + u]
// for u < count, zero in the padding.
__device__ __forceinline__ void load_slice(float* __restrict__ dst,
                                           const float* __restrict__ src, int rows,
                                           int row_stride, int gate_stride, int start,
                                           int count, const Tiling& tl) {
#pragma unroll 4
  for (int x = threadIdx.x; x < rows * tl.stride; x += blockDim.x) {
    const int row = x / tl.stride, j = x % tl.stride;
    const int gate = j / tl.gate_cols, u = j % tl.gate_cols;
    dst[x] = (gate < 3 && u < count)
        ? src[(size_t)row * row_stride + (size_t)gate * gate_stride + start + u] : 0.f;
  }
}

// part[s][r][4g .. 4g + 3] = sum over e = s, s + split, ... of
// xT[e][r] * w[e][4g .. 4g + 3] for the BB batch rows r; xT is [H][BB], w is
// [H][stride], part is [split][BB][stride].
template <int BB>
__device__ __forceinline__ void partial_product(const float* __restrict__ xT,
                                                const float* __restrict__ w,
                                                float* __restrict__ part, int H, int stride,
                                                int split, int g, int s) {
  float acc[BB][4];
#pragma unroll
  for (int r = 0; r < BB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* wg = w + 4 * g;
#pragma unroll 2
  for (int e = s; e < H; e += split) {
    const float4 wv = *reinterpret_cast<const float4*>(wg + e * stride);
#pragma unroll
    for (int q = 0; q < BB / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(xT + e * BB + 4 * q);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * q + i][0] = fmaf(xs[i], wv.x, acc[4 * q + i][0]);
        acc[4 * q + i][1] = fmaf(xs[i], wv.y, acc[4 * q + i][1]);
        acc[4 * q + i][2] = fmaf(xs[i], wv.z, acc[4 * q + i][2]);
        acc[4 * q + i][3] = fmaf(xs[i], wv.w, acc[4 * q + i][3]);
      }
    }
  }
  float* out = part + (size_t)s * BB * stride + 4 * g;
#pragma unroll
  for (int r = 0; r < BB; ++r)
    *reinterpret_cast<float4*>(out + r * stride) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// Sum of column j's partial sums for batch row r, s in order; MAXS bounds
// `split`, so that the loads leave together.
template <int BB, int MAXS>
__device__ __forceinline__ float column_sum(const float* __restrict__ part, int stride,
                                            int split, int j, int r) {
  float v[MAXS];
#pragma unroll
  for (int s = 0; s < MAXS; ++s)
    v[s] = s < split ? part[((size_t)s * BB + r) * stride + j] : 0.f;
  float acc = v[0];
#pragma unroll
  for (int s = 1; s < MAXS; ++s) acc += v[s];
  return acc;
}

// Copy `count` floats (a multiple of 4) at buf + first (16-byte aligned) from
// this block's buffer to the same place in every peer's, one float4 per
// thread and store: a block sends its slice of a step's state in a few wide
// stores instead of one narrow store per value and peer.
__device__ __forceinline__ void send_to_peers(cooperative_groups::cluster_group& cluster,
                                              float* buf, int first, int count) {
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n4 = count / 4;
  for (int x = threadIdx.x; x < (C - 1) * n4; x += blockDim.x) {
    const int p = x / n4, at = first + 4 * (x % n4);
    float* dst = cluster.map_shared_rank(buf, p + (p >= rank ? 1 : 0));
    *reinterpret_cast<float4*>(dst + at) = *reinterpret_cast<const float4*>(buf + at);
  }
}

// The cluster barrier in two halves, so that work that no peer waits for
// (stores to device memory, the next step's loads) sits between them. The
// arrive releases this block's writes into the peers' shared memory; the
// wait acquires theirs. Every thread of every block of the cluster calls
// both, in step.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A launch of `clusters` clusters of C blocks along x.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int clusters, int C, size_t smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int clusters, int C, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Launch l(clusters, C, smem, stream);
  return cudaLaunchKernelEx(&l.cfg, kernel, args...);
}

// Clusters of C blocks of `kernel` that the card holds at once
// (cudaOccupancyMaxActiveClusters), or the negated CUDA error.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  Launch l(1, C, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &l.cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace gru_cluster
