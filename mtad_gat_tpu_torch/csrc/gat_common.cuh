// Helpers shared by the fused GATv2 attention kernels (gat_fwd.cu, gat_bwd.cu).
//
// drop_hash is the attention-dropout keep decision of the JAX package's
// fused attention, mtad_gat_tpu/kernels/gat_pallas.py::_hash_u32 and
// _keep_mask: a counter-based hash of the GLOBAL (seed, batch index of the
// call, row, column), so any tiling, and the backward's recomputation, draws
// the same mask as the TPU kernel's 128-wide tiles, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gat {

constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// uint32 arithmetic wraps modulo 2^32, as jnp.uint32 does.
__device__ __forceinline__ uint32_t drop_hash(uint32_t seed, uint32_t b, uint32_t row,
                                              uint32_t col) {
  uint32_t x = seed ^ (b * 0x27D4EB2Fu) ^ (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// ---- the whole-graph kernels' staging and score (K1, K1-res, K2ab) ------

// Embedding splits of the whole-graph score pass: one value for the forward
// and K2ab, so the backward recomputes the forward's scores term for term.
constexpr int G_SPLIT = 2;

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
// A row stride for float4 reads: an odd number of 16-byte units.
__host__ __device__ inline int stride4(int x) {
  const int s = up4(x);
  return (s / 4) % 2 ? s : s + 4;
}

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  __nv_bfloat16 h[4];
  *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(x);
  return make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
}

// nrows x ncols of src (row-major) into dst [rows][stride] in groups of
// four floats, zeros in the padding; vector loads where every row starts
// aligned. Unrolled so that a thread has several loads in flight: with one
// block a multiprocessor nothing else hides their latency.
template <typename S>
__device__ void stage_padded(float* dst, const S* __restrict__ src, int nrows, int ncols,
                             int rows, int stride) {
  const int groups = stride / 4;
  const bool vec = ncols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % (4 * sizeof(S)) == 0;
#pragma unroll 4
  for (int x = threadIdx.x; x < rows * groups; x += blockDim.x) {
    const int r = x / groups, c = x % groups * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && c < ncols) {
      const S* row = src + (size_t)r * ncols;
      if (vec) {
        val = load4(row + c);
      } else {
        val.x = to_f(row[c]);
        if (c + 1 < ncols) val.y = to_f(row[c + 1]);
        if (c + 2 < ncols) val.z = to_f(row[c + 2]);
        if (c + 3 < ncols) val.w = to_f(row[c + 3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = val;
  }
}

// a . leakyrelu(p + q) over four lanes, added to s in lane order.
__device__ __forceinline__ float score4(const float4& p, const float4& q, const float4& a,
                                        float s, float alpha) {
  float z = p.x + q.x;
  s = fmaf(a.x, z >= 0.f ? z : alpha * z, s);
  z = p.y + q.y;
  s = fmaf(a.y, z >= 0.f ? z : alpha * z, s);
  z = p.z + q.z;
  s = fmaf(a.z, z >= 0.f ? z : alpha * z, s);
  z = p.w + q.w;
  return fmaf(a.w, z >= 0.f ? z : alpha * z, s);
}

// Sum x over LANES neighbouring lanes (lane % LANES), scattered: afterwards
// x[v], v < NV / LANES, holds the sum of value (lane % LANES) * NV / LANES + v.
// Halving steps at xor offsets LANES / 2, ..., 1: a fixed order. Every index
// is a compile-time constant, so x stays in registers.
template <int NV, int LANES, int O = LANES / 2>
__device__ __forceinline__ void reduce_scatter(float (&x)[NV], int lane) {
  static_assert(NV % LANES == 0, "values must divide among the lanes");
  if constexpr (O >= 1) {
    constexpr int half = NV * O / LANES;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int v = 0; v < half; ++v) {
      const float send = upper ? x[v] : x[v + half];
      const float keep = upper ? x[v + half] : x[v];
      x[v] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter<NV, LANES, O / 2>(x, lane);
  }
}

}  // namespace gat
