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

}  // namespace gat
