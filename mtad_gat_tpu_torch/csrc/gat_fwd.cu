// Fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the forward kernel of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_kernel (launched by _fused_forward),
// without its in-kernel dropout. For each destination node i of a complete
// graph it computes
//
//     out_i = sigmoid( sum_j softmax_j( a . leakyrelu(p_i + q_j) + bias_ij ) v_j )
//
// with an online softmax over key tiles, so no (N, N) tensor ever exists in
// device memory: each block keeps one row tile's running max, running sum
// and output accumulator in shared memory and streams the key tiles past it.
//
// What bounds it on the card: the additive GATv2 score has no product
// structure (a . leakyrelu(p_i + q_j) is not a matrix product), so it is
// float32 work on the CUDA cores, about 4 operations per (i, j, e); at the
// model's graph sizes (N = 38 and 100) that work and the bytes of p, q and v
// are of the same order. This first design keeps every operand of the inner
// loop in shared memory or registers (p chunk broadcast across a warp, q
// chunk transposed and padded against bank conflicts, one key per lane) and
// reads each input from device memory once per row tile. It does not use the
// tensor cores for the exp(s - m) . v aggregate; that, and wider register
// tiles, are later work.
//
// Layouts are those of gatv2_attention_fused: p, q (B, N, E), v (B, N, D),
// a (E,), bias (N, N) float32 or null, out (B, N, D) in v's type. p, q, a
// and v share one type (float32 or bfloat16); all arithmetic is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BI = 16;                      // query rows per block
constexpr int BJ = 32;                      // keys per tile: one per lane
constexpr int EC = 32;                      // embedding lanes staged per pass
constexpr int THREADS = 128;                // four warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BI / WARPS;            // query rows per thread
constexpr int QT_STRIDE = BJ + 1;           // padded: conflict-free transpose
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

size_t smem_floats(int D) {
  return (size_t)BI * EC + (size_t)EC * QT_STRIDE + EC + (size_t)BI * BJ +
         3 * BI + (size_t)BJ * D + (size_t)BI * D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_kernel(const T* __restrict__ p, const T* __restrict__ q,
                 const T* __restrict__ a, const float* __restrict__ bias,
                 const T* __restrict__ v, T* __restrict__ out,
                 int N, int E, int D, int row_tiles, float alpha) {
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
      w_s[rl * BJ + lane] = ex;
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
    }
  }
}

template <typename T>
int launch(const void* p, const void* q, const void* a, const void* bias,
           const void* v, void* out, int B, int N, int E, int D, float alpha,
           void* stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gatv2_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_tiles = (N + BI - 1) / BI;
  gatv2_fwd_kernel<T><<<B * row_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const float*)bias, (const T*)v,
      (T*)out, N, E, D, row_tiles, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs at value width D.
long gatv2_fwd_smem_bytes(int D) { return (long)(smem_floats(D) * sizeof(float)); }

int gatv2_fwd_f32(const void* p, const void* q, const void* a, const void* bias,
                  const void* v, void* out, int B, int N, int E, int D,
                  float alpha, void* stream) {
  return launch<float>(p, q, a, bias, v, out, B, N, E, D, alpha, stream);
}

int gatv2_fwd_bf16(const void* p, const void* q, const void* a, const void* bias,
                   const void* v, void* out, int B, int N, int E, int D,
                   float alpha, void* stream) {
  return launch<__nv_bfloat16>(p, q, a, bias, v, out, B, N, E, D, alpha, stream);
}

}  // extern "C"
