// Fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the forward kernels of the JAX package's fused attention,
// mtad_gat_tpu/kernels/gat_pallas.py::_kernel (K1, launched by
// _fused_forward) and ::_kernel_res (K1-res, the training forward). For
// each destination node i of a complete graph it computes
//
//     out_i = sigmoid( sum_j softmax_j( a . leakyrelu(p_i + q_j) + bias_ij ) v_j )
//
// with an online softmax over key tiles, so no (N, N) tensor ever exists in
// device memory: each block keeps one row tile's running max, running sum
// and output accumulator in shared memory and streams the key tiles past it.
//
// Two compile-time flags make the training variant; with both off (K1, the
// scoring path) the code is that of the forward alone:
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
// are of the same order. This first design keeps every operand of the inner
// loop in shared memory or registers (p chunk broadcast across a warp, q
// chunk transposed and padded against bank conflicts, one key per lane) and
// reads each input from device memory once per row tile. It does not use the
// tensor cores for the exp(s - m) . v aggregate; that, and wider register
// tiles, are later work.
//
// Layouts are those of gatv2_attention_fused: p, q (B, N, E), v (B, N, D),
// a (E,), bias (N, N) float32 or null, out (B, N, D) in v's type; u
// (B, N, D), m and l (B, N) float32. p, q, a and v share one type (float32
// or bfloat16); all arithmetic is float32.

#include "gat_common.cuh"

namespace {

using namespace gat;

constexpr int BI = 16;                      // query rows per block
constexpr int BJ = 32;                      // keys per tile: one per lane
constexpr int EC = 32;                      // embedding lanes staged per pass
constexpr int THREADS = 128;                // four warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BI / WARPS;            // query rows per thread
constexpr int QT_STRIDE = BJ + 1;           // padded: conflict-free transpose

struct Residuals {
  float* u;                                 // (B, N, D)
  float* m;                                 // (B, N)
  float* l;                                 // (B, N)
  const long long* seed;                    // one value, low 32 bits used
  uint32_t thresh;                          // keep when hash < thresh
  float scale;                              // 1 / (1 - rate)
};

size_t smem_floats(int D) {
  return (size_t)BI * EC + (size_t)EC * QT_STRIDE + EC + (size_t)BI * BJ +
         3 * BI + (size_t)BJ * D + (size_t)BI * D;
}

template <typename T, bool RES, bool DROP>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_kernel(const T* __restrict__ p, const T* __restrict__ q,
                 const T* __restrict__ a, const float* __restrict__ bias,
                 const T* __restrict__ v, T* __restrict__ out,
                 int N, int E, int D, int row_tiles, float alpha, Residuals res) {
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
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)(unsigned long long)(*res.seed);

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
      float ex_agg = ex;
      if constexpr (DROP) {
        ex_agg = drop_hash(seed, (uint32_t)b, (uint32_t)i, (uint32_t)j) < res.thresh
                     ? ex * res.scale : 0.f;
      }
      w_s[rl * BJ + lane] = ex_agg;
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
      if constexpr (RES) res.u[v_base + (size_t)i * D + x % D] = u;
    }
  }
  if constexpr (RES) {
    if (tid < BI && i0 + tid < N) {
      res.m[(size_t)b * N + i0 + tid] = m_s[tid];
      res.l[(size_t)b * N + i0 + tid] = l_s[tid];
    }
  }
}

template <typename T, bool RES, bool DROP>
int launch(const void* p, const void* q, const void* a, const void* bias,
           const void* v, void* out, int B, int N, int E, int D, float alpha,
           Residuals res, void* stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gatv2_fwd_kernel<T, RES, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_tiles = (N + BI - 1) / BI;
  gatv2_fwd_kernel<T, RES, DROP><<<B * row_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)a, (const float*)bias, (const T*)v,
      (T*)out, N, E, D, row_tiles, alpha, res);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_res(const void* p, const void* q, const void* a, const void* bias,
               const void* v, void* out, void* u, void* m, void* l, const void* seed,
               int B, int N, int E, int D, float alpha, unsigned int thresh, float scale,
               void* stream) {
  const Residuals res{(float*)u, (float*)m, (float*)l, (const long long*)seed, thresh, scale};
  if (seed == nullptr)
    return launch<T, true, false>(p, q, a, bias, v, out, B, N, E, D, alpha, res, stream);
  return launch<T, true, true>(p, q, a, bias, v, out, B, N, E, D, alpha, res, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs at value width D.
long gatv2_fwd_smem_bytes(int D) { return (long)(smem_floats(D) * sizeof(float)); }

// K1: the forward alone (scoring).
int gatv2_fwd_f32(const void* p, const void* q, const void* a, const void* bias,
                  const void* v, void* out, int B, int N, int E, int D,
                  float alpha, void* stream) {
  return launch<float, false, false>(p, q, a, bias, v, out, B, N, E, D, alpha,
                                     Residuals{}, stream);
}

int gatv2_fwd_bf16(const void* p, const void* q, const void* a, const void* bias,
                   const void* v, void* out, int B, int N, int E, int D,
                   float alpha, void* stream) {
  return launch<__nv_bfloat16, false, false>(p, q, a, bias, v, out, B, N, E, D, alpha,
                                             Residuals{}, stream);
}

// K1-res: the forward with residuals; dropout when seed is not null.
int gatv2_fwd_res_f32(const void* p, const void* q, const void* a, const void* bias,
                      const void* v, void* out, void* u, void* m, void* l,
                      const void* seed, int B, int N, int E, int D, float alpha,
                      unsigned int thresh, float scale, void* stream) {
  return launch_res<float>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D, alpha,
                           thresh, scale, stream);
}

int gatv2_fwd_res_bf16(const void* p, const void* q, const void* a, const void* bias,
                       const void* v, void* out, void* u, void* m, void* l,
                       const void* seed, int B, int N, int E, int D, float alpha,
                       unsigned int thresh, float scale, void* stream) {
  return launch_res<__nv_bfloat16>(p, q, a, bias, v, out, u, m, l, seed, B, N, E, D,
                                   alpha, thresh, scale, stream);
}

}  // extern "C"
