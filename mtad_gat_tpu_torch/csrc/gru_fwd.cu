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
// Design: one block per tile of BB batch rows walks all T steps with its
// hidden state in shared memory, a __syncthreads() between the recurrent
// product and the gate update of each step. One thread per gate column
// (3H of them) computes that column of h . W_hh for the BB rows, reading
// W_hh from device memory, where it stays resident in the 50 MB L2; then
// the threads update h for (row, unit) pairs and write h_t.
//
// What bounds it on the card: the T steps are serial, so a step's latency,
// not the card's throughput, sets the time. Each step is a (BB, H) x (H, 3H)
// product; at H = 150, W_hh is 150 x 450 float32 = 270 KB, more than the
// 227 KB of shared memory a block may use, so this design reads it from L2
// on every step and reuses each value BB times from registers. Keeping W_hh
// on chip (split across a thread-block cluster, or held in bfloat16) and
// using the tensor cores for the step product are later work.
//
// Layouts are those of gru_scan_fused: gi (B, T, 3H) float32 or bfloat16,
// w_hh (H, 3H) float32, b_hh (3H,) float32, gate order (r, z, n); hseq
// (B, T, H) float32. All arithmetic is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BB = 8;             // batch rows per block
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

size_t smem_bytes(int H) { return (size_t)(H * BB + BB * 3 * H) * sizeof(float); }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
gru_fwd_kernel(const T* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ hseq,
               int B, int n_steps, int H) {
  extern __shared__ float smem[];
  float* hT = smem;               // [H][BB]: h transposed, float4-readable
  float* gh = hT + H * BB;        // [BB][3H]: h . W_hh + b_hh of this step
  const int H3 = 3 * H;
  const int b0 = blockIdx.x * BB;

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
      if (row < B) {
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

template <typename T>
int launch(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
           int B, int n_steps, int H, void* stream) {
  const size_t bytes = smem_bytes(H);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int blocks = (B + BB - 1) / BB;
  gru_fwd_kernel<T><<<blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)gi, (const float*)w_hh, (const float*)b_hh, (float*)hseq, B,
      n_steps, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs at hidden width H.
long gru_fwd_smem_bytes(int H) { return (long)smem_bytes(H); }

int gru_fwd_f32(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
                int B, int n_steps, int H, void* stream) {
  return launch<float>(gi, w_hh, b_hh, hseq, B, n_steps, H, stream);
}

int gru_fwd_bf16(const void* gi, const void* w_hh, const void* b_hh, void* hseq,
                 int B, int n_steps, int H, void* stream) {
  return launch<__nv_bfloat16>(gi, w_hh, b_hh, hseq, B, n_steps, H, stream);
}

}  // extern "C"
