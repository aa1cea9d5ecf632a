// Participation-masked FedAvg merge, batched over scenarios, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_agg.py:fedavg_agg
// (_kernel). Same math, per scenario b and parameter column j:
//
//   total   = sum_i m[b, i]
//   out[b,j] = total > 0 ? (sum_i m[b, i] * c[b, i, j]) / max(total, 1e-9)
//                        : (float) g[b, j]
//
// accumulated in fp32 and written in the global's dtype (fp32, fp64 or
// bf16; the clients share that dtype). Float masks carry participation *
// weight products. On an empty round the output is the previous global cast
// through fp32, as in the reference.
//
// Design: grid (P tiles, B). Each block stages its scenario's N mask values
// in shared memory and sums them once. Thread t of a block owns the COLS
// columns base + t + k * THREADS (k < COLS), so each load instruction of a
// warp touches 32 neighbouring columns (coalesced), and loops over the N
// clients with COLS independent loads in flight. A ragged last tile is masked
// here; nothing is padded. The client slab is read exactly once, as it lies
// in memory: (B, N, P) contiguous.
//
// Bound on this card: memory. At the campaign's (B, N, P) = (500, 50, 3258)
// in fp64 the kernel reads 651.6 MB of client slab, 13.0 MB of globals and
// 0.1 MB of masks, and writes 13.0 MB: about 0.20 ms at 3.35 TB/s. The
// arithmetic, 2 * N * P operations per scenario, is far below it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_f32<double>(float v) { return (double)v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fedavg_agg_kernel(const T* __restrict__ global, const T* __restrict__ clients,
                  const float* __restrict__ mask, T* __restrict__ out, int n,
                  int64_t p) {
  extern __shared__ float m_s[];        // this scenario's n mask values
  __shared__ float total_s;
  const int64_t b = blockIdx.y;
  for (int i = threadIdx.x; i < n; i += THREADS) m_s[i] = mask[b * n + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < n; ++i) t += m_s[i];
    total_s = t;
  }
  __syncthreads();
  const float total = total_s;

  const int64_t base = (int64_t)blockIdx.x * (THREADS * COLS) + threadIdx.x;
  const T* rows = clients + b * n * p;
  float acc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float w = m_s[i];
    const T* row = rows + (int64_t)i * p;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int64_t col = base + k * THREADS;
      if (col < p) acc[k] += w * to_f32(row[col]);
    }
  }
  const float denom = fmaxf(total, 1e-9f);
  const T* g = global + b * p;
  T* o = out + b * p;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int64_t col = base + k * THREADS;
    if (col < p) o[col] = from_f32<T>(total > 0.f ? acc[k] / denom : to_f32(g[col]));
  }
}

template <typename T>
int launch(const void* global, const void* clients, const void* mask, void* out,
           int b, int n, int64_t p, void* stream) {
  const int64_t tiles = (p + THREADS * COLS - 1) / (THREADS * COLS);
  if (tiles > 0x7fffffff || b > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fedavg_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)tiles, (unsigned)b);
  fedavg_agg_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)global, (const T*)clients, (const float*)mask, (T*)out, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// global: (B, P); clients: (B, N, P), both contiguous and of one dtype
// (dtype 0 = fp32, 1 = fp64, 2 = bf16); mask: (B, N) fp32; out: (B, P) in the
// global's dtype. Launches on `stream` and returns cudaGetLastError() (0 on
// success) or the configuration error that stopped the launch.
int fedavg_agg(const void* global, const void* clients, const void* mask,
               void* out, int b, int n, int64_t p, int dtype, void* stream) {
  switch (dtype) {
    case 0: return launch<float>(global, clients, mask, out, b, n, p, stream);
    case 1: return launch<double>(global, clients, mask, out, b, n, p, stream);
    case 2: return launch<__nv_bfloat16>(global, clients, mask, out, b, n, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fedavg_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
