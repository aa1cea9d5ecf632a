// Streaming-softmax (flash) attention, causal / sliding window, GQA, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_kernel). Same math, per batch row b, query head h (kv
// head h / (H / KV)) and query position i:
//
//   s_ij = (q_i . k_j) * D^-0.5      over keys j allowed by the mask
//   out_i = sum_j softmax_j(s_ij) v_j
//
// with the mask "j < S" (ragged tail), "i >= j" when causal and
// "i - j < window" when window > 0; online softmax state (m, l, acc) in
// fp32, a row that sees no key divides by max(l, 1e-30) and gives 0, output
// in q's dtype (fp32 or bf16 inputs, converted to fp32 as they are read).
//
// Design: the TPU kernel walks a sequential grid axis over key tiles and
// carries (m, l, acc) in VMEM scratch. Here one block owns one (batch row,
// query head, 64-row query tile) and loops over the 64-key tiles itself, from
// the window's first tile to the causal diagonal. The Q tile stays in shared
// memory for the whole loop; each key tile's K and V are staged in shared
// memory as fp32 (rows padded to an odd stride, so the column reads of the
// score product hit distinct banks). 256 threads as 16 x 16: thread (ty, tx)
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 j (j < 8, head_dim <= 128), so the 16 threads of a
// row reduce its max and sum with warp shuffles and apply the correction to
// their own accumulators. Products run on CUDA cores in fp32 (no tensor
// cores: a later PR's work).
//
// Shared memory: (2 * 64 * (D + 1) + 64 * D + 64 * 65) * 4 bytes, 78.6 KB at
// D = 80 and 115.5 KB at D = 128, above the 48 KB default: the launch opts in
// with cudaFuncSetAttribute.
//
// Bound on this card: memory. At the model path's q/k/v (32, 256, 32, 80) bf16
// the kernel must read q, k, v and write out, 167.8 MB: 50.1 us at 3.35 TB/s;
// the causal products, 10.8 GFLOP, take 10.9 us at the bf16 tensor-core peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int s, int causal, int window) {
  return kpos < s && (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

size_t smem_bytes(int d) {
  return (size_t)(2 * BQ * (d + 1) + BK * d + BQ * (BK + 1)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s, int h,
                       int kvh, int d, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                 // BQ x ld
  float* ks = qs + BQ * ld;         // BK x ld
  float* vs = ks + BK * ld;         // BK x d
  float* ps = vs + BK * d;          // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row_q = (int64_t)h * d;      // elements between positions
  const int64_t row_k = (int64_t)kvh * d;
  const T* qb = q + bb * s * row_q + (int64_t)head * d;
  const T* kb = k + bb * s * row_k + (int64_t)kv_head * d;
  const T* vb = v + bb * s * row_k + (int64_t)kv_head * d;
  T* ob = out + bb * s * row_q + (int64_t)head * d;

  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const int pos = q0 + r;
    qs[r * ld + c] = pos < s ? to_f32(qb[pos * row_q + c]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the previous tile's reads are done
    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d, c = e - r * d;
      const int pos = k0 + r;
      const bool in = pos < s;
      ks[r * ld + c] = in ? to_f32(kb[pos * row_k + c]) : 0.f;
      vs[r * d + c] = in ? to_f32(vb[pos * row_k + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(qpos, k0 + tx + 16 * j, s, causal, window);
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = allowed(qpos, k0 + col, s, causal, window)
                            ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (BK + 1) + col] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();              // the probability tile is complete

    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[qpos * row_q + c] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s,
           int h, int kvh, int d, int causal, int window, float scale, void* stream) {
  if (d < 1 || d > MAX_D || kvh < 1 || h % kvh != 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  // Opt in once per element type, for the largest head_dim seen, so that a
  // launch captured in a CUDA graph makes no attribute call.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)h, (unsigned)b);
  flash_attention_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, h, kvh, d, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, S, H, D); k, v: (B, S, KV, D); all contiguous and of one dtype
// (0 = fp32, 2 = bf16; 1, fp64, is refused); H a multiple of KV; D <= 128.
// Launches on `stream` and returns cudaGetLastError() (0 on success) or the
// error that stopped the launch.
int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                    int s, int h, int kvh, int d, int causal, int window, float scale,
                    int dtype, void* stream) {
  switch (dtype) {
    case 0: return launch<float>(q, k, v, out, b, s, h, kvh, d, causal, window, scale, stream);
    case 2: return launch<__nv_bfloat16>(q, k, v, out, b, s, h, kvh, d, causal, window, scale,
                                         stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
