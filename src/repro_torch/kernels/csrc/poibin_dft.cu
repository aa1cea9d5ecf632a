// Batched Poisson-Binomial pmf + all leave-one-out pmfs, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/poibin_dft.py:poibin_dft
// (_pmf_body, _kernel_pmf, _kernel_loo). Same math, fp32 throughout:
//
//   chi(n)  = prod_k [p_k (w^n - 1) + 1],  w = exp(2 pi i / S),  S = N + 1
//   raw(m)  = clip((sum_n chi_re(n) cos(2 pi n m/S) + chi_im(n) sin(2 pi n m/S)) / S, 0, 1)
//   pmf     = raw / sum(raw)                                       (paper eq. 9)
//   loo[i]  = pmf with node i's [1 - p_i, p_i] factor divided back out:
//             g[k] = (f[k] - p_i g[k-1]) / (1 - p_i)        for p_i <= 1/2 (forward)
//             g[k] = (f[k+1] - (1 - p_i) g[k+1]) / p_i      for p_i >  1/2 (backward)
//
// Design: one thread block per scenario row, so no padding of B. The (S, S)
// cos/sin tables (built by the wrapper exactly as the reference builds them)
// and the p row live in shared memory. Thread n forms chi(n) as an explicit
// (re, im) pair; thread m forms one inverse-DFT output; a block reduction
// renormalises. For the leave-one-out pass thread i runs node i's recursion,
// reading its input forwards or reversed so that a warp never diverges and a
// lane only ever divides by max(p_i, 1 - p_i) >= 1/2 (the reference's
// q_safe / p_safe guards, poibin_dft.py:81-84, are implicit: the unused
// branch is never computed). Rows are staged in shared memory (stride S, odd
// at S = 51, so the column writes are free of bank conflicts) and written out
// as one contiguous, coalesced (N, S) slab in the public (B, N, N+1) layout.
//
// Bound on this card: memory, on the leave-one-out write of B*N*(N+1)*4 bytes
// (15.3 MB at B = 1500, N = 50: about 4.6 us at 3.35 TB/s); the arithmetic is
// about 6e7 fp32 operations at that shape, about 1 us at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace {

__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
    scratch[0] = total;
  }
  __syncthreads();
  return scratch[0];
}

__global__ void poibin_dft_kernel(const float* __restrict__ p,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t,
                                  float* __restrict__ pmf,
                                  float* __restrict__ loo, int n) {
  extern __shared__ float smem[];
  const int s = n + 1;
  float* cos_s = smem;              // (S, S)
  float* sin_s = cos_s + s * s;     // (S, S)
  float* p_s = sin_s + s * s;       // (S,)  p row (N used)
  float* chi_re = p_s + s;          // (S,)
  float* chi_im = chi_re + s;       // (S,)
  float* f_s = chi_im + s;          // (S,)  pmf row
  float* red = f_s + s;             // (32,) reduction scratch
  float* loo_s = red + 32;          // (N, S) leave-one-out rows
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;

  for (int t = tid; t < s * s; t += nt) {
    cos_s[t] = cos_t[t];
    sin_s[t] = sin_t[t];
  }
  for (int t = tid; t < n; t += nt) p_s[t] = p[b * n + t];
  __syncthreads();

  // Characteristic function on the S-point unit circle; w^n = cos[1, n] + i sin[1, n].
  for (int j = tid; j < s; j += nt) {
    const float w_re = cos_s[s + j] - 1.f, w_im = sin_s[s + j];
    float re = 1.f, im = 0.f;
    for (int k = 0; k < n; ++k) {
      const float pk = p_s[k];
      const float t_re = pk * w_re + 1.f, t_im = pk * w_im;
      const float re_next = re * t_re - im * t_im;
      im = re * t_im + im * t_re;
      re = re_next;
    }
    chi_re[j] = re;
    chi_im[j] = im;
  }
  __syncthreads();

  // Inverse DFT, clip, renormalise (the cos/sin tables are symmetric).
  float part = 0.f;
  for (int m = tid; m < s; m += nt) {
    float acc_c = 0.f, acc_s = 0.f;
    for (int j = 0; j < s; ++j) {
      acc_c += chi_re[j] * cos_s[j * s + m];
      acc_s += chi_im[j] * sin_s[j * s + m];
    }
    const float raw = fminf(fmaxf((acc_c + acc_s) / (float)s, 0.f), 1.f);
    f_s[m] = raw;
    part += raw;
  }
  const float total = block_sum(part, red);
  for (int m = tid; m < s; m += nt) {
    const float v = f_s[m] / total;
    f_s[m] = v;
    pmf[b * s + m] = v;
  }
  if (loo == nullptr) return;
  __syncthreads();

  for (int i = tid; i < n; i += nt) {
    const float pi = p_s[i], qi = 1.f - pi;
    const bool fwd = pi <= 0.5f;
    const float a = fwd ? pi : qi;   // weight of the carried value
    const float d = fwd ? qi : pi;   // divisor, >= 1/2 on both branches
    float* row = loo_s + i * s;
    float g = 0.f;
    for (int j = 0; j < n; ++j) {
      const int k = fwd ? j : n - 1 - j;     // slot written
      const int src = fwd ? j : n - j;       // f[k] forward, f[k+1] backward
      g = (f_s[src] - a * g) / d;
      row[k] = g;
    }
    row[n] = 0.f;                            // support is 0..N-1
  }
  __syncthreads();
  float* out = loo + b * n * s;
  for (int t = tid; t < n * s; t += nt) out[t] = loo_s[t];
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at N nodes.
size_t poibin_dft_smem_bytes(int n, int with_loo) {
  const size_t s = (size_t)n + 1;
  return (2 * s * s + 4 * s + 32 + (with_loo ? (size_t)n * s : 0)) * sizeof(float);
}

// p: (B, N) fp32; cos_t, sin_t: (S, S) fp32; pmf: (B, S) fp32;
// loo: (B, N, S) fp32, or NULL for the pmf-only variant. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int poibin_dft_f32(const void* p, const void* cos_t, const void* sin_t,
                   void* pmf, void* loo, int b, int n, void* stream) {
  const size_t smem = poibin_dft_smem_bytes(n, loo != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poibin_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((n + 1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  poibin_dft_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)p, (const float*)cos_t, (const float*)sin_t,
      (float*)pmf, (float*)loo, n);
  return (int)cudaGetLastError();
}

const char* poibin_dft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
