// Fused cross-entropy (hidden @ vocab -> per-token NLL), batched over
// replicas, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ce.py:fused_ce
// (_kernel). Same math, per replica r and token t:
//
//   z_v   = h[r, t] . W[r, :, v]                 (fp32 accumulate)
//   nll_t = logsumexp_v z_v - z_label[r, t]
//
// with an online logsumexp over vocab tiles, so the (T, V) logits are never
// stored; the label logit comes from its own column of the tile that holds
// it. fp32 or bf16 inputs, fp32 accumulation, fp32 output.
//
// Design: the TPU kernel walks a sequential grid axis over vocab tiles and
// carries (m, l, label logit) in VMEM scratch. Here one block owns 64 tokens
// of one replica (grid (token tiles, replicas): every FL client has its own
// lm_head, so W carries a replica stride) and loops over 128-column vocab
// tiles itself, so W is read T / 64 times, not T times. 256 threads; in the
// epilogue of a tile thread (ty, tx) owns rows ty + 16 i (i < 4) and columns
// tx + 16 j (j < 8), and the 16 threads of a row reduce its max and sum with
// warp shuffles. Ragged T, V and width are masked here; nothing is padded.
// The products: for fp32 inputs on CUDA cores in fp32 (fused_ce_kernel), for
// bf16 inputs on the tensor cores through warp-level mma, bf16 products
// accumulated in fp32 (fused_ce_tc_kernel). Neither pipelines its loads
// (cp.async / TMA) nor uses wgmma: later work.
//
// Bound on this card: operations. At the model path's hidden (8, 1024, 2560),
// W (8, 2560, 50304) in bf16 the products are 2.11 TFLOP: 2.13 ms at the bf16
// tensor-core peak of 989 TFLOP/s (the bytes, 2.10 GB, take 0.63 ms). On CUDA
// cores in fp32 the floor is 31.5 ms at 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;
constexpr int BV = 128;
constexpr int BD = 16;
constexpr int THREADS = 256;
constexpr int H_PER_THREAD = BT * BD / THREADS;   // 4
constexpr int W_PER_THREAD = BD * BV / THREADS;   // 8
constexpr float NEG_INF = -1e30f;

// The online logsumexp over one 64 x 128 tile of logits held as thread
// (ty, tx)'s rows ty + 16 i and columns tx + 16 j (masked past the vocab),
// and the label's own column; the 16 threads of a row reduce with shuffles.
__device__ __forceinline__ void online_lse(float (&z)[4][8], int v0, int vocab,
                                           int tx, const int (&lab)[4], float (&m)[4],
                                           float (&l)[4], float (&lab_logit)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float rmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col >= vocab) z[i][j] = NEG_INF;
      else if (col == lab[i]) lab_logit[i] += z[i][j];
      rmax = fmaxf(rmax, z[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(m[i], rmax);
    const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + tx + 16 * j < vocab) rsum += expf(z[i][j] - m_new);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l[i] = l[i] * corr + rsum;
    m[i] = m_new;
  }
}

// nll = m + log(max(l, 1e-30)) - label logit, one thread a row.
__device__ __forceinline__ void write_nll(float* out, int t0, int t, int tx, int ty,
                                          const float (&m)[4], const float (&l)[4],
                                          const float (&lab_logit)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lg = lab_logit[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, off);
    const int row = t0 + ty + 16 * i;
    if (tx == 0 && row < t) out[row] = m[i] + logf(fmaxf(l[i], 1e-30f)) - lg;
  }
}

__global__ void __launch_bounds__(THREADS)
fused_ce_kernel(const float* __restrict__ hidden, const float* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ out, int t,
                int d, int vocab, int64_t h_stride, int64_t w_stride) {
  __shared__ float hs[BD][BT + 1];   // hidden chunk, transposed
  __shared__ float ws[BD][BV];

  const int t0 = blockIdx.x * BT;
  const int64_t rep = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* hb = hidden + rep * h_stride;
  const float* wb = w + rep * w_stride;

  int lab[4];
  float m[4], l[4], lab_logit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty + 16 * i;
    lab[i] = row < t ? labels[rep * t + row] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    lab_logit[i] = 0.f;
  }

  float hreg[H_PER_THREAD], wreg[W_PER_THREAD];
  auto load_chunk = [&](int v0, int d0) {
#pragma unroll
    for (int q = 0; q < H_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      const int r = e / BD, c = e % BD;
      const int row = t0 + r, col = d0 + c;
      hreg[q] = (row < t && col < d) ? hb[(int64_t)row * d + col] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < W_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      const int r = e / BV, c = e % BV;
      const int k = d0 + r, col = v0 + c;
      wreg[q] = (k < d && col < vocab) ? wb[(int64_t)k * vocab + col] : 0.f;
    }
  };

  for (int v0 = 0; v0 < vocab; v0 += BV) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load_chunk(v0, 0);
    for (int d0 = 0; d0 < d; d0 += BD) {
      __syncthreads();            // the previous chunk's reads are done
#pragma unroll
      for (int q = 0; q < H_PER_THREAD; ++q) {
        const int e = tid + THREADS * q;
        hs[e % BD][e / BD] = hreg[q];
      }
#pragma unroll
      for (int q = 0; q < W_PER_THREAD; ++q) {
        const int e = tid + THREADS * q;
        ws[e / BV][e % BV] = wreg[q];
      }
      __syncthreads();
      if (d0 + BD < d) load_chunk(v0, d0 + BD);   // in flight during the products
#pragma unroll
      for (int kk = 0; kk < BD; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    online_lse(acc, v0, vocab, tx, lab, m, l, lab_logit);
  }
  write_nll(out + rep * t, t0, t, tx, ty, m, l, lab_logit);
}

// bf16 inputs: the same block and epilogue, the products on the tensor
// cores (bf16 x bf16 -> fp32, warp-level 16 x 16 x 16 tiles). Each 64 x 128
// tile of logits is accumulated over the width in chunks of 32: the chunk of
// hidden (64 x 32) and of W (32 x 128) is staged in shared memory as bf16
// (16-byte loads where the widths and strides allow, else one element at a
// time), and the 8 warps, as 2 x 4, each own 32 x 32 of the tile. The tile is
// stored to shared memory in fp32 and read back in the epilogue's layout.
constexpr int TC_BD = 32;
constexpr int A_LD = TC_BD + 8;      // bf16 row strides: 16-byte rows, and
constexpr int B_LD = BV + 8;         // fragment pointers 32-byte aligned
constexpr int C_LD = BV + 4;         // fp32

__global__ void __launch_bounds__(THREADS)
fused_ce_tc_kernel(const __nv_bfloat16* __restrict__ hidden,
                   const __nv_bfloat16* __restrict__ w, const int* __restrict__ labels,
                   float* __restrict__ out, int t, int d, int vocab, int64_t h_stride,
                   int64_t w_stride, int vec) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 as[BT * A_LD];
  __shared__ __align__(32) __nv_bfloat16 bs[TC_BD * B_LD];
  __shared__ __align__(32) float cs[BT * C_LD];

  const int t0 = blockIdx.x * BT;
  const int64_t rep = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, wr = (warp >> 2) * 32, wc = (warp & 3) * 32;
  const __nv_bfloat16* hb = hidden + rep * h_stride;
  const __nv_bfloat16* wb = w + rep * w_stride;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  int lab[4];
  float m[4], l[4], lab_logit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty + 16 * i;
    lab[i] = row < t ? labels[rep * t + row] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    lab_logit[i] = 0.f;
  }

  for (int v0 = 0; v0 < vocab; v0 += BV) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int d0 = 0; d0 < d; d0 += TC_BD) {
      __syncthreads();            // the previous chunk's fragments are loaded
      if (vec) {                  // d, V, strides multiples of 8: whole groups
        {
          const int r = tid >> 2, c = (tid & 3) * 8;
          const int row = t0 + r, col = d0 + c;
          uint4 x = make_uint4(0, 0, 0, 0);
          if (row < t && col < d)
            x = *reinterpret_cast<const uint4*>(hb + (int64_t)row * d + col);
          *reinterpret_cast<uint4*>(as + r * A_LD + c) = x;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = tid + THREADS * q;
          const int r = e >> 4, c = (e & 15) * 8;
          const int k = d0 + r, col = v0 + c;
          uint4 x = make_uint4(0, 0, 0, 0);
          if (k < d && col < vocab)
            x = *reinterpret_cast<const uint4*>(wb + (int64_t)k * vocab + col);
          *reinterpret_cast<uint4*>(bs + r * B_LD + c) = x;
        }
      } else {
        for (int e = tid; e < BT * TC_BD; e += THREADS) {
          const int r = e / TC_BD, c = e % TC_BD;
          const int row = t0 + r, col = d0 + c;
          as[r * A_LD + c] = (row < t && col < d) ? hb[(int64_t)row * d + col] : zero;
        }
        for (int e = tid; e < TC_BD * BV; e += THREADS) {
          const int r = e / BV, c = e % BV;
          const int k = d0 + r, col = v0 + c;
          bs[r * B_LD + c] = (k < d && col < vocab) ? wb[(int64_t)k * vocab + col] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_BD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], as + (wr + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], bs + kk * B_LD + wc + 16 * j, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wr + 16 * i) * C_LD + wc + 16 * j, acc[i][j], C_LD,
                                wmma::mem_row_major);
    __syncthreads();
    float z[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) z[i][j] = cs[(ty + 16 * i) * C_LD + tx + 16 * j];
    online_lse(z, v0, vocab, tx, lab, m, l, lab_logit);
    // the next tile's stores into cs follow its chunk loop's barriers
  }
  write_nll(out + rep * t, t0, t, tx, ty, m, l, lab_logit);
}

int launch(const void* hidden, const void* w, const void* labels, void* out, int r,
           int t, int d, int vocab, int64_t h_stride, int64_t w_stride, int dtype,
           void* stream) {
  if (r > 65535 || t < 1 || d < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((t + BT - 1) / BT), (unsigned)r);
  if (dtype == 0) {
    fused_ce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)hidden, (const float*)w, (const int*)labels, (float*)out, t, d,
        vocab, h_stride, w_stride);
  } else if (dtype == 2) {
    const int vec = (uintptr_t)hidden % 16 == 0 && (uintptr_t)w % 16 == 0 && d % 8 == 0 &&
                    vocab % 8 == 0 && h_stride % 8 == 0 && w_stride % 8 == 0;
    fused_ce_tc_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)hidden, (const __nv_bfloat16*)w, (const int*)labels,
        (float*)out, t, d, vocab, h_stride, w_stride, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hidden: (R, T, d) with rows contiguous and `h_stride` elements between
// replicas; w: (R, d, V) with rows contiguous and `w_stride` elements between
// replicas; both of one dtype (0 = fp32, 2 = bf16). labels: (R, T) int32
// contiguous; out: (R, T) fp32. Launches on `stream` and returns
// cudaGetLastError() (0 on success) or the error that stopped the launch.
int fused_ce(const void* hidden, const void* w, const void* labels, void* out, int r,
             int t, int d, int vocab, int64_t h_stride, int64_t w_stride, int dtype,
             void* stream) {
  return launch(hidden, w, labels, out, r, t, d, vocab, h_stride, w_stride, dtype, stream);
}

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
