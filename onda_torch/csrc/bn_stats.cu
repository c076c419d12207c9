// K2 — train-mode BatchNorm batch statistics, hand-written for Hopper (sm_90a).
//
// Replaces: onda_tpu/ops/pallas_kernels.py, `bn_batch_stats` (kernel body
// `_bn_stats_kernel`). For a 4-D activation (N, C, H, W) in f32 or bf16 it
// returns per-channel mean and biased variance max(E[x^2] - E[x]^2, 0),
// accumulated in f32 (folded in f64), the semantics of `_bn_train_math` in
// onda_tpu/models/layers.py.
//
// What bounds it on this card: bytes. Every input element is read once and
// takes three flops, so at 3.35 TB/s the read is the whole cost: e.g. about
// 40 us for the 134 MB f32 activation after the stem conv at batch 4, 1024x512.
//
// What the design does about it: a two-stage reduction with no atomics, so
// results are the same from run to run. Stage 1 spreads each channel over
// many blocks; every block reads a contiguous span (NCHW: a piece of one
// image's H*W plane; channels_last: 32 channels by a run of rows, one channel
// per lane so a warp reads 32 neighbouring values) and writes one f32 partial
// sum and sum of squares. Stage 2 folds a channel's partials in f64 and writes
// mean and variance. The TPU kernel carried its sums from one grid step to the
// next; Hopper's blocks run in no order, so the partials go through device
// memory instead (a few KB). Simple scalar loads: the first, simple version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClRows = kThreads / 32;  // channels_last block: 32 channels x 8 rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  __shared__ T sa[kThreads / 32];
  __shared__ T sb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : T(0);
    b = lane < kThreads / 32 ? sb[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// grid (chunks, N, C): block (k, n, c) sums x[n, c, k*chunk : (k+1)*chunk]
template <typename T>
__global__ void stats_nchw_kernel(const T* __restrict__ x, int C, long long HW,
                                  long long chunk, float* __restrict__ psum,
                                  float* __restrict__ psq, int nparts) {
  const int k = blockIdx.x;
  const int n = blockIdx.y;
  const int c = blockIdx.z;
  const T* base = x + ((size_t)n * C + c) * (size_t)HW;
  const long long lo = (long long)k * chunk;
  const long long hi = lo + chunk < HW ? lo + chunk : HW;
  float s = 0.0f, q = 0.0f;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float v = to_f32(base[i]);
    s += v;
    q += v * v;
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    const size_t at = (size_t)c * nparts + (size_t)n * gridDim.x + k;
    psum[at] = s;
    psq[at] = q;
  }
}

// grid (row chunks, ceil(C/32)): x is (M, C) row-major (channels_last memory)
template <typename T>
__global__ void stats_cl_kernel(const T* __restrict__ x, int C, long long M,
                                long long rows, float* __restrict__ psum,
                                float* __restrict__ psq, int nparts) {
  __shared__ float ss[kClRows][33];
  __shared__ float sq[kClRows][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + tx;
  const long long lo = (long long)blockIdx.x * rows;
  const long long hi = lo + rows < M ? lo + rows : M;
  float s = 0.0f, q = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (long long r = lo + ty; r < hi; r += kClRows) {
      const float v = to_f32(x[(size_t)r * C + c]);
      s += v;
      q += v * v;
    }
  }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int j = 1; j < kClRows; ++j) {
      s += ss[j][tx];
      q += sq[j][tx];
    }
    const size_t at = (size_t)c * nparts + blockIdx.x;
    psum[at] = s;
    psq[at] = q;
  }
}

// grid (C,): fold one channel's partials in f64
__global__ void finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                int nparts, double count, float* __restrict__ mean,
                                float* __restrict__ var) {
  const int c = blockIdx.x;
  double s = 0.0, q = 0.0;
  for (int i = threadIdx.x; i < nparts; i += kThreads) {
    s += psum[(size_t)c * nparts + i];
    q += psq[(size_t)c * nparts + i];
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    const double m = s / count;
    const double v = q / count - m * m;
    mean[c] = (float)m;
    var[c] = (float)(v > 0.0 ? v : 0.0);
  }
}

template <typename T>
int launch(const void* x, int channels_last, int N, int C, long long HW, long long chunk,
           int nchunks, float* partial, float* mean, float* var, cudaStream_t stream) {
  const int nparts = channels_last ? nchunks : N * nchunks;
  float* psum = partial;
  float* psq = partial + (size_t)C * nparts;
  if (channels_last) {
    dim3 grid(nchunks, (C + 31) / 32);
    stats_cl_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, C, (long long)N * HW,
                                                      chunk, psum, psq, nparts);
  } else {
    dim3 grid(nchunks, N, C);
    stats_nchw_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, C, HW, chunk, psum,
                                                        psq, nparts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<C, kThreads, 0, stream>>>(psum, psq, nparts, (double)N * (double)HW,
                                              mean, var);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, C, H, W) with HW = H*W, NCHW-contiguous or channels_last; `chunk` is
// elements of one plane per block (NCHW) or rows per block (channels_last),
// `nchunks` their count; `partial` holds 2 * C * nparts f32 scratch, with
// nparts = N * nchunks (NCHW) or nchunks (channels_last).
extern "C" int onda_bn_stats(const void* x, int is_bf16, int channels_last, int N, int C,
                             long long HW, long long chunk, int nchunks, void* partial,
                             void* mean, void* var, void* stream) {
  if (N < 1 || C < 1 || HW < 1 || chunk < 1 || nchunks < 1 || C > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, channels_last, N, C, HW, chunk, nchunks, (float*)partial,
                                 (float*)mean, (float*)var, s);
  return launch<float>(x, channels_last, N, C, HW, chunk, nchunks, (float*)partial,
                       (float*)mean, (float*)var, s);
}
