// K1 — prototype pseudo-labels, hand-written for Hopper (sm_90a).
//
// Replaces: onda_tpu/ops/pallas_kernels.py, `fused_pseudo_labels` (kernel body
// `_kernel`). For every pixel p of a (P, F) feature matrix and C <= 32 class
// prototypes (C, F):
//
//   d_c   = sqrt(max(|f|^2 - 2 f.m_c + |m_c|^2, 0))   (f, m scaled by inv_std
//                                                      when given: mahalanobis)
//   prop  = softmax(-(d - min_c d) / tau)              (tau read from device)
//   fused = prop * prior / sum(prop * prior)
//   soft[p, :] = fused; hard[p] = argmax fused, 255 where max < thresh;
//   prop_max[p] = max_c prop
//
// What bounds it on this card: bytes. Per launch at the main path's shape
// (P = 4*65*129 = 33,540, F = 256, C = 19) it reads the 34.3 MB feature matrix
// and the 2.5 MB prior, and writes 2.5 MB of soft labels plus 0.27 MB of hard
// labels and maxima; its 2*P*C*F = 0.33 GFLOP is negligible beside that.
//
// What the design does about it: each feature row is read from device memory
// exactly once, by one warp, with neighbouring lanes on neighbouring
// addresses. The scaled prototypes and their squared norms live in shared
// memory for the whole block; the 19 dot products of a pixel are lane-local
// FMAs followed by warp shuffles, and the distance, min-subtract, softmax,
// prior fusion, argmax and threshold all stay in registers, one class per
// lane. Blocks stride over pixels so the prototype tile is loaded only once
// per block. Plain FMA, no tensor cores: this is the first, simple version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxC = 32;
constexpr int kWarps = 8;
constexpr int kMaxBlocks = 132 * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void pseudo_labels_kernel(const float* __restrict__ feat,
                                     const float* __restrict__ protos,
                                     const float* __restrict__ prior,
                                     const float* __restrict__ tau_ptr,
                                     const float* __restrict__ inv_std,
                                     float thresh, int P, int F, int C,
                                     float* __restrict__ soft,
                                     int* __restrict__ hard,
                                     float* __restrict__ prop_max) {
  extern __shared__ float smem[];
  float* sp = smem;                 // (C, F) scaled prototypes
  float* sp2 = smem + C * F;        // (kMaxC,) their squared norms
  float* sinv = sp2 + kMaxC;        // (F,) feature scale (1 for euclidean)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < F; i += blockDim.x) sinv[i] = inv_std ? inv_std[i] : 1.0f;
  __syncthreads();
  for (int i = tid; i < C * F; i += blockDim.x) sp[i] = protos[i] * sinv[i % F];
  __syncthreads();
  for (int c = warp; c < C; c += kWarps) {
    float s = 0.0f;
    for (int f = lane; f < F; f += 32) s += sp[c * F + f] * sp[c * F + f];
    s = warp_sum(s);
    if (lane == 0) sp2[c] = s;
  }
  __syncthreads();

  const float tau = *tau_ptr;
  const bool valid = lane < C;
  for (int p = blockIdx.x * kWarps + warp; p < P; p += gridDim.x * kWarps) {
    const float* fp = feat + (size_t)p * F;
    float acc[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
    float f2 = 0.0f;
    for (int f = lane; f < F; f += 32) {
      const float v = fp[f] * sinv[f];
      f2 += v * v;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc[c] += v * sp[c * F + f];
    }
    f2 = warp_sum(f2);
    float cross = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const float s = warp_sum(acc[c]);
        if (lane == c) cross = s;
      }
    }
    const float d = valid ? sqrtf(fmaxf(f2 - 2.0f * cross + sp2[lane], 0.0f)) : INFINITY;
    const float dmin = warp_min(d);
    const float e = valid ? expf(-(d - dmin) / tau) : 0.0f;
    const float prop = e / warp_sum(e);
    const float pmax = warp_max(prop);
    const float pr = valid ? prior[(size_t)p * C + lane] : 0.0f;
    float fused = prop * pr;
    fused = fused / warp_sum(fused);

    // argmax over classes; the lowest index wins a tie, as argmax does
    float best = valid ? fused : -INFINITY;
    int idx = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    if (valid) soft[(size_t)p * C + lane] = fused;
    if (lane == 0) {
      hard[p] = best < thresh ? 255 : idx;
      prop_max[p] = pmax;
    }
  }
}

}  // namespace

extern "C" int onda_pseudo_labels(const void* feat, const void* protos, const void* prior,
                                  const void* tau, const void* inv_std, float thresh,
                                  int P, int F, int C, void* soft, void* hard,
                                  void* prop_max, void* stream) {
  if (C < 1 || C > kMaxC || F < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(C * F + kMaxC + F) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pseudo_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (P + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pseudo_labels_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)protos, (const float*)prior, (const float*)tau,
      (const float*)inv_std, thresh, P, F, C, (float*)soft, (int*)hard, (float*)prop_max);
  return (int)cudaGetLastError();
}
