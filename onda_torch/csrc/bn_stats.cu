// K2 — train-mode BatchNorm batch statistics, hand-written for Hopper (sm_90a).
//
// Replaces: onda_tpu/ops/pallas_kernels.py, `bn_batch_stats` (kernel body
// `_bn_stats_kernel`). For a 4-D activation (N, C, H, W) in f32 or bf16 it
// returns per-channel mean and biased variance max(E[x^2] - E[x]^2, 0),
// accumulated in f32 per thread and folded in f64, the semantics of
// `_bn_train_math` in onda_tpu/models/layers.py.
//
// What bounds it on this card: bytes. Every input element is read once and
// takes three flops, so at 3.35 TB/s the read is the whole cost: 40 us for the
// 134 MB f32 activation after the stem conv at batch 4, 1024x512, but only
// 5-10 us for the 17-34 MB inputs of the later stages, where a launch, a short
// block's set-up and a reduction tail weigh as much as the read.
//
// What the design does about it (NCHW, the layout of the main path):
// - One launch per call, on thread-block clusters. Channel c gets a cluster of
//   `cluster` blocks (grid (cluster, C), at most 8: the portable size, which
//   already gives >= 256 blocks at every R50 shape, >= 512 in f32). Block r
//   reduces the span [r*span, (r+1)*span) of the channel's N*H*W values (the
//   N planes laid end to end) into f32 registers, then folds them across its
//   threads in f64.
//   The blocks of a cluster meet through distributed shared memory: after
//   cluster.sync() the first 32 threads of rank 0 read every rank's partial
//   with map_shared_rank and add them in a fixed shuffle tree, and rank 0
//   writes mean and var. No partial buffer in device memory, no second launch,
//   no atomics: the result is the same bit for bit from run to run.
// - 16-byte loads. Each plane piece is split at the first 16-byte boundary:
//   scalars up to it, then 16-byte vectors (4 f32 or 8 bf16) for the body,
//   four of them in flight per thread before any is added, then scalars for
//   the tail. The odd plane sizes (129*257, 65*129) leave most planes
//   unaligned, so the split is taken from the address at run time.
// - A grid sized to the card. `ops/kernels.py::bn_stats_plan` picks the
//   cluster size so that there are about 512 blocks (4 on each of 132 SMs, all
//   resident at once) but no block reads less than 32 KB, and the span as a
//   multiple of 8 elements; the tests check on the CPU that the blocks cover
//   every element exactly once. Fewer, longer blocks won on an H100 (SXM,
//   700 W): against about 1024 blocks they took 8-13% less time on the f32
//   inputs of 34-136 MB with 256 or 512 channels, and about 256 blocks were
//   no faster. Each block pays a fixed path (set-up, block reduction, two
//   cluster syncs); fewer blocks pay it fewer times.
// channels_last (not on the main path) keeps a two-launch design:
// blocks of 32 channels by a run of rows, one channel per lane so that a warp
// reads neighbouring values, write f32 partials, and a second launch folds each
// channel's partials in f64. Its loads are scalar.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 16-byte loads in flight per thread
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void add1(float v, float (&s)[4], float (&q)[4]) {
  s[0] += v;
  q[0] = fmaf(v, v, q[0]);
}

// the values of one 16-byte vector, spread over the four accumulator pairs
__device__ __forceinline__ void add_vec(const uint4& u, float (&s)[4], float (&q)[4], float) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] += v[j];
    q[j] = fmaf(v[j], v[j], q[j]);
  }
}

__device__ __forceinline__ void add_vec(const uint4& u, float (&s)[4], float (&q)[4],
                                        __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of an f32: exact
    const float lo = __uint_as_float(w[j] << 16);
    const float hi = __uint_as_float(w[j] & 0xffff0000u);
    s[j] += lo;
    q[j] = fmaf(lo, lo, q[j]);
    s[j] += hi;
    q[j] = fmaf(hi, hi, q[j]);
  }
}

template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  __shared__ T sa[kWarps];
  __shared__ T sb[kWarps];
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
    a = lane < kWarps ? sa[lane] : T(0);
    b = lane < kWarps ? sb[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// Sum len contiguous values at p: scalar head to the first 16-byte boundary,
// 16-byte body, scalar tail.
template <typename T>
__device__ __forceinline__ void reduce_run(const T* __restrict__ p, long long len, float (&s)[4],
                                           float (&q)[4]) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(p) & 15u);
  long long head = mis ? (16 - mis) / sizeof(T) : 0;
  if (head > len) head = len;
  if (threadIdx.x < head) add1(to_f32(p[threadIdx.x]), s, q);
  const long long nvec = (len - head) / kVec;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(v + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_vec(r[u], s, q, T());
  }
  for (; i < nvec; i += kThreads) add_vec(__ldg(v + i), s, q, T());
  for (long long j = head + nvec * kVec + threadIdx.x; j < len; j += kThreads)
    add1(to_f32(p[j]), s, q);
}

// grid (cluster, C), clusters of (cluster, 1, 1): block r of channel c sums
// the values [r*span, min((r+1)*span, M)) of the channel, M = N*HW.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_stats_cluster_kernel(const T* __restrict__ x, int C, long long HW, long long M,
                            long long span, float* __restrict__ mean, float* __restrict__ var) {
  __shared__ double part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y;
  long long lo = (long long)blockIdx.x * span;
  const long long hi = lo + span < M ? lo + span : M;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  long long n = lo / HW;
  long long off = lo - n * HW;
  while (lo < hi) {  // one piece of each plane the span touches
    const long long len = HW - off < hi - lo ? HW - off : hi - lo;
    reduce_run(x + ((long long)n * C + c) * HW + off, len, s, q);
    lo += len;
    ++n;
    off = 0;
  }
  double ds = ((double)s[0] + (double)s[1]) + ((double)s[2] + (double)s[3]);
  double dq = ((double)q[0] + (double)q[1]) + ((double)q[2] + (double)q[3]);
  block_sum2(ds, dq);
  if (threadIdx.x == 0) {
    part[0] = ds;
    part[1] = dq;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < 32) {
    double a = 0.0, b = 0.0;
    if (threadIdx.x < cluster.num_blocks()) {
      const double* r = cluster.map_shared_rank(part, threadIdx.x);
      a = r[0];
      b = r[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (threadIdx.x == 0) {
      const double m = a / (double)M;
      const double v = b / (double)M - m * m;
      mean[c] = (float)m;
      var[c] = (float)(v > 0.0 ? v : 0.0);
    }
  }
  cluster.sync();  // keep every block's shared memory alive until rank 0 has read it
}

// channels_last: grid (row chunks, ceil(C/32)); x is (M, C) row-major
template <typename T>
__global__ void stats_cl_kernel(const T* __restrict__ x, int C, long long M, long long rows,
                                float* __restrict__ psum, float* __restrict__ psq, int nparts) {
  __shared__ float ss[kWarps][33];
  __shared__ float sq[kWarps][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + tx;
  const long long lo = (long long)blockIdx.x * rows;
  const long long hi = lo + rows < M ? lo + rows : M;
  float s = 0.0f, q = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (long long r = lo + ty; r < hi; r += kWarps) {
      const float v = to_f32(x[(size_t)r * C + c]);
      s += v;
      q += v * v;
    }
  }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int j = 1; j < kWarps; ++j) {
      s += ss[j][tx];
      q += sq[j][tx];
    }
    const size_t at = (size_t)c * nparts + blockIdx.x;
    psum[at] = s;
    psq[at] = q;
  }
}

// channels_last, second launch: grid (C,), fold one channel's partials in f64
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
int launch_nchw(const void* x, int N, int C, long long HW, int cluster, long long span,
                float* mean, float* var, cudaStream_t stream) {
  const long long M = (long long)N * HW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, C, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, bn_stats_cluster_kernel<T>, (const T*)x, C, HW, M,
                                       span, mean, var);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cl(const void* x, int C, long long M, long long rows, int nchunks, float* partial,
              float* mean, float* var, cudaStream_t stream) {
  float* psum = partial;
  float* psq = partial + (size_t)C * nchunks;
  stats_cl_kernel<T><<<dim3(nchunks, (C + 31) / 32), kThreads, 0, stream>>>(
      (const T*)x, C, M, rows, psum, psq, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<C, kThreads, 0, stream>>>(psum, psq, nchunks, (double)M, mean, var);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, C, H, W) NCHW-contiguous, HW = H*W. The plan (ops/kernels.py::
// bn_stats_plan) gives `cluster` blocks per channel, each summing `span`
// values of the channel's N*HW, with (cluster - 1) * span < N*HW <= cluster * span.
extern "C" int onda_bn_stats_nchw(const void* x, int is_bf16, int N, int C, long long HW,
                                  int cluster, long long span, void* mean, void* var,
                                  void* stream) {
  const long long M = (long long)N * HW;
  if (N < 1 || C < 1 || HW < 1 || C > 65535 || cluster < 1 || cluster > kMaxCluster ||
      span < 1 || (long long)(cluster - 1) * span >= M || (long long)cluster * span < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_nchw<__nv_bfloat16>(x, N, C, HW, cluster, span, (float*)mean, (float*)var, s);
  return launch_nchw<float>(x, N, C, HW, cluster, span, (float*)mean, (float*)var, s);
}

// x: channels_last, i.e. (M, C) row-major with M = N*H*W; `rows` rows per
// block, `nchunks` = ceil(M / rows) blocks per 32 channels; `partial` holds
// 2 * C * nchunks f32 scratch.
extern "C" int onda_bn_stats_cl(const void* x, int is_bf16, long long M, int C, long long rows,
                                int nchunks, void* partial, void* mean, void* var, void* stream) {
  if (M < 1 || C < 1 || rows < 1 || nchunks < 1 || (long long)nchunks * rows < M ||
      (C + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_cl<__nv_bfloat16>(x, C, M, rows, nchunks, (float*)partial, (float*)mean,
                                    (float*)var, s);
  return launch_cl<float>(x, C, M, rows, nchunks, (float*)partial, (float*)mean, (float*)var, s);
}
