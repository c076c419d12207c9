// BatchNorm's normalisation and its closed-form backward, hand-written for
// Hopper (sm_90a): one pass forward (train and eval), one reduction and one
// pass backward. The statistics come from K2 (bn_stats.cu).
//
// Replaces no TPU kernel. The JAX package writes these steps in plain jnp
// (`onda_tpu/models/layers.py::_bn_train_math`, its eval branch, and the
// closed form `_bn_train_bwd`), which XLA fuses with their neighbours. Run
// eagerly in PyTorch, each operation of the same expressions is a kernel and
// a full pass over the activation: about 6 launches a forward (13 with the
// running update) and 12 a backward. These kernels were added to do that
// work in as few passes as its data dependences allow.
//
// What bounds them on this card: bytes. Per element the forward reads x and
// writes y, the reduction reads x and dy, the dx pass reads x and dy and
// writes dx, each with a few f32 operations: at 3.35 TB/s the transfers are
// the whole cost (R50 at b4 1024x512: 4.2 GB of BatchNorm inputs a forward).
//
// What the design does about it:
// - Every pass is one launch over the activation, in x's dtype (f32 or bf16,
//   computed in f32). A block derives its channel's constants itself from the
//   (C,) statistics, gamma, beta and eps: no separate per-channel launches.
// - bn_apply_kernel keeps the expression order of the plain version,
//   (x - mean) * (gamma * rsqrt(var + eps)) + beta, with round-to-nearest
//   operations that the compiler may not contract into FMAs, so it rounds as
//   the separate PyTorch kernels do. The block that owns a channel also writes
//   1/sqrt(var + eps) (the backward's saved `inv`) and, in training, the
//   channel's running update, rm*(1-m) + m*mean and rv*(1-m) + (m*var)*n/(n-1),
//   in the order of the plain `mul_`/`add_` sequence.
// - bn_grad_sums_kernel reads x and dy once and writes each channel's sum of
//   dy and of dy*x_hat (x_hat from mean and inv on the fly): f32 per thread,
//   f64 across the block. A channel's blocks meet without a second launch: each
//   writes its partial, and the last to arrive (an atomic count per channel,
//   reset by that block) folds the partials in block order, so the result is
//   the same bit for bit from run to run. The all-reduce of data parallelism
//   sits between this kernel and the next.
// - bn_grad_dx_kernel reads x and dy and writes
//   dx = (gamma*inv) * ((dy - sum_dy/n) - x_hat*(sum_dy_xhat/n)); without the
//   sums (statistics held constant, eval mode) dx = (gamma*inv) * dy.
// - NCHW (the main path): grid (blocks, C); block r of channel c takes the
//   span [r*span, (r+1)*span) of the channel's N*H*W values, its N planes laid
//   end to end (ops/kernels.py::bn_pass_plan: about 1024 blocks, none under
//   4 KB, so that the card is full at every BatchNorm shape the port feeds).
//   Each plane piece is split at the first 16-byte boundary: scalars up to it,
//   16-byte vectors (4 f32 or 8 bf16), four of them in flight per thread, then
//   scalars for the tail. The R50 planes (65x129, 129x257) are odd, so most
//   start off a boundary; the split is taken from the address at run time,
//   and a call whose tensors differ in their offset from a boundary runs all
//   scalar.
// - Order: K2 walks the channels upwards and the gradient arrives from
//   elementwise kernels that do too, so bn_apply_kernel and
//   bn_grad_sums_kernel walk them downwards, starting on what the pass before
//   left in the 50 MB L2; bn_grad_dx_kernel walks upwards again, after the
//   reduction.
// channels_last (not on the main path): the reduction takes blocks of 32
// channels (one a lane) by a run of rows and folds them as above; the two
// elementwise passes walk the tensor flat with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread and input
constexpr int kClChannels = 32; // channels_last reduction: channels a block takes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 bytes of T as f32 values, and back
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of an f32: exact
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Visit the len values of a run: out[j] = op(x[j], dy[j]) (kDy: dy read,
// kOut: out written). With `vec` the run splits into a scalar head up to x's
// first 16-byte boundary, a 16-byte body and a scalar tail; without it (the
// tensors' offsets from a boundary differ) every value is a scalar.
template <typename T, bool kDy, bool kOut, typename Op>
__device__ __forceinline__ void visit_run(const T* __restrict__ x, const T* __restrict__ dy,
                                          T* __restrict__ out, long long len, bool vec, Op op) {
  constexpr int kN = Vec<T>::kN;
  long long head = 0, nvec = 0;
  if (vec) {
    const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(x) & 15u);
    head = mis ? (16 - mis) / sizeof(T) : 0;
    if (head > len) head = len;
    nvec = (len - head) / kN;
  }
  auto scalar = [&](long long j) {
    const float r = op(to_f32(x[j]), kDy ? to_f32(dy[j]) : 0.0f);
    if constexpr (kOut) store(out + j, r);
  };
  auto vector = [&](const uint4& rx, const uint4& rd, uint4* o) {
    float a[kN], d[kN];
    Vec<T>::unpack(rx, a);
    if constexpr (kDy) Vec<T>::unpack(rd, d);
#pragma unroll
    for (int k = 0; k < kN; ++k) a[k] = op(a[k], kDy ? d[k] : 0.0f);
    if constexpr (kOut) *o = Vec<T>::pack(a);
  };
  if (threadIdx.x < head) scalar(threadIdx.x);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* dv = reinterpret_cast<const uint4*>(dy + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 rx[kUnroll], rd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rx[u] = __ldg(xv + i + u * kThreads);
      if constexpr (kDy) rd[u] = __ldg(dv + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) vector(rx[u], rd[u], ov + i + u * kThreads);
  }
  for (; i < nvec; i += kThreads) {
    uint4 rd = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kDy) rd = __ldg(dv + i);
    vector(__ldg(xv + i), rd, ov + i);
  }
  for (long long j = head + nvec * kN + threadIdx.x; j < len; j += kThreads) scalar(j);
}

// The plane pieces of block `part`'s span of channel c in an NCHW tensor:
// f(element offset of the piece, its length) for each.
template <typename F>
__device__ __forceinline__ void for_each_piece(int c, int C, long long HW, long long M,
                                               long long span, long long part, F f) {
  long long lo = part * span;
  const long long hi = lo + span < M ? lo + span : M;
  long long n = lo / HW;
  long long off = lo - n * HW;
  while (lo < hi) {
    const long long len = HW - off < hi - lo ? HW - off : hi - lo;
    f((n * C + c) * HW + off, len);
    lo += len;
    ++n;
    off = 0;
  }
}

__device__ __forceinline__ bool same_offset(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

__device__ __forceinline__ float affine(float v, float mu, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mu), a), b);
}

__device__ __forceinline__ float dx_of(float x, float d, float mu, float inv, float a, float s1,
                                       float s2) {
  const float xh = __fmul_rn(__fsub_rn(x, mu), inv);
  return __fmul_rn(a, __fsub_rn(__fsub_rn(d, s1), __fmul_rn(xh, s2)));
}

// What the block owning channel c writes besides y: inv, and the running update
__device__ __forceinline__ void channel_epilogue(int c, float inv, const float* __restrict__ mean,
                                                 const float* __restrict__ var,
                                                 float* __restrict__ inv_out,
                                                 float* __restrict__ run_mean,
                                                 float* __restrict__ run_var, float keep,
                                                 float mom, float unbias) {
  if (inv_out) inv_out[c] = inv;
  if (run_mean) {
    run_mean[c] = __fadd_rn(__fmul_rn(run_mean[c], keep), __fmul_rn(mean[c], mom));
    run_var[c] = __fadd_rn(__fmul_rn(run_var[c], keep), __fmul_rn(__fmul_rn(var[c], mom), unbias));
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

// NCHW forward: grid (blocks, C), channels walked downwards
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, int C, long long HW, long long M,
                    long long span, const float* __restrict__ mean, const float* __restrict__ var,
                    const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                    float* __restrict__ inv_out, float* __restrict__ run_mean,
                    float* __restrict__ run_var, float keep, float mom, float unbias) {
  const int c = C - 1 - (int)blockIdx.y;
  const long long part = (long long)gridDim.x - 1 - blockIdx.x;
  const float inv = rsqrtf(__fadd_rn(var[c], eps));
  const float mu = mean[c];
  const float a = __fmul_rn(inv, weight[c]);
  const float b = bias[c];
  if (part == 0 && threadIdx.x == 0)
    channel_epilogue(c, inv, mean, var, inv_out, run_mean, run_var, keep, mom, unbias);
  const bool vec = same_offset(x, y);
  for_each_piece(c, C, HW, M, span, part, [&](long long at, long long len) {
    visit_run<T, false, true>(x + at, nullptr, y + at, len, vec,
                              [=](float v, float) { return affine(v, mu, a, b); });
  });
}

// NCHW reduction: grid (blocks, C), channels walked downwards. partial holds
// 2 doubles per block, arrivals one counter per channel (0 on entry and exit).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, int C, long long HW,
                        long long M, long long span, const float* __restrict__ mean,
                        const float* __restrict__ inv, double* __restrict__ partial,
                        unsigned* __restrict__ arrivals, float* __restrict__ sum_dy,
                        float* __restrict__ sum_dy_xhat) {
  __shared__ bool last;
  const int c = C - 1 - (int)blockIdx.y;
  const long long part = (long long)gridDim.x - 1 - blockIdx.x;
  const float mu = mean[c];
  const float iv = inv[c];
  float s = 0.0f, q = 0.0f;
  const bool vec = same_offset(x, dy);
  for_each_piece(c, C, HW, M, span, part, [&](long long at, long long len) {
    visit_run<T, true, false>(x + at, dy + at, (T*)nullptr, len, vec, [&](float v, float d) {
      s += d;
      q = fmaf(d, __fmul_rn(__fsub_rn(v, mu), iv), q);
      return 0.0f;
    });
  });
  double ds = s, dq = q;
  block_sum2(ds, dq);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      sum_dy[c] = (float)ds;
      sum_dy_xhat[c] = (float)dq;
    }
    return;
  }
  if (threadIdx.x == 0) {
    double* p = partial + 2 * ((long long)c * gridDim.x + part);
    p[0] = ds;
    p[1] = dq;
    __threadfence();
    last = atomicAdd(arrivals + c, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double fa = 0.0, fb = 0.0;
  for (long long i = threadIdx.x; i < gridDim.x; i += kThreads) {
    const double* p = partial + 2 * ((long long)c * gridDim.x + i);
    fa += __ldcg(p);
    fb += __ldcg(p + 1);
  }
  block_sum2(fa, fb);
  if (threadIdx.x == 0) {
    sum_dy[c] = (float)fa;
    sum_dy_xhat[c] = (float)fb;
    arrivals[c] = 0u;
  }
}

// NCHW dx: grid (blocks, C), channels walked upwards; null sums: eval mode
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_grad_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int C,
                      long long HW, long long M, long long span, const float* __restrict__ mean,
                      const float* __restrict__ inv, const float* __restrict__ weight,
                      const float* __restrict__ sum_dy, const float* __restrict__ sum_dy_xhat,
                      float n) {
  const int c = blockIdx.y;
  const float mu = mean[c];
  const float iv = inv[c];
  const float a = __fmul_rn(weight[c], iv);
  const float s1 = sum_dy ? __fdiv_rn(sum_dy[c], n) : 0.0f;
  const float s2 = sum_dy_xhat ? __fdiv_rn(sum_dy_xhat[c], n) : 0.0f;
  const bool vec = same_offset(x, dy) && same_offset(x, dx);
  for_each_piece(c, C, HW, M, span, blockIdx.x, [&](long long at, long long len) {
    visit_run<T, true, true>(x + at, dy + at, dx + at, len, vec, [=](float v, float d) {
      return dx_of(v, d, mu, iv, a, s1, s2);
    });
  });
}

// channels_last forward: x is (M, C) row-major, walked flat
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_apply_cl_kernel(const T* __restrict__ x, T* __restrict__ y, int C, long long total,
                       const float* __restrict__ mean, const float* __restrict__ var,
                       const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                       float* __restrict__ inv_out, float* __restrict__ run_mean,
                       float* __restrict__ run_var, float keep, float mom, float unbias) {
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < C; c += kThreads)
      channel_epilogue(c, rsqrtf(__fadd_rn(var[c], eps)), mean, var, inv_out, run_mean, run_var,
                       keep, mom, unbias);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % C);
    const float a = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), weight[c]);
    store(y + i, affine(to_f32(x[i]), mean[c], a, bias[c]));
  }
}

// channels_last reduction: grid (row chunks, ceil(C/32)); lane = channel,
// warp = row; the last chunk of a group of 32 channels to arrive folds them
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy, int C, long long M,
                           long long rows, const float* __restrict__ mean,
                           const float* __restrict__ inv, double* __restrict__ partial,
                           unsigned* __restrict__ arrivals, float* __restrict__ sum_dy,
                           float* __restrict__ sum_dy_xhat) {
  __shared__ double ss[kWarps][kClChannels];
  __shared__ double sq[kWarps][kClChannels];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int c = g * kClChannels + lane;
  const long long lo = (long long)blockIdx.x * rows;
  const long long hi = lo + rows < M ? lo + rows : M;
  float s = 0.0f, q = 0.0f;
  if (c < C) {
    const float mu = mean[c];
    const float iv = inv[c];
    for (long long r = lo + warp; r < hi; r += kWarps) {
      const float d = to_f32(dy[r * C + c]);
      s += d;
      q = fmaf(d, __fmul_rn(__fsub_rn(to_f32(x[r * C + c]), mu), iv), q);
    }
  }
  ss[warp][lane] = s;
  sq[warp][lane] = q;
  __syncthreads();
  double a = 0.0, b = 0.0;
  if (warp == 0) {
    for (int j = 0; j < kWarps; ++j) {
      a += ss[j][lane];
      b += sq[j][lane];
    }
  }
  if (gridDim.x == 1) {
    if (warp == 0 && c < C) {
      sum_dy[c] = (float)a;
      sum_dy_xhat[c] = (float)b;
    }
    return;
  }
  double* base = partial + 2 * (long long)(g * kClChannels) * gridDim.x;
  if (warp == 0) {
    double* p = base + 2 * ((long long)lane * gridDim.x + blockIdx.x);
    p[0] = a;
    p[1] = b;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + g, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  a = 0.0;
  b = 0.0;
  for (long long i = warp; i < gridDim.x; i += kWarps) {
    const double* p = base + 2 * ((long long)lane * gridDim.x + i);
    a += __ldcg(p);
    b += __ldcg(p + 1);
  }
  ss[warp][lane] = a;
  sq[warp][lane] = b;
  __syncthreads();
  if (warp == 0) {
    a = 0.0;
    b = 0.0;
    for (int j = 0; j < kWarps; ++j) {
      a += ss[j][lane];
      b += sq[j][lane];
    }
    if (c < C) {
      sum_dy[c] = (float)a;
      sum_dy_xhat[c] = (float)b;
    }
    if (lane == 0) arrivals[g] = 0u;
  }
}

// channels_last dx, walked flat
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_grad_dx_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                         int C, long long total, const float* __restrict__ mean,
                         const float* __restrict__ inv, const float* __restrict__ weight,
                         const float* __restrict__ sum_dy, const float* __restrict__ sum_dy_xhat,
                         float n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % C);
    const float iv = inv[c];
    const float s1 = sum_dy ? __fdiv_rn(sum_dy[c], n) : 0.0f;
    const float s2 = sum_dy_xhat ? __fdiv_rn(sum_dy_xhat[c], n) : 0.0f;
    store(dx + i, dx_of(to_f32(x[i]), to_f32(dy[i]), mean[c], iv, __fmul_rn(weight[c], iv), s1, s2));
  }
}

int launched() { return (int)cudaGetLastError(); }

bool plan_ok(int N, int C, long long HW, int blocks, long long span) {
  const long long M = (long long)N * HW;
  return N >= 1 && C >= 1 && HW >= 1 && C <= 65535 && blocks >= 1 && span >= 1 &&
         (long long)(blocks - 1) * span < M && (long long)blocks * span >= M;
}

}  // namespace

// The three passes. x: (N, C, H, W) with HW = H*W, NCHW-contiguous (cl = 0:
// grid (blocks, C), each block `span` values of a channel's N*HW, with
// (blocks - 1) * span < N*HW <= blocks * span; ops/kernels.py::bn_pass_plan)
// or channels_last (cl = 1: the elementwise passes take `blocks` blocks
// walking the tensor flat, the reduction `blocks` chunks of `span` rows).
// Every other tensor is f32 and contiguous; null pointers are absent
// arguments as each signature says.

// y = (x - mean) * (weight * rsqrt(var + eps)) + bias; a non-null inv_out
// receives rsqrt(var + eps); non-null run_mean/run_var are updated in place.
extern "C" int onda_bn_apply(const void* x, void* y, int is_bf16, int cl, int N, int C,
                             long long HW, int blocks, long long span, const void* mean,
                             const void* var, const void* weight, const void* bias, float eps,
                             void* inv_out, void* run_mean, void* run_var, float keep, float mom,
                             float unbias, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *m = (const float*)mean, *v = (const float*)var, *w = (const float*)weight,
              *b = (const float*)bias;
  float *io = (float*)inv_out, *rm = (float*)run_mean, *rv = (float*)run_var;
  if (cl) {
    if (N < 1 || C < 1 || HW < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)N * HW * C;
    if (is_bf16)
      bn_apply_cl_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, (__nv_bfloat16*)y, C, total, m, v, w, b, eps, io, rm, rv, keep,
          mom, unbias);
    else
      bn_apply_cl_kernel<float><<<blocks, kThreads, 0, s>>>((const float*)x, (float*)y, C, total, m,
                                                            v, w, b, eps, io, rm, rv, keep, mom,
                                                            unbias);
    return launched();
  }
  if (!plan_ok(N, C, HW, blocks, span)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * HW;
  const dim3 grid(blocks, C);
  if (is_bf16)
    bn_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, C, HW, M, span, m, v, w, b, eps, io, rm, rv,
        keep, mom, unbias);
  else
    bn_apply_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (float*)y, C, HW, M, span, m,
                                                     v, w, b, eps, io, rm, rv, keep, mom, unbias);
  return launched();
}

// Each channel's sum of dy and of dy * (x - mean) * inv. partial: 2 doubles
// per block and channel (NCHW: blocks * C; channels_last: blocks * 32 *
// ceil(C/32)); arrivals: one zeroed counter per channel (NCHW) or per 32
// channels (channels_last), left zeroed.
extern "C" int onda_bn_grad_sums(const void* x, const void* dy, int is_bf16, int cl, int N, int C,
                                 long long HW, int blocks, long long span, const void* mean,
                                 const void* inv, void* partial, void* arrivals, void* sum_dy,
                                 void* sum_dy_xhat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *m = (const float*)mean, *iv = (const float*)inv;
  double* p = (double*)partial;
  unsigned* arr = (unsigned*)arrivals;
  float *s1 = (float*)sum_dy, *s2 = (float*)sum_dy_xhat;
  if (cl) {
    const long long M = (long long)N * HW;
    if (N < 1 || C < 1 || HW < 1 || blocks < 1 || span < 1 || (long long)blocks * span < M ||
        (C + kClChannels - 1) / kClChannels > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(blocks, (C + kClChannels - 1) / kClChannels);
    if (is_bf16)
      bn_grad_sums_cl_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, C, M, span, m, iv, p, arr, s1, s2);
    else
      bn_grad_sums_cl_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (const float*)dy, C,
                                                              M, span, m, iv, p, arr, s1, s2);
    return launched();
  }
  if (!plan_ok(N, C, HW, blocks, span)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * HW;
  const dim3 grid(blocks, C);
  if (is_bf16)
    bn_grad_sums_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, C, HW, M, span, m, iv, p, arr, s1, s2);
  else
    bn_grad_sums_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (const float*)dy, C, HW,
                                                         M, span, m, iv, p, arr, s1, s2);
  return launched();
}

// dx = (weight * inv) * ((dy - sum_dy / n) - x_hat * (sum_dy_xhat / n)),
// x_hat = (x - mean) * inv; null sums: dx = (weight * inv) * dy.
extern "C" int onda_bn_grad_dx(const void* x, const void* dy, void* dx, int is_bf16, int cl, int N,
                               int C, long long HW, int blocks, long long span, const void* mean,
                               const void* inv, const void* weight, const void* sum_dy,
                               const void* sum_dy_xhat, float n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *m = (const float*)mean, *iv = (const float*)inv, *w = (const float*)weight,
              *s1 = (const float*)sum_dy, *s2 = (const float*)sum_dy_xhat;
  if (cl) {
    if (N < 1 || C < 1 || HW < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)N * HW * C;
    if (is_bf16)
      bn_grad_dx_cl_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, C, total, m, iv,
          w, s1, s2, n);
    else
      bn_grad_dx_cl_kernel<float><<<blocks, kThreads, 0, s>>>(
          (const float*)x, (const float*)dy, (float*)dx, C, total, m, iv, w, s1, s2, n);
    return launched();
  }
  if (!plan_ok(N, C, HW, blocks, span)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * HW;
  const dim3 grid(blocks, C);
  if (is_bf16)
    bn_grad_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, C, HW, M, span, m,
        iv, w, s1, s2, n);
  else
    bn_grad_dx_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (const float*)dy,
                                                       (float*)dx, C, HW, M, span, m, iv, w, s1,
                                                       s2, n);
  return launched();
}
