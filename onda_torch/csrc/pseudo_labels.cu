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
//   soft[p, :] = fused; hard[p] = argmax fused (lowest index on a tie), 255
//   where max < thresh; prop_max[p] = max_c prop
//
// What bounds it on this card: bytes, in principle. At the main path's shape
// (P = 4*65*129 = 33,540, F = 256, C = 19) it reads the 34.3 MB feature matrix
// and the 2.5 MB prior and writes 2.5 MB of soft labels and 0.27 MB of hard
// labels and maxima: 11.9 us at 3.35 TB/s. Its 2*P*C*F = 0.33 GFLOP is 5 us of
// f32 FMA. In practice the time goes elsewhere. 33,540 pixels are only 263
// tiles of 128, two per SM, so each SM's time is the serial path of its tiles:
// load the prototypes, stream 8 feature chunks through the dot products, then
// the epilogue; and at one pixel per thread that is only 8 warps a SM to hide
// the latency of each step. A one-pixel-per-thread version of this design lost
// most of its time there, not on device memory.
//
// What the design does about it:
// - A register tile of 4 pixels x 4 classes a thread, as many threads as one
//   per pixel. A block takes a tile of 128 pixels with one warp per group of 4
//   classes (C padded to CP, a multiple of 4: CP/4 warps); lane g holds pixels
//   g, g+32, g+64, g+96. Per 4 features a thread makes 8 16-byte shared-memory
//   reads (4 feature rows, 4 prototype vectors) for 64 FMAs, where one pixel a
//   thread made 22 for 80.
// - The prototypes sit in shared memory transposed, (F, CP), as m * s^2 (s the
//   mahalanobis scale, or 1): f.(m s^2) = (f s).(m s), so the features enter
//   the dot products as they are, and only the first class group scales them,
//   for |f s|^2. A warp reads its 4 classes of a feature as one broadcast
//   16-byte load. They arrive by cp.async, one group of 4-byte copies put
//   straight into their transposed places, in flight with the ring's first
//   stages; the norms |m s|^2 are taken once they land.
// - Features reach shared memory by cp.async through a ring of 4 stages of
//   128 rows x 32 features, so three stages are in flight while the fourth is
//   computed. Rows are padded to 36 floats (36 = 4 mod 32): the 16-byte reads
//   that the 8 lanes of a quarter warp make of their rows fall in 8 distinct
//   groups of 4 banks, free of conflicts. The copies are coalesced: a warp
//   copies 4 rows x 128 contiguous bytes.
// - The epilogue is one thread per pixel with no warp shuffle: the class
//   groups leave their dot products in a shared (128, CP + 1) tile (an odd
//   stride: no bank conflicts), and thread p reads its row and computes the
//   distances, min, exp, both sums (a reciprocal each, not a division per
//   class), argmax and threshold.
// - The prior tile is one more item of the ring: its 128 x C values, contiguous
//   in device memory, are copied into rows padded to an odd stride; thread p
//   overwrites its row with its soft labels, and the block then writes the
//   tile back contiguous.
// - A persistent grid: as many blocks as the card holds at once (asked of
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor at launch), each walking
//   tiles blockIdx.x, +gridDim.x, ...
// - f32 FMA, not tensor cores: |f|^2 - 2 f.m + |m|^2 cancels when f is close
//   to m, and TF32's 10-bit mantissa in the cross term would break the 1e-4
//   tolerance of the soft labels. Error-compensated 3xTF32 is a later option.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;        // pixels per tile
constexpr int kPix = 4;           // pixels per thread: lane g holds g, g+32, g+64, g+96
constexpr int kChunk = 32;        // features per ring stage
constexpr int kRow = kChunk + 4;  // padded row stride in floats
constexpr int kStages = 4;
constexpr int kMaxC = 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy; bytes past src_bytes (0 or 16) are filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int padded_classes(int C) { return (C + 3) / 4 * 4; }
__host__ __device__ constexpr int prior_stride(int C) { return C | 1; }
__host__ __device__ constexpr int stage_floats(int C) {
  return kTile * kRow > kTile * prior_stride(C) ? kTile * kRow : kTile * prior_stride(C);
}

// Shared memory of one block, in bytes.
__host__ constexpr long long smem_bytes(int F, int C) {
  const long long fpad = (F + kChunk - 1) / kChunk * kChunk;
  const long long cp = padded_classes(C);
  return 4LL * (fpad * cp + fpad + cp + (long long)kStages * stage_floats(C) + kTile * (cp + 2));
}

template <int CP>
__global__ void __launch_bounds__(32 * (CP / 4))
    pseudo_labels_kernel(const float* __restrict__ feat, const float* __restrict__ protos,
                         const float* __restrict__ prior, const float* __restrict__ tau_ptr,
                         const float* __restrict__ inv_std, float thresh, int P, int F, int C,
                         float* __restrict__ soft, int* __restrict__ hard,
                         float* __restrict__ prop_max) {
  constexpr int kThreads = 32 * (CP / 4);  // a warp per group of 4 classes
  constexpr int kCross = CP + 1;           // odd row stride of the dot-product tile
  extern __shared__ __align__(16) float smem[];
  const int kch = (F + kChunk - 1) / kChunk;  // feature chunks per tile
  const int fpad = kch * kChunk;
  const int cs = prior_stride(C);
  const int sfl = stage_floats(C);
  float* sproto = smem;                     // (fpad, CP): scaled prototypes, transposed
  float* sscale = sproto + fpad * CP;        // (fpad,): feature scale
  float* snorm = sscale + fpad;              // (CP,): squared norms of the scaled prototypes
  float* sstage = snorm + CP;                // kStages x sfl: the ring
  float* scross = sstage + kStages * sfl;  // (kTile, kCross): f.m of the tile's pixels
  float* sf2 = scross + kTile * kCross;    // (kTile,): |f s|^2 of the tile's pixels
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = tid >> 5;  // classes 4*group .. 4*group + 3

  // ring items: for each of this block's tiles, kch feature chunks, then the prior tile
  const int ntiles = (P + kTile - 1) / kTile;
  const int mine = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = kch + 1;
  const int items = mine * per_tile;

  auto issue = [&](int item) {
    const int tile = blockIdx.x + (item / per_tile) * gridDim.x;
    const int k = item % per_tile;
    const int p0 = tile * kTile;
    const int np = P - p0 < kTile ? P - p0 : kTile;
    float* st = sstage + (item % kStages) * sfl;
    if (k < kch) {  // rows p0.., features k*kChunk..: 8 16-byte pieces a row
      for (int i = tid; i < kTile * (kChunk / 4); i += kThreads) {
        const int r = i / (kChunk / 4);
        const int col = k * kChunk + (i % (kChunk / 4)) * 4;
        const bool ok = r < np && col < F;
        cp_async16(st + r * kRow + (i % (kChunk / 4)) * 4,
                   ok ? feat + (size_t)(p0 + r) * F + col : feat, ok ? 16 : 0);
      }
    } else {  // the prior tile, np*C contiguous values, into rows of stride cs
      const float* src = prior + (size_t)p0 * C;
      for (int i = tid; i < np * C; i += kThreads) {
        const int r = i / C;
        cp_async4(st + r * cs + (i - r * C), src + i);
      }
    }
  };

  // the prototypes, transposed to (fpad, CP), and the feature scale: one group
  // of copies, in flight with the ring's first stages
  const float tau = *tau_ptr;
  for (int c = 0; c < C; ++c)
    for (int f = tid; f < F; f += kThreads) cp_async4(sproto + f * CP + c, protos + c * F + f);
  for (int i = tid; i < fpad * CP; i += kThreads)
    if (i / CP >= F || i % CP >= C) sproto[i] = 0.0f;
  for (int i = tid; i < fpad; i += kThreads) {
    if (i < F && inv_std)
      cp_async4(sscale + i, inv_std + i);
    else
      sscale[i] = i < F ? 1.0f : 0.0f;
  }
  cp_async_commit();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the prototypes have landed; the ring's stages may not have
  __syncthreads();
  // |m s|^2 per class, and m becomes m s^2 in place: f.(m s^2) = (f s).(m s), so
  // the features enter the dot products as they are
  for (int c = tid >> 5; c < CP; c += kThreads / 32) {
    float s = 0.0f;
#pragma unroll 4
    for (int f = lane; f < fpad; f += 32) {
      const float sc = sscale[f];
      const float v = sproto[f * CP + c] * sc;
      s = fmaf(v, v, s);
      sproto[f * CP + c] = v * sc;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) snorm[c] = s;
  }
  const float rtau = 1.0f / tau;

  float acc[kPix][4];
  float f2[kPix];
  for (int it = 0; it < items; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed for all; the stage refilled below is free
    if (it + kStages - 1 < items) issue(it + kStages - 1);
    cp_async_commit();

    float* st = sstage + (it % kStages) * sfl;
    const int k = it % per_tile;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        f2[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
    }
    if (k < kch) {
      const int f0 = k * kChunk;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 fv[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          fv[i] = *reinterpret_cast<const float4*>(st + (lane + 32 * i) * kRow + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 m =
              *reinterpret_cast<const float4*>(sproto + (f0 + kk + u) * CP + 4 * group);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float x = (&fv[i].x)[u];
            acc[i][0] = fmaf(x, m.x, acc[i][0]);
            acc[i][1] = fmaf(x, m.y, acc[i][1]);
            acc[i][2] = fmaf(x, m.z, acc[i][2]);
            acc[i][3] = fmaf(x, m.w, acc[i][3]);
          }
        }
        if (group == 0) {  // |f s|^2 once per pixel, by the first class group
          const float4 sv = *reinterpret_cast<const float4*>(sscale + f0 + kk);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float v[4] = {fv[i].x * sv.x, fv[i].y * sv.y, fv[i].z * sv.z, fv[i].w * sv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) f2[i] = fmaf(v[u], v[u], f2[i]);
          }
        }
      }
      continue;
    }

    // epilogue of the tile; `st` holds the prior tile
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) scross[(lane + 32 * i) * kCross + 4 * group + j] = acc[i][j];
      if (group == 0) sf2[lane + 32 * i] = f2[i];
    }
    __syncthreads();
    const int p0 = (blockIdx.x + (it / per_tile) * gridDim.x) * kTile;
    const int np = P - p0 < kTile ? P - p0 : kTile;
    for (int p = tid; p < np; p += kThreads) {  // a thread per pixel, all in registers
      const float* cross = scross + p * kCross;
      float* pr = st + p * cs;
      const float ff = sf2[p];
      float d[CP];
      float dmin = INFINITY;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) {
          d[c] = sqrtf(fmaxf(ff - 2.0f * cross[c] + snorm[c], 0.0f));
          dmin = fminf(dmin, d[c]);
        }
      }
      float se = 0.0f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) {
          d[c] = expf((dmin - d[c]) * rtau);
          se += d[c];
        }
      }
      const float rse = 1.0f / se;
      float pmax = 0.0f, sf = 0.0f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) {
          const float prop = d[c] * rse;
          pmax = fmaxf(pmax, prop);
          d[c] = prop * pr[c];
          sf += d[c];
        }
      }
      const float rsf = 1.0f / sf;
      float best = -INFINITY;
      int idx = 0;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) {
          const float fused = d[c] * rsf;
          pr[c] = fused;
          if (fused > best) {  // strict: the lowest index wins a tie
            best = fused;
            idx = c;
          }
        }
      }
      hard[p0 + p] = best < thresh ? 255 : idx;
      prop_max[p0 + p] = pmax;
    }
    __syncthreads();
    float* out = soft + (size_t)p0 * C;
    for (int i = tid; i < np * C; i += kThreads) {
      const int r = i / C;
      out[i] = st[r * cs + (i - r * C)];
    }
  }
  cp_async_wait<0>();
}

// A persistent grid: as many blocks as the card holds at once, at most one per tile.
template <int CP>
int launch(const void* feat, const void* protos, const void* prior, const void* tau,
           const void* inv_std, float thresh, int P, int F, int C, void* soft, void* hard,
           void* prop_max, cudaStream_t stream) {
  constexpr int kThreads = 32 * (CP / 4);
  const long long smem = smem_bytes(F, C);
  int dev = 0, smem_max = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;  // F too large for the ring
  err = cudaFuncSetAttribute(pseudo_labels_kernel<CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pseudo_labels_kernel<CP>,
                                                        kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (P + kTile - 1) / kTile;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  pseudo_labels_kernel<CP><<<grid, kThreads, (size_t)smem, stream>>>(
      (const float*)feat, (const float*)protos, (const float*)prior, (const float*)tau,
      (const float*)inv_std, thresh, P, F, C, (float*)soft, (int*)hard, (float*)prop_max);
  return (int)cudaGetLastError();
}

}  // namespace

// feat must be 16-byte aligned (its rows move by 16-byte copies) and F a
// multiple of 4; the other inputs move by 4-byte copies. Returns a CUDA error
// code: cudaErrorInvalidValue also where a block's shared memory for this F
// and C exceeds what the card allows.
extern "C" int onda_pseudo_labels(const void* feat, const void* protos, const void* prior,
                                  const void* tau, const void* inv_std, float thresh, int P,
                                  int F, int C, void* soft, void* hard, void* prop_max,
                                  void* stream) {
  if (C < 1 || C > kMaxC || F < 4 || F % 4 != 0 || P < 1 || (size_t)feat % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_classes(C)) {
#define ONDA_K1_CASE(CP) \
  case CP:               \
    return launch<CP>(feat, protos, prior, tau, inv_std, thresh, P, F, C, soft, hard, prop_max, s);
    ONDA_K1_CASE(4)
    ONDA_K1_CASE(8)
    ONDA_K1_CASE(12)
    ONDA_K1_CASE(16)
    ONDA_K1_CASE(20)
    ONDA_K1_CASE(24)
    ONDA_K1_CASE(28)
    ONDA_K1_CASE(32)
#undef ONDA_K1_CASE
  }
  return (int)cudaErrorInvalidValue;
}
