// fused_corr: the memoryless correlation lookup, forward and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/corr_kernels.py::
// fused_windowed_corr_pallas (its forward _fused_fwd_kernel and its backward
// _fused_bwd_kernel). For every pixel p = (b, h, w1) of fmap1 (B, H, W1, D)
// with window center c = center[p], against the row fmap2[b, h] (W2, D):
//
//   s = 1/sqrt(D),  base = floor(c) - r,  f = c - floor(c)
//   g_j = s * <fmap1[p], fmap2[b, h, base + j]>   for j in [0, 2r+1],
//         0 where base + j lies outside [0, W2)
//   out[p, k] = (1 - f) * g_k + f * g_{k+1}      for k in [0, 2r]
//
// Backward, for the output cotangent ct (B, H, W1, 2r+1):
//
//   dg_j = s * ((1 - f) * ct_j + f * ct_{j-1})   (ct_{-1} = ct_{2r+1} = 0)
//   df1[p]         = sum_j dg_j * fmap2[b, h, base + j]   (in-range taps)
//   df2[b, h, w2]  = sum over (w1, j) with base(w1) + j = w2 of
//                    dg_j(w1) * fmap1[b, h, w1]
//
// with no gradient for the center (the model detaches the coordinates every
// iteration). Features (and df1, df2) are fp32 or bf16; every dot product
// and sum is accumulated in fp32 and df1/df2 are rounded once to the
// feature dtype, as the JAX backward does.
//
// Design. The TPU kernel builds a (rows, W1, Wb) product sub-slab per W2
// block on the MXU and moves the window into place with a barrel-shifter
// rotate network, because a TPU has no cheap gather. Hopper reads
// fmap2[base + j] by index, so no product slab exists at all:
//
// * forward: one warp per output pixel. The lanes split D, each keeps fp32
//   partial dots for its 2r+2 taps (skipping taps outside the row, which are
//   never read), a butterfly of shuffles sums them, and lane k blends output
//   k. Bound: bytes. Per pixel it reads one fmap1 row and the 2r+2 fmap2
//   rows of its window, which neighbouring pixels share (they hit L1/L2), so
//   the least traffic is fmap1 and fmap2 once each: about 226 us at the
//   1/4-resolution level of a 2016x2880 fp32 pair, against 28 us of fp32
//   arithmetic.
// * backward, df1: the same pixel-parallel gather, dg in fp32.
// * backward, df2: a many-to-one scatter, made deterministic without float
//   atomics. One block owns one (b, h) row: it stages the row's window
//   bases and dg in shared memory, counts the contributions that land on
//   each w2, turns the counts into list offsets by a prefix sum, and lists
//   each w2's contributions in ascending w1 order (a pixel's rank in a list
//   is the number of lower pixels whose window covers the same w2). Then
//   each thread owns one feature channel and walks the lists in order, so
//   every df2 element is one fixed-order fp32 sum, written once, zeros
//   included: two runs are bitwise equal. Shared memory is
//   4 * (W1 * (2 * (2r+2) + 1) + W2 + 1) bytes (63 KB at W1 = W2 = 720,
//   r = 4); a row whose lists do not fit the block's 227 KB is refused.
//
// Numerics. floor(c) is clamped in float before the int cast, as
// windowed_sample does, so centers far outside the row (+-1e9) touch no tap
// and give exact zeros; a NaN center takes base 0 - r and its NaN f poisons
// the output and dg. Offsets are 64-bit: B*H*W*D passes 2^31 at
// full-resolution widths.

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int R>
__global__ void fused_corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                                      const float* __restrict__ center,
                                      float* __restrict__ out, int64_t n_pix, int w1,
                                      int w2, int d, float scale) {
  constexpr int K = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= n_pix) return;  // uniform across the warp
  float frac;
  const int base = window_base(center[p], w2, R, &frac);
  const T* a = f1 + p * d;
  const T* row = f2 + (p / w1) * (int64_t)w2 * d;
  float acc[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) acc[j] = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float x = load_as_float(a + c);
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      const int i = base + j;
      if (i >= 0 && i < w2) acc[j] = fmaf(x, load_as_float(row + (int64_t)i * d + c), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j <= K; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (lane < K) {
    float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j == lane) {
        g0 = acc[j];
        g1 = acc[j + 1];
      }
    }
    g0 = __fmul_rn(g0, scale);
    g1 = __fmul_rn(g1, scale);
    out[p * K + lane] = __fadd_rn(__fmul_rn(1.0f - frac, g0), __fmul_rn(frac, g1));
  }
}

template <typename T, int R>
__global__ void fused_corr_bwd_df1_kernel(const T* __restrict__ f2,
                                          const float* __restrict__ center,
                                          const float* __restrict__ ct, T* __restrict__ df1,
                                          int64_t n_pix, int w1, int w2, int d,
                                          float scale) {
  constexpr int K = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= n_pix) return;
  float frac;
  const int base = window_base(center[p], w2, R, &frac);
  float dg[K + 1];
  tap_grads<K>(ct + p * K, frac, scale, dg);
  const T* row = f2 + (p / w1) * (int64_t)w2 * d;
  T* out = df1 + p * d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      const int i = base + j;
      if (i >= 0 && i < w2) acc = fmaf(dg[j], load_as_float(row + (int64_t)i * d + c), acc);
    }
    out[c] = from_float(acc, (T*)nullptr);
  }
}

// Shared memory bytes of one df2 block: 4-byte bases (w1), dg and list
// entries (w1 * (K+1) each), list offsets (w2 + 1).
inline int64_t df2_smem_bytes(int w1, int w2, int radius) {
  const int64_t taps = 2 * radius + 2;
  return 4 * ((int64_t)w1 * (2 * taps + 1) + w2 + 1);
}

template <typename T, int R>
__global__ void fused_corr_bwd_df2_kernel(const T* __restrict__ f1,
                                          const float* __restrict__ center,
                                          const float* __restrict__ ct, T* __restrict__ df2,
                                          int w1, int w2, int d, float scale) {
  constexpr int K = 2 * R + 1;
  extern __shared__ int smem[];
  int* base_s = smem;                                         // [w1]
  float* dg_s = reinterpret_cast<float*>(base_s + w1);        // [w1 * (K+1)]
  int* list_s = reinterpret_cast<int*>(dg_s + w1 * (K + 1));  // [w1 * (K+1)]
  int* start_s = list_s + w1 * (K + 1);                       // [w2 + 1]

  const int64_t row = blockIdx.x;
  const int64_t p0 = row * w1;
  const int tid = threadIdx.x;

  for (int i = tid; i <= w2; i += blockDim.x) start_s[i] = 0;
  __syncthreads();

  // bases, dg, and per-w2 counts (at i + 1, for the prefix sum below;
  // integer atomics give the same count in any order)
  for (int w = tid; w < w1; w += blockDim.x) {
    float frac;
    const int b = window_base(center[p0 + w], w2, R, &frac);
    base_s[w] = b;
    float dg[K + 1];
    tap_grads<K>(ct + (p0 + w) * K, frac, scale, dg);
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      dg_s[w * (K + 1) + j] = dg[j];
      const int i = b + j;
      if (i >= 0 && i < w2) atomicAdd(&start_s[i + 1], 1);
    }
  }
  __syncthreads();

  // inclusive prefix sum over start_s[0..w2] by the first warp
  if (tid < 32) {
    int carry = 0;
    for (int c0 = 0; c0 <= w2; c0 += 32) {
      const int i = c0 + tid;
      int v = i <= w2 ? start_s[i] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (i <= w2) start_s[i] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();

  // each w2's list in ascending w1 order: pixel w's rank in the list of
  // w2 = base(w) + j counts the lower pixels whose window covers that w2
  for (int w = tid; w < w1; w += blockDim.x) {
    const int b = base_s[w];
    int rank[K + 1];
#pragma unroll
    for (int j = 0; j <= K; ++j) rank[j] = 0;
    for (int v = 0; v < w; ++v) {
      const int dd = base_s[v] - b;  // v covers b + j for j in [dd, dd + K]
      if (dd >= -K && dd <= K) {
#pragma unroll
        for (int j = 0; j <= K; ++j) rank[j] += (j >= dd && j <= dd + K) ? 1 : 0;
      }
    }
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      const int i = b + j;
      if (i >= 0 && i < w2) list_s[start_s[i] + rank[j]] = w * (K + 1) + j;
    }
  }
  __syncthreads();

  // one thread per feature channel walks every list in order
  for (int c = tid; c < d; c += blockDim.x) {
    for (int i = 0; i < w2; ++i) {
      float acc = 0.0f;
      const int end = start_s[i + 1];
      for (int e = start_s[i]; e < end; ++e) {
        const int ent = list_s[e];
        const int w = ent / (K + 1);
        acc = fmaf(dg_s[ent], load_as_float(f1 + (p0 + w) * d + c), acc);
      }
      df2[(row * w2 + i) * d + c] = from_float(acc, (T*)nullptr);
    }
  }
}

inline unsigned int blocks_for(int64_t threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

template <typename T, int R>
cudaError_t launch_fwd(const void* f1, const void* f2, const void* center, void* out,
                       int64_t b_h, int w1, int w2, int d, cudaStream_t stream) {
  const int64_t n_pix = b_h * w1;
  const float scale = 1.0f / sqrtf((float)d);
  fused_corr_fwd_kernel<T, R><<<blocks_for(n_pix * 32), kThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(center), static_cast<float*>(out), n_pix, w1, w2, d, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_bwd(const void* f1, const void* f2, const void* center, const void* ct,
                       void* df1, void* df2, int64_t b_h, int w1, int w2, int d,
                       cudaStream_t stream) {
  const int64_t n_pix = b_h * w1;
  const float scale = 1.0f / sqrtf((float)d);
  const float* c = static_cast<const float*>(center);
  const float* g = static_cast<const float*>(ct);
  if (df1 != nullptr) {
    fused_corr_bwd_df1_kernel<T, R><<<blocks_for(n_pix * 32), kThreads, 0, stream>>>(
        static_cast<const T*>(f2), c, g, static_cast<T*>(df1), n_pix, w1, w2, d, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (df2 == nullptr) return cudaSuccess;
  const int64_t smem = df2_smem_bytes(w1, w2, R);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > smem_max) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_corr_bwd_df2_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_corr_bwd_df2_kernel<T, R><<<(unsigned int)b_h, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(f1), c, g, static_cast<T*>(df2), w1, w2, d, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 features, 1 = bfloat16 features. fmap1 (b_h, w1, d)
// and fmap2 (b_h, w2, d) contiguous, center (b_h, w1) fp32, out (b_h, w1,
// 2r+1) fp32. Each entry point returns the cudaError_t of its launches (0 on
// success); the caller raises on anything else. They launch on `stream` and
// do not synchronise.
extern "C" int fused_corr_fwd(const void* f1, const void* f2, const void* center, void* out,
                              long long b_h, int w1, int w2, int d, int radius,
                              int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
#define CALL_F32(R) launch_fwd<float, R>(f1, f2, center, out, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_F32)
#undef CALL_F32
  }
  if (dtype_code == 1) {
#define CALL_BF16(R) launch_fwd<__nv_bfloat16, R>(f1, f2, center, out, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_BF16)
#undef CALL_BF16
  }
  return (int)cudaErrorInvalidValue;
}

// ct (b_h, w1, 2r+1) fp32 contiguous; df1 like fmap1 and df2 like fmap2, in
// the feature dtype, either NULL to skip it.
extern "C" int fused_corr_bwd(const void* f1, const void* f2, const void* center,
                              const void* ct, void* df1, void* df2, long long b_h, int w1,
                              int w2, int d, int radius, int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
#define CALL_F32(R) launch_bwd<float, R>(f1, f2, center, ct, df1, df2, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_F32)
#undef CALL_F32
  }
  if (dtype_code == 1) {
#define CALL_BF16(R) \
  launch_bwd<__nv_bfloat16, R>(f1, f2, center, ct, df1, df2, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_BF16)
#undef CALL_BF16
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
