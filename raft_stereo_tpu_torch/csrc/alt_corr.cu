// alt_corr: the windowed lookup of a correlation slab computed on-chip,
// forward and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/corr_kernels.py::
// alt_windowed_corr_pallas (its forward _alt_fwd_kernel and its backward
// _alt_bwd_kernel). For every pixel p = (b, h, w1) of fmap1 (B, H, W1, D)
// with window center c = center[p], against the row fmap2[b, h] (W2, D):
//
//   s = 1/sqrt(D),  vol[w1, w2] = s * <fmap1[b, h, w1], fmap2[b, h, w2]>
//   base = floor(c) - r,  f = c - floor(c)
//   g_j = vol[w1, base + j]   for j in [0, 2r+1], 0 outside [0, W2)
//   out[p, k] = (1 - f) * g_k + f * g_{k+1}      for k in [0, 2r]
//
// Backward, for the output cotangent ct (B, H, W1, 2r+1):
//
//   dg_j = s * ((1 - f) * ct_j + f * ct_{j-1})   (ct_{-1} = ct_{2r+1} = 0)
//   dvol[w1, w2] = dg_{w2 - base(w1)} where 0 <= w2 - base(w1) <= 2r+1, else 0
//   df1 = dvol . fmap2[b, h]     df2 = dvol^T . fmap1[b, h]
//
// with no gradient for the center (the model detaches the coordinates every
// iteration). Features (and df1, df2) are fp32 or bf16; every product is
// accumulated in fp32 and df1/df2 are rounded once to the feature dtype, as
// the JAX backward does.
//
// Design. The TPU kernel builds each row block's whole (W1, W2) slab on the
// MXU in VMEM and moves the window into place with a barrel-shifter rotate
// network. Here the slab is cut into 64x64 tiles that live in shared memory
// and registers only: no (W1, W2) buffer exists in device memory at any
// shape, and no shape needs another branch (W2 <= 2r+2 included).
//
// * forward: one block per (b, h, tile of 64 W1 pixels). The block finds the
//   W2 span its pixels' windows cover, [min base, max base + 2r+2) clipped
//   to [0, W2), and walks it in 64-wide chunks (a chunk no window touches is
//   skipped). Each chunk's 64x64 slab tile is a product over D in 32-wide
//   slices staged in shared memory, 4x4 outputs a thread in fp32 FMAs (bf16
//   features are widened on the load: no tensor cores yet). Each pixel then
//   picks the taps that fall in the chunk; each tap is one finished dot
//   product, scaled once, so taps never accumulate across chunks.
// * backward: the same tiles with the roles of the operands swapped. df1:
//   one block per (b, h, 64 W1 pixels, 64 channels) walks the W2 span in
//   32-wide chunks, builds that chunk of its pixels' banded dvol rows in
//   shared memory from dg, and multiplies it with the fmap2 chunk. df2: one
//   block per (b, h, 64 W2 columns, 64 channels) walks W1 in 32-pixel
//   chunks (skipping chunks whose windows miss its columns), builds the
//   transposed band and multiplies it with the fmap1 chunk. Every output
//   element is owned by one thread and summed in ascending chunk and index
//   order: no float atomics, two runs are bitwise equal.
//
// Bound. The function is B2's (fused_corr): bytes, fmap1 and the fmap2 rows
// the windows touch read once. The slab's product is what this formulation
// adds: 2*D flops per (pixel, span column) against fused_corr's 2*D per
// tap, in fp32 FMAs at 67 TFLOP/s. Shared memory is static, under 40 KB a
// block at every shape.
//
// Numerics. floor(c) is clamped in float before the int cast, as
// windowed_sample and fused_corr do, so centers far outside the row (+-1e9)
// touch no tap and give exact zeros; a NaN center takes base 0 - r and its
// NaN f poisons the output and dg (and, through the band, df1's row and the
// df2 rows of its taps, as a dense product does). The tap scale and the
// blend are explicitly rounded multiplies and adds, as the plain PyTorch
// version computes them. Offsets are 64-bit.

#include <limits.h>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // output tile edge; 16x16 threads, 4x4 each
constexpr int kSlice = 32;  // reduction slice staged in shared memory

// The 4x4 register tile of thread (ty, tx): rows ty + 16 i, columns
// tx + 16 j, so a warp reads 2 rows (broadcast) and 16 consecutive columns
// of the staged operands (distinct banks with the +1 padding).
struct Acc {
  float v[4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.0f;
  }
};

// ------------------------------------------------------------- forward

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                        const float* __restrict__ center, float* __restrict__ out, int w1,
                        int w2, int d, int n_tiles, float scale) {
  constexpr int K = 2 * R + 1;
  __shared__ float a_s[kTile][kSlice + 1];  // fmap1 tile, one D slice
  __shared__ float b_s[kTile][kSlice + 1];  // fmap2 chunk, one D slice
  __shared__ float c_s[kTile][kTile + 1];   // the chunk's slab tile
  __shared__ float tap_s[kTile][K + 1];
  __shared__ int base_s[kTile];
  __shared__ float frac_s[kTile];
  __shared__ int span_s[2];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t row = blockIdx.x / n_tiles;
  const int w0 = (int)(blockIdx.x % n_tiles) * kTile;
  const int n_pix = min(kTile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const T* f1_row = f1 + p0 * d;
  const T* f2_row = f2 + row * (int64_t)w2 * d;

  if (tid == 0) {
    span_s[0] = INT_MAX;
    span_s[1] = INT_MIN;
  }
  for (int i = tid; i < kTile * (K + 1); i += kThreads) tap_s[i / (K + 1)][i % (K + 1)] = 0.0f;
  __syncthreads();
  int lo = 0, hi = 0;  // this pixel's in-range taps [lo, hi)
  if (tid < n_pix) {
    float frac;
    const int b = window_base(center[p0 + tid], w2, R, &frac);
    base_s[tid] = b;
    frac_s[tid] = frac;
    lo = max(b, 0);
    hi = min(b + K + 1, w2);
    if (lo < hi) {  // integer atomics: the same span in any order
      atomicMin(&span_s[0], lo);
      atomicMax(&span_s[1], hi);
    }
  }
  __syncthreads();
  const int span_lo = span_s[0], span_hi = span_s[1];

  for (int c0 = span_lo; c0 < span_hi; c0 += kTile) {
    if (!__syncthreads_or(lo < hi && lo < c0 + kTile && hi > c0)) continue;
    Acc acc;
    acc.zero();
    for (int d0 = 0; d0 < d; d0 += kSlice) {
      for (int e = tid; e < kTile * kSlice; e += kThreads) {
        const int m = e / kSlice, kk = e % kSlice;
        const bool in_d = d0 + kk < d;
        a_s[m][kk] = (m < n_pix && in_d) ? load_as_float(f1_row + (int64_t)m * d + d0 + kk)
                                         : 0.0f;
        b_s[m][kk] = (c0 + m < w2 && in_d)
                         ? load_as_float(f2_row + (int64_t)(c0 + m) * d + d0 + kk)
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = b_s[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c_s[ty + 16 * i][tx + 16 * j] = acc.v[i][j];
    __syncthreads();
    for (int e = tid; e < n_pix * (K + 1); e += kThreads) {
      const int m = e / (K + 1), j = e % (K + 1);
      const int x = base_s[m] + j;
      if (x >= c0 && x < c0 + kTile && x >= 0 && x < w2)
        tap_s[m][j] = __fmul_rn(c_s[m][x - c0], scale);
    }
    __syncthreads();
  }

  for (int e = tid; e < n_pix * K; e += kThreads) {
    const int m = e / K, k = e % K;
    const float f = frac_s[m];
    out[(p0 + m) * K + k] =
        __fadd_rn(__fmul_rn(1.0f - f, tap_s[m][k]), __fmul_rn(f, tap_s[m][k + 1]));
  }
}

// ------------------------------------------------------------ backward

// df1[p, n] = sum over w2 of dvol[p, w2] * fmap2[w2, n]: one block per
// (row, 64 pixels, 64 channels).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_bwd_df1_kernel(const T* __restrict__ f2, const float* __restrict__ center,
                            const float* __restrict__ ct, T* __restrict__ df1, int w1, int w2,
                            int d, int n_wtiles, int n_dtiles, float scale) {
  constexpr int K = 2 * R + 1;
  __shared__ float s_s[kTile][kSlice + 1];  // dvol band: pixels x W2 chunk
  __shared__ float f_s[kSlice][kTile + 1];  // fmap2 chunk: W2 chunk x channels
  __shared__ float dg_s[kTile][K + 1];
  __shared__ int base_s[kTile];
  __shared__ int span_s[2];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int w0 = wt * kTile, d0 = dt * kTile;
  const int n_pix = min(kTile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const T* f2_row = f2 + row * (int64_t)w2 * d;

  if (tid == 0) {
    span_s[0] = INT_MAX;
    span_s[1] = INT_MIN;
  }
  __syncthreads();
  int lo = 0, hi = 0;
  if (tid < n_pix) {
    float frac;
    const int b = window_base(center[p0 + tid], w2, R, &frac);
    base_s[tid] = b;
    float dg[K + 1];
    tap_grads<K>(ct + (p0 + tid) * K, frac, scale, dg);
#pragma unroll
    for (int j = 0; j <= K; ++j) dg_s[tid][j] = dg[j];
    lo = max(b, 0);
    hi = min(b + K + 1, w2);
    if (lo < hi) {
      atomicMin(&span_s[0], lo);
      atomicMax(&span_s[1], hi);
    }
  }
  __syncthreads();
  const int span_lo = span_s[0], span_hi = span_s[1];

  Acc acc;
  acc.zero();
  for (int c0 = span_lo; c0 < span_hi; c0 += kSlice) {
    if (!__syncthreads_or(lo < hi && lo < c0 + kSlice && hi > c0)) continue;
    for (int e = tid; e < kTile * kSlice; e += kThreads) {
      const int m = e / kSlice, kk = e % kSlice;
      const int x = c0 + kk;
      float v = 0.0f;
      if (m < n_pix && x < w2) {
        const int j = x - base_s[m];
        if (j >= 0 && j <= K) v = dg_s[m][j];
      }
      s_s[m][kk] = v;
      const int kr = e / kTile, n = e % kTile;  // the same e, as fmap2 chunk
      const int xr = c0 + kr;
      f_s[kr][n] = (xr < w2 && d0 + n < d) ? load_as_float(f2_row + (int64_t)xr * d + d0 + n)
                                           : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_s[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = f_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= n_pix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = d0 + tx + 16 * j;
      if (n < d) df1[(p0 + m) * d + n] = from_float(acc.v[i][j], (T*)nullptr);
    }
  }
}

// df2[w2, n] = sum over w1 of dvol[w1, w2] * fmap1[w1, n]: one block per
// (row, 64 W2 columns, 64 channels), walking W1 in 32-pixel chunks.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_bwd_df2_kernel(const T* __restrict__ f1, const float* __restrict__ center,
                            const float* __restrict__ ct, T* __restrict__ df2, int w1, int w2,
                            int d, int n_wtiles, int n_dtiles, float scale) {
  constexpr int K = 2 * R + 1;
  __shared__ float s_s[kTile][kSlice + 1];  // dvol band transposed: W2 tile x pixels
  __shared__ float f_s[kSlice][kTile + 1];  // fmap1 chunk: pixels x channels
  __shared__ float dg_s[kSlice][K + 1];
  __shared__ int base_s[kSlice];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int t0 = wt * kTile, d0 = dt * kTile;
  const int n_cols = min(kTile, w2 - t0);
  const int64_t p_row = row * w1;
  const T* f1_row = f1 + p_row * d;

  Acc acc;
  acc.zero();
  for (int k0 = 0; k0 < w1; k0 += kSlice) {
    bool hit = false;
    if (tid < kSlice && k0 + tid < w1) {
      const int64_t p = p_row + k0 + tid;
      float frac;
      const int b = window_base(center[p], w2, R, &frac);
      base_s[tid] = b;
      float dg[K + 1];
      tap_grads<K>(ct + p * K, frac, scale, dg);
#pragma unroll
      for (int j = 0; j <= K; ++j) dg_s[tid][j] = dg[j];
      const int lo = max(b, 0), hi = min(b + K + 1, w2);
      hit = lo < hi && lo < t0 + n_cols && hi > t0;
    }
    if (!__syncthreads_or(hit)) continue;
    for (int e = tid; e < kTile * kSlice; e += kThreads) {
      const int m = e / kSlice, kk = e % kSlice;
      float v = 0.0f;
      if (m < n_cols && k0 + kk < w1) {
        const int j = t0 + m - base_s[kk];
        if (j >= 0 && j <= K) v = dg_s[kk][j];
      }
      s_s[m][kk] = v;
      const int kr = e / kTile, n = e % kTile;
      f_s[kr][n] = (k0 + kr < w1 && d0 + n < d)
                       ? load_as_float(f1_row + (int64_t)(k0 + kr) * d + d0 + n)
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_s[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = f_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= n_cols) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = d0 + tx + 16 * j;
      if (n < d) df2[(row * w2 + t0 + m) * d + n] = from_float(acc.v[i][j], (T*)nullptr);
    }
  }
}

inline int tiles(int n, int t) { return (n + t - 1) / t; }

template <typename T, int R>
cudaError_t launch_fwd(const void* f1, const void* f2, const void* center, void* out,
                       int64_t b_h, int w1, int w2, int d, cudaStream_t stream) {
  const int n_tiles = tiles(w1, kTile);
  const int64_t blocks = b_h * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  alt_corr_fwd_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(center), static_cast<float*>(out), w1, w2, d, n_tiles,
      1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_bwd(const void* f1, const void* f2, const void* center, const void* ct,
                       void* df1, void* df2, int64_t b_h, int w1, int w2, int d,
                       cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)d);
  const float* c = static_cast<const float*>(center);
  const float* g = static_cast<const float*>(ct);
  const int n_dtiles = tiles(d, kTile);
  if (df1 != nullptr) {
    const int n_wtiles = tiles(w1, kTile);
    const int64_t blocks = b_h * n_wtiles * n_dtiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    alt_corr_bwd_df1_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(f2), c, g, static_cast<T*>(df1), w1, w2, d, n_wtiles,
        n_dtiles, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (df2 == nullptr) return cudaSuccess;
  const int n_wtiles = tiles(w2, kTile);
  const int64_t blocks = b_h * n_wtiles * n_dtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  alt_corr_bwd_df2_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), c, g, static_cast<T*>(df2), w1, w2, d, n_wtiles, n_dtiles,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 features, 1 = bfloat16 features. fmap1 (b_h, w1, d)
// and fmap2 (b_h, w2, d) contiguous, center (b_h, w1) fp32, out (b_h, w1,
// 2r+1) fp32. Each entry point returns the cudaError_t of its launches (0 on
// success); the caller raises on anything else. They launch on `stream` and
// do not synchronise.
extern "C" int alt_corr_fwd(const void* f1, const void* f2, const void* center, void* out,
                            long long b_h, int w1, int w2, int d, int radius, int dtype_code,
                            void* stream) {
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
extern "C" int alt_corr_bwd(const void* f1, const void* f2, const void* center,
                            const void* ct, void* df1, void* df2, long long b_h, int w1, int w2,
                            int d, int radius, int dtype_code, void* stream) {
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

extern "C" const char* alt_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
