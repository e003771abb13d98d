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
// * backward: route (b), the products over the band's nonzeros only. dvol's
//   row p holds at most 2r+2 nonzeros, dg_j(p) at w2 = base(p) + j, in a
//   span of ~100-250 columns at the train shape, so a dense band product
//   (64x64 tiles, fp32 FMAs, as this file first did) is ~12x the needed
//   products at level 0, and there every (W2 tile x D tile) block
//   recomputed every pixel's base and dg. Now one pass computes the band
//   once per launch (base and dg of every pixel, into scratch: 2r+3 words
//   a pixel).
//   df1: one block per (b, h, 32 pixels, 128 bytes of D) stages the fmap2
//   rows its windows span (16-byte loads, in chunks of kCapRows) and each
//   thread (pixel, 16 bytes of D) sums its 2r+2 taps in ascending w2. df2:
//   one block per (b, h, 32 W2 columns, 128 bytes of D) lists the pixels
//   whose in-range taps meet its columns, in ascending w1 (a ballot and a
//   prefix over the warps), stages their fmap1 rows, and each thread
//   (column, 16 bytes of D) sums the listed pixels whose window holds its
//   column. Many small independent blocks: a variant walking D inside the
//   block with cp.async double buffering (a quarter of the blocks) took
//   1.15 ms for the four train levels against 0.86 for this one, timed
//   alike (scripts/time_corr_kernels.py, NVIDIA H100 80GB HBM3, 700 W).
//   Both sums run in the dense product's order with its zeros dropped
//   (fmaf(0, x, a) = a), so on finite features df1/df2 are the values the
//   dense kernels gave and fused_corr's backward gives (up to the sign of
//   a zero). Every output is owned by one thread: no float
//   atomics, bitwise equal run to run. Route (a), the band on the tensor
//   cores (mma.sync with dvol split into hi + lo TF32 parts), was not built:
//   it still multiplies the band's zeros (~6-12x the products of (b) on
//   random disparities, 2-3x that again for the hi + lo split), while (b)
//   moves the same bytes with no wasted product; its time against the
//   bound is in PERF.md.
// Bound. The function is B2's (fused_corr): bytes, fmap1 and the fmap2 rows
// the windows touch read once. The slab's product is what this formulation
// adds: 2*D flops per (pixel, span column) against fused_corr's 2*D per
// tap, in fp32 FMAs at 67 TFLOP/s. Shared memory is under 48 KB a block at
// every shape (no opt-in).
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
constexpr unsigned kFull = 0xffffffffu;
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

// The backward multiplies the band only where it is not zero: dvol's row p
// has at most 2r+2 nonzeros, dg_j(p) at w2 = base(p) + j.
constexpr int kWarps = kThreads / 32;
constexpr int kBandTile = 32;     // pixels (df1) or W2 columns (df2) a block
constexpr int kSliceBytes = 128;  // a D slice: 8 chunks of 16 bytes
constexpr int kChunks = kSliceBytes / 16;
constexpr int kCapRows = 300;     // df1's staged fmap2 rows (37.5 KB)
constexpr int kListChunk = kThreads;  // W1 pixels a df2 block lists at a time
constexpr int kListStage = 64;    // listed fmap1 rows a df2 stage

// The band, once per launch: base(p) and dg_j(p) for j in [0, 2r+1] of every
// pixel, into scratch (b_h * w1 ints, then b_h * w1 * (2r+2) floats).
template <int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_bwd_band_kernel(const float* __restrict__ center, const float* __restrict__ ct,
                             int* __restrict__ base_g, float* __restrict__ dg_g,
                             int64_t n_pix, int w2, float scale) {
  constexpr int K = 2 * R + 1;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float frac;
  base_g[p] = window_base(center[p], w2, R, &frac);
  float dg[K + 1];
  tap_grads<K>(ct + p * K, frac, scale, dg);
#pragma unroll
  for (int j = 0; j <= K; ++j) dg_g[p * (K + 1) + j] = dg[j];
}

// df1[p, n] = sum over j of dg_j(p) * fmap2[base(p) + j, n], j ascending
// (w2 ascending, as the dense product's order with its zeros dropped): one
// block per (row, 32 pixels, 128 bytes of D). It stages the fmap2 rows its
// windows span (in chunks of kCapRows); thread (pixel, 16-byte chunk) sums
// its 2r+2 rows from shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_bwd_df1_kernel(const T* __restrict__ f2, const int* __restrict__ base_g,
                            const float* __restrict__ dg_g, T* __restrict__ df1, int w1,
                            int w2, int d, int n_wtiles, int n_dtiles, int cap, bool vec) {
  constexpr int KT = 2 * R + 2;
  constexpr int V = V16<T>::n;
  extern __shared__ __align__(16) unsigned char f2_s[];  // [cap][kSliceBytes]
  __shared__ float dg_s[kBandTile][KT];
  __shared__ int base_s[kBandTile];
  __shared__ int span_s[2];

  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int w0 = wt * kBandTile, d0 = dt * (kSliceBytes / (int)sizeof(T));
  const int n_pix = min(kBandTile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const T* f2_row = f2 + row * (int64_t)w2 * d;

  if (tid == 0) {
    span_s[0] = INT_MAX;
    span_s[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < n_pix) {
    const int b = base_g[p0 + tid];
    base_s[tid] = b;
#pragma unroll
    for (int j = 0; j < KT; ++j) dg_s[tid][j] = dg_g[(p0 + tid) * KT + j];
    const int lo = max(b, 0), hi = min(b + KT, w2);
    if (lo < hi) {  // integer atomics: the same span in any order
      atomicMin(&span_s[0], lo);
      atomicMax(&span_s[1], hi);
    }
  }
  __syncthreads();
  const int span_lo = span_s[0], span_hi = span_s[1];
  const int m = tid >> 3, q = tid & 7;
  const bool on = m < n_pix;
  const int b = on ? base_s[m] : 0;
  const int lo = on ? max(b, 0) : 0, hi = on ? min(b + KT, w2) : 0;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int c0 = span_lo; c0 < span_hi; c0 += cap) {
    const int n = min(cap, span_hi - c0);
    if (!__syncthreads_or(lo < hi && lo < c0 + n && hi > c0)) continue;
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i >> 3, qq = i & 7;
      *reinterpret_cast<uint4*>(f2_s + r * kSliceBytes + qq * 16) =
          load16(f2_row + (int64_t)(c0 + r) * d, d0 + qq * V, d, vec);
    }
    __syncthreads();
    if (on) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int x = b + j;
        if (x < c0 || x >= c0 + n) continue;
        float y[V];
        unpack16(*reinterpret_cast<const uint4*>(f2_s + (x - c0) * kSliceBytes + q * 16), y,
                 (T*)nullptr);
        const float g = dg_s[m][j];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(g, y[e], acc[e]);
      }
    }
    __syncthreads();
  }
  if (on) store16(df1 + (p0 + m) * d, d0 + q * V, d, vec, acc);
}

// df2[w2, n] = sum over the pixels p whose window holds w2, ascending p, of
// dg_{w2 - base(p)}(p) * fmap1[p, n]: one block per (row, 32 W2 columns,
// 128 bytes of D). It lists, in order, the pixels whose in-range taps meet
// its columns (a ballot and a prefix over the warps, kListChunk pixels at
// a time), stages their fmap1 rows, and thread (column, 16-byte chunk)
// sums the listed pixels whose window holds its column.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    alt_corr_bwd_df2_kernel(const T* __restrict__ f1, const int* __restrict__ base_g,
                            const float* __restrict__ dg_g, T* __restrict__ df2, int w1,
                            int w2, int d, int n_wtiles, int n_dtiles, bool vec) {
  constexpr int KT = 2 * R + 2;
  constexpr int V = V16<T>::n;
  __shared__ __align__(16) unsigned char f1_s[kListStage * kSliceBytes];
  __shared__ float dg_l[kListStage][KT];
  __shared__ int list_s[kListChunk];
  __shared__ int lbase_s[kListChunk];
  __shared__ int count_s[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int t0 = wt * kBandTile, d0 = dt * (kSliceBytes / (int)sizeof(T));
  const int n_cols = min(kBandTile, w2 - t0);
  const int64_t p_row = row * w1;
  const int c = tid >> 3, q = tid & 7;
  const int col = t0 + c;
  const bool on = c < n_cols;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < w1; k0 += kListChunk) {
    const int w = k0 + tid;
    bool hit = false;
    int b = 0;
    if (w < w1) {
      b = base_g[p_row + w];
      const int lo = max(b, 0), hi = min(b + KT, w2);
      hit = lo < hi && lo < t0 + n_cols && hi > t0;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) count_s[warp] = __popc(mask);
    __syncthreads();
    int offs = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int cnt = count_s[i];
      offs += i < warp ? cnt : 0;
      total += cnt;
    }
    if (hit) {
      const int pos = offs + __popc(mask & ((1u << lane) - 1u));
      list_s[pos] = w;
      lbase_s[pos] = b;
    }
    __syncthreads();
    for (int e0 = 0; e0 < total; e0 += kListStage) {
      const int ne = min(kListStage, total - e0);
      for (int i = tid; i < ne * kChunks; i += kThreads) {
        const int r = i >> 3, qq = i & 7;
        *reinterpret_cast<uint4*>(f1_s + r * kSliceBytes + qq * 16) =
            load16(f1 + (p_row + list_s[e0 + r]) * d, d0 + qq * V, d, vec);
      }
      for (int i = tid; i < ne * KT; i += kThreads) {
        const int r = i / KT, j = i % KT;
        dg_l[r][j] = dg_g[(p_row + list_s[e0 + r]) * KT + j];
      }
      __syncthreads();
      if (on) {
        for (int r = 0; r < ne; ++r) {
          const int j = col - lbase_s[e0 + r];
          if ((unsigned)j >= (unsigned)KT) continue;
          float y[V];
          unpack16(*reinterpret_cast<const uint4*>(f1_s + r * kSliceBytes + q * 16), y,
                   (T*)nullptr);
          const float g = dg_l[r][j];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(g, y[e], acc[e]);
        }
      }
      __syncthreads();
    }
  }
  if (on) store16(df2 + (row * w2 + col) * d, d0 + q * V, d, vec, acc);
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
                       void* df1, void* df2, void* scratch, int64_t b_h, int w1, int w2, int d,
                       cudaStream_t stream) {
  const int64_t n_pix = b_h * w1;
  int* base_g = static_cast<int*>(scratch);
  float* dg_g = reinterpret_cast<float*>(base_g + n_pix);
  const int64_t band_blocks = (n_pix + kThreads - 1) / kThreads;
  if (band_blocks > INT_MAX) return cudaErrorInvalidValue;
  alt_corr_bwd_band_kernel<R><<<(unsigned int)band_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(center), static_cast<const float*>(ct), base_g, dg_g, n_pix,
      w2, 1.0f / sqrtf((float)d));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = d % V16<T>::n == 0 && aligned16(f1) && aligned16(f2) &&
                   (df1 == nullptr || aligned16(df1)) && (df2 == nullptr || aligned16(df2));
  const int n_dtiles = tiles(d, kSliceBytes / (int)sizeof(T));
  if (df1 != nullptr) {
    const int n_wtiles = tiles(w1, kBandTile);
    const int64_t blocks = b_h * n_wtiles * n_dtiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const int cap = w2 < kCapRows ? w2 : kCapRows;
    alt_corr_bwd_df1_kernel<T, R>
        <<<(unsigned int)blocks, kThreads, (size_t)cap * kSliceBytes, stream>>>(
            static_cast<const T*>(f2), base_g, dg_g, static_cast<T*>(df1), w1, w2, d,
            n_wtiles, n_dtiles, cap, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (df2 == nullptr) return cudaSuccess;
  const int n_wtiles = tiles(w2, kBandTile);
  const int64_t blocks = b_h * n_wtiles * n_dtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  alt_corr_bwd_df2_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), base_g, dg_g, static_cast<T*>(df2), w1, w2, d, n_wtiles,
      n_dtiles, vec);
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
// the feature dtype, either NULL to skip it; scratch holds b_h * w1 * (2r+3)
// 4-byte words (the band: bases, then dg).
extern "C" int alt_corr_bwd(const void* f1, const void* f2, const void* center,
                            const void* ct, void* df1, void* df2, void* scratch, long long b_h,
                            int w1, int w2, int d, int radius, int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
#define CALL_F32(R) \
  launch_bwd<float, R>(f1, f2, center, ct, df1, df2, scratch, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_F32)
#undef CALL_F32
  }
  if (dtype_code == 1) {
#define CALL_BF16(R) \
  launch_bwd<__nv_bfloat16, R>(f1, f2, center, ct, df1, df2, scratch, b_h, w1, w2, d, s)
    RADIUS_DISPATCH(radius, CALL_BF16)
#undef CALL_BF16
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* alt_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
