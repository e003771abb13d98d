// alt_corr: the windowed lookup of the correlation slab fmap1 . fmap2^T,
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
// network. On Hopper no slab is needed at all: only the 2r+2 slab entries a
// window reads are ever used, and each is one dot product of two feature
// rows.
//
// * forward: one launch for 1 to 4 pyramid levels (level i looks up
//   center / 2**i), the staged-span tap split of span_fwd.cuh (shared with
//   fused_corr): fmap1's tile is staged once for all the levels, each
//   level's span of fmap2 rows a 128-byte slice of D at a time, and lane
//   (pixel, tap) sums one slab entry. Its order of summation
//   (alt_corr_order below) is one plain PyTorch can repeat exactly:
//   products rounded, element d into partial sum (d / V) mod 4 (V elements
//   a 16-byte chunk) in ascending d, then (s0 + s1) + (s2 + s3), scaled
//   once; so the kernel is bitwise equal to alt_corr_plain, and the
//   pyramid launch to its one-level launches.
//   Why: the first forward built 64x64 slab tiles with fp32 FMAs
//   (bf16 widened: no tensor cores), one launch a level, multiplying every
//   (pixel, span column) pair: 0.36 / 0.21 / 0.21 / 0.21 ms at the four
//   train levels (bf16) against fused_corr's 0.32 ms for all four in one
//   launch; this design takes 0.34 ms for the four (scripts/
//   time_corr_kernels.py, NVIDIA H100 80GB HBM3, 700 W).
//   Bound: bytes, as fused_corr's: fmap1 and the fmap2 rows some tap
//   touches read once, the center read and the output written once.
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
//   bound is in PERF.md. Shared memory is under 48 KB a block (no opt-in).
//
// Numerics. floor(c) is clamped in float before the int cast, as
// windowed_sample and fused_corr do, so centers far outside the row (+-1e9)
// touch no tap and give exact zeros; a NaN center takes base 0 - r and its
// NaN f poisons the output and dg (and, through the band, df1's row and the
// df2 rows of its taps, as a dense product does). The tap scale and the
// blend are explicitly rounded multiplies and adds, as the plain PyTorch
// version computes them. Offsets are 64-bit.

#include "span_fwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------- forward

// The forward's order of summation: no rotation (chunks in order), each
// product rounded and added, rounded, to partial sum q mod 4, elements in
// order. Separate multiplies and adds (never contracted into an FMA), so a
// plain PyTorch version gives the same bits.
struct alt_corr_order {
  static __device__ __forceinline__ int rotation(int) { return 0; }
  template <typename T>
  static __device__ __forceinline__ void add(float* acc, int q, uint4 a, uint4 b) {
    constexpr int V = V16<T>::n;
    float xa[V], xb[V];
    unpack16(a, xa, (T*)nullptr);
    unpack16(b, xb, (T*)nullptr);
    float s = acc[q & 3];
#pragma unroll
    for (int e = 0; e < V; ++e) s = __fadd_rn(s, __fmul_rn(xa[e], xb[e]));
    acc[q & 3] = s;
  }
};

// ------------------------------------------------------------ backward

// The backward multiplies the band only where it is not zero: dvol's row p
// has at most 2r+2 nonzeros, dg_j(p) at w2 = base(p) + j.
constexpr int kWarps = kThreads / 32;
constexpr int kBandTile = 32;     // pixels (df1) or W2 columns (df2) a block
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
// contiguous; n_levels in [1, 4] fmap2 levels, f2[i] (b_h, w2[i], d)
// contiguous; center (b_h, w1) fp32 (level i looks up center / 2**i); out
// (b_h, w1, n_levels * (2r+1)) fp32, level i's taps at [i (2r+1), (i+1)
// (2r+1)). Each entry point returns the cudaError_t of its launches (0 on
// success); the caller raises on anything else. They launch on `stream` and
// do not synchronise.
extern "C" int alt_corr_fwd(const void* f1, const void* const* f2, const int* w2, int n_levels,
                            const void* center, void* out, long long b_h, int w1, int d,
                            int radius, int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  pyr.n = n_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    pyr.f2[i] = i < n_levels ? f2[i] : nullptr;
    pyr.w2[i] = i < n_levels ? w2[i] : 0;
    if (i < n_levels && w2[i] < 0) return (int)cudaErrorInvalidValue;
  }
  const float* c = static_cast<const float*>(center);
  float* o = static_cast<float*>(out);
  if (dtype_code == 0) {
#define CALL_F32(R)                                                                     \
  launch_span_fwd_tap<float, R, alt_corr_order>(static_cast<const float*>(f1), pyr, c, o, \
                                                b_h, w1, d, s)
    RADIUS_DISPATCH(radius, CALL_F32)
#undef CALL_F32
  }
  if (dtype_code == 1) {
#define CALL_BF16(R)                                                                  \
  launch_span_fwd_tap<__nv_bfloat16, R, alt_corr_order>(                              \
      static_cast<const __nv_bfloat16*>(f1), pyr, c, o, b_h, w1, d, s)
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
