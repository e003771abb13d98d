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
// * forward: one launch for 1 to 4 pyramid levels (level i looks up
//   center / 2**i, exact in fp32) writing each level's taps into its slot
//   of the concatenated (.., L (2r+1)) output. A block takes up to 128
//   consecutive pixels of one (b, h) row, finds the span of fmap2 rows each
//   level's windows cover, [min base, max base + 2r+2) clipped to [0, W2),
//   and stages fmap1 and those rows in shared memory 128 bytes of D at a
//   time (cp.async, two buffers: the next slice loads while this one is
//   summed). fmap1 is read once for all the levels. Two work splits, one
//   order of summation (so the same bits; the launcher picks by shape):
//   - the pixel split (several levels, D of 1 KB or more: the hires
//     pyramid): a stage holds one slice of the tile's fmap1 and of every
//     level's span; thread (s, p) sums 5 taps of pixel p at every level,
//     reading each 16 bytes of fmap1 once for 20 taps. Spans that outgrow
//     a stage are walked in passes.
//   - the tap split (one level, or bf16 at the train shape): fmap1's tile
//     stays whole in shared memory; level after level, lane (pixel, tap)
//     sums one tap, a pixel's taps 0-7 on one quarter-warp (8 consecutive
//     rows: no bank twice).
//   Order: each tap's dot is 4 fp32 partial sums, slice after slice; a
//   slice's 8 chunks of 16 bytes are visited from chunk (w1 mod 8) on, the
//   k-th into sum k mod 4 (the rotation puts the 8 consecutive pixels of a
//   quarter-warp on 8 bank groups whatever rows their windows hold); then
//   (s0 + s1) + (s2 + s3), scaled once, blended with the next tap.
//   Why: the first version of this kernel (one warp a pixel, lanes
//   splitting D, 5 shuffle rounds a tap) took 0.71 / 0.68 / 0.66 / 0.66 ms
//   at the four hires levels and 0.70 ms at level 0 on a field where every
//   pixel of a row looks up one window: neither DRAM nor L2 traffic set
//   its time, but per-pixel work, repeated at every level
//   (scripts/time_corr_kernels.py, NVIDIA H100 80GB HBM3, 700 W).
//   Bound: bytes (fmap1 once, the fmap2 rows some tap touches once, center
//   and output): 0.33 ms for the four hires levels of a 2016x2880 fp32
//   pair on random centers. What the splits pay: shared-memory delivery (8
//   bytes a multiply-add in the tap split, ~4.8 in the pixel split, at 128
//   bytes a clock an SM), the staged span (~2.6 rows a pixel at hires
//   level 0 on random disparities), and a pipeline of few warps an SM.
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

#include <limits.h>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The forward. Two kernels share one order of summation, so either gives
// the same bits (the launcher picks by shape, for speed only): each tap's
// dot over D is 4 fp32 partial sums, walked 128-byte slice after slice;
// within a slice the 8 chunks of 16 bytes are visited from chunk (w1 mod 8)
// on, the k-th visited into sum k mod 4, elements in order; then (s0 + s1)
// + (s2 + s3), scaled once, blended with the next tap. The rotation spreads
// a quarter-warp of consecutive pixels over the 8 bank groups.
constexpr int kMaxLevels = 4;
constexpr int kSliceBytes = 128;  // one D slice of a staged row: 8 chunks of 16 bytes
constexpr int kChunks = kSliceBytes / 16;

// Up to kMaxLevels fmap2 levels (b_h, w2[i], d), passed by value.
struct Pyramid {
  const void* f2[kMaxLevels];
  int w2[kMaxLevels];
  int n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// 16 bytes of a feature row into shared memory: [first, first + V16) of
// row, zero past d; asynchronous where one aligned load covers it.
template <typename T>
__device__ __forceinline__ void stage16(unsigned char* dst, const T* row, int first, int d,
                                        bool vec) {
  if (vec && first + V16<T>::n <= d)
    cp_async16(dst, row + first);
  else
    *reinterpret_cast<uint4*>(dst) = load16(row, first, d, false);
}

// Adds chunk k (its position in the rotated visit) of one slice to the
// partial sums of one tap.
template <typename T>
__device__ __forceinline__ void add_chunk(float* acc, int k, uint4 a, uint4 b) {
  constexpr int V = V16<T>::n;
  float xa[V], xb[V];
  unpack16(a, xa, (T*)nullptr);
  unpack16(b, xb, (T*)nullptr);
  float s = acc[k & 3];
#pragma unroll
  for (int e = 0; e < V; ++e) s = fmaf(xa[e], xb[e], s);
  acc[k & 3] = s;
}

__device__ __forceinline__ float tap_value(const float* acc, bool in_row, float scale) {
  return in_row ? __fmul_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), scale) : 0.0f;
}

__device__ __forceinline__ float blend(float f, float g0, float g1) {
  return __fadd_rn(__fmul_rn(1.0f - f, g0), __fmul_rn(f, g1));
}

// ---- the tap split: level after level, a lane a tap ----
//
// One block per (b, h, tile of up to kTapTile pixels), kTapThreads threads.
// fmap1's tile is staged whole (every D) once for all the levels; per level
// the fmap2 rows its windows span are staged a slice at a time in two
// buffers (cp.async; rows padded 16 bytes). Lane = (pixel, tap): from 2r+2
// >= 8 taps a pixel, taps 0-7 fill one quarter-warp (8 consecutive rows:
// no bank twice) and the rest share the last lanes; slot s of warp w holds
// pixels (w + 16 s) G .. + G - 1.
constexpr int kTapThreads = 512;
constexpr int kTapWarps = kTapThreads / 32;
constexpr int kTapTile = 128;
constexpr int kTapRowStride = kSliceBytes + 16;
constexpr int kMinCap = 256;  // rows a buffer holds at the least

struct Stage {
  int lvl, c0, s0;
};

template <typename T, int R>
__global__ void __launch_bounds__(kTapThreads, 1)
    fused_corr_fwd_tap_kernel(const T* __restrict__ f1, const Pyramid pyr,
                              const float* __restrict__ center, float* __restrict__ out,
                              int w1, int d, int tile, int n_tiles, int f1_stride, int cap,
                              float scale, bool vec) {
  constexpr int K = 2 * R + 1;
  constexpr int KT = K + 1;
  constexpr int G = 32 / KT;  // pixels a warp slot
  constexpr int NS = ((kTapTile + G - 1) / G + kTapWarps - 1) / kTapWarps;
  constexpr int V = V16<T>::n;
  extern __shared__ __align__(16) unsigned char tap_smem[];
  unsigned char* f1_s = tap_smem;                     // [tile][f1_stride]
  unsigned char* f2_s = tap_smem + tile * f1_stride;  // [2][cap][kTapRowStride]
  __shared__ int base_s[kMaxLevels][kTapTile];
  __shared__ float frac_s[kMaxLevels][kTapTile];
  __shared__ int span_s[kMaxLevels][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x / n_tiles;
  const int w0 = (int)(blockIdx.x % n_tiles) * tile;
  const int n_pix = min(tile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const int f1_bytes = f1_stride - 16;  // a whole number of slices
  const int n_lvl = pyr.n;

  if (tid < kMaxLevels) {
    span_s[tid][0] = INT_MAX;
    span_s[tid][1] = INT_MIN;
  }
  for (int i = tid; i < n_pix * (f1_bytes / 16); i += kTapThreads) {
    const int m = i / (f1_bytes / 16), q = i % (f1_bytes / 16);
    stage16(f1_s + m * f1_stride + q * 16, f1 + (p0 + m) * d, q * V, d, vec);
  }
  __syncthreads();
  for (int i = tid; i < n_lvl * n_pix; i += kTapThreads) {
    const int lvl = i / n_pix, m = i % n_pix;
    const int w2 = pyr.w2[lvl];
    float frac;
    const int b = window_base(center[p0 + m] * (1.0f / (float)(1 << lvl)), w2, R, &frac);
    base_s[lvl][m] = b;
    frac_s[lvl][m] = frac;
    const int lo = max(b, 0), hi = min(b + KT, w2);
    if (lo < hi) {  // integer atomics: the same span in any order
      atomicMin(&span_s[lvl][0], lo);
      atomicMax(&span_s[lvl][1], hi);
    }
  }
  __syncthreads();

  const int p_of = KT >= 8 ? (lane < 8 * G ? lane / 8 : (lane - 8 * G) / max(KT - 8, 1))
                           : lane / KT;
  const int j = KT >= 8 ? (lane < 8 * G ? lane % 8 : 8 + (lane - 8 * G) % max(KT - 8, 1))
                        : lane % KT;
  const bool lane_used = KT >= 8 ? lane < 8 * G || lane - 8 * G < G * (KT - 8) : lane < G * KT;
  // the lane holding tap j + 1 of this lane's pixel (itself past the last)
  const int next_lane =
      j + 1 >= KT ? lane
      : KT >= 8   ? (j + 1 < 8 ? p_of * 8 + j + 1 : 8 * G + p_of * (KT - 8) + (j + 1 - 8))
                  : lane + 1;
  int pix[NS], rot[NS];
  bool lane_on[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    pix[s] = (warp + kTapWarps * s) * G + p_of;
    lane_on[s] = lane_used && pix[s] < n_pix;
    rot[s] = (w0 + pix[s]) & (kChunks - 1);
  }

  auto first_of = [&](int lvl) {
    while (lvl < n_lvl && span_s[lvl][0] >= span_s[lvl][1]) ++lvl;
    return Stage{lvl, lvl < n_lvl ? span_s[lvl][0] : 0, 0};
  };
  auto next_of = [&](Stage st) {
    st.s0 += kSliceBytes;
    if (st.s0 < f1_bytes) return st;
    st.s0 = 0;
    st.c0 += cap;
    if (st.c0 < span_s[st.lvl][1]) return st;
    return first_of(st.lvl + 1);
  };
  auto issue = [&](Stage st, int buf) {
    const int w2 = pyr.w2[st.lvl];
    const T* f2 = static_cast<const T*>(pyr.f2[st.lvl]) + row * (int64_t)w2 * d;
    const int n = min(cap, span_s[st.lvl][1] - st.c0);
    unsigned char* dst = f2_s + (int64_t)buf * cap * kTapRowStride;
    const int first = st.s0 / (int)sizeof(T);
    for (int i = tid; i < n * kChunks; i += kTapThreads) {
      const int r = i / kChunks, q = i % kChunks;
      stage16(dst + r * kTapRowStride + q * 16, f2 + (int64_t)(st.c0 + r) * d, first + q * V,
              d, vec);
    }
  };
  float acc[NS][4] = {};
  int x[NS];  // this lane's fmap2 row at the current level, -1 outside
  auto write_level = [&](int lvl) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int xs = lane_on[s] ? base_s[lvl][pix[s]] + j : -1;
      const float g = tap_value(acc[s], xs >= 0 && xs < pyr.w2[lvl], scale);
      const float g_next = __shfl_sync(kFull, g, next_lane);
      if (lane_on[s] && j < K)
        out[(p0 + pix[s]) * ((int64_t)n_lvl * K) + lvl * K + j] =
            blend(frac_s[lvl][pix[s]], g, g_next);
    }
  };
  auto start_level = [&](int lvl) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      x[s] = lane_on[s] ? base_s[lvl][pix[s]] + j : -1;
      if (x[s] >= pyr.w2[lvl]) x[s] = -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0.0f;
    }
  };

  Stage cur = first_of(0);
  for (int lvl = 0; lvl < cur.lvl; ++lvl) write_level(lvl);  // acc is 0
  if (cur.lvl < n_lvl) {
    issue(cur, 0);
    start_level(cur.lvl);
  }
  cp_async_commit();
  int buf = 0;
  while (cur.lvl < n_lvl) {
    const Stage nxt = next_of(cur);
    if (nxt.lvl < n_lvl) issue(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int n = min(cap, span_s[cur.lvl][1] - cur.c0);
    bool hit[NS];
    bool any = false;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      hit[s] = x[s] >= cur.c0 && x[s] < cur.c0 + n;
      any = any || hit[s];
    }
    if (__any_sync(kFull, any)) {
      const unsigned char* b_buf = f2_s + (int64_t)buf * cap * kTapRowStride;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (!hit[s]) continue;
        const unsigned char* a = f1_s + pix[s] * f1_stride + cur.s0;
        const unsigned char* b = b_buf + (x[s] - cur.c0) * kTapRowStride;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int c = ((q + rot[s]) & (kChunks - 1)) * 16;
          add_chunk<T>(acc[s], q, *reinterpret_cast<const uint4*>(a + c),
                       *reinterpret_cast<const uint4*>(b + c));
        }
      }
    }
    __syncthreads();  // buffer buf is read: the next issue may refill it
    if (nxt.lvl != cur.lvl) {
      write_level(cur.lvl);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][e] = 0.0f;
      for (int lvl = cur.lvl + 1; lvl < nxt.lvl; ++lvl) write_level(lvl);
      if (nxt.lvl < n_lvl) start_level(nxt.lvl);
    }
    cur = nxt;
    buf ^= 1;
  }
  // fmap1's copies stay unwaited when no level's span holds a row
  cp_async_wait_all();
}

// ---- the pixel split: slice after slice, every level, a thread a pixel ----
//
// One block per (b, h, tile of up to kPixTile pixels). A stage holds one D
// slice of the tile's fmap1 rows and of every level's fmap2 rows its windows
// span (unpadded 128-byte rows; the rotation keeps a quarter-warp on 8 bank
// groups whatever rows its pixels' windows hold), two stages alternating.
// Thread (s, p) sums taps [s TT, (s+1) TT) of pixel p at every level and
// reads each 16 bytes of fmap1 once for all of them. If the levels' spans
// outgrow a stage, they are walked in passes (each tap lies in one).
constexpr int kPixTile = 128;

template <int R>
struct PixSplit {
  static constexpr int kt = 2 * R + 2;
  static constexpr int per_pixel = (kt + 4) / 5;
  static constexpr int taps = (kt + per_pixel - 1) / per_pixel;
  static constexpr int threads = kPixTile * per_pixel;
};

template <typename T, int R>
__global__ void __launch_bounds__(PixSplit<R>::threads, 1)
    fused_corr_fwd_pixel_kernel(const T* __restrict__ f1, const Pyramid pyr,
                                const float* __restrict__ center, float* __restrict__ out,
                                int w1, int d, int tile, int n_tiles, int n_slices, int cap,
                                float scale, bool vec) {
  constexpr int K = 2 * R + 1;
  constexpr int KT = K + 1;
  constexpr int TT = PixSplit<R>::taps;
  constexpr int NT = PixSplit<R>::threads;
  constexpr int V = V16<T>::n;
  extern __shared__ __align__(16) unsigned char pix_smem[];
  const int stage_bytes = (tile + cap) * kSliceBytes;  // [tile] fmap1, [cap] fmap2 rows
  __shared__ int base_s[kMaxLevels][kPixTile];
  __shared__ float frac_s[kMaxLevels][kPixTile];
  __shared__ int span_s[kMaxLevels][2];
  __shared__ float g_s[kPixTile][KT];

  const int tid = threadIdx.x;
  const int p = tid % kPixTile, tap0 = (tid / kPixTile) * TT;
  const int64_t row = blockIdx.x / n_tiles;
  const int w0 = (int)(blockIdx.x % n_tiles) * tile;
  const int n_pix = min(tile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const int n_lvl = pyr.n;
  const bool on = p < n_pix;
  const int rot = (w0 + p) & (kChunks - 1);

  if (tid < kMaxLevels) {
    span_s[tid][0] = INT_MAX;
    span_s[tid][1] = INT_MIN;
  }
  __syncthreads();
  for (int i = tid; i < n_lvl * n_pix; i += NT) {
    const int lvl = i / n_pix, m = i % n_pix;
    const int w2 = pyr.w2[lvl];
    float frac;
    const int b = window_base(center[p0 + m] * (1.0f / (float)(1 << lvl)), w2, R, &frac);
    base_s[lvl][m] = b;
    frac_s[lvl][m] = frac;
    const int lo = max(b, 0), hi = min(b + KT, w2);
    if (lo < hi) {  // integer atomics: the same span in any order
      atomicMin(&span_s[lvl][0], lo);
      atomicMax(&span_s[lvl][1], hi);
    }
  }
  __syncthreads();

  int b[kMaxLevels], cursor[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    b[l] = on && l < n_lvl ? base_s[l][p] : 0;
    cursor[l] = l < n_lvl && span_s[l][0] < span_s[l][1] ? span_s[l][0] : 0;
  }
  float acc[kMaxLevels][TT][4] = {};

  while (true) {  // passes
    int lo[kMaxLevels], n[kMaxLevels], off[kMaxLevels];
    int total = 0;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      const int rem = l < n_lvl && span_s[l][0] < span_s[l][1] ? span_s[l][1] - cursor[l] : 0;
      lo[l] = cursor[l];
      n[l] = min(rem, cap - total);
      off[l] = total;
      total += n[l];
      cursor[l] += n[l];
    }
    if (total == 0) break;

    auto issue = [&](int sl, int buf) {
      unsigned char* st = pix_smem + (int64_t)buf * stage_bytes;
      const int first = sl * (kSliceBytes / (int)sizeof(T));
      for (int i = tid; i < n_pix * kChunks; i += NT) {
        const int m = i / kChunks, q = i % kChunks;
        stage16(st + m * kSliceBytes + q * 16, f1 + (p0 + m) * d, first + q * V, d, vec);
      }
      unsigned char* rows = st + tile * kSliceBytes;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (n[l] == 0) continue;
        const T* f2 = static_cast<const T*>(pyr.f2[l]) + row * (int64_t)pyr.w2[l] * d;
        for (int i = tid; i < n[l] * kChunks; i += NT) {
          const int r = i / kChunks, q = i % kChunks;
          stage16(rows + (off[l] + r) * kSliceBytes + q * 16, f2 + (int64_t)(lo[l] + r) * d,
                  first + q * V, d, vec);
        }
      }
    };
    issue(0, 0);
    cp_async_commit();
    for (int sl = 0; sl < n_slices; ++sl) {
      const int buf = sl & 1;
      if (sl + 1 < n_slices) issue(sl + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      if (on) {
        const unsigned char* st = pix_smem + (int64_t)buf * stage_bytes;
        const unsigned char* a_row = st + p * kSliceBytes;
        const unsigned char* rows = st + tile * kSliceBytes;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int c = ((q + rot) & (kChunks - 1)) * 16;
          const uint4 ua = *reinterpret_cast<const uint4*>(a_row + c);
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l) {
            const int r0 = b[l] + tap0 - lo[l];  // this pass's row of the first tap
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              const int r = r0 + t;
              if (tap0 + t >= KT || r < 0 || r >= n[l]) continue;
              add_chunk<T>(acc[l][t], q, ua,
                           *reinterpret_cast<const uint4*>(rows + (off[l] + r) * kSliceBytes + c));
            }
          }
        }
      }
      __syncthreads();  // stage buf is read: the next issue may refill it
    }
  }

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= n_lvl) break;
    if (on) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const int jj = tap0 + t;
        if (jj < KT)
          g_s[p][jj] = tap_value(acc[l][t], b[l] + jj >= 0 && b[l] + jj < pyr.w2[l], scale);
      }
    }
    __syncthreads();
    if (on) {
      const float f = frac_s[l][p];
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const int k = tap0 + t;
        if (k < K)
          out[(p0 + p) * ((int64_t)n_lvl * K) + l * K + k] = blend(f, g_s[p][k], g_s[p][k + 1]);
      }
    }
    __syncthreads();  // g_s is read
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

// Shared memory a block may use beside its static arrays.
inline cudaError_t dynamic_smem_max(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes -= 16 * 1024;  // the static arrays
  return err;
}

// The tap split: the widest tile whose two fmap2 buffers still hold
// kMinCap rows (or the widest row), the row's pixels spread evenly.
template <typename T, int R>
cudaError_t launch_fwd_tap(const T* f1, const Pyramid& pyr, const float* center, float* out,
                           int64_t b_h, int w1, int d, int max_w2, bool vec, float scale,
                           cudaStream_t stream) {
  int smem_max = 0;
  cudaError_t err = dynamic_smem_max(&smem_max);
  if (err != cudaSuccess) return err;
  const int64_t f1_stride = (d * (int64_t)sizeof(T) + kSliceBytes - 1) / kSliceBytes *
                                kSliceBytes + 16;
  int tile = kTapTile;
  const int64_t want_cap = max_w2 < kMinCap ? max_w2 : kMinCap;
  while (tile > 1 && smem_max - tile * f1_stride < 2 * want_cap * kTapRowStride) tile /= 2;
  int64_t cap = (smem_max - tile * f1_stride) / (2 * kTapRowStride);
  if (cap < 1) return cudaErrorInvalidValue;  // D too wide for one pixel's row
  if (cap > max_w2) cap = max_w2;
  const int n_tiles = (w1 + tile - 1) / tile;
  tile = (w1 + n_tiles - 1) / n_tiles;
  const int64_t smem = tile * f1_stride + 2 * cap * kTapRowStride;
  const int64_t blocks = b_h * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_corr_fwd_tap_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_corr_fwd_tap_kernel<T, R><<<(unsigned int)blocks, kTapThreads, (size_t)smem, stream>>>(
      f1, pyr, center, out, w1, d, tile, n_tiles, (int)f1_stride, (int)cap, scale, vec);
  return cudaGetLastError();
}

// The pixel split: tiles of up to kPixTile pixels spread evenly; a stage
// holds their fmap1 slices and up to cap fmap2 rows (no more than the
// levels' widths together).
template <typename T, int R>
cudaError_t launch_fwd_pixel(const T* f1, const Pyramid& pyr, const float* center,
                             float* out, int64_t b_h, int w1, int d, bool vec, float scale,
                             cudaStream_t stream) {
  int smem_max = 0;
  cudaError_t err = dynamic_smem_max(&smem_max);
  if (err != cudaSuccess) return err;
  const int n_slices = (int)((d * (int64_t)sizeof(T) + kSliceBytes - 1) / kSliceBytes);
  const int n_tiles = (w1 + kPixTile - 1) / kPixTile;
  const int tile = (w1 + n_tiles - 1) / n_tiles;
  int64_t cap = smem_max / (2 * kSliceBytes) - tile;
  int64_t all_rows = 0;
  for (int i = 0; i < pyr.n; ++i) all_rows += pyr.w2[i];
  if (cap > all_rows) cap = all_rows;
  if (cap < 1) return cudaErrorInvalidValue;
  const int64_t smem = 2 * (tile + cap) * kSliceBytes;
  const int64_t blocks = b_h * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_corr_fwd_pixel_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_corr_fwd_pixel_kernel<T, R>
      <<<(unsigned int)blocks, PixSplit<R>::threads, (size_t)smem, stream>>>(
          f1, pyr, center, out, w1, d, tile, n_tiles, n_slices, (int)cap, scale, vec);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_fwd(const void* f1, const Pyramid& pyr, const void* center, void* out,
                       int64_t b_h, int w1, int d, cudaStream_t stream) {
  int max_w2 = 1;
  bool vec = d % V16<T>::n == 0 && aligned16(f1);
  for (int i = 0; i < pyr.n; ++i) {
    if (pyr.w2[i] > max_w2) max_w2 = pyr.w2[i];
    vec = vec && aligned16(pyr.f2[i]);
  }
  const float scale = 1.0f / sqrtf((float)d);
  const T* a = static_cast<const T*>(f1);
  const float* c = static_cast<const float*>(center);
  float* o = static_cast<float*>(out);
  // Both splits give the same bits; the pixel split pays where several
  // levels share each fmap1 slice and D has 8+ slices to pipeline (the
  // hires pyramid, fp32), the tap split elsewhere (one level, or bf16 at
  // the train shape; timings in PERF.md).
  if (pyr.n > 1 && d * (int64_t)sizeof(T) >= 8 * kSliceBytes) return launch_fwd_pixel<T, R>(a, pyr, c, o, b_h, w1, d, vec, scale, stream);
  return launch_fwd_tap<T, R>(a, pyr, c, o, b_h, w1, d, max_w2, vec, scale, stream);
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
// contiguous; n_levels in [1, 4] fmap2 levels, f2[i] (b_h, w2[i], d)
// contiguous; center (b_h, w1) fp32 (level i looks up center / 2**i); out
// (b_h, w1, n_levels * (2r+1)) fp32, level i's taps at [i (2r+1), (i+1)
// (2r+1)). Each entry point returns the cudaError_t of its launches (0 on
// success); the caller raises on anything else. They launch on `stream` and
// do not synchronise.
extern "C" int fused_corr_fwd(const void* f1, const void* const* f2, const int* w2,
                              int n_levels, const void* center, void* out, long long b_h,
                              int w1, int d, int radius, int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  pyr.n = n_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    pyr.f2[i] = i < n_levels ? f2[i] : nullptr;
    pyr.w2[i] = i < n_levels ? w2[i] : 0;
    if (i < n_levels && w2[i] < 0) return (int)cudaErrorInvalidValue;
  }
  if (dtype_code == 0) {
#define CALL_F32(R) launch_fwd<float, R>(f1, pyr, center, out, b_h, w1, d, s)
    RADIUS_DISPATCH(radius, CALL_F32)
#undef CALL_F32
  }
  if (dtype_code == 1) {
#define CALL_BF16(R) launch_fwd<__nv_bfloat16, R>(f1, pyr, center, out, b_h, w1, d, s)
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
