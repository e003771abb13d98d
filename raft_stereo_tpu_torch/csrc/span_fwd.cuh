// The staged-span forward shared by fused_corr and alt_corr: the windowed
// taps g_j = s * <fmap1[p], fmap2_l[b, h, base_l(p) + j]> of 1 to 4 pyramid
// levels in one launch (level l looks up center / 2**l, exact in fp32),
// blended into each level's slot of the concatenated (.., L (2r+1)) output.
// The two kernels compute the same function and differ only in the order of
// each tap's sum over D, which an Order policy sets:
//
//   Order::rotation(w1)     the first 16-byte chunk a pixel visits in each
//                           128-byte slice (the rest follow cyclically);
//   Order::add<T>(acc, q, a, b)
//                           adds the products of the q-th visited chunk to
//                           the tap's 4 partial sums (acc[q mod 4]).
//
// Every tap is then (acc0 + acc1) + (acc2 + acc3), scaled once and blended
// with the next tap, each operation rounded.
//
// Design: the tap split. One block per (b, h, tile of up to kTapTile
// pixels), kTapThreads threads. fmap1's tile is staged whole (every D) once
// for all the levels; per level the fmap2 rows its windows span, [min base,
// max base + 2r+2) clipped to [0, W2), are staged a 128-byte slice of D at a
// time in two buffers (cp.async; rows padded 16 bytes, so the 8 rows of a
// quarter-warp sit on 8 bank groups). Lane = (pixel, tap): from 2r+2 >= 8
// taps a pixel, taps 0-7 fill one quarter-warp and the rest share the last
// lanes; slot s of warp w holds pixels (w + 16 s) G .. + G - 1.

#pragma once

#include <limits.h>

#include "window.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kSliceBytes = 128;  // one D slice of a staged row: 8 chunks of 16 bytes
constexpr int kChunks = kSliceBytes / 16;

// Up to kMaxLevels fmap2 levels (b_h, w2[i], d), passed by value.
struct Pyramid {
  const void* f2[kMaxLevels];
  int w2[kMaxLevels];
  int n;
};

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

__device__ __forceinline__ float tap_value(const float* acc, bool in_row, float scale) {
  return in_row ? __fmul_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), scale) : 0.0f;
}

__device__ __forceinline__ float blend(float f, float g0, float g1) {
  return __fadd_rn(__fmul_rn(1.0f - f, g0), __fmul_rn(f, g1));
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

constexpr int kTapThreads = 512;
constexpr int kTapWarps = kTapThreads / 32;
constexpr int kTapTile = 128;
constexpr int kTapRowStride = kSliceBytes + 16;
constexpr int kMinCap = 256;  // rows a buffer holds at the least

struct Stage {
  int lvl, c0, s0;
};

template <typename T, int R, typename Order>
__global__ void __launch_bounds__(kTapThreads, 1)
    span_fwd_tap_kernel(const T* __restrict__ f1, const Pyramid pyr,
                        const float* __restrict__ center, float* __restrict__ out, int w1, int d,
                        int tile, int n_tiles, int f1_stride, int cap, float scale, bool vec) {
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
    rot[s] = Order::rotation(w0 + pix[s]);
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
      const float g_next = __shfl_sync(0xffffffffu, g, next_lane);
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
    if (__any_sync(0xffffffffu, any)) {
      const unsigned char* b_buf = f2_s + (int64_t)buf * cap * kTapRowStride;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (!hit[s]) continue;
        const unsigned char* a = f1_s + pix[s] * f1_stride + cur.s0;
        const unsigned char* b = b_buf + (x[s] - cur.c0) * kTapRowStride;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int c = ((q + rot[s]) & (kChunks - 1)) * 16;
          Order::template add<T>(acc[s], q, *reinterpret_cast<const uint4*>(a + c),
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

// The tap split's launch: the widest tile whose two fmap2 buffers still
// hold kMinCap rows (or the widest row), the row's pixels spread evenly
// over n tiles. One block fills an SM, so n is chosen from [n_min, 2 n_min]
// to keep the rounds of blocks full: the least ceil(rows n / SMs) *
// ceil(w1 / n), ties to the fewest tiles (at a 1 x 96 x 312 frame 4 tiles
// of 78 pixels make 3 full rounds where 3 tiles of 104 leave the third
// round a fifth full).
template <typename T, int R, typename Order>
cudaError_t launch_span_fwd_tap(const T* f1, const Pyramid& pyr, const float* center,
                                float* out, int64_t b_h, int w1, int d, cudaStream_t stream) {
  int max_w2 = 1;
  bool vec = d % V16<T>::n == 0 && aligned16(f1);
  for (int i = 0; i < pyr.n; ++i) {
    if (pyr.w2[i] > max_w2) max_w2 = pyr.w2[i];
    vec = vec && aligned16(pyr.f2[i]);
  }
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
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_min = (w1 + tile - 1) / tile;
  int n_tiles = n_min;
  int64_t best = -1;
  for (int n = n_min; n <= 2 * n_min && n <= w1; ++n) {
    const int64_t cost = (b_h * n + sms - 1) / sms * ((w1 + n - 1) / n);
    if (best < 0 || cost < best) {
      best = cost;
      n_tiles = n;
    }
  }
  tile = (w1 + n_tiles - 1) / n_tiles;
  const int64_t smem = tile * f1_stride + 2 * cap * kTapRowStride;
  const int64_t blocks = b_h * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(span_fwd_tap_kernel<T, R, Order>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  span_fwd_tap_kernel<T, R, Order><<<(unsigned int)blocks, kTapThreads, (size_t)smem, stream>>>(
      f1, pyr, center, out, w1, d, tile, n_tiles, (int)f1_stride, (int)cap,
      1.0f / sqrtf((float)d), vec);
  return cudaGetLastError();
}

}  // namespace
