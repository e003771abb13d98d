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
//   - the tap split (one level, or bf16 at the train shape; span_fwd.cuh,
//     shared with alt_corr): fmap1's tile stays whole in shared memory; level after level, lane (pixel, tap)
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
// * backward: both passes tile the row, so a row of any width spreads over
//   many blocks (the JAX kernel tiles W2 the same way, _fused_tiles), and
//   both keep one fixed order, so two runs are bitwise equal.
//   - df1: one block per (b, h, 32 pixels, 512 bytes of D) computes its
//     pixels' bases and dg from center and ct, stages the fmap2 rows its
//     windows span (cp.async) and thread (pixel, 4 chunks of 16 bytes) sums
//     the 2r+2 taps in ascending w2.
//   - df2: a many-to-one scatter, made deterministic without float atomics.
//     One block per (b, h, 32 W2 columns, 512 bytes of D) lists the pixels
//     whose windows meet its columns in ascending w1 (a ballot and a prefix
//     over the warps, 256 pixels at a time), stages their fmap1 rows and dg,
//     and thread (column, 4 chunks) sums the listed pixels whose window
//     holds its column: every df2 element is one fp32 sum in ascending w1,
//     written once, zeros included.
//   Why: the first df2 gave one block a whole row: the row's lists
//   in shared memory (refused above ~2,640 pixels at radius 4), an O(W1^2)
//   rank pass, and one thread a channel walking every list in series; at
//   the train shape it took 0.42-0.50 ms a level against bounds of
//   0.04-0.07 ms (scripts/time_corr_kernels.py, NVIDIA H100 80GB HBM3,
//   700 W); this design takes 0.12-0.16 ms a level there on the three
//   center fields timed. Bound: bytes (fmap1, the touched fmap2 rows,
//   center and ct read once; df1 and df2 written once). What the tiles
//   pay: each pixel tile re-reads the fmap2 rows its neighbours' windows
//   share, each column tile its listed fmap1 rows, and every df2 block
//   scans the row's centers.
//
// Numerics. floor(c) is clamped in float before the int cast, as
// windowed_sample does, so centers far outside the row (+-1e9) touch no tap
// and give exact zeros; a NaN center takes base 0 - r and its NaN f poisons
// the output and dg. Offsets are 64-bit: B*H*W*D passes 2^31 at
// full-resolution widths.

#include "span_fwd.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The forward's order of summation: each tap's dot over D is 4 fp32
// partial sums, walked 128-byte slice after slice; within a slice the 8
// chunks of 16 bytes are visited from chunk (w1 mod 8) on, the k-th visited
// into sum k mod 4 by fmaf, elements in order (the rotation spreads a
// quarter-warp of consecutive pixels over the 8 bank groups in the pixel
// split). Both forward kernels sum in this order, so either gives the same
// bits (the launcher picks by shape, for speed only).
struct fused_corr_order {
  static __device__ __forceinline__ int rotation(int w1) { return w1 & (kChunks - 1); }
  template <typename T>
  static __device__ __forceinline__ void add(float* acc, int k, uint4 a, uint4 b) {
    constexpr int V = V16<T>::n;
    float xa[V], xb[V];
    unpack16(a, xa, (T*)nullptr);
    unpack16(b, xb, (T*)nullptr);
    float s = acc[k & 3];
#pragma unroll
    for (int e = 0; e < V; ++e) s = fmaf(xa[e], xb[e], s);
    acc[k & 3] = s;
  }
};

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
  const int rot = fused_corr_order::rotation(w0 + p);

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
              fused_corr_order::add<T>(acc[l][t], q, ua,
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
// ---- the backward: df1 over W1 tiles, df2 over W2 tiles ----
//
// Both kernels take a (b, h) row in tiles of kBwdTile pixels (df1) or W2
// columns (df2) and a D tile of kDTileBytes, so a row of any width spreads
// over many blocks. Thread (m, q) of a block owns pixel or column m of the
// tile and chunks q, q + 8, q + 16, q + 24 of the D tile (16 bytes each: a
// quarter-warp reads one staged row's 128 contiguous bytes, no bank twice).
// Each computes its own windows from center and ct (no band pass, no
// scratch). Staged rows go to shared memory by cp.async, kRowCap rows a
// pass.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdTile = 32;       // pixels (df1) or W2 columns (df2) a block
constexpr int kDTileBytes = 512;   // a block's D tile: 32 chunks of 16 bytes
constexpr int kDChunks = kDTileBytes / 16;
constexpr int kLanes = kBwdThreads / kBwdTile;  // 8 threads a pixel or column
constexpr int kPerLane = kDChunks / kLanes;     // 4 chunks a thread
constexpr int kRowCap = 96;        // staged rows a pass (48 KB)

// df1[p] = sum over j ascending of dg_j(p) * fmap2[base(p) + j] (in-range
// taps), one fmaf chain from 0: one block per (row, kBwdTile pixels, D
// tile). The block stages the fmap2 rows its windows span, [min base, max
// base + 2r+2) clipped to [0, W2), in passes of `cap` rows (a pass no
// window meets is skipped).
template <typename T, int R>
__global__ void __launch_bounds__(kBwdThreads)
    fused_corr_bwd_df1_kernel(const T* __restrict__ f2, const float* __restrict__ center,
                              const float* __restrict__ ct, T* __restrict__ df1, int w1, int w2,
                              int d, int n_wtiles, int n_dtiles, int cap, float scale, bool vec) {
  constexpr int K = 2 * R + 1;
  constexpr int KT = K + 1;
  constexpr int V = V16<T>::n;
  extern __shared__ __align__(16) unsigned char rows_s[];  // [cap][kDTileBytes]
  __shared__ float dg_s[kBwdTile][KT];
  __shared__ int base_s[kBwdTile];
  __shared__ int span_s[2];

  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int w0 = wt * kBwdTile, first = dt * (kDTileBytes / (int)sizeof(T));
  const int n_pix = min(kBwdTile, w1 - w0);
  const int64_t p0 = row * w1 + w0;
  const T* f2_row = f2 + row * (int64_t)w2 * d;

  if (tid == 0) {
    span_s[0] = INT_MAX;
    span_s[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < n_pix) {
    float frac;
    const int b = window_base(center[p0 + tid], w2, R, &frac);
    base_s[tid] = b;
    float dg[KT];
    tap_grads<K>(ct + (p0 + tid) * K, frac, scale, dg);
#pragma unroll
    for (int j = 0; j < KT; ++j) dg_s[tid][j] = dg[j];
    const int lo = max(b, 0), hi = min(b + KT, w2);
    if (lo < hi) {  // integer atomics: the same span in any order
      atomicMin(&span_s[0], lo);
      atomicMax(&span_s[1], hi);
    }
  }
  __syncthreads();
  const int span_lo = span_s[0], span_hi = span_s[1];
  const int m = tid / kLanes, q = tid % kLanes;
  const bool on = m < n_pix;
  const int b = on ? base_s[m] : 0;
  const int lo = on ? max(b, 0) : 0, hi = on ? min(b + KT, w2) : 0;

  float acc[kPerLane][V];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.0f;
  for (int c0 = span_lo; c0 < span_hi; c0 += cap) {
    const int n = min(cap, span_hi - c0);
    if (!__syncthreads_or(lo < hi && lo < c0 + n && hi > c0)) continue;
    for (int i = tid; i < n * kDChunks; i += kBwdThreads) {
      const int r = i / kDChunks, qq = i % kDChunks;
      stage16(rows_s + r * kDTileBytes + qq * 16, f2_row + (int64_t)(c0 + r) * d,
              first + qq * V, d, vec);
    }
    cp_async_wait_all();
    __syncthreads();
    if (on) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int x = b + j;
        if (x < c0 || x >= c0 + n) continue;
        const float g = dg_s[m][j];
        const unsigned char* src = rows_s + (x - c0) * kDTileBytes;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          float y[V];
          unpack16(*reinterpret_cast<const uint4*>(src + (q + kLanes * i) * 16), y,
                   (T*)nullptr);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(g, y[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // the rows are read: the next pass may refill them
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      store16(df1 + (p0 + m) * d, first + (q + kLanes * i) * V, d, vec, acc[i]);
  }
}

// df2[w2] = sum over the pixels w1 whose window holds w2, ascending w1, of
// dg_{w2 - base(w1)}(w1) * fmap1[w1], one fmaf chain from 0, written once
// (zeros included): one block per (row, kBwdTile W2 columns, D tile). The
// block scans the row's pixels kBwdThreads at a time, lists those whose
// in-range taps meet its columns in ascending w1 (a ballot and a prefix
// over the warps), stages their fmap1 rows and tap gradients in passes of
// `cap`, and thread (column, q) sums the listed pixels whose window holds
// its column. No float atomics: every output has one owner.
template <typename T, int R>
__global__ void __launch_bounds__(kBwdThreads)
    fused_corr_bwd_df2_kernel(const T* __restrict__ f1, const float* __restrict__ center,
                              const float* __restrict__ ct, T* __restrict__ df2, int w1, int w2,
                              int d, int n_wtiles, int n_dtiles, int cap, float scale, bool vec) {
  constexpr int K = 2 * R + 1;
  constexpr int KT = K + 1;
  constexpr int V = V16<T>::n;
  extern __shared__ __align__(16) unsigned char rows_s[];  // [cap][kDTileBytes]
  __shared__ float dg_s[kRowCap][KT];
  __shared__ int lbase_s[kRowCap];
  __shared__ int list_s[kBwdThreads];
  __shared__ int count_s[kBwdWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t blk = blockIdx.x;
  const int dt = (int)(blk % n_dtiles);
  const int wt = (int)((blk / n_dtiles) % n_wtiles);
  const int64_t row = blk / ((int64_t)n_dtiles * n_wtiles);
  const int t0 = wt * kBwdTile, first = dt * (kDTileBytes / (int)sizeof(T));
  const int n_cols = min(kBwdTile, w2 - t0);
  const int64_t p_row = row * w1;
  const int c = tid / kLanes, q = tid % kLanes;
  const int col = t0 + c;
  const bool on = c < n_cols;

  float acc[kPerLane][V];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.0f;
  for (int k0 = 0; k0 < w1; k0 += kBwdThreads) {
    const int w = k0 + tid;
    bool hit = false;
    if (w < w1) {
      float frac;
      const int b = window_base(center[p_row + w], w2, R, &frac);
      const int lo = max(b, 0), hi = min(b + KT, w2);
      hit = lo < hi && lo < t0 + n_cols && hi > t0;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) count_s[warp] = __popc(mask);
    __syncthreads();
    int offs = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kBwdWarps; ++i) {
      const int cnt = count_s[i];
      offs += i < warp ? cnt : 0;
      total += cnt;
    }
    if (hit) list_s[offs + __popc(mask & ((1u << lane) - 1u))] = w;
    __syncthreads();
    for (int e0 = 0; e0 < total; e0 += cap) {
      const int ne = min(cap, total - e0);
      for (int i = tid; i < ne * kDChunks; i += kBwdThreads) {
        const int r = i / kDChunks, qq = i % kDChunks;
        stage16(rows_s + r * kDTileBytes + qq * 16, f1 + (p_row + list_s[e0 + r]) * d,
                first + qq * V, d, vec);
      }
      for (int r = tid; r < ne; r += kBwdThreads) {
        const int64_t p = p_row + list_s[e0 + r];
        float frac;
        lbase_s[r] = window_base(center[p], w2, R, &frac);
        float dg[KT];
        tap_grads<K>(ct + p * K, frac, scale, dg);
#pragma unroll
        for (int j = 0; j < KT; ++j) dg_s[r][j] = dg[j];
      }
      cp_async_wait_all();
      __syncthreads();
      if (on) {
        for (int r = 0; r < ne; ++r) {
          const int j = col - lbase_s[r];
          if ((unsigned)j >= (unsigned)KT) continue;
          const float g = dg_s[r][j];
          const unsigned char* src = rows_s + r * kDTileBytes;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            float y[V];
            unpack16(*reinterpret_cast<const uint4*>(src + (q + kLanes * i) * 16), y,
                     (T*)nullptr);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][e] = fmaf(g, y[e], acc[i][e]);
          }
        }
      }
      __syncthreads();  // rows, dg and bases are read: the next pass may refill them
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      store16(df2 + (row * w2 + col) * d, first + (q + kLanes * i) * V, d, vec, acc[i]);
  }
}

inline int tiles(int64_t n, int t) { return (int)((n + t - 1) / t); }

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
  bool vec = d % V16<T>::n == 0 && aligned16(f1);
  for (int i = 0; i < pyr.n; ++i) vec = vec && aligned16(pyr.f2[i]);
  const T* a = static_cast<const T*>(f1);
  const float* c = static_cast<const float*>(center);
  float* o = static_cast<float*>(out);
  // Both splits give the same bits; the pixel split pays where several
  // levels share each fmap1 slice and D has 8+ slices to pipeline (the
  // hires pyramid, fp32), the tap split elsewhere (one level, or bf16 at
  // the train shape; timings in PERF.md).
  if (pyr.n > 1 && d * (int64_t)sizeof(T) >= 8 * kSliceBytes)
    return launch_fwd_pixel<T, R>(a, pyr, c, o, b_h, w1, d, vec, 1.0f / sqrtf((float)d),
                                  stream);
  return launch_span_fwd_tap<T, R, fused_corr_order>(a, pyr, c, o, b_h, w1, d, stream);
}

// One backward kernel over (rows x tiles of `width` x D tiles), `cap`
// staged rows of dynamic shared memory.
template <typename T>
cudaError_t launch_bwd_kernel(void (*kernel)(const T*, const float*, const float*, T*, int, int,
                                             int, int, int, int, float, bool),
                              int64_t b_h, int width, int n_dtiles, int cap, cudaStream_t stream,
                              const T* src, const float* center, const float* ct, T* dst, int w1,
                              int w2, int d, float scale, bool vec) {
  const int n_wtiles = tiles(width, kBwdTile);
  const int64_t blocks = b_h * n_wtiles * n_dtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * kDTileBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned int)blocks, kBwdThreads, smem, stream>>>(
      src, center, ct, dst, w1, w2, d, n_wtiles, n_dtiles, cap, scale, vec);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_bwd(const void* f1, const void* f2, const void* center, const void* ct,
                       void* df1, void* df2, int64_t b_h, int w1, int w2, int d,
                       cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)d);
  const float* c = static_cast<const float*>(center);
  const float* g = static_cast<const float*>(ct);
  const bool vec = d % V16<T>::n == 0 && aligned16(f1) && aligned16(f2) &&
                   (df1 == nullptr || aligned16(df1)) && (df2 == nullptr || aligned16(df2));
  const int n_dtiles = tiles(d * (int64_t)sizeof(T), kDTileBytes);
  if (df1 != nullptr) {
    const cudaError_t err = launch_bwd_kernel(
        fused_corr_bwd_df1_kernel<T, R>, b_h, w1, n_dtiles, w2 < kRowCap ? w2 : kRowCap,
        stream, static_cast<const T*>(f2), c, g, static_cast<T*>(df1), w1, w2, d, scale, vec);
    if (err != cudaSuccess) return err;
  }
  if (df2 == nullptr) return cudaSuccess;
  return launch_bwd_kernel(fused_corr_bwd_df2_kernel<T, R>, b_h, w2, n_dtiles,
                           w1 < kRowCap ? w1 : kRowCap, stream, static_cast<const T*>(f1), c,
                           g, static_cast<T*>(df2), w1, w2, d, scale, vec);
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
