// windowed_sample: the correlation pyramid's 2r+1-tap window lookup over 1 to
// 4 levels in one launch, forward and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/corr_kernels.py::windowed_sample_pallas
// (its forward _lookup_fwd_kernel and its backward _lookup_bwd_kernel), as
// raft_stereo_tpu/ops/corr.py::_lookup_reg_pallas calls it once a level. For
// every pixel p of a (B, H, W1) grid with level-0 center x = center[p] and
// level l's volume row vol_l[p, 0:W2_l], l in [0, L):
//
//   c_l = x 2^-l,  base = floor(c_l) - r,  f = c_l - floor(c_l)
//   g_j = vol_l[p, base + j]   for j in [0, 2r+1], zero outside [0, W2_l)
//   out[p, l (2r+1) + k] = (1 - f) g_k + f g_{k+1}   for k in [0, 2r]
//
// Backward, for the output cotangent ct (B, H, W1, L (2r+1)), ct_l its
// level-l window:
//
//   dg_j = (1 - f) ct_{l,j} + f ct_{l,j-1}     (ct_{l,-1} = ct_{l,2r+1} = 0)
//   dvol_l[p, x] = dg_{x - base} where 0 <= x - base <= 2r+1, else 0
//   dcoords_l[p] = sum_k ct_{l,k} (g_{k+1} - g_k)
//   dcoords[p]   = sum over l, from the last level to the first, of
//                  2^-l dcoords_l[p]
//
// The volume (and dvol) is fp32 or bf16; the blend, dg and dcoords are fp32,
// and dvol is rounded once to the volume's dtype, as the JAX backward does.
//
// What bounds it on an H100. Bytes, and before them latency: the forward
// reads the centers and the in-range taps and writes 4 (2r+1) fp32 outputs a
// pixel (~9.2 MB at the default frame's pyramid, ~2.7 us at 3.35 TB/s); the
// backward writes every level's dense dvol, zeros included (77.6 MB at the
// SceneFlow batch in bf16, ~23 us), and reads the cotangent (16.6 MB). One
// launch for the pyramid pays the launch's fixed cost once, not once a
// level, and the lookup's host side is one call.
//
// Forward design. The TPU kernel keeps a slab of rows in VMEM and moves each
// window into place with a barrel-shifter rotate network, because a TPU has
// no cheap gather. Hopper loads by index. A block takes a tile of P
// consecutive pixels: one thread a pixel reads its center once and keeps
// each level's base and frac in shared memory; then item (q, l, k) of the
// tile's P L (2r+1) outputs blends taps k and k + 1 of level l's window of
// pixel q, items in output order over consecutive threads, so a window's
// 2r+2 taps are read as a run of consecutive addresses and the tile's
// outputs (a pixel's L (2r+1) values one contiguous run) are written as one
// coalesced run. Each thread issues the loads of all its items (up to 2r+1)
// before it uses any. P L <= 256 (P = 64 for 4 levels), halved while the
// tiles would leave SMs idle.
//
// Backward design. A persistent grid of 256-thread blocks walks tiles of 64
// pixels. A block stages a tile's centers and cotangent rows into shared
// memory by asynchronous copies (coalesced; each center read once), one
// tile ahead, so the next tile's rows land while this one's dvol is
// written. Per tile it computes each level's base and frac once a pixel,
// then writes each level's dvol rows of the tile, one contiguous run, with
// the dvol writer it shares with fused_lookup's backward
// (csrc/dvol_writer.cuh: pieces zeroed and filled in shared memory, here
// 1536 bytes, written by bulk copies that drain while the block goes on).
// Every element is written once: no memset, no scatter after a memset, no
// atomics, no global load between the stores. dcoords, which the model
// never asks for (it detaches the coordinates every iteration), is a
// separate one-thread-per-pixel kernel launched only when the caller wants
// it.
//
// Numerics. floor(c) is clamped in float before the int cast, so centers
// far outside the row (+-1e9) read and write no tap and give exact zeros;
// a NaN center takes base 0 - r (as the plain PyTorch version and XLA's
// float-to-int conversion do) and its NaN f poisons the output and dg. The
// blend and dg use explicitly rounded multiplies and adds (no FMA
// contraction), so forward and dvol are bitwise equal to the plain PyTorch
// version, which rounds each operation; x 2^-l is exact, as the plain
// version's x / 2**l. Offsets are 64-bit: B*H*W1*W2 passes 2^31 at
// Middlebury-F widths.

#include <limits.h>

#include "dvol_writer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdPixels = kThreads;           // the most pixels a forward tile takes
constexpr int kBwdTile = kThreads / kLevels;   // pixels a backward tile
constexpr int kBwdPiece = 1536;                // bytes of dvol a warp fills, then bulk-copies
// Register caps (__launch_bounds__ blocks an SM): the forward at 40
// registers (6 blocks an SM) runs the train pyramid's 1,800 tiles in fewer
// waves; the backward at 56 (4 blocks), where 6 or 8 blocks would spill.
constexpr int kFwdBlocksPerSm = 6;
constexpr int kBwdBlocksPerSm = 4;

// m / n for a level count n in [1, kLevels], uniform across the block.
__device__ __forceinline__ int div_levels(int m, int n) {
  return n == 4 ? m >> 2 : n == 2 ? m >> 1 : n == 1 ? m : m / 3;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    windowed_sample_fwd_kernel(Levels lv, int n_levels, const float* __restrict__ center,
                               float* __restrict__ out, int64_t n_pix, int p_log2) {
  constexpr int K = 2 * R + 1;
  __shared__ int base_s[kFwdPixels];  // [l][q], P L <= kFwdPixels
  __shared__ float frac_s[kFwdPixels];
  const int P = 1 << p_log2, tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x << p_log2;
  const int n_valid = (int)min((int64_t)P, n_pix - p0);
  const int lk = n_levels * K, n_items = n_valid * lk;

  if (tid < n_valid) {
    const float x = __ldg(center + p0 + tid);
    for (int l = 0; l < n_levels; ++l) {
      float f;
      base_s[l * P + tid] = level_window<R>(x, l, level_width(lv, l), &f);
      frac_s[l * P + tid] = f;
    }
  }
  __syncthreads();

  // item i = q lk + l K + k, K items a thread at most (P L K <= kThreads K)
  float g0[K], g1[K], fr[K];
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int i = it * kThreads + tid;
    const int m = i / K, k = i - m * K;
    const int q = div_levels(m, n_levels), l = m - q * n_levels;
    const bool valid = i < n_items;
    const int w2 = level_width(lv, l);
    const int i0 = (valid ? base_s[l * P + q] : 0) + k;
    fr[it] = valid ? frac_s[l * P + q] : 0.0f;
    const T* row = static_cast<const T*>(level_volume(lv, l)) + (p0 + q) * (int64_t)w2;
    g0[it] = (valid && i0 >= 0 && i0 < w2) ? load_as_float(row + i0) : 0.0f;
    g1[it] = (valid && i0 + 1 >= 0 && i0 + 1 < w2) ? load_as_float(row + i0 + 1) : 0.0f;
  }
  float* run = out + p0 * lk;
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int i = it * kThreads + tid;
    if (i < n_items)
      run[i] = __fadd_rn(__fmul_rn(1.0f - fr[it], g0[it]), __fmul_rn(fr[it], g1[it]));
  }
}

// The tile at p0's centers and cotangent rows into c_s [P] and ct_s [P][C]
// (level l's window at l (2r+1) of a row), by asynchronous 4-byte copies
// (coalesced: consecutive threads, consecutive addresses), one group.
template <int R>
__device__ __forceinline__ void stage_tile(const float* center, const float* ct,
                                           int64_t ct_stride, int lk, int64_t p0, int n_valid,
                                           float* c_s, float* ct_s, int tid) {
  constexpr int C = kLevels * (2 * R + 1);
  if (tid < n_valid) cp_async4(c_s + tid, center + p0 + tid);
  for (int i = tid; i < n_valid * C; i += kThreads) {
    const int q = i / C, c = i - q * C;
    if (c < lk) cp_async4(ct_s + i, ct + (p0 + q) * ct_stride + c);
  }
  cp_async_commit();
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    windowed_sample_bwd_kernel(Levels lv, GradLevels glv, int n_levels,
                               const float* __restrict__ center, const float* __restrict__ ct,
                               int64_t ct_stride, int64_t n_pix) {
  constexpr int K = 2 * R + 1, C = kLevels * K, P = kBwdTile;
  extern __shared__ __align__(16) float smem[];
  float* ct_s = smem;                                     // [2][P][C]
  float* c_s = ct_s + 2 * P * C;                          // [2][P]
  int* base_s = reinterpret_cast<int*>(c_s + 2 * P);      // [4][P]
  float* frac_s = reinterpret_cast<float*>(base_s + kLevels * P);
  unsigned char* pieces = reinterpret_cast<unsigned char*>(frac_s + kLevels * P);
  const int tid = threadIdx.x, lk = n_levels * K;
  int n_pieces = 0, buf = 0;
  const int64_t n_tiles = (n_pix + P - 1) / P;
  auto n_valid_of = [&](int64_t tile) { return (int)min((int64_t)P, n_pix - tile * P); };
  if (blockIdx.x < n_tiles)
    stage_tile<R>(center, ct, ct_stride, lk, blockIdx.x * (int64_t)P, n_valid_of(blockIdx.x),
                  c_s, ct_s, tid);
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t p0 = tile * P;
    const int n_valid = n_valid_of(tile);
    cp_async_wait_all();
    // the tile's rows have landed, and the previous tile's dvol pass is done
    // with the windows and the other buffer
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)  // lands while this tile's dvol is written
      stage_tile<R>(center, ct, ct_stride, lk, next * P, n_valid_of(next),
                    c_s + (buf ^ 1) * P, ct_s + (buf ^ 1) * P * C, tid);
    if (tid < n_valid) {
      const float x = c_s[buf * P + tid];
      for (int l = 0; l < n_levels; ++l) {
        float f;
        base_s[l * P + tid] = level_window<R>(x, l, level_width(lv, l), &f);
        frac_s[l * P + tid] = f;
      }
    }
    __syncthreads();
    write_dvol<T, R, P, kWarps, kBwdPiece>(lv, glv, p0, n_valid, base_s, frac_s,
                                           ct_s + buf * P * C, pieces, n_pieces);
  }
  if ((tid & 31) == 0) bulk_wait_all();  // this warp's copies are written and its pieces free
}

template <typename T, int R>
__global__ void windowed_sample_dcoords_kernel(Levels lv, int n_levels,
                                               const float* __restrict__ center,
                                               const float* __restrict__ ct, int64_t ct_stride,
                                               float* __restrict__ dcoords, int64_t n_pix) {
  constexpr int K = 2 * R + 1;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const float x = center[p];
  float acc = 0.0f;
  for (int l = n_levels - 1; l >= 0; --l) {
    const int w2 = level_width(lv, l);
    float f;
    const int base = level_window<R>(x, l, w2, &f);
    const T* row = static_cast<const T*>(level_volume(lv, l)) + p * (int64_t)w2;
    const float* ctp = ct + p * ct_stride + l * K;
    float g_prev = (base >= 0 && base < w2) ? load_as_float(row + base) : 0.0f;
    float s = 0.0f;
    for (int j = 0; j < K; ++j) {
      const int i1 = base + j + 1;
      const float g_next = (i1 >= 0 && i1 < w2) ? load_as_float(row + i1) : 0.0f;
      s = __fadd_rn(s, __fmul_rn(__ldg(ctp + j), __fsub_rn(g_next, g_prev)));
      g_prev = g_next;
    }
    const float term = __fmul_rn(s, __int_as_float((127 - l) << 23));  // exact: s 2^-l
    acc = l == n_levels - 1 ? term : __fadd_rn(acc, term);
  }
  dcoords[p] = acc;
}

constexpr int kMaxDevices = 64;

// *value = query() for the current device, queried once a device and then
// kept in cache (zero: not yet known); a launch then costs the host no
// driver query.
template <typename Query>
cudaError_t per_device(int* cache, int* value, Query query) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *value = cache[dev];
    return cudaSuccess;
  }
  err = query(value);
  if (err == cudaSuccess && dev < kMaxDevices) cache[dev] = *value;
  return err;
}

inline cudaError_t device_sms(int* sms) {
  static int cache[kMaxDevices];
  return per_device(cache, sms, sm_count);
}

// The forward's tile: P pixels with P L <= 256 (64 for 4 levels), halved
// while fewer tiles than SMs would leave SMs idle (down to 16 pixels).
template <typename T, int R>
cudaError_t launch_fwd(const Levels& lv, int n_levels, const void* center, void* out,
                       int64_t n_pix, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  int p_log2 = 0;
  while ((2 << p_log2) * n_levels <= kFwdPixels) ++p_log2;
  while (p_log2 > 4 && ((n_pix + (1 << p_log2) - 1) >> p_log2) < sms) --p_log2;
  const int64_t blocks = (n_pix + (1 << p_log2) - 1) >> p_log2;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  windowed_sample_fwd_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      lv, n_levels, static_cast<const float*>(center), static_cast<float*>(out), n_pix, p_log2);
  return cudaGetLastError();
}

template <int R>
constexpr int bwd_smem_bytes() {
  return (2 * kBwdTile * kLevels * (2 * R + 1) + 2 * kBwdTile + 2 * kLevels * kBwdTile) *
             (int)sizeof(float) +
         kWarps * 2 * kBwdPiece;
}

// The backward's persistent grid: as many blocks as fit on the SMs at once,
// at most one a tile; dcoords after it, when asked for.
template <typename T, int R>
cudaError_t launch_bwd(const Levels& lv, const GradLevels* glv, int n_levels,
                       const void* center, const void* ct, int64_t ct_stride, void* dcoords,
                       int64_t n_pix, cudaStream_t stream) {
  const float* c = static_cast<const float*>(center);
  const float* g = static_cast<const float*>(ct);
  cudaError_t err;
  if (glv != nullptr) {
    constexpr int smem = bwd_smem_bytes<R>();
    auto kernel = windowed_sample_bwd_kernel<T, R>;
    static int cache[kMaxDevices];  // blocks the device runs at once
    int fit = 0;
    err = per_device(cache, &fit, [&](int* value) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      int per_sm = 0, sms = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      if (e == cudaSuccess) e = sm_count(&sms);
      *value = (per_sm > 0 ? per_sm : 1) * sms;
      return e;
    });
    if (err != cudaSuccess) return err;
    const int64_t n_tiles = (n_pix + kBwdTile - 1) / kBwdTile;
    kernel<<<(unsigned int)(n_tiles < fit ? n_tiles : (int64_t)fit), kThreads, smem, stream>>>(
        lv, *glv, n_levels, c, g, ct_stride, n_pix);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dcoords == nullptr) return cudaSuccess;
  const int64_t blocks = (n_pix + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  windowed_sample_dcoords_kernel<T, R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      lv, n_levels, c, g, ct_stride, static_cast<float*>(dcoords), n_pix);
  return cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const Levels& lv, int n_levels, const void* center, void* out, int64_t n_pix,
                 int radius, cudaStream_t s) {
#define CALL(R) launch_fwd<T, R>(lv, n_levels, center, out, n_pix, s)
  RADIUS_DISPATCH(radius, CALL)
#undef CALL
}

template <typename T>
int dispatch_bwd(const Levels& lv, const GradLevels* glv, int n_levels, const void* center,
                 const void* ct, int64_t ct_stride, void* dcoords, int64_t n_pix, int radius,
                 cudaStream_t s) {
#define CALL(R) launch_bwd<T, R>(lv, glv, n_levels, center, ct, ct_stride, dcoords, n_pix, s)
  RADIUS_DISPATCH(radius, CALL)
#undef CALL
}

}  // namespace

// vols: n_levels in [1, 4] contiguous levels (n_pix, w2s[l]), all float32
// (dtype_code 0) or all bfloat16 (1); center (n_pix,) fp32 level-0 centers;
// out (n_pix, n_levels (2r+1)) fp32, level l's taps at [l (2r+1), (l+1)
// (2r+1)); radius in [0, 8]. Each entry point returns the cudaError_t of its
// launches (0 on success); the caller raises on anything else. They launch
// on `stream` and do not synchronise.
extern "C" int windowed_sample_fwd(const void* const* vols, const int* w2s, int n_levels,
                                   const void* center, void* out, long long n_pix, int radius,
                                   int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_levels < 1 || n_levels > kLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(vols, w2s, n_levels);
  if (dtype_code == 0) return dispatch_fwd<float>(lv, n_levels, center, out, n_pix, radius, s);
  if (dtype_code == 1)
    return dispatch_fwd<__nv_bfloat16>(lv, n_levels, center, out, n_pix, radius, s);
  return (int)cudaErrorInvalidValue;
}

// dvols: n_levels dense gradients (n_pix, w2s[l]) in the volume's dtype, or
// NULL to skip them; ct fp32 with pixel rows ct_stride floats apart, level
// l's window at [l (2r+1), (l+1) (2r+1)) of a row; dcoords (n_pix,) fp32 or
// NULL to skip it (the volumes are read only for dcoords).
extern "C" int windowed_sample_bwd(const void* const* vols, void* const* dvols, const int* w2s,
                                   int n_levels, const void* center, const void* ct,
                                   long long ct_stride, void* dcoords, long long n_pix,
                                   int radius, int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_levels < 1 || n_levels > kLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(vols, w2s, n_levels);
  GradLevels glv;
  for (int l = 0; l < kLevels; ++l) glv.dvol[l] = dvols != nullptr && l < n_levels ? dvols[l] : nullptr;
  const GradLevels* g = dvols != nullptr ? &glv : nullptr;
  if (dtype_code == 0)
    return dispatch_bwd<float>(lv, g, n_levels, center, ct, ct_stride, dcoords, n_pix, radius, s);
  if (dtype_code == 1)
    return dispatch_bwd<__nv_bfloat16>(lv, g, n_levels, center, ct, ct_stride, dcoords, n_pix,
                                       radius, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* windowed_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
