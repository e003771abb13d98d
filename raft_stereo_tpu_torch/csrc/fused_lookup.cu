// fused_lookup: the 4-level correlation-pyramid lookup fused with the motion
// encoder's 1x1 convc1 and its ReLU, forward and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/lookup_kernels.py::fused_lookup_c1
// (its forward _fwd_kernel and its backward _bwd_kernel). For every pixel p
// of a (B, H, W1) grid with lookup center x = coords[p] (level-0 pixels),
// the volume pyramid vol_l (B, H, W1, W2_l), l in [0, 4), the kernel k
// (C, 64) with C = 4 (2r+1), the bias b (64,) and the compute dtype dt:
//
//   c_l = x / 2^l,  base_l = floor(c_l) - r,  f_l = c_l - floor(c_l)
//   g_{l,j} = vol_l[p, base_l + j]  for j in [0, 2r+1], 0 outside [0, W2_l)
//   corr[l (2r+1) + k] = dt((1 - f_l) g_{l,k} + f_l g_{l,k+1})
//   pre[o] = sum_c corr[c] * dt(k[c, o]) + b[o]   (fp32)
//   out[p, o] = dt(relu(pre[o]))
//
// Backward, for the output cotangent g (B, H, W1, 64) in dt:
//
//   g'[o] = g[o] * (pre[o] > 0)                    (pre recomputed)
//   dk[c, o] = sum over every pixel of corr[c] * g'[o]    (fp32)
//   db[o] = sum over every pixel of g'[o]                 (fp32)
//   dcorr[c] = sum_o g'[o] * dt(k[c, o])                  (fp32)
//   dvol_l[p, x] = (1 - f_l) dcorr_{l,j} + f_l dcorr_{l,j-1} where
//                  j = x - base_l in [0, 2r+1], else 0 (in the volume dtype)
//
// and no gradient for the coordinates (the model detaches them every
// iteration). The volume is fp32 or bf16, dt is fp32 or bf16.
//
// Design. The TPU kernel extracts each level's window with a barrel-shifter
// rotate network on a VMEM slab of rows and runs the 36x64 product on the
// MXU. Hopper reads the taps by index, so:
//
// * forward: one thread per pixel. It reads 4 x (2r+2) taps (B1's window),
//   blends the 4 (2r+1) corr values in fp32 and rounds them to dt, and
//   multiplies them with k (rounded to dt once per block into shared
//   memory; every thread reads the same k element at a time, a broadcast):
//   16 output channels at a time, in 16 fp32 sums in registers, then adds
//   the bias, applies the ReLU and stores them NHWC with 16-byte stores.
//   The loop over the 4 channel groups stays rolled: fully unrolled, the
//   C x 64 product of each of the 36 (radius, dtype) instantiations made
//   this file take minutes to compile. Bound: bytes (the taps, the center
//   and the output; ~12.6 MB and ~4 us at the default frame's shapes), so
//   one launch is latency-bound, as B1's is.
// * backward: one warp per pixel, 16 pixels a warp. Lane o owns channels o
//   and o + 32: it recomputes their pre-activations, masks g, and keeps its
//   dk and db partial sums in registers over the warp's pixels; lane c owns
//   dcorr[c] (and c + 32); lanes share values by shuffles. The warp then
//   writes the pixel's 4 dense dvol rows once, zeros included, lanes on
//   consecutive elements (coalesced, no atomics: each pixel owns its rows).
//   The 8 warps of a block add their dk/db partials in warp order into
//   shared memory and the block writes one partial to scratch; a second
//   kernel sums the blocks' partials, one warp per element, lanes over
//   blocks in order and then a fixed butterfly. Every sum has a fixed
//   order: two runs are bitwise equal. Bound: bytes, the dense dvol written
//   once (77.6 MB at the SceneFlow batch in bf16, ~23 us).
//
// Numerics. Both kernels take the products over c (and over o for dcorr) in
// ascending order with each multiply and add rounded (no FMA contraction),
// as the plain PyTorch version does, so the forward, the ReLU mask and
// dvol are bitwise equal to it; dk and db are sums over pixels in another
// order. floor(c) is clamped in float before the int cast, as
// windowed_sample does: far-out centers give exact zeros, a NaN center NaN
// (the ReLU keeps NaN, as torch.relu does). Offsets are 64-bit.

#include "window.cuh"

namespace {

constexpr int kLevels = 4;
constexpr int kCo = 64;              // convc1's output channels
constexpr int kGroup = 16;           // output channels a forward thread sums at a time
constexpr int kFwdThreads = 128;
constexpr int kBwdWarps = 8;
constexpr int kPixPerWarp = 16;
constexpr unsigned kFull = 0xffffffffu;

// The pyramid's levels and widths, and their gradients, passed by value.
struct Levels {
  const void* vol[kLevels];
  int w2[kLevels];
};

struct GradLevels {
  void* dvol[kLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to the compute dtype and back to fp32.
template <typename DT>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float(v, (DT*)nullptr));
}

// The blended value k of level l's window for pixel p.
template <typename T>
__device__ __forceinline__ float level_tap(const T* vol, int w2, int64_t p, int base, float f,
                                           int k) {
  const T* row = vol + p * (int64_t)w2;
  const int i0 = base + k;
  const float g0 = (i0 >= 0 && i0 < w2) ? load_as_float(row + i0) : 0.0f;
  const float g1 = (i0 + 1 >= 0 && i0 + 1 < w2) ? load_as_float(row + i0 + 1) : 0.0f;
  return __fadd_rn(__fmul_rn(1.0f - f, g0), __fmul_rn(f, g1));
}

// torch.relu: max(v, 0), NaN kept.
__device__ __forceinline__ float relu(float v) { return (v > 0.0f || isnan(v)) ? v : 0.0f; }

// 16-byte stores of one group of outputs.
__device__ __forceinline__ void store_group(float* out, const float* v) {
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q)
    reinterpret_cast<float4*>(out)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* out, const float* v) {
#pragma unroll
  for (int q = 0; q < kGroup / 8; ++q) {
    __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pack[i] = __float2bfloat16_rn(v[8 * q + i]);
    reinterpret_cast<uint4*>(out)[q] = *reinterpret_cast<const uint4*>(pack);
  }
}

template <typename T, typename DT, int R>
__global__ void __launch_bounds__(kFwdThreads)
    fused_lookup_fwd_kernel(Levels lv, const float* __restrict__ coords,
                            const float* __restrict__ kern, const float* __restrict__ bias,
                            DT* __restrict__ out, int64_t n_pix) {
  constexpr int K = 2 * R + 1;
  constexpr int C = kLevels * K;
  __shared__ float k_s[C][kCo];
  __shared__ float b_s[kCo];
  for (int i = threadIdx.x; i < C * kCo; i += blockDim.x)
    k_s[i / kCo][i % kCo] = round_to<DT>(kern[i]);
  for (int i = threadIdx.x; i < kCo; i += blockDim.x) b_s[i] = bias[i];
  __syncthreads();
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;

  const float x = coords[p];
  float corr[C];
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    float f;
    const int w2 = lv.w2[l];
    const int base = window_base(__fdiv_rn(x, (float)(1 << l)), w2, R, &f);
    const T* vol = static_cast<const T*>(lv.vol[l]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      corr[l * K + k] = round_to<DT>(level_tap(vol, w2, p, base, f, k));
  }
#pragma unroll 1
  for (int o0 = 0; o0 < kCo; o0 += kGroup) {
    float acc[kGroup];
#pragma unroll
    for (int o = 0; o < kGroup; ++o) acc[o] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int o = 0; o < kGroup; ++o)
        acc[o] = __fadd_rn(acc[o], __fmul_rn(corr[c], k_s[c][o0 + o]));
    }
#pragma unroll
    for (int o = 0; o < kGroup; ++o) acc[o] = relu(__fadd_rn(acc[o], b_s[o0 + o]));
    store_group(out + p * kCo + o0, acc);
  }
}

template <typename T, typename DT, int R>
__global__ void __launch_bounds__(kBwdWarps * 32)
    fused_lookup_bwd_kernel(Levels lv, GradLevels glv, const float* __restrict__ coords,
                            const DT* __restrict__ g_in, const float* __restrict__ kern,
                            const float* __restrict__ bias, float* __restrict__ partials,
                            int64_t n_pix) {
  constexpr int K = 2 * R + 1;
  constexpr int C = kLevels * K;
  constexpr int NC = (C + 31) / 32;                  // corr/dcorr registers a lane
  constexpr int NT = (kLevels * (K + 1) + 31) / 32;  // dg registers a lane
  constexpr int PART = C * kCo + kCo;                // dk then db
  __shared__ float k_s[C][kCo + 1];  // padded: lane c reads row c
  __shared__ float b_s[kCo];
  __shared__ float part_s[PART];
  for (int i = threadIdx.x; i < C * kCo; i += blockDim.x)
    k_s[i / kCo][i % kCo] = round_to<DT>(kern[i]);
  for (int i = threadIdx.x; i < kCo; i += blockDim.x) b_s[i] = bias[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dk_a[C], dk_b[C];  // channels lane and lane + 32
#pragma unroll
  for (int c = 0; c < C; ++c) dk_a[c] = dk_b[c] = 0.0f;
  float db_a = 0.0f, db_b = 0.0f;

  const int64_t first = ((int64_t)blockIdx.x * kBwdWarps + warp) * kPixPerWarp;
  for (int i = 0; i < kPixPerWarp; ++i) {
    const int64_t p = first + i;
    if (p >= n_pix) break;  // uniform across the warp
    const float x = coords[p];
    float fr[kLevels];
    int base[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; ++l)
      base[l] = window_base(__fdiv_rn(x, (float)(1 << l)), lv.w2[l], R, &fr[l]);

    // corr: lane t holds entries t, t + 32, ...
    float cr[NC];
#pragma unroll
    for (int h = 0; h < NC; ++h) {
      const int t = lane + 32 * h;
      float v = 0.0f;
      if (t < C) {
        const int l = t / K, k = t % K;
        float f = 0.0f;
        int b = 0;
#pragma unroll
        for (int q = 0; q < kLevels; ++q)
          if (q == l) {
            f = fr[q];
            b = base[q];
          }
        v = round_to<DT>(level_tap(static_cast<const T*>(lv.vol[l]), lv.w2[l], p, b, f, k));
      }
      cr[h] = v;
    }
    float corr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) corr[c] = __shfl_sync(kFull, cr[c / 32], c % 32);

    // pre-activations of channels lane and lane + 32, the mask, g
    float pa = 0.0f, pb = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pa = __fadd_rn(pa, __fmul_rn(corr[c], k_s[c][lane]));
      pb = __fadd_rn(pb, __fmul_rn(corr[c], k_s[c][lane + 32]));
    }
    pa = __fadd_rn(pa, b_s[lane]);
    pb = __fadd_rn(pb, b_s[lane + 32]);
    const DT* gp = g_in + p * kCo;
    const float ga = __fmul_rn(load_as_float(gp + lane), pa > 0.0f ? 1.0f : 0.0f);
    const float gb = __fmul_rn(load_as_float(gp + lane + 32), pb > 0.0f ? 1.0f : 0.0f);
    db_a = __fadd_rn(db_a, ga);
    db_b = __fadd_rn(db_b, gb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk_a[c] = __fadd_rn(dk_a[c], __fmul_rn(corr[c], ga));
      dk_b[c] = __fadd_rn(dk_b[c], __fmul_rn(corr[c], gb));
    }

    // dcorr: lane t holds entries t, t + 32, ..., each summed over o in order
    float dc[NC];
#pragma unroll
    for (int h = 0; h < NC; ++h) dc[h] = 0.0f;
#pragma unroll
    for (int o = 0; o < kCo; ++o) {
      const float go = __shfl_sync(kFull, o < 32 ? ga : gb, o % 32);
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int t = lane + 32 * h;
        if (t < C) dc[h] = __fadd_rn(dc[h], __fmul_rn(go, k_s[t][o]));
      }
    }

    // dg: lane s holds tap entries s, s + 32, ... of the 4 (2r+2) taps
    float dg[NT];
#pragma unroll
    for (int h = 0; h < NT; ++h) {
      const int s = lane + 32 * h;
      const int l = min(s / (K + 1), kLevels - 1), j = s % (K + 1);
      const int c_j = l * K + j, c_prev = l * K + j - 1;
      const int src_j = min(max(c_j, 0), C - 1), src_p = min(max(c_prev, 0), C - 1);
      float at_j = 0.0f, at_p = 0.0f;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float u_j = __shfl_sync(kFull, dc[q], src_j % 32);
        const float u_p = __shfl_sync(kFull, dc[q], src_p % 32);
        if (src_j / 32 == q) at_j = u_j;
        if (src_p / 32 == q) at_p = u_p;
      }
      const float ct_j = j < K ? at_j : 0.0f;
      const float ct_prev = j > 0 ? at_p : 0.0f;
      float f = 0.0f;
#pragma unroll
      for (int q = 0; q < kLevels; ++q)
        if (q == l) f = fr[q];
      dg[h] = __fadd_rn(__fmul_rn(1.0f - f, ct_j), __fmul_rn(f, ct_prev));
    }

    // the dense dvol rows, every element written once
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      const int w2 = lv.w2[l];
      T* row = static_cast<T*>(glv.dvol[l]) + p * (int64_t)w2;
      for (int x0 = 0; x0 < w2; x0 += 32) {
        const int xx = x0 + lane;
        const int j = xx - base[l];
        const bool inside = j >= 0 && j <= K;
        const int s = l * (K + 1) + (inside ? j : 0);
        float v = 0.0f;
#pragma unroll
        for (int h = 0; h < NT; ++h) {
          const float u = __shfl_sync(kFull, dg[h], s % 32);
          if (s / 32 == h) v = u;
        }
        if (xx < w2) row[xx] = from_float(inside ? v : 0.0f, (T*)nullptr);
      }
    }
  }

  // the block's dk/db partial: warps add in order
  for (int w = 0; w < kBwdWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float pa = w == 0 ? 0.0f : part_s[c * kCo + lane];
        const float pb = w == 0 ? 0.0f : part_s[c * kCo + lane + 32];
        part_s[c * kCo + lane] = __fadd_rn(pa, dk_a[c]);
        part_s[c * kCo + lane + 32] = __fadd_rn(pb, dk_b[c]);
      }
      const float qa = w == 0 ? 0.0f : part_s[C * kCo + lane];
      const float qb = w == 0 ? 0.0f : part_s[C * kCo + lane + 32];
      part_s[C * kCo + lane] = __fadd_rn(qa, db_a);
      part_s[C * kCo + lane + 32] = __fadd_rn(qb, db_b);
    }
    __syncthreads();
  }
  float* dst = partials + (int64_t)blockIdx.x * PART;
  for (int i = threadIdx.x; i < PART; i += blockDim.x) dst[i] = part_s[i];
}

// out[e] = sum over blocks of partials[block, e]: one warp per element,
// lanes over blocks in order, then a fixed butterfly.
__global__ void fused_lookup_reduce_kernel(const float* __restrict__ partials,
                                           float* __restrict__ out, int n_elems,
                                           int n_blocks) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= n_elems) return;  // uniform across the warp
  float acc = 0.0f;
  for (int b = lane; b < n_blocks; b += 32)
    acc = __fadd_rn(acc, partials[(int64_t)b * n_elems + e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) out[e] = acc;
}

template <typename T, typename DT, int R>
cudaError_t launch_fwd(const Levels& lv, const void* coords, const void* kern,
                       const void* bias, void* out, int64_t n_pix, cudaStream_t stream) {
  const int64_t blocks = (n_pix + kFwdThreads - 1) / kFwdThreads;
  fused_lookup_fwd_kernel<T, DT, R><<<(unsigned int)blocks, kFwdThreads, 0, stream>>>(
      lv, static_cast<const float*>(coords), static_cast<const float*>(kern),
      static_cast<const float*>(bias), static_cast<DT*>(out), n_pix);
  return cudaGetLastError();
}

inline int64_t bwd_blocks(int64_t n_pix) {
  const int64_t per_block = (int64_t)kBwdWarps * kPixPerWarp;
  return (n_pix + per_block - 1) / per_block;
}

template <typename T, typename DT, int R>
cudaError_t launch_bwd(const Levels& lv, const GradLevels& glv, const void* coords,
                       const void* g, const void* kern, const void* bias, void* partials,
                       void* dkdb, int64_t n_pix, cudaStream_t stream) {
  constexpr int C = kLevels * (2 * R + 1);
  constexpr int PART = C * kCo + kCo;
  const int64_t blocks = bwd_blocks(n_pix);
  fused_lookup_bwd_kernel<T, DT, R><<<(unsigned int)blocks, kBwdWarps * 32, 0, stream>>>(
      lv, glv, static_cast<const float*>(coords), static_cast<const DT*>(g),
      static_cast<const float*>(kern), static_cast<const float*>(bias),
      static_cast<float*>(partials), n_pix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int64_t red_blocks = ((int64_t)PART * 32 + threads - 1) / threads;
  fused_lookup_reduce_kernel<<<(unsigned int)red_blocks, threads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dkdb), PART, (int)blocks);
  return cudaGetLastError();
}

template <typename T, typename DT>
int dispatch_fwd(const Levels& lv, const void* coords, const void* kern, const void* bias,
                 void* out, int64_t n_pix, int radius, cudaStream_t s) {
#define CALL(R) launch_fwd<T, DT, R>(lv, coords, kern, bias, out, n_pix, s)
  RADIUS_DISPATCH(radius, CALL)
#undef CALL
}

template <typename T, typename DT>
int dispatch_bwd(const Levels& lv, const GradLevels& glv, const void* coords, const void* g,
                 const void* kern, const void* bias, void* partials, void* dkdb,
                 int64_t n_pix, int radius, cudaStream_t s) {
#define CALL(R) launch_bwd<T, DT, R>(lv, glv, coords, g, kern, bias, partials, dkdb, n_pix, s)
  RADIUS_DISPATCH(radius, CALL)
#undef CALL
}

Levels make_levels(const void* const* vols, const int* w2s) {
  Levels lv;
  for (int l = 0; l < kLevels; ++l) {
    lv.vol[l] = vols[l];
    lv.w2[l] = w2s[l];
  }
  return lv;
}

}  // namespace

// vol_code: the volume's dtype, dt_code: the compute dtype (0 = float32,
// 1 = bfloat16). vols: 4 contiguous levels (n_pix, w2s[l]); coords (n_pix,)
// fp32; kern (C, 64) fp32 contiguous, C = 4 (2r+1); bias (64,) fp32; out
// (n_pix, 64) in dt, 16-byte aligned. Each entry point returns the
// cudaError_t of its launches (0 on success); the caller raises on anything
// else. They launch on `stream` and do not synchronise.
extern "C" int fused_lookup_fwd(const void* const* vols, const int* w2s, const void* coords,
                                const void* kern, const void* bias, void* out, long long n_pix,
                                int radius, int vol_code, int dt_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(vols, w2s);
  if (vol_code < 0 || vol_code > 1 || dt_code < 0 || dt_code > 1)
    return (int)cudaErrorInvalidValue;
#define ARGS lv, coords, kern, bias, out, n_pix, radius, s
  switch (2 * vol_code + dt_code) {
    case 0: return dispatch_fwd<float, float>(ARGS);
    case 1: return dispatch_fwd<float, __nv_bfloat16>(ARGS);
    case 2: return dispatch_fwd<__nv_bfloat16, float>(ARGS);
    default: return dispatch_fwd<__nv_bfloat16, __nv_bfloat16>(ARGS);
  }
#undef ARGS
}

// The number of dk/db partials the backward writes: the scratch it takes is
// fused_lookup_partials(n_pix) x (C x 64 + 64) fp32.
extern "C" long long fused_lookup_partials(long long n_pix) { return bwd_blocks(n_pix); }

// g (n_pix, 64) in dt contiguous; dvols like vols, in the volume dtype;
// partials scratch as above; dkdb (C x 64 + 64) fp32: dk then db.
extern "C" int fused_lookup_bwd(const void* const* vols, void* const* dvols, const int* w2s,
                                const void* coords, const void* g, const void* kern,
                                const void* bias, void* partials, void* dkdb, long long n_pix,
                                int radius, int vol_code, int dt_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(vols, w2s);
  GradLevels glv;
  for (int l = 0; l < kLevels; ++l) glv.dvol[l] = dvols[l];
  if (vol_code < 0 || vol_code > 1 || dt_code < 0 || dt_code > 1)
    return (int)cudaErrorInvalidValue;
#define ARGS lv, glv, coords, g, kern, bias, partials, dkdb, n_pix, radius, s
  switch (2 * vol_code + dt_code) {
    case 0: return dispatch_bwd<float, float>(ARGS);
    case 1: return dispatch_bwd<float, __nv_bfloat16>(ARGS);
    case 2: return dispatch_bwd<__nv_bfloat16, float>(ARGS);
    default: return dispatch_bwd<__nv_bfloat16, __nv_bfloat16>(ARGS);
  }
#undef ARGS
}

extern "C" const char* fused_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
