// Helpers shared by the port's lookup kernels (windowed_sample, fused_corr,
// alt_corr, fused_lookup): loads and stores in the tensor's dtype, 16-byte
// feature chunks and asynchronous copies, the window's base, the taps'
// gradient, the volume pyramid's descriptor and the dispatch of a radius
// onto its compile-time instantiation.
//
// Every kernel must compute window_base bit for bit alike (their results are
// compared with each other and with the plain PyTorch versions), so it lives
// here only. ops/kernels/_build.py hashes this header into every library's
// name: an edit rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The largest radius the radius-templated kernels are built for.
constexpr int kMaxRadius = 8;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float from_float(float v, float*) { return v; }

__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// floor(c) clamped to +-(w2 + r + 2) (a NaN center to 0), minus r; frac =
// c - floor(c) taken before the clamp.
__device__ __forceinline__ int window_base(float c, int w2, int radius, float* frac) {
  float base_f = floorf(c);
  *frac = c - base_f;
  const float lim = (float)(w2 + radius + 2);
  base_f = isnan(base_f) ? 0.0f : fminf(fmaxf(base_f, -lim), lim);
  return (int)base_f - radius;
}

// dg_j = s * ((1 - f) * ct_j + f * ct_{j-1}) for j in [0, K], each operation
// rounded (no FMA contraction), as the plain PyTorch versions compute it.
template <int K>
__device__ __forceinline__ void tap_grads(const float* ctp, float frac, float scale,
                                          float* dg) {
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const float ct_j = j < K ? ctp[j] : 0.0f;
    const float ct_prev = j > 0 ? ctp[j - 1] : 0.0f;
    dg[j] = __fmul_rn(__fadd_rn(__fmul_rn(1.0f - frac, ct_j), __fmul_rn(frac, ct_prev)),
                      scale);
  }
}

// ---------------------------------------------- 16-byte feature chunks
//
// The staged kernels (fused_corr's forward, alt_corr's backward) move
// feature rows between device and shared memory 16 bytes at a time: V16<T>
// elements of T, widened to fp32 for the arithmetic (exactly: a bf16 is the
// high half of an fp32).

template <typename T>
struct V16 {
  static constexpr int n = 16 / (int)sizeof(T);
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Asynchronous 16-byte copies from device to shared memory (cp.async), in
// groups: commit closes a group; wait_prior waits for all but the newest,
// wait_all for every copy the thread issued.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// One 4-byte asynchronous copy (cp.async.ca: any 4-byte aligned address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Elements [first, first + V16) of `row`, zero past d. With `vec` (row
// 16-byte aligned and d a multiple of V16) one 16-byte load.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int first, int d, bool vec) {
  constexpr int V = V16<T>::n;
  if (vec && first + V <= d) return __ldg(reinterpret_cast<const uint4*>(row + first));
  alignas(16) T t[V];
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = first + e < d ? row[first + e] : from_float(0.0f, (T*)nullptr);
  return *reinterpret_cast<const uint4*>(t);
}

__device__ __forceinline__ void unpack16(uint4 u, float* x, float*) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(uint4 u, float* x, __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Writes x[0, V16) rounded to T as elements [first, first + V16) of `row`,
// none past d.
template <typename T>
__device__ __forceinline__ void store16(T* row, int first, int d, bool vec, const float* x) {
  constexpr int V = V16<T>::n;
  if (vec && first + V <= d) {
    alignas(16) T t[V];
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = from_float(x[e], (T*)nullptr);
    *reinterpret_cast<uint4*>(row + first) = *reinterpret_cast<const uint4*>(t);
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (first + e < d) row[first + e] = from_float(x[e], (T*)nullptr);
}

// ------------------------------------------------- the volume pyramid
//
// windowed_sample and fused_lookup take the reg pyramid's levels (n_pix,
// W2_l) in one launch; level l is looked up around the level-0 center
// scaled by 2^-l.

constexpr int kLevels = 4;  // the most levels a launch takes

// The pyramid's levels and widths, and their gradients, passed by value;
// a level past the pyramid has width 0 and no volume.
struct Levels {
  const void* vol[kLevels];
  int w2[kLevels];
};

struct GradLevels {
  void* dvol[kLevels];
};

inline Levels make_levels(const void* const* vols, const int* w2s, int n_levels = kLevels) {
  Levels lv;
  for (int l = 0; l < kLevels; ++l) {
    lv.vol[l] = l < n_levels ? vols[l] : nullptr;
    lv.w2[l] = l < n_levels ? w2s[l] : 0;
  }
  return lv;
}

__device__ __forceinline__ int level_width(const Levels& lv, int l) {
  return l == 0 ? lv.w2[0] : l == 1 ? lv.w2[1] : l == 2 ? lv.w2[2] : lv.w2[3];
}

__device__ __forceinline__ const void* level_volume(const Levels& lv, int l) {
  return l == 0 ? lv.vol[0] : l == 1 ? lv.vol[1] : l == 2 ? lv.vol[2] : lv.vol[3];
}

// level l's window around the level-0 center x: base (frac in *f); x / 2^l
// is exact as a product with 2^-l
template <int R>
__device__ __forceinline__ int level_window(float x, int l, int w2, float* f) {
  return window_base(__fmul_rn(x, __int_as_float((127 - l) << 23)), w2, R, f);
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// Returns (int)CALL(r) for RADIUS = r in [0, kMaxRadius], one instantiation
// each (the tap count sizes registers and shared arrays), else
// cudaErrorInvalidValue.
#define RADIUS_DISPATCH(RADIUS, CALL)           \
  switch (RADIUS) {                             \
    case 0: return (int)CALL(0);                \
    case 1: return (int)CALL(1);                \
    case 2: return (int)CALL(2);                \
    case 3: return (int)CALL(3);                \
    case 4: return (int)CALL(4);                \
    case 5: return (int)CALL(5);                \
    case 6: return (int)CALL(6);                \
    case 7: return (int)CALL(7);                \
    case 8: return (int)CALL(8);                \
    default: return (int)cudaErrorInvalidValue; \
  }

static_assert(kMaxRadius == 8, "RADIUS_DISPATCH lists radii 0..8");
