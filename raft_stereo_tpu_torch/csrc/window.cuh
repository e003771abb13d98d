// Helpers shared by the port's lookup kernels (windowed_sample, fused_corr,
// alt_corr, fused_lookup): loads and stores in the tensor's dtype, 16-byte
// feature chunks, the window's base, the taps' gradient and the dispatch of
// a radius onto its compile-time instantiation.
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
