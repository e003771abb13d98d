// windowed_sample: the correlation pyramid's 2r+1-tap window lookup, forward
// and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/corr_kernels.py::windowed_sample_pallas
// (its forward _lookup_fwd_kernel and its backward _lookup_bwd_kernel). For
// every pixel p of a (B, H, W1) grid with window center c = center[p] and
// volume row vol[p, 0:W2]:
//
//   base = floor(c) - r,  f = c - floor(c)
//   g_j  = vol[p, base + j]   for j in [0, 2r+1], zero outside [0, W2)
//   out[p, k] = (1 - f) * g_k + f * g_{k+1}   for k in [0, 2r]
//
// Backward, for the output cotangent ct (B, H, W1, 2r+1):
//
//   dg_j = (1 - f) * ct_j + f * ct_{j-1}      (ct_{-1} = ct_{2r+1} = 0)
//   dvol[p, x]   = dg_{x - base} where 0 <= x - base <= 2r+1, else 0
//   dcoords[p]   = sum_k ct_k * (g_{k+1} - g_k)
//
// The volume (and dvol) is fp32 or bf16; the blend, dg and dcoords are fp32,
// and dvol is rounded once to the volume's dtype, as the JAX backward does.
//
// Forward design. The TPU kernel keeps a whole (rows, W1, W2) slab in VMEM
// and moves the window into place with a barrel-shifter rotate network,
// because a TPU has no cheap gather. Hopper loads by index directly, so one
// thread computes one output element (p, k): it reads the center and the
// two taps it blends, and a pixel's 2r+1 threads are neighbours in a warp,
// so the 2r+2 taps of a row and the 2r+1 outputs are read and written as
// runs of consecutive addresses. Bound: memory, not arithmetic. Per pixel it
// reads the center (4 B) and at most 2r+2 taps and writes 2r+1 fp32
// outputs, against 3 flops per output: under 2.5 MB a launch at the main
// path's shapes, below a microsecond at 3.35 TB/s, so the launch latency,
// not the bytes, sets the time of one call.
//
// Backward design. The whole dense dvol must be written, zeros included
// (41.5 MB at level 0 of a SceneFlow training batch in bf16), and those
// bytes are the kernel's bound: ct (36 B a pixel) and the center are a
// tenth of it. The TPU kernel scatters with the rotate network; here one
// pass writes dvol once: each thread owns VEC consecutive dvol elements
// (16 bytes: 8 bf16 or 4 fp32), decides for each whether it lies in its
// pixel's window, and stores dg or 0 with one vector store. There is no
// memset followed by a scatter (which would write the volume twice) and no
// atomics: each pixel owns its row, and its 2r+2 taps are distinct
// addresses. dcoords, which the model never asks for (it detaches the
// coordinates every iteration), is a separate one-thread-per-pixel kernel
// launched only when the caller wants it. Measured on an H100 (PERF.md):
// about twice the time of a memset of the same bytes. Not yet tested as the
// cause: each thread's one 16-byte store waits on its dependent load of the
// center; several chunks a thread, with their loads issued first, would
// hide that latency.
//
// Numerics. floor(c) is clamped in float before the int cast, so centers
// far outside the row (+-1e9) read and write no tap and give exact zeros;
// a NaN center takes base 0 - r (as the plain PyTorch version and XLA's
// float-to-int conversion do) and its NaN f poisons the output and dg. The
// blend and dg use explicitly rounded multiplies and adds (no FMA
// contraction), so they are bitwise equal to the plain PyTorch version,
// which rounds each operation.
//
// Offsets are 64-bit: B*H*W1*W2 passes 2^31 at Middlebury-F widths.

#include "window.cuh"

namespace {

template <typename T>
__global__ void windowed_sample_fwd_kernel(const T* __restrict__ vol,
                                           const float* __restrict__ center,
                                           float* __restrict__ out,
                                           int64_t n_out, int w2, int radius) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int k = 2 * radius + 1;
  const int64_t p = idx / k;
  const int j = (int)(idx - p * k);

  float frac;
  const int i0 = window_base(center[p], w2, radius, &frac) + j;
  const T* row = vol + p * (int64_t)w2;
  const float g0 = (i0 >= 0 && i0 < w2) ? load_as_float(row + i0) : 0.0f;
  const float g1 = (i0 + 1 >= 0 && i0 + 1 < w2) ? load_as_float(row + i0 + 1) : 0.0f;
  out[idx] = __fadd_rn(__fmul_rn(1.0f - frac, g0), __fmul_rn(frac, g1));
}

// VEC values of T, stored with one vector store (16 bytes for the main
// variant, one element for the tail variant).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// dvol: thread t owns flat elements [first + t*VEC, first + t*VEC + VEC)
// of the (n_pix, w2) gradient; n_elems is a multiple of VEC (the wrapper
// hands the ragged tail to the scalar variant, VEC = 1). ct rows are
// ct_stride floats apart (the lookup's cotangent is a slice of the 4-level
// concatenation).
template <typename T, int VEC>
__global__ void windowed_sample_bwd_dvol_kernel(const float* __restrict__ center,
                                                const float* __restrict__ ct,
                                                T* __restrict__ dvol,
                                                int64_t first, int64_t n_elems,
                                                int w2, int radius,
                                                int64_t ct_stride) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_elems / VEC) return;
  const int64_t e0 = first + t * VEC;
  const int k = 2 * radius + 1;
  int64_t p = e0 / w2;
  int x = (int)(e0 - p * w2);
  float frac;
  int base = window_base(center[p], w2, radius, &frac);
  const float* ctp = ct + p * ct_stride;
  Pack<T, VEC> pack;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (x == w2) {  // the run crossed into the next pixel's row
      x = 0;
      ++p;
      base = window_base(center[p], w2, radius, &frac);
      ctp = ct + p * ct_stride;
    }
    const int j = x - base;
    float dg = 0.0f;
    if (j >= 0 && j <= k) {
      const float ct_j = j < k ? __ldg(ctp + j) : 0.0f;
      const float ct_prev = j > 0 ? __ldg(ctp + j - 1) : 0.0f;
      dg = __fadd_rn(__fmul_rn(1.0f - frac, ct_j), __fmul_rn(frac, ct_prev));
    }
    pack.v[i] = from_float(dg, (T*)nullptr);
    ++x;
  }
  *reinterpret_cast<Pack<T, VEC>*>(dvol + e0) = pack;
}

template <typename T>
__global__ void windowed_sample_bwd_dcoords_kernel(const T* __restrict__ vol,
                                                   const float* __restrict__ center,
                                                   const float* __restrict__ ct,
                                                   float* __restrict__ dcoords,
                                                   int64_t n_pix, int w2, int radius,
                                                   int64_t ct_stride) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int k = 2 * radius + 1;
  float frac;
  const int base = window_base(center[p], w2, radius, &frac);
  const T* row = vol + p * (int64_t)w2;
  const float* ctp = ct + p * ct_stride;
  float g_prev = (base >= 0 && base < w2) ? load_as_float(row + base) : 0.0f;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int i1 = base + j + 1;
    const float g_next = (i1 >= 0 && i1 < w2) ? load_as_float(row + i1) : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(ctp + j), __fsub_rn(g_next, g_prev)));
    g_prev = g_next;
  }
  dcoords[p] = acc;
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch_fwd(const void* vol, const void* center, void* out,
                       int64_t n_pix, int w2, int radius, cudaStream_t stream) {
  const int64_t n_out = n_pix * (2 * radius + 1);
  windowed_sample_fwd_kernel<T><<<blocks_for(n_out), kThreads, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const float*>(center),
      static_cast<float*>(out), n_out, w2, radius);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* vol, const void* center, const void* ct,
                       void* dvol, void* dcoords, int64_t n_pix, int w2,
                       int radius, int64_t ct_stride, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const float* c = static_cast<const float*>(center);
  const float* g = static_cast<const float*>(ct);
  T* d = static_cast<T*>(dvol);
  const int64_t n_elems = n_pix * (int64_t)w2;
  const int64_t n_vec = n_elems / VEC * VEC;
  if (n_vec > 0) {
    windowed_sample_bwd_dvol_kernel<T, VEC>
        <<<blocks_for(n_vec / VEC), kThreads, 0, stream>>>(
            c, g, d, 0, n_vec, w2, radius, ct_stride);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_elems > n_vec) {
    windowed_sample_bwd_dvol_kernel<T, 1><<<1, kThreads, 0, stream>>>(
        c, g, d, n_vec, n_elems - n_vec, w2, radius, ct_stride);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dcoords == nullptr) return cudaSuccess;
  windowed_sample_bwd_dcoords_kernel<T><<<blocks_for(n_pix), kThreads, 0, stream>>>(
      static_cast<const T*>(vol), c, g, static_cast<float*>(dcoords), n_pix, w2,
      radius, ct_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 volume, 1 = bfloat16 volume. Each entry point
// returns the cudaError_t of its launches (0 on success); the caller raises
// on anything else. They launch on `stream` and do not synchronise.
extern "C" int windowed_sample_fwd(const void* vol, const void* center, void* out,
                                   long long n_pix, int w2, int radius,
                                   int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return (int)launch_fwd<float>(vol, center, out, n_pix, w2, radius, s);
  if (dtype_code == 1) return (int)launch_fwd<__nv_bfloat16>(vol, center, out, n_pix, w2, radius, s);
  return (int)cudaErrorInvalidValue;
}

// dvol (n_pix, w2) in the volume's dtype, 16-byte aligned; ct fp32 with
// rows ct_stride floats apart; dcoords (n_pix,) fp32 or NULL to skip it
// (vol is read only for dcoords).
extern "C" int windowed_sample_bwd(const void* vol, const void* center, const void* ct,
                                   void* dvol, void* dcoords, long long n_pix, int w2,
                                   int radius, long long ct_stride, int dtype_code,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return (int)launch_bwd<float>(vol, center, ct, dvol, dcoords, n_pix, w2, radius,
                                  ct_stride, s);
  if (dtype_code == 1)
    return (int)launch_bwd<__nv_bfloat16>(vol, center, ct, dvol, dcoords, n_pix, w2,
                                          radius, ct_stride, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* windowed_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
