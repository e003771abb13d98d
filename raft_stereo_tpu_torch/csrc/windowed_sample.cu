// windowed_sample: the correlation pyramid's 2r+1-tap window lookup, forward.
//
// Replaces raft_stereo_tpu/ops/pallas/corr_kernels.py::windowed_sample_pallas
// (its forward, _lookup_fwd_kernel). For every pixel p of a (B, H, W1) grid
// with window center c = center[p] and volume row vol[p, 0:W2]:
//
//   base = floor(c) - r,  f = c - floor(c)
//   g_j  = vol[p, base + j]   for j in [0, 2r+1], zero outside [0, W2)
//   out[p, k] = (1 - f) * g_k + f * g_{k+1}   for k in [0, 2r]
//
// The volume is fp32 or bf16; the blend and the output are fp32.
//
// Design. The TPU kernel keeps a whole (rows, W1, W2) slab in VMEM and moves
// the window into place with a barrel-shifter rotate network, because a TPU
// has no cheap gather. Hopper loads by index directly, so here one thread
// computes one output element (p, k): it reads the center and the two taps
// it blends, and a pixel's 2r+1 threads are neighbours in a warp, so the
// 2r+2 taps of a row and the 2r+1 outputs are read and written as runs of
// consecutive addresses. A pixel touches (2r+2) taps of its row, not the
// whole 4*W2-byte row.
//
// Bound on this card: memory, not arithmetic. Per pixel it must read the
// center (4 B) and at most 2r+2 taps (40 B fp32, 20 B bf16) and write 2r+1
// fp32 outputs (36 B), against 3 flops per output. At the main path's
// shapes (about 30k pixels at 1/4 resolution of a 384x1248 pair) that is
// under 2.5 MB a launch, below a microsecond at 3.35 TB/s, so the launch
// latency, not the bytes, sets the time of one call.
//
// Numerics. floor(c) is clamped in float before the int cast, so centers
// far outside the row (+-1e9) read no memory and give exact zeros, and a
// NaN center yields NaN (through f). The blend uses explicitly rounded
// multiplies and add (no FMA contraction), so it is bitwise equal to the
// plain PyTorch version, which rounds each operation.
//
// Offsets are 64-bit: B*H*W1*W2 passes 2^31 at Middlebury-F widths.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

  const float c = center[p];
  float base_f = floorf(c);
  const float frac = c - base_f;
  // fmaxf/fminf drop a NaN operand, so a NaN center lands on a finite base;
  // its NaN frac still poisons the output below.
  const float lim = (float)(w2 + radius + 2);
  base_f = fminf(fmaxf(base_f, -lim), lim);
  const int i0 = (int)base_f - radius + j;

  const T* row = vol + p * (int64_t)w2;
  const float g0 = (i0 >= 0 && i0 < w2) ? load_as_float(row + i0) : 0.0f;
  const float g1 = (i0 + 1 >= 0 && i0 + 1 < w2) ? load_as_float(row + i0 + 1) : 0.0f;
  out[idx] = __fadd_rn(__fmul_rn(1.0f - frac, g0), __fmul_rn(frac, g1));
}

template <typename T>
cudaError_t launch(const void* vol, const void* center, void* out, int64_t n_pix,
                   int w2, int radius, cudaStream_t stream) {
  const int64_t n_out = n_pix * (2 * radius + 1);
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  windowed_sample_fwd_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const float*>(center),
      static_cast<float*>(out), n_out, w2, radius);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 volume, 1 = bfloat16 volume. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else. Launches on `stream` and does not synchronise.
extern "C" int windowed_sample_fwd(const void* vol, const void* center, void* out,
                                   long long n_pix, int w2, int radius,
                                   int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return (int)launch<float>(vol, center, out, n_pix, w2, radius, s);
  if (dtype_code == 1) return (int)launch<__nv_bfloat16>(vol, center, out, n_pix, w2, radius, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* windowed_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
