// fused_lookup: the 4-level correlation-pyramid lookup fused with the motion
// encoder's 1x1 convc1 and its ReLU, forward and backward.
//
// Replaces raft_stereo_tpu/ops/pallas/lookup_kernels.py::fused_lookup_c1:
// its forward _fwd_kernel (pallas_call at lookup_kernels.py:243) and its
// backward _bwd_kernel (pallas_call at lookup_kernels.py:277). For every
// pixel p of a (B, H, W1) grid with lookup center x = coords[p] (level-0
// pixels), the volume pyramid vol_l (B, H, W1, W2_l), l in [0, 4), the
// kernel k (C, 64) with C = 4 (2r+1), the bias b (64,) and the compute
// dtype dt:
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
// What bounds it on an H100. Bytes: the forward reads the taps and centers
// and writes 64 channels a pixel (~12.6 MB at the default frame, ~4 us at
// 3.35 TB/s); the backward writes every dense dvol row, zeros included
// (77.6 MB at the SceneFlow batch in bf16, ~23 us). And the order of
// summation: pre and dcorr must sum their products in ascending order with
// each multiply and add rounded, as the plain PyTorch version does, or ReLU
// masks flip and dk moves by O(1). So the 36 x 64 products run on CUDA
// cores, 4,608 instructions a pixel each as FMUL and FADD: ~4.5 us at the
// default frame and ~17 us at the SceneFlow batch over 132 SMs at ~1.8 GHz,
// one product each; the backward has two. With a bf16 compute dtype a
// product of two bf16 values is exact in fp32, so one FFMA gives the same
// bits as FMUL then FADD (mac()), and the floor halves.
//
// Design. The TPU kernel extracts each level's window with a barrel-shifter
// rotate network on a VMEM slab of rows and runs the product on the MXU.
// Here a block takes a tile of P consecutive pixels (P = 64, 32 or 16 in the
// forward, chosen so that every SM gets a tile; 64 in the backward), whose
// rows are contiguous in every level, the output and the cotangent:
//
// * Taps staged once. Thread item (l, q, k) blends taps k and k + 1 of
//   level l's window of pixel q in fp32 and rounds the value to dt into
//   corr_s[c][q]; neighbouring threads take a pixel's neighbouring values,
//   so a window's 2r+2 taps are read as a run of consecutive addresses, as
//   windowed_sample's forward reads them, each from device memory once. A
//   thread's loads are all in flight together, and k is copied into shared
//   memory meanwhile (cp.async) and rounded to dt there.
// * The product shared. Thread (pg, cg) of 16 x 16 sums a 4-pixel x
//   4-channel register tile, reading 4 pixels' corr and 4 channels' k with
//   two 16-byte shared loads: 16 threads a pixel, each output still summed
//   over c in ascending order.
// * Coalesced writes. The forward's [P x 64] output goes through shared
//   memory and is written as one contiguous run of 16-byte stores.
// * Backward: a persistent grid (as many 256-thread blocks as fit on the
//   SMs, each walking tiles blockIdx, blockIdx + grid, ...). Per tile it
//   stages corr, recomputes pre with the forward's code and order, forms
//   g' = g (pre > 0) from the cotangent (read as 8- or 16-byte runs) in
//   shared memory, adds the tile to its dk/db partial, which stays in
//   registers across the block's tiles, computes dcorr[q][c] (4 x 4
//   register tiles, ascending over o), and writes each level's dvol rows of
//   the tile, one contiguous run of P x W2_l elements (the writer of
//   csrc/dvol_writer.cuh, shared with windowed_sample's backward): each
//   warp fills 768-byte pieces of the run in shared memory (zeros, then
//   the dg values of the windows that meet the piece) and one lane writes
//   each piece with a bulk copy (cp.async.bulk, the Tensor Memory
//   Accelerator), so the stores drain while the block goes on to its next
//   tile. Every element is
//   written once: no memset, no atomics. Row C of corr_s holds 1 for every
//   pixel, so the product's row C is db. One partial per block goes to
//   scratch; a second kernel sums the blocks' partials in a fixed order, so
//   two runs are bitwise equal.
// * Tensor cores for dk only. dk = corr^T g' is a sum over pixels that the
//   plain version takes in another order anyway (dk and db are held to a
//   tolerance, not to bits), so in bf16 it runs as mma.sync m16n8k16 with
//   fp32 accumulation: corr and g' are exact bf16 values. pre and dcorr
//   must keep their rounded ascending order, which a tensor core does not
//   give; an fp32 dt keeps dk on CUDA cores too (no TF32).
//
// Numerics. The forward, the ReLU mask and dvol are bitwise equal to the
// plain version (with a bf16 compute dtype for every product in fp32's
// normal range, the only products FMUL would round; see mac()); dk and db
// are sums over pixels in another order. floor(c) is clamped in float
// before the int cast, as windowed_sample does: far-out centers give exact
// zeros, a NaN center NaN (the ReLU keeps NaN, as torch.relu does). Pixel
// offsets are 64-bit.

#include <limits.h>

#include <type_traits>

#include "dvol_writer.cuh"

namespace {

constexpr int kCo = 64;                     // convc1's output channels
constexpr int kMaxFwdThreads = 256;         // 64 pixels a forward tile
constexpr int kBwdTile = 64;                // pixels a backward tile
constexpr int kBwdLog2 = 6;
constexpr int kBwdThreads = 4 * kBwdTile;   // 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCorrStride = kBwdTile + 8;   // backward corr_s row: conflict-free mma loads
constexpr unsigned kFull = 0xffffffffu;

// Sizes of one radius' arrays, in floats.
template <int R>
struct Dims {
  static constexpr int K = 2 * R + 1;            // taps a level's window blends
  static constexpr int C = kLevels * K;          // corr channels, a multiple of 4
  static constexpr int C16 = (C + 1 + 15) / 16 * 16;  // backward corr rows: + ones, to mma tiles
  static constexpr int PART = C * kCo + kCo;     // dk then db
};

// The forward's corr_s rows hold a tile's P pixels and 4 more floats (so a
// pixel's neighbouring values fall in other banks as they are staged).
__host__ __device__ constexpr int fwd_corr_stride(int p) { return p + 4; }

template <int R>
__host__ __device__ constexpr int fwd_smem_floats(int p) {
  using D = Dims<R>;
  const int corr = D::C * fwd_corr_stride(p);
  return D::C * kCo + (corr > p * kCo ? corr : p * kCo);
}

template <int R>
__host__ __device__ constexpr int bwd_smem_floats() {
  using D = Dims<R>;
  return 2 * D::C * kCo + D::C16 * kCorrStride + kCo * kBwdTile + 2 * kLevels * kBwdTile +
         kBwdTile * D::C + kBwdWarps * 2 * kPiece / 4;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to the compute dtype and back to fp32.
template <typename DT>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float(v, (DT*)nullptr));
}

// torch.relu: max(v, 0), NaN kept.
__device__ __forceinline__ float relu(float v) { return (v > 0.0f || isnan(v)) ? v : 0.0f; }

// corr_s[c][q] (rows cs floats apart) for the tile's pixels p0 + q, q < P,
// by threads tid of nthreads = 4 P. Item (l, q, k) of the 4 P K
// blends taps k and k + 1 of level l's window in fp32, each operation
// rounded as windowed_sample's forward does, and rounds the value to dt;
// neighbouring threads take a pixel's neighbouring values, so a window's
// 2r+2 taps are read as one run of consecutive addresses (a tap's second
// read, by the next value, hits L1). Each thread takes K items, their loads
// all in flight together. Pixels past n_valid give 0. With base_s, each
// window's base and frac are kept for the dvol pass.
template <typename T, typename DT, int R>
__device__ __forceinline__ void stage_corr(const Levels& lv, const float* coords, int64_t p0,
                                           int n_valid, int p_log2, float* corr_s, int cs,
                                           int* base_s, float* frac_s, int tid, int nthreads) {
  constexpr int K = Dims<R>::K;
  const int P = 1 << p_log2;
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int i = it * nthreads + tid;
    const int m = i / K, k = i - m * K;
    const int l = m >> p_log2, q = m & (P - 1);
    const int w2 = level_width(lv, l);
    const bool valid = q < n_valid;
    float f;
    const int base = level_window<R>(valid ? __ldg(coords + p0 + q) : 0.0f, l, w2, &f);
    const int i0 = base + k;
    const T* row = static_cast<const T*>(level_volume(lv, l)) + (p0 + q) * (int64_t)w2;
    const float g0 = (valid && i0 >= 0 && i0 < w2) ? load_as_float(row + i0) : 0.0f;
    const float g1 = (valid && i0 + 1 >= 0 && i0 + 1 < w2) ? load_as_float(row + i0 + 1) : 0.0f;
    corr_s[(l * K + k) * cs + q] =
        round_to<DT>(__fadd_rn(__fmul_rn(1.0f - f, g0), __fmul_rn(f, g1)));
    if (base_s != nullptr && k == 0) {
      base_s[l * P + q] = base;
      frac_s[l * P + q] = f;
    }
  }
}

// acc + a * b with the product and the sum each rounded to fp32. With a
// bf16 compute dtype both factors are bf16 values, whose product (16
// significant bits) fp32 holds exactly, so one fused multiply-add rounds
// only the sum and gives the same bits as FMUL then FADD (for any product
// in fp32's normal range: below 2^-126 FMUL would round it to a subnormal,
// from 2^128 to infinity). fp32 factors take FMUL then FADD.
template <typename DT>
__device__ __forceinline__ float mac(float acc, float a, float b) {
  if (std::is_same<DT, __nv_bfloat16>::value) return __fmaf_rn(a, b, acc);
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// acc[i][j] = sum over c in ascending order of corr[c][4 pg + i] *
// k[c][4 cg + j], each product and sum rounded: the forward's
// pre-activation without the bias, for a 4 x 4 tile.
template <typename DT, int C>
__device__ __forceinline__ void tile_product(const float* corr_s, int cs, int pg,
                                             const float* k_s, int cg, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(corr_s + c * cs + 4 * pg);
    const float4 w = *reinterpret_cast<const float4*>(k_s + c * kCo + 4 * cg);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = mac<DT>(acc[i][j], xs[i], ws[j]);
  }
}

// k (C, 64) into k_s[c][o] by asynchronous 16-byte copies, issued first so
// that they overlap the taps' loads; round_kernel then waits for them and
// rounds each thread's own chunks to dt in place.
template <int C>
__device__ __forceinline__ void copy_kernel(const float* kern, float* k_s, int tid,
                                            int nthreads) {
  for (int i = tid; i < C * kCo / 4; i += nthreads) cp_async16(k_s + 4 * i, kern + 4 * i);
  cp_async_commit();
}

template <typename DT, int C>
__device__ __forceinline__ void round_kernel(float* k_s, int tid, int nthreads) {
  cp_async_wait_all();
  if (std::is_same<DT, float>::value) return;
  for (int i = tid; i < C * kCo / 4; i += nthreads) {
    float4* v = reinterpret_cast<float4*>(k_s) + i;
    const float4 x = *v;
    *v = make_float4(round_to<DT>(x.x), round_to<DT>(x.y), round_to<DT>(x.z), round_to<DT>(x.w));
  }
}

template <typename T, typename DT, int R>
__global__ void __launch_bounds__(kMaxFwdThreads, 4)
    fused_lookup_fwd_kernel(Levels lv, const float* __restrict__ coords,
                            const float* __restrict__ kern, const float* __restrict__ bias,
                            DT* __restrict__ out, int64_t n_pix, int p_log2) {
  using D = Dims<R>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float b_s[kCo];
  const int P = 1 << p_log2, cs = fwd_corr_stride(P);
  float* k_s = smem;                  // [C][64]
  float* corr_s = k_s + D::C * kCo;   // [C][cs]
  float* out_s = corr_s;              // [P][64] after the product

  const int64_t p0 = (int64_t)blockIdx.x << p_log2;
  const int n_valid = (int)min((int64_t)P, n_pix - p0);
  copy_kernel<D::C>(kern, k_s, threadIdx.x, blockDim.x);
  stage_corr<T, DT, R>(lv, coords, p0, n_valid, p_log2, corr_s, cs, nullptr, nullptr,
                       threadIdx.x, blockDim.x);
  round_kernel<DT, D::C>(k_s, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < kCo; i += blockDim.x) b_s[i] = bias[i];
  __syncthreads();

  const int pg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[4][4];
  tile_product<DT, D::C>(corr_s, cs, pg, k_s, cg, acc);
  __syncthreads();  // out_s overwrites corr
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = relu(__fadd_rn(acc[i][j], b_s[4 * cg + j]));
    *reinterpret_cast<float4*>(out_s + (4 * pg + i) * kCo + 4 * cg) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  // the tile's rows are one contiguous run: 16-byte stores, consecutive
  // threads on consecutive addresses (64 channels are whole 16-byte packs)
  constexpr int V = V16<DT>::n;
  DT* run = out + p0 * kCo;
  const int n_el = n_valid * kCo;
  for (int e = threadIdx.x * V; e < n_el; e += blockDim.x * V) store16(run, e, n_el, true, out_s + e);
}

// ------------------------------------------------------------------ backward

// g'[o][q] of the backward tile in shared memory, 16-byte quads of pixels
// swizzled by o so that the mask step's column writes, the dcorr tiles' and
// the dk product's reads hit distinct banks.
__device__ __forceinline__ int gt_at(int o, int q) {
  const int sw = ((o & 3) << 1) ^ ((o >> 2) & 7);
  return o * kBwdTile + ((((q >> 2) ^ sw)) << 2) + (q & 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The block's dk/db partial on tensor cores (bf16 dt: corr and g' are exact
// bf16 values): warp w owns output channels [8 w, 8 w + 8) and every 16-row
// tile of corr's C16 rows (row C, all ones, gives db).
template <int R>
struct DkMma {
  static constexpr int MT = Dims<R>::C16 / 16;
  float d[MT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[m][i] = 0.0f;
  }

  __device__ __forceinline__ void add(const float* corr_s, const float* gt_s) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int o = (threadIdx.x >> 5) * 8 + g;
#pragma unroll
    for (int k0 = 0; k0 < kBwdTile; k0 += 16) {
      const float2 lo = *reinterpret_cast<const float2*>(gt_s + gt_at(o, k0 + 2 * t));
      const float2 hi = *reinterpret_cast<const float2*>(gt_s + gt_at(o, k0 + 2 * t + 8));
      const uint32_t b0 = pack_bf16(lo.x, lo.y), b1 = pack_bf16(hi.x, hi.y);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* a = corr_s + (16 * m + g) * kCorrStride + k0 + 2 * t;
        const float2 a0 = *reinterpret_cast<const float2*>(a);
        const float2 a1 = *reinterpret_cast<const float2*>(a + 8 * kCorrStride);
        const float2 a2 = *reinterpret_cast<const float2*>(a + 8);
        const float2 a3 = *reinterpret_cast<const float2*>(a + 8 * kCorrStride + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[m][0]), "+f"(d[m][1]), "+f"(d[m][2]), "+f"(d[m][3])
            : "r"(pack_bf16(a0.x, a0.y)), "r"(pack_bf16(a1.x, a1.y)),
              "r"(pack_bf16(a2.x, a2.y)), "r"(pack_bf16(a3.x, a3.y)), "r"(b0), "r"(b1));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
    constexpr int C = Dims<R>::C;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int o = (threadIdx.x >> 5) * 8 + 2 * t;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int c = 16 * m + g;
      if (c <= C) {
        dst[c * kCo + o] = d[m][0];
        dst[c * kCo + o + 1] = d[m][1];
      }
      if (c + 8 <= C) {
        dst[(c + 8) * kCo + o] = d[m][2];
        dst[(c + 8) * kCo + o + 1] = d[m][3];
      }
    }
  }
};

// The same partial on CUDA cores (fp32 dt): lane (w, g) owns output channel
// 8 w + (lane & 7) and corr rows (lane >> 3) + 4 m, summed over the tile's
// pixels in ascending order.
template <int R>
struct DkFp32 {
  static constexpr int NC = Dims<R>::C16 / 4;
  float d[NC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < NC; ++m) d[m] = 0.0f;
  }

  __device__ __forceinline__ void add(const float* corr_s, const float* gt_s) {
    const int lane = threadIdx.x & 31;
    const int o = (threadIdx.x >> 5) * 8 + (lane & 7), row = lane >> 3;
#pragma unroll 2
    for (int q0 = 0; q0 < kBwdTile; q0 += 4) {
      const float4 gq = *reinterpret_cast<const float4*>(gt_s + gt_at(o, q0));
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(corr_s + (row + 4 * m) * kCorrStride + q0);
        d[m] = __fadd_rn(d[m], __fmul_rn(x.x, gq.x));
        d[m] = __fadd_rn(d[m], __fmul_rn(x.y, gq.y));
        d[m] = __fadd_rn(d[m], __fmul_rn(x.z, gq.z));
        d[m] = __fadd_rn(d[m], __fmul_rn(x.w, gq.w));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
    constexpr int C = Dims<R>::C;
    const int lane = threadIdx.x & 31;
    const int o = (threadIdx.x >> 5) * 8 + (lane & 7), row = lane >> 3;
#pragma unroll
    for (int m = 0; m < NC; ++m)
      if (row + 4 * m <= C) dst[(row + 4 * m) * kCo + o] = d[m];
  }
};

// 4 consecutive cotangent channels of one pixel, widened to fp32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <typename T, typename DT, int R>
__global__ void __launch_bounds__(kBwdThreads, 3)
    fused_lookup_bwd_kernel(Levels lv, GradLevels glv, const float* __restrict__ coords,
                            const DT* __restrict__ g_in, const float* __restrict__ kern,
                            const float* __restrict__ bias, float* __restrict__ partials,
                            int64_t n_pix) {
  using D = Dims<R>;
  constexpr int P = kBwdTile, CS = kCorrStride, CG = D::C / 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ float b_s[kCo];
  float* k_s = smem;                                     // [C][64]
  float* kt_s = k_s + D::C * kCo;                        // [64][C]
  float* corr_s = kt_s + kCo * D::C;                     // [C16][CS]: row C ones, then zeros
  float* gt_s = corr_s + D::C16 * CS;                    // g'[o][q] (gt_at)
  int* base_s = reinterpret_cast<int*>(gt_s + kCo * P);  // [4][P]
  float* frac_s = reinterpret_cast<float*>(base_s + kLevels * P);
  float* dcorr_s = frac_s + kLevels * P;                 // [P][C]
  unsigned char* pieces = reinterpret_cast<unsigned char*>(dcorr_s + P * D::C);
  const int tid = threadIdx.x;

  copy_kernel<D::C>(kern, k_s, tid, kBwdThreads);
  round_kernel<DT, D::C>(k_s, tid, kBwdThreads);
  for (int i = tid; i < kCo; i += kBwdThreads) b_s[i] = bias[i];
  for (int i = (D::C + 1) * CS + tid; i < D::C16 * CS; i += kBwdThreads) corr_s[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < D::C * kCo; i += kBwdThreads) kt_s[(i % kCo) * D::C + i / kCo] = k_s[i];

  using Dk = typename std::conditional<std::is_same<DT, __nv_bfloat16>::value, DkMma<R>,
                                       DkFp32<R>>::type;
  Dk dk;
  dk.zero();
  int n_pieces = 0;
  const int pg = tid >> 4, cg = tid & 15;
  const int64_t n_tiles = (n_pix + P - 1) / P;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * P;
    const int n_valid = (int)min((int64_t)P, n_pix - p0);
    __syncthreads();  // the previous tile's dvol pass is done with the windows and dcorr
    stage_corr<T, DT, R>(lv, coords, p0, n_valid, kBwdLog2, corr_s, CS, base_s, frac_s, tid,
                         kBwdThreads);
    if (tid < P) corr_s[D::C * CS + tid] = tid < n_valid ? 1.0f : 0.0f;
    __syncthreads();

    // the tile's cotangent, 4 pixels x 4 channels a thread
    float gv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = 4 * pg + r;
      if (q < n_valid) {
        load4(g_in + (p0 + q) * kCo + 4 * cg, gv[r]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[r][j] = 0.0f;
      }
    }
    // pre in the forward's order, the mask, g' = g * (pre > 0) into gt_s
    float pre[4][4];
    tile_product<DT, D::C>(corr_s, CS, pg, k_s, cg, pre);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = b_s[4 * cg + j];
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        m[r] = __fmul_rn(gv[r][j], __fadd_rn(pre[r][j], b) > 0.0f ? 1.0f : 0.0f);
      *reinterpret_cast<float4*>(gt_s + gt_at(4 * cg + j, 4 * pg)) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    dk.add(corr_s, gt_s);
    // dcorr[q][c] = sum over o in ascending order of g'[q][o] * k[c][o]
    for (int u = tid; u < (P / 4) * CG; u += kBwdThreads) {
      const int up = u / CG, uc = u - up * CG;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
#pragma unroll 4
      for (int o = 0; o < kCo; ++o) {
        const float4 x = *reinterpret_cast<const float4*>(gt_s + gt_at(o, 4 * up));
        const float4 w = *reinterpret_cast<const float4*>(kt_s + o * D::C + 4 * uc);
        const float xs[4] = {x.x, x.y, x.z, x.w}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = mac<DT>(acc[r][j], xs[r], ws[j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(dcorr_s + (4 * up + r) * D::C + 4 * uc) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    write_dvol<T, R, P, kBwdWarps>(lv, glv, p0, n_valid, base_s, frac_s, dcorr_s, pieces,
                                   n_pieces);
  }
  dk.store(partials + (int64_t)blockIdx.x * D::PART);
  if ((tid & 31) == 0) bulk_wait_all();  // this warp's copies are written and its pieces free
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

// The forward's tile: 64 pixels (256 threads), or 32 or 16 where fewer
// tiles than SMs would leave SMs idle (the realtime pyramid: 7,488 pixels
// make 117 tiles of 64 and 234 of 32 for 132 SMs).
template <typename T, typename DT, int R>
cudaError_t launch_fwd(const Levels& lv, const void* coords, const void* kern,
                       const void* bias, void* out, int64_t n_pix, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int p_log2 = 6;
  while (p_log2 > 4 && ((n_pix + (1 << p_log2) - 1) >> p_log2) < sms) --p_log2;
  const int64_t blocks = (n_pix + (1 << p_log2) - 1) >> p_log2;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int smem = fwd_smem_floats<R>(1 << p_log2) * (int)sizeof(float);
  auto kernel = fused_lookup_fwd_kernel<T, DT, R>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned int)blocks, 4 << p_log2, smem, stream>>>(
      lv, static_cast<const float*>(coords), static_cast<const float*>(kern),
      static_cast<const float*>(bias), static_cast<DT*>(out), n_pix, p_log2);
  return cudaGetLastError();
}

// The backward's persistent grid: as many blocks as fit on the SMs at once,
// at most one a tile. A device gives every launch of a shape the same grid,
// so the tiles each partial sums are fixed.
template <typename T, typename DT, int R>
cudaError_t bwd_grid(int64_t n_pix, int* grid) {
  const int smem = bwd_smem_floats<R>() * (int)sizeof(float);
  auto kernel = fused_lookup_bwd_kernel<T, DT, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return err;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (n_pix + kBwdTile - 1) / kBwdTile;
  const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(n_tiles < fit ? n_tiles : fit);
  return cudaSuccess;
}

template <typename T, typename DT, int R>
cudaError_t launch_bwd(const Levels& lv, const GradLevels& glv, const void* coords,
                       const void* g, const void* kern, const void* bias, void* partials,
                       void* dkdb, int64_t n_pix, cudaStream_t stream) {
  constexpr int PART = Dims<R>::PART;
  int grid = 0;
  cudaError_t err = bwd_grid<T, DT, R>(n_pix, &grid);
  if (err != cudaSuccess) return err;
  const int smem = bwd_smem_floats<R>() * (int)sizeof(float);
  fused_lookup_bwd_kernel<T, DT, R><<<grid, kBwdThreads, smem, stream>>>(
      lv, glv, static_cast<const float*>(coords), static_cast<const DT*>(g),
      static_cast<const float*>(kern), static_cast<const float*>(bias),
      static_cast<float*>(partials), n_pix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int64_t red_blocks = ((int64_t)PART * 32 + threads - 1) / threads;
  fused_lookup_reduce_kernel<<<(unsigned int)red_blocks, threads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dkdb), PART, grid);
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

template <typename T, typename DT>
int dispatch_grid(int64_t n_pix, int radius, int* grid) {
#define CALL(R) bwd_grid<T, DT, R>(n_pix, grid)
  RADIUS_DISPATCH(radius, CALL)
#undef CALL
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

// *count = the number of dk/db partials the backward writes on the current
// device: its scratch is *count x (C x 64 + 64) fp32.
extern "C" int fused_lookup_partials(long long n_pix, int radius, int vol_code, int dt_code,
                                     long long* count) {
  if (vol_code < 0 || vol_code > 1 || dt_code < 0 || dt_code > 1)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  int err;
  switch (2 * vol_code + dt_code) {
    case 0: err = dispatch_grid<float, float>(n_pix, radius, &grid); break;
    case 1: err = dispatch_grid<float, __nv_bfloat16>(n_pix, radius, &grid); break;
    case 2: err = dispatch_grid<__nv_bfloat16, float>(n_pix, radius, &grid); break;
    default: err = dispatch_grid<__nv_bfloat16, __nv_bfloat16>(n_pix, radius, &grid); break;
  }
  *count = grid;
  return err;
}

// g (n_pix, 64) in dt contiguous, 16-byte aligned; dvols like vols, in the
// volume dtype; partials scratch as above; dkdb (C x 64 + 64) fp32: dk then
// db.
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
