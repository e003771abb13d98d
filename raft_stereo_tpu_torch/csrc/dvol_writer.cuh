// The dense dvol writer shared by the backward kernels of the volume
// pyramid's lookups (windowed_sample, fused_lookup).
//
// A block takes a tile of P consecutive pixels, whose rows are one
// contiguous run in every level's dvol. For each pixel q and level l it
// holds in shared memory the window's base (base_s[l P + q]), its frac
// (frac_s[l P + q]) and the gradient of the window's 2r+1 outputs
// (dcorr_s[q C + l (2r+1)], C = 4 (2r+1)); write_dvol then writes every
// level's run of the tile once, zeros included (no memset, no atomics):
//
//   dvol_l[p, x] = (1 - f) dcorr_{l,j} + f dcorr_{l,j-1}  where j = x - base
//                  is in [0, 2r+1] (dcorr 0 outside [0, 2r]), else 0
//
// in the volume's dtype, each operation rounded as the plain PyTorch
// version's window_grads. Each warp fills pieces of a run in shared memory
// (zeros, then the values of the windows that meet the piece) and one lane
// writes each with a bulk copy (cp.async.bulk, the Tensor Memory
// Accelerator), two pieces in flight a warp, so the stores drain while the
// block goes on: no per-element decoding, no global load between the
// stores.

#pragma once

#include "window.cuh"

namespace {

constexpr int kPiece = 768;  // bytes of dvol a warp writes with one bulk copy, by default

// Bulk copies (the Tensor Memory Accelerator) from shared to device memory,
// in groups a thread commits: wait_read1 returns once all but the newest of
// its groups have read their source, wait_all once all are written.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(s), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later bulk copies' reads
__device__ __forceinline__ void fence_shared_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The gradient of tap j in [0, 2r+1] of pixel q's level-l window: dg_j =
// (1 - f) dcorr_j + f dcorr_{j-1} (dcorr 0 outside [0, 2r]), each
// operation rounded as the plain version's window_grads.
template <int R, int P>
__device__ __forceinline__ float tap_grad(int q, int l, int j, const float* frac_s,
                                          const float* dcorr_s) {
  constexpr int K = 2 * R + 1;
  const float f = frac_s[l * P + q];
  const float* dc = dcorr_s + q * (kLevels * K) + l * K;
  const float ct_j = j < K ? dc[j] : 0.0f;
  const float ct_prev = j > 0 ? dc[j - 1] : 0.0f;
  return __fadd_rn(__fmul_rn(1.0f - f, ct_j), __fmul_rn(f, ct_prev));
}

// Element e of level l's dvol run (pixel q = e / w2 of the tile): tap_grad
// where x = e mod w2 is in the window, else 0.
template <int R, int P>
__device__ __forceinline__ float dvol_value(int e, int w2, int l, const int* base_s,
                                            const float* frac_s, const float* dcorr_s) {
  const int q = e / w2, j = e - q * w2 - base_s[l * P + q];
  return j < 0 || j > 2 * R + 1 ? 0.0f : tap_grad<R, P>(q, l, j, frac_s, dcorr_s);
}

// piece[0, n) = elements [s0, s0 + n) of level l's dvol run, by one warp:
// zeros, 16 bytes a lane, then the dg values of every window that meets the
// piece (the rows q0..q1 it spans, 2r+2 values each).
template <typename T, int R, int P>
__device__ __forceinline__ void fill_piece(T* piece, int s0, int n, int w2, int n_valid, int l,
                                           const int* base_s, const float* frac_s,
                                           const float* dcorr_s, int lane) {
  constexpr int K = 2 * R + 1, V = V16<T>::n;
  for (int e = lane * V; e < n; e += 32 * V)
    *reinterpret_cast<uint4*>(piece + e) = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  const int q0 = s0 / w2, q1 = min((s0 + n - 1) / w2, n_valid - 1);
  for (int it = lane; it < (q1 - q0 + 1) * (K + 1); it += 32) {
    const int r = it / (K + 1), j = it - r * (K + 1);
    const int q = q0 + r;
    const int x = base_s[l * P + q] + j;
    const int e = q * w2 + x - s0;
    if (x >= 0 && x < w2 && e >= 0 && e < n)
      piece[e] = from_float(tap_grad<R, P>(q, l, j, frac_s, dcorr_s), (T*)nullptr);
  }
}

// Each level's dvol rows of the tile of P pixels at p0 (n_valid of them
// real): one contiguous run of n_valid * W2_l elements, every one written
// once (zeros included; no memset, no atomics), by a block of WARPS warps.
// Warp w fills pieces w, w + WARPS, ... of PIECE bytes (a multiple of 16)
// of the run in shared memory (fill_piece; `pieces` holds two a warp) and
// one lane writes each with a bulk copy, two pieces in flight a warp; the
// copies drain while the block goes on to its next tile (n_pieces counts
// the warp's pieces across tiles; before the block exits, lane 0 of every
// warp calls bulk_wait_all). The run's last elements that do not fill 16
// bytes, and a run that does not start 16-byte aligned, are stored
// directly. A level of width 0 is skipped.
template <typename T, int R, int P, int WARPS, int PIECE = kPiece>
__device__ __forceinline__ void write_dvol(const Levels& lv, const GradLevels& glv, int64_t p0,
                                           int n_valid, const int* base_s, const float* frac_s,
                                           const float* dcorr_s, unsigned char* pieces,
                                           int& n_pieces) {
  constexpr int V = V16<T>::n, EP = PIECE / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* mine = pieces + warp * 2 * PIECE;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int w2 = lv.w2[l];
    T* run = static_cast<T*>(glv.dvol[l]) + p0 * (int64_t)w2;
    const int n_el = n_valid * w2;
    const int n_bulk = aligned16(run) ? n_el / V * V : 0;
    for (int s0 = warp * EP; s0 < n_bulk; s0 += WARPS * EP) {
      T* piece = reinterpret_cast<T*>(mine + (n_pieces & 1) * PIECE);
      if (n_pieces >= 2) {  // the piece's buffer was copied from two pieces ago
        if (lane == 0) bulk_wait_read1();
        __syncwarp();
      }
      const int n = min(EP, n_bulk - s0);
      fill_piece<T, R, P>(piece, s0, n, w2, n_valid, l, base_s, frac_s, dcorr_s, lane);
      fence_shared_to_bulk();
      __syncwarp();
      if (lane == 0) {
        bulk_store(run + s0, piece, n * (int)sizeof(T));
        bulk_commit();
      }
      ++n_pieces;
    }
    for (int e = n_bulk + threadIdx.x; e < n_el; e += 32 * WARPS)
      run[e] = from_float(dvol_value<R, P>(e, w2, l, base_s, frac_s, dcorr_s), (T*)nullptr);
  }
}

}  // namespace
