// The window tile shared by K1's and K4's bf16 tensor-core bodies
// (csrc/window_attn_fwd.cu, csrc/window_attn_bwd.cu): windows of N <= 64
// tokens, head dim D a multiple of 16 up to 128.
//
// One window (a (window, head) pair) is one 64-row tile: 4 warps of 16
// query rows, the M of mma.m16n8k16, over all 64 key columns.  q, k, v (and
// dO) come in as bf16 rows of stride D + 8 (ldmatrix rows hit distinct
// banks), rows past N zero-filled by the copy itself; keys past N are
// masked to -inf before the softmax, and rows past N are never stored.
//
// The bias of pair p starts p·N² floats into the (W·nH, N, N) fp32 array:
// at N = 49 that is 16-byte aligned for every 4th pair only.  Each pair's
// N² floats are therefore copied with 4-byte cp.async, which takes any
// alignment, consecutive threads on consecutive floats; element (i, j)
// sits at bs[i·N + j].  (Copying each pair's run in 16-byte chunks from the
// aligned boundary before it timed the same on the H100: the bias is a
// fifth of a pair's bytes, and the copy overlaps the previous pair's
// compute either way.)  K4 writes dS over the same elements and stores
// them to dbias a float a thread, coalesced.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace mtp {
namespace win {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // a window's tile: queries and keys, N <= kRows
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kNB = kRows / 8;  // 8-key column blocks of a score tile
constexpr int kMaxD = 128;

// The body K1's and K4's C entry points run for an (N, D) window of
// `dtype`: the tensor cores for bf16 windows of at most kRows tokens and
// head dims up to kMaxD, the CUDA cores otherwise.  ops/fused_attn.py
// `window_body` is the same rule over the same two limits (WINDOW_TILE,
// FLASH_MAX_D; a test holds them equal) and pads D to a multiple of 16
// before the launch; a tensor-core window whose D was not padded is
// kUnpadded, which the entry points refuse rather than run elsewhere.
enum Body { kCudaCores, kTensorCores, kUnpadded };

inline Body body(int N, int D, int dtype) {
  if (dtype != kBFloat16 || N > kRows || D > kMaxD) return kCudaCores;
  return D % 16 == 0 ? kTensorCores : kUnpadded;
}

template <int D>
struct Tile {
  static constexpr int LD = D + 8;  // bf16 row stride
  static constexpr int kBytes = kRows * LD * 2;
};

// Floats of one pair's bias in shared memory: N², rounded up to whole
// 16-byte chunks so that the next tile stays aligned.
__host__ __device__ inline int bias_floats(int N) { return (N * N + 3) / 4 * 4; }

// Pair p's N×N bias from `bias` (the (W·nH, N, N) array) into dst; the
// block's threads share the copies.
__device__ __forceinline__ void load_bias_async(float* dst, const float* bias, long long p,
                                                int N) {
  const float* src = bias + p * N * N;
  for (int i = threadIdx.x; i < N * N; i += kThreads) cp_async4(dst + i, src + i, true);
}

// Pair p's N² floats from src (as `load_bias_async` left them, dS written
// over them) out to pair p of the (W·nH, N, N) array dst.
__device__ __forceinline__ void store_bias_run(float* dst, const float* src, long long p,
                                               int N) {
  float* out = dst + p * N * N;
  for (int i = threadIdx.x; i < N * N; i += kThreads) out[i] = src[i];
}

// Pair p's (N, D) bf16 rows (src already at the pair) into a 64-row tile,
// zeros from row N on.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int N) {
  load_rows_async<kRows, D, Tile<D>::LD, kThreads>(dst, src, 0, N);
}

// The warp's 16 query rows of P = softmax(q·kᵀ·scale + bias) over the
// tile's 64 keys, unnormalised: on return s[nb] holds the C fragments of
// exp2(S·log2 e − row max) for keys nb·8..nb·8+7 of the thread's rows
// r0 = warp·16 + g and r0 + 8 (0 at keys past N), and l0, l1 those rows'
// sums (the quad's parts added).  qf: the warp's q rows as A fragments; ks:
// the key tile; bs: the pair's bias; sl2 = scale·log2 e.
template <int D>
__device__ __forceinline__ void softmax_rows(float (&s)[kNB][4], const uint32_t (&qf)[D / 16][4],
                                             const bf16* ks, const float* bs, int N, float sl2,
                                             float& l0, float& l1) {
  constexpr int LD = Tile<D>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < kNB; nb += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, ks + b_frag_offset_nk(lane, nb * 8, kk * 16, LD));
      mma_bf16(s[nb], qf[kk], bf[0], bf[1]);
      mma_bf16(s[nb + 1], qf[kk], bf[2], bf[3]);
    }
  }
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float* b0 = bs + r0 * N;
  const float* b1 = bs + r1 * N;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nb * 8 + 2 * t + e;
      if (c < N) {
        s[nb][e] = fmaf(s[nb][e], sl2, r0 < N ? b0[c] * kLog2e : 0.f);
        s[nb][2 + e] = fmaf(s[nb][2 + e], sl2, r1 < N ? b1[c] * kLog2e : 0.f);
      } else {
        s[nb][e] = s[nb][2 + e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, s[nb][e]);
      mx1 = fmaxf(mx1, s[nb][2 + e]);
    }
  }
  // the 4 threads of a quad share a row; key 0 is always in, so the max is finite
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  l0 = l1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    s[nb][0] = exp2_approx(s[nb][0] - mx0);
    s[nb][1] = exp2_approx(s[nb][1] - mx0);
    s[nb][2] = exp2_approx(s[nb][2] - mx1);
    s[nb][3] = exp2_approx(s[nb][3] - mx1);
    l0 += s[nb][0] + s[nb][1];
    l1 += s[nb][2] + s[nb][3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

// The C fragments of the warp's 16 rows × D columns (rows r0, r0 + 8 as in
// `softmax_rows`), times f0 and f1 by row, as bf16 into the warp's own rows
// of a tile of row stride LD.
template <int D>
__device__ __forceinline__ void frag_rows_to_tile(bf16* tile, const float (&c)[D / 8][4],
                                                  float f0, float f1) {
  constexpr int LD = Tile<D>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    *reinterpret_cast<uint32_t*>(tile + r0 * LD + nd * 8 + col) =
        pack_bf16(c[nd][0] * f0, c[nd][1] * f0);
    *reinterpret_cast<uint32_t*>(tile + (r0 + 8) * LD + nd * 8 + col) =
        pack_bf16(c[nd][2] * f1, c[nd][3] * f1);
  }
}

// The warp's own 16 rows of a tile out to the pair's (N, D) rows at dst,
// 16-byte stores, rows past N skipped.  The caller has synchronised the
// warp since writing them.
template <int D>
__device__ __forceinline__ void store_warp_rows(bf16* dst, const bf16* tile, int N) {
  constexpr int LD = Tile<D>::LD, kChunks = D / 8;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = row0 + i / kChunks, c = (i % kChunks) * 8;
    if (r < N)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * D + c) =
          *reinterpret_cast<const uint4*>(tile + r * LD + c);
  }
}

// Launch geometry of a persistent kernel: min(pairs, SMs × resident blocks
// an SM) blocks, each walking the pairs blockIdx.x, + gridDim.x, ...
template <typename K>
inline cudaError_t persistent_grid(K kernel, size_t smem, long long pairs, unsigned& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(sms) * per_sm;
  blocks = static_cast<unsigned>(pairs < most ? pairs : most);
  return cudaSuccess;
}

}  // namespace win
}  // namespace mtp
