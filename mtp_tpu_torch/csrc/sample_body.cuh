// The bodies of K3 and K6 (bilinear multi-tap sampling, forward and
// backward), the one rule that picks between them, and the 16-byte vector
// helpers they share.
//
// Bodies (Body):
//   kScalar — one thread per channel (K3) or one warp per output pixel (K6),
//             2- or 4-byte accesses: any C, any alignment.
//   kVector — one thread per (output pixel, 16-byte run of its channels):
//             8 bf16 or 4 fp32 a thread, every corner read, output store
//             and image-gradient add one 16-byte access; the block's
//             coordinates staged in shared memory by coalesced loads; taps
//             unrolled for P = 1 and P = 9.
//   kTiled  — K6 at P = 9 where the output grid is the map's (DCNv3 at
//             stride 1): dm, dpy, dpx by kVector without its scatter, then
//             the image gradient by blocks that each own a kTile² tile of
//             one (image·group)'s output pixels and the region within kHalo
//             pixels of it: the corners that land there are listed per
//             region pixel in shared memory (pixel and weight), each region
//             pixel sums its list in registers and adds the sum into device
//             memory with 16-byte vector atomics; corners further out go
//             there directly.
//
// The rule, `body`, is the one `mtp_tpu_torch/ops/dcnv3_sample.py`
// `sample_body` applies over the same limits (a CPU test holds the
// constants below equal to its own).  The wrappers pass the body they
// chose; the C entry points run it only if it is the rule's or the scalar
// body (which runs any shape), and refuse a vector body on storage that is
// not 16-byte aligned instead of running the scalar one.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace smp {

constexpr int kVecBytes = 16;       // one run: a thread's channels, one access
constexpr int kMaxRunThreads = 32;  // runs per pixel: a power of two, in one warp
constexpr int kMaxTaps = 32;        // taps a vector body stages in shared memory
constexpr int kFwdThreads = 128;    // threads of a K3 vector block
constexpr int kBwdThreads = 256;    // threads of a K6 vector block
constexpr int kTiledThreads = 512;  // threads of a kTiled image-gradient block
constexpr int kTile = 16;           // kTiled: output pixels per tile side
constexpr int kHalo = 8;            // kTiled: its region reaches this far past the tile
constexpr int kRegion = kTile + 2 * kHalo;
constexpr int kSmemLimit = 232448;  // shared memory one H100 block may use

enum Body : int { kScalar = 0, kVector = 1, kTiled = 2 };

inline int elem_bytes(int dtype) { return dtype == mtp::kBFloat16 ? 2 : 4; }

// Threads per pixel of the vector bodies, one 16-byte run each; 0 unless
// C·sizeof(T) is 16 bytes times a power of two up to kMaxRunThreads.
inline int run_threads(int C, int dtype) {
  const int bytes = C * elem_bytes(dtype);
  if (C <= 0 || bytes % kVecBytes) return 0;
  const int runs = bytes / kVecBytes;
  return (runs & (runs - 1)) == 0 && runs <= kMaxRunThreads ? runs : 0;
}

// The vector bodies' coordinate staging: py, px, m of a block's pixels
// (and, backward, dpy, dpx, dm before their coalesced store), fp32.
inline size_t stage_bytes(int C, int P, int dtype, bool bwd) {
  const int runs = run_threads(C, dtype);
  const int threads = bwd ? kBwdThreads : kFwdThreads;
  return runs ? static_cast<size_t>(threads / runs) * P * (bwd ? 6 : 3) * sizeof(float) : 0;
}

// kTiled's image-gradient block: its tile's py, px, m (kTile² pixels × 9
// taps), g's rows as fp32, its lists (a weight, fp32, and a pixel, 2
// bytes, per tap corner), and the region's list offsets and cursors
// (kRegion² each) and a scan's warp totals.  (Its first launch, kVector's,
// takes stage_bytes.)
inline size_t tiled_bytes(int C) {
  const size_t pixels = kTile * kTile, cells = kRegion * kRegion;
  return sizeof(float) * (pixels * 9 * 3 + pixels * C + pixels * 9 * 4) +
         sizeof(int) * (2 * cells + 1 + kTiledThreads / 32) +
         sizeof(unsigned short) * pixels * 9 * 4;
}

inline size_t smem_bytes(Body b, int C, int P, int dtype, bool bwd) {
  if (b == kScalar) return 0;
  return b == kTiled ? tiled_bytes(C) : stage_bytes(C, P, dtype, bwd);
}

inline Body body(int C, int P, int dtype, bool aligned, bool bwd, bool same_grid) {
  if (!aligned || run_threads(C, dtype) == 0 || P < 1 || P > kMaxTaps) return kScalar;
  if (bwd && P == 9 && same_grid && smem_bytes(kTiled, C, P, dtype, true) <= kSmemLimit)
    return kTiled;
  return kVector;
}

// 0 if the requested body may run; else the error the entry point returns.
inline cudaError_t refuse(int requested, int C, int P, int dtype, bool aligned, bool bwd,
                          bool same_grid) {
  if (requested == kScalar) return cudaSuccess;
  const Body rule = body(C, P, dtype, aligned, bwd, same_grid);
  if (requested == rule) return cudaSuccess;
  if (!aligned && body(C, P, dtype, true, bwd, same_grid) == requested)
    return cudaErrorMisalignedAddress;
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// ------------------------------------------------------------ device side --

template <typename T>
struct Run {
  static constexpr int kN = kVecBytes / sizeof(T);  // channels of one run
};

__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// 8 bf16 (two a 32-bit word, the first in the low half): a bf16 is the
// top half of the fp32 of the same value.
__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[8]) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 from_floats(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// rounded to nearest even, as __float2bfloat16
__device__ __forceinline__ uint4 from_floats(const float (&f)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
               << 16;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One run of channels through the read-only path.
template <typename T>
__device__ __forceinline__ uint4 load_run(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// dst[0..kN) += v[0..kN) in device memory with 16-byte vector atomics
// (sm_90; dst 16-byte aligned).
template <int kN>
__device__ __forceinline__ void atomic_add_run(float* dst, const float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4)
    atomicAdd(reinterpret_cast<float4*>(dst + i),
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
}

// The threads of one pixel are `runs` neighbouring lanes (a power of two):
// the sum over them, in each of them.
__device__ __forceinline__ float run_sum(float v, int runs) {
  for (int o = runs >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace smp
