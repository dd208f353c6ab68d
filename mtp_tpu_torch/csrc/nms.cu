// N1 — greedy non-maximum suppression of horizontal boxes: the suppression
// bitmask, then the serial scan, both on the card.
//
// Port-only kernel: it replaces no pallas_call.  It takes the place of the
// lax loops of mtp_tpu/ops/nms.py `_nms_single_lane` (:122-168), the blocked
// greedy scan behind `nms`, `nms_batched` and `batched_nms`, which XLA runs
// as a `lax.fori_loop` over tiles of 128 boxes with an inner `fori_loop`
// over each tile's rows.
//
// Computes, for each image b of a batch, on boxes already in stable
// descending score order (x1, y1, x2, y2 fp32) with their sorted scores:
//     keep[b, i] = valid[i] and no kept j < i has IoU(j, i) > thr
// where valid means score > NEG_INF / 2 = -5e9.  That is JAX's greedy rule:
// a kept box suppresses every later box whose IoU with it is strictly above
// the threshold; a suppressed or invalid box suppresses nothing.
//
// Two launches on the current stream, no host round trip:
// 1. nms_mask_kernel: one block of 64 threads per (64-row, 64-column) tile
//    of an image's pairs, the tile's column boxes staged in shared memory;
//    thread i sets bit t of word mask[b, row, col_tile] iff column
//    col_tile·64 + t > row and IoU(row, column) > thr.  Tiles wholly below
//    the diagonal are skipped and never written: the scan reads only the
//    words at or past a row's own tile.  The IoU is `bbox_overlaps`'
//    expression evaluated in its order with every operation rounded on
//    its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), so no
//    contraction into an FMA moves a value across the threshold: the bits
//    are those of the plain PyTorch version (ops/nms.py `nms_ref`), which
//    rounds each tensor operation.
// 2. nms_scan_kernel (csrc/nms_scan.cuh, shared with R1's rotated NMS): one
//    block per image walks the rows 64 at a time, the "removed" bits of all
//    N boxes in shared memory, and writes keep.
//
// What bounds it on the H100: the function reads 20 bytes a box and writes
// one, and computes one IoU (14 fp32 operations) for each pair whose first
// box is kept; at the RPN's shape (B = 2, N = 8,382) that is a few
// microseconds of either.  The kernel is bound instead by the mask's
// round trip through device memory (B·N·⌈N/64⌉ words, 17.6 MB at that
// shape, written once, the kept rows' upper triangle read once) and by the
// scan's serial walk: one block per image, N/64 steps each ending in a
// block barrier.  Tiles that hold no kept row cost the scan nothing past
// the diagonal.

#include <stdint.h>

#include "common.cuh"
#include "nms_scan.cuh"

namespace {

using nms::kMaxBoxes;
using nms::kTile;
using nms::u64;

// bbox_overlaps(a, b) in mode "iou" with eps 1e-6, operation for operation.
__device__ __forceinline__ float box_iou(const float4 a, const float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                                 fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(denom, 1e-6f));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int N,
                int words, float thr) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y;
  if (col_tile < row_tile) return;  // every column before every row: never read
  const long long b = blockIdx.z;
  const float4* bx = boxes + b * N;
  __shared__ float4 cols[kTile];
  const int col0 = col_tile * kTile;
  const int ncol = min(kTile, N - col0);
  if (threadIdx.x < ncol) cols[threadIdx.x] = bx[col0 + threadIdx.x];
  __syncthreads();
  const int i = row_tile * kTile + threadIdx.x;
  if (i >= N) return;
  const float4 a = bx[i];
  u64 bits = 0;
  for (int t = col_tile == row_tile ? threadIdx.x + 1 : 0; t < ncol; ++t)
    if (box_iou(a, cols[t]) > thr) bits |= 1ull << t;
  mask[(b * N + i) * words + col_tile] = bits;
}

}  // namespace

// boxes (B, N, 4) fp32 and scores (B, N) fp32 in stable descending score
// order; mask (B, N, ⌈N/64⌉) 64-bit scratch; keep (B, N) bytes, 0 or 1.
extern "C" int mtp_nms(const void* boxes, const void* scores, void* mask, void* keep,
                       int B, int N, float thr, int dtype, void* stream) {
  if (dtype != mtp::kFloat32 || N <= 0 || N > kMaxBoxes || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, B), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), N, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms::nms_scan_kernel<<<B, nms::kScanThreads, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), N, words);
  return static_cast<int>(cudaGetLastError());
}
