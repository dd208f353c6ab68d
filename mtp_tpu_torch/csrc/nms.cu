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
//    of the upper triangle of an image's pairs, launched by a linear tile
//    index (csrc/nms_scan.cuh `tile_of`: no block below the diagonal), the
//    tile's column boxes and their areas staged in shared memory; thread i
//    sets bit t of word mask[b, row, col_tile] iff column col_tile·64 + t >
//    row and IoU(row, column) > thr.  The bits are exactly those of the
//    plain version (ops/nms.py `nms_mask_ref`, `bbox_overlaps` > thr): the
//    intersection, the areas and the union are `bbox_overlaps`' expression
//    in its order with every operation rounded on its own (__fadd_rn,
//    __fsub_rn, __fmul_rn: no contraction into an FMA moves a value), and
//    the test fl(inter / union) > thr is decided without the division
//    wherever inter lies outside thr·union·(1 ± 2⁻²⁰): fl(thr·(1 + 2⁻²⁰))
//    and fl(thr·(1 − 2⁻²⁰)) times the union are each off by at most two
//    roundings (2⁻²³ of the value), so inter above the first puts the
//    quotient ≥ thr·(1 + 2⁻²¹), which rounds above thr, and inter below the
//    second puts it below thr.  Only pairs inside that band, and every pair
//    of a threshold outside [1e-20, 1e20] (where a product could leave the
//    normal range), run __fdiv_rn.  A row's word of a tile past its own
//    also goes, as box indices, to the row's list (nms_scan.cuh
//    `append_later`).
// 2. nms_scan_kernel (csrc/nms_scan.cuh, shared with R1's rotated NMS): one
//    warp per image walks the rows 64 at a time and writes keep.
//
// What bounds it on the H100: the function reads 20 bytes a box and writes
// one, and computes one IoU (14 fp32 operations) for each pair whose first
// box is kept; at the RPN's shape (B = 2, N = 8,382) that is a few
// microseconds of either.  The mask kernel computes every upper-triangle
// pair (~10 operations where the boxes do not meet, which is most pairs) and
// writes the mask's B·N·⌈N/64⌉/2 words (8.8 MB at that shape) to L2; the
// scan is a chain of latencies, tile after tile (nms_scan.cuh), which reads
// the kept rows' lists and not their mostly zero words.

#include <stdint.h>

#include "common.cuh"
#include "nms_scan.cuh"

namespace {

using nms::kMaxBoxes;
using nms::kTile;
using nms::u64;

// 1 ± 2⁻²⁰, exact in fp32
constexpr float kAbove = 1.f + 1.f / 1048576.f;
constexpr float kBelow = 1.f - 1.f / 1048576.f;

// bbox_overlaps' box_area: clamp(x2 − x1, 0) · clamp(y2 − y1, 0).
__device__ __forceinline__ float box_area(const float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f), fmaxf(__fsub_rn(a.w, a.y), 0.f));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int* __restrict__ lists,
                int B, int N, int words, float thr) {
  int row_tile, col_tile;
  nms::tile_of(blockIdx.x, row_tile, col_tile);
  const long long b = blockIdx.y;
  const float4* bx = boxes + b * N;
  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int col0 = col_tile * kTile;
  const int ncol = min(kTile, N - col0);
  if (threadIdx.x < ncol) {
    const float4 c = bx[col0 + threadIdx.x];
    cols[threadIdx.x] = c;
    col_area[threadIdx.x] = box_area(c);
  }
  __syncthreads();
  const int i = row_tile * kTile + threadIdx.x;
  if (i >= N) return;
  const float4 a = bx[i];
  const float area_a = box_area(a);
  const bool fast = thr >= 1e-20f && thr <= 1e20f;
  const float thr_above = __fmul_rn(thr, kAbove), thr_below = __fmul_rn(thr, kBelow);
  u64 bits = 0;
  const int t0 = col_tile == row_tile ? threadIdx.x + 1 : 0;
#pragma unroll 4
  for (int t = t0; t < ncol; ++t) {
    const float4 c = cols[t];
    // bbox_overlaps(a, c) in mode "iou" with eps 1e-6, operation for operation
    const float w = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float denom = fmaxf(__fsub_rn(__fadd_rn(area_a, col_area[t]), inter), 1e-6f);
    // decided without the division outside the band (an empty intersection
    // lies below it)
    bool over;
    if (fast && inter > __fmul_rn(thr_above, denom))
      over = true;
    else if (fast && inter < __fmul_rn(thr_below, denom))
      over = false;
    else
      over = __fdiv_rn(inter, denom) > thr;
    if (over) bits |= 1ull << t;
  }
  mask[(b * N + i) * words + col_tile] = bits;
  if (col_tile != row_tile) nms::append_later(lists, B, words, b, i, col0, bits);
}

}  // namespace

// boxes (B, N, 4) fp32 and scores (B, N) fp32 in stable descending score
// order; mask (B, N, ⌈N/64⌉) 64-bit scratch; lists the scan's int32 scratch
// (nms_scan.cuh); keep (B, N) bytes, 0 or 1.
extern "C" int mtp_nms(const void* boxes, const void* scores, void* mask, void* lists,
                       void* keep, int B, int N, float thr, int dtype, void* stream) {
  if (dtype != mtp::kFloat32 || N <= 0 || N > kMaxBoxes || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* lst = static_cast<int*>(lists);
  cudaError_t err = cudaMemsetAsync(nms::list_count(lst, B, words, 0, 0), 0,
                                    sizeof(int) * B * words * kTile, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_kernel<<<dim3(nms::upper_tiles(words), B), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), lst, B, N, words, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms::nms_scan_kernel<<<B, nms::kWarp, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const float*>(scores), lst,
      static_cast<uint8_t*>(keep), B, N, words);
  return static_cast<int>(cudaGetLastError());
}
