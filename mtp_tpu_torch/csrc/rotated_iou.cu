// R1 — rotated IoU of (cx, cy, w, h, θ) boxes, one thread a pair, in two
// forms: the dense IoU matrix, and the suppression bitmask of greedy NMS
// followed by N1's scan.
//
// Port-only kernel: it replaces no pallas_call.  It takes the place of the
// lax loops of mtp_tpu/ops/nms.py `_nms_single_lane` (:122-168) when they
// run with `iou_fn=rbox_overlaps` (the rotated test NMS, tasks/detection.py
// :418-420), and of the jnp pair grid of mtp_tpu/ops/rotated_boxes.py
// `rbox_overlaps` / `_intersection_area` (:116-219), which XLA runs as
// (…, 24, 24) one-hot rank arrays: at the predict's 2,000 candidates an
// image one fp32 intermediate of that grid is ~1.2 GB a 128-row block at
// batch 2.
//
// The function of a pair (a, b) is `rbox_overlaps`' (ops/rotated_boxes.py):
// - the corners of each box, counter-clockwise (`_ccw`: reversed where the
//   signed shoelace area is negative);
// - the 24 candidates of the intersection polygon, in JAX's index order: the
//   4 corners of a inside b, the 4 of b inside a (inside: all four edge
//   cross products >= 0), the 16 crossings of a's edge i with b's edge j at
//   8 + 4i + j (parallel when |r×s| <= 1e-12; t, u in [0, 1]);
// - the valid candidates sorted by their angle about their centroid,
//   equal angles in index order (an insertion sort in registers and local
//   memory: JAX's rank order);
// - the shoelace over them, area 0 below 3;
// - IoU = inter / max(area_a + area_b − inter, 1e-6), area = w·h; IoF =
//   inter / max(area_a, 1e-6).
// Rounding differs from the plain version's: each pair is translated to
// a's centre before its corners are formed (the corners of a about (0, 0),
// those of b about (cx_b − cx_a, cy_b − cy_a)), and the shoelace runs on
// the candidates less their centroid.  After `class_offset_boxes` the
// centres reach ~5·10⁴ px, where fp32's spacing is ~4·10⁻³ px: the plain
// version's corners carry that error, the kernel's do not.  FMA contraction,
// sincosf and atan2f also round otherwise; chip_smoke.py phase 3g holds the
// kernel against the plain version in fp32 and in float64.
//
// Launches, on the current stream, no host round trip:
// - dense (`mtp_rbox_iou`): a (B, N, 5), b (B, M, 5) → out (B, N, M), a
//   thread per pair, 128 threads over b's boxes, a block's a box shared;
// - mask (`mtp_nms_rotated`): boxes (B, N, 5) in score order → N1's 64×64
//   tile layout (csrc/nms_scan.cuh), 256 threads a tile: 64 rows × 4
//   quarters of 16 columns, the tile's column boxes staged in shared memory,
//   a row's quarters ORed into its word in shared memory; tiles wholly
//   below the diagonal are skipped.  Then `nms_scan_kernel`, the same code
//   that N1 launches.
//
// What bounds it on the H100: operations.  The function needs a box's
// corners once (~81 fp32 operations, its edge vectors included); a pair's
// 16 crossings and its IoU (~309); its inside tests, each corner tested
// up to the first edge it lies outside of (6 an edge test); and, where
// the pair overlaps, its polygon: the centroid, the atan2s, the sort and
// the shoelace (~260 at the usual 8 vertices) (chip_smoke.py `r1_ops`).
// It reads 20 bytes a box and writes 4 bytes a pair (dense) or one bit
// (mask).  The kernel does more than that: it forms both quads of every
// pair (~146 operations a pair, for the translation), the candidate arrays
// live in local memory (a 288-byte frame, L1), and the branches diverge
// between pairs that overlap and pairs that do not.  The design stays
// simple: one pair a thread, no early exit for disjoint pairs (a box of
// zero area passes the inside test at every point of its line, which
// makes an exact early exit subtle).

#include <stdint.h>

#include "common.cuh"
#include "nms_scan.cuh"

namespace {

using nms::kMaxBoxes;
using nms::kTile;
using nms::u64;

constexpr int kDenseThreads = 128;
constexpr int kQuarters = 4;                        // column quarters of a mask tile
constexpr int kMaskThreads = kTile * kQuarters;
constexpr int kCandidates = 24;

struct Quad {
  float x[4], y[4];
};

// The corners of a box of centre (cx, cy), counter-clockwise.
__device__ __forceinline__ Quad corners(float cx, float cy, float w, float h, float t) {
  float s, c;
  sincosf(t, &s, &c);
  const float dx[4] = {-0.5f * w, 0.5f * w, 0.5f * w, -0.5f * w};
  const float dy[4] = {-0.5f * h, -0.5f * h, 0.5f * h, 0.5f * h};
  Quad q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.x[k] = cx + dx[k] * c - dy[k] * s;
    q.y[k] = cy + dx[k] * s + dy[k] * c;
  }
  float area2 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    area2 += q.x[k] * q.y[(k + 1) & 3] - q.x[(k + 1) & 3] * q.y[k];
  if (area2 < 0.f) {  // _ccw: reverse the order
    float tx = q.x[0], ty = q.y[0];
    q.x[0] = q.x[3]; q.y[0] = q.y[3]; q.x[3] = tx; q.y[3] = ty;
    tx = q.x[1]; ty = q.y[1];
    q.x[1] = q.x[2]; q.y[1] = q.y[2]; q.x[2] = tx; q.y[2] = ty;
  }
  return q;
}

// (px, py) inside the counter-clockwise quad q: every edge's cross >= 0.
__device__ __forceinline__ bool inside(float px, float py, const Quad& q) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float s = (q.x[f] - q.x[e]) * (py - q.y[e]) - (q.y[f] - q.y[e]) * (px - q.x[e]);
    if (!(s >= 0.f)) return false;
  }
  return true;
}

// The intersection area of two counter-clockwise quads.
__device__ float intersection_area(const Quad& A, const Quad& Bq) {
  float px[kCandidates], py[kCandidates];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (inside(A.x[k], A.y[k], Bq)) { px[n] = A.x[k]; py[n] = A.y[k]; ++n; }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (inside(Bq.x[k], Bq.y[k], A)) { px[n] = Bq.x[k]; py[n] = Bq.y[k]; ++n; }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float rx = A.x[(i + 1) & 3] - A.x[i], ry = A.y[(i + 1) & 3] - A.y[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sx = Bq.x[(j + 1) & 3] - Bq.x[j], sy = Bq.y[(j + 1) & 3] - Bq.y[j];
      const float rxs = rx * sy - ry * sx;
      const float qpx = Bq.x[j] - A.x[i], qpy = Bq.y[j] - A.y[i];
      const float safe = fabsf(rxs) < 1e-12f ? 1e-12f : rxs;
      const float t = (qpx * sy - qpy * sx) / safe;
      const float u = (qpx * ry - qpy * rx) / safe;
      if (fabsf(rxs) > 1e-12f && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f) {
        px[n] = A.x[i] + t * rx;
        py[n] = A.y[i] + t * ry;
        ++n;
      }
    }
  }
  if (n < 3) return 0.f;
  float cx = 0.f, cy = 0.f;
  for (int k = 0; k < n; ++k) { cx += px[k]; cy += py[k]; }
  cx /= n;
  cy /= n;
  float ang[kCandidates];
  for (int k = 0; k < n; ++k) {
    px[k] -= cx;
    py[k] -= cy;
    ang[k] = atan2f(py[k], px[k]);
  }
  // stable insertion sort by angle: equal angles keep their index order
  for (int k = 1; k < n; ++k) {
    const float a = ang[k], x = px[k], y = py[k];
    int j = k - 1;
    while (j >= 0 && ang[j] > a) {
      ang[j + 1] = ang[j]; px[j + 1] = px[j]; py[j + 1] = py[j];
      --j;
    }
    ang[j + 1] = a; px[j + 1] = x; py[j + 1] = y;
  }
  float twice = 0.f;
  for (int k = 0; k < n; ++k) {
    const int m = k + 1 < n ? k + 1 : 0;
    twice += px[k] * py[m] - px[m] * py[k];
  }
  return 0.5f * fabsf(twice);
}

// The IoU (or IoF) of rboxes a and b, b translated to a's centre.
__device__ __forceinline__ float rbox_iou(const float* a, const float* b, bool iof) {
  const Quad A = corners(0.f, 0.f, a[2], a[3], a[4]);
  const Quad Bq = corners(b[0] - a[0], b[1] - a[1], b[2], b[3], b[4]);
  const float inter = intersection_area(A, Bq);
  const float area_a = a[2] * a[3];
  const float denom = iof ? area_a : area_a + b[2] * b[3] - inter;
  return inter / fmaxf(denom, 1e-6f);
}

__global__ void __launch_bounds__(kDenseThreads)
rbox_iou_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int N, int M, int iof) {
  const int j = blockIdx.x * kDenseThreads + threadIdx.x;
  const long long img = blockIdx.z;
  if (j >= M) return;
  float bj[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) bj[k] = b[(img * M + j) * 5 + k];
  for (int i = blockIdx.y; i < N; i += gridDim.y) {
    float ai[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) ai[k] = a[(img * N + i) * 5 + k];
    out[(img * N + i) * M + j] = rbox_iou(ai, bj, iof != 0);
  }
}

__global__ void __launch_bounds__(kMaskThreads)
rbox_mask_kernel(const float* __restrict__ boxes, u64* __restrict__ mask, int N,
                 int words, float thr) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y;
  if (col_tile < row_tile) return;  // every column before every row: never read
  const long long img = blockIdx.z;
  const float* bx = boxes + img * N * 5;
  __shared__ float cols[kTile * 5];
  __shared__ u64 bits[kTile];
  const int col0 = col_tile * kTile;
  const int ncol = min(kTile, N - col0);
  for (int k = threadIdx.x; k < ncol * 5; k += kMaskThreads) cols[k] = bx[col0 * 5 + k];
  if (threadIdx.x < kTile) bits[threadIdx.x] = 0;
  __syncthreads();
  const int r = threadIdx.x % kTile, quarter = threadIdx.x / kTile;
  const int i = row_tile * kTile + r;
  if (i < N) {
    float ai[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) ai[k] = bx[i * 5 + k];
    const int t0 = quarter * (kTile / kQuarters);
    const int t1 = min(t0 + kTile / kQuarters, ncol);
    u64 mine = 0;
    for (int t = col_tile == row_tile ? max(t0, r + 1) : t0; t < t1; ++t)
      if (rbox_iou(ai, cols + t * 5, false) > thr) mine |= 1ull << t;
    if (mine) atomicOr(&bits[r], mine);
  }
  __syncthreads();
  if (threadIdx.x < kTile && row_tile * kTile + threadIdx.x < N)
    mask[(img * N + row_tile * kTile + threadIdx.x) * words + col_tile] = bits[threadIdx.x];
}

}  // namespace

// a (B, N, 5) and b (B, M, 5) fp32 → out (B, N, M) fp32: IoU, or IoF if iof.
extern "C" int mtp_rbox_iou(const void* a, const void* b, void* out, int B, int N, int M,
                            int iof, int dtype, void* stream) {
  if (dtype != mtp::kFloat32 || N <= 0 || N > kMaxBoxes || M <= 0 || M > kMaxBoxes ||
      B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kDenseThreads - 1) / kDenseThreads, N < 65535 ? N : 65535, B);
  rbox_iou_dense_kernel<<<grid, kDenseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      N, M, iof);
  return static_cast<int>(cudaGetLastError());
}

// boxes (B, N, 5) fp32 and scores (B, N) fp32 in stable descending score
// order; mask (B, N, ⌈N/64⌉) 64-bit scratch; keep (B, N) bytes, 0 or 1.
extern "C" int mtp_nms_rotated(const void* boxes, const void* scores, void* mask,
                               void* keep, int B, int N, float thr, int dtype,
                               void* stream) {
  if (dtype != mtp::kFloat32 || N <= 0 || N > kMaxBoxes || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rbox_mask_kernel<<<dim3(words, words, B), kMaskThreads, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<u64*>(mask), N, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms::nms_scan_kernel<<<B, nms::kScanThreads, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), N, words);
  return static_cast<int>(cudaGetLastError());
}
