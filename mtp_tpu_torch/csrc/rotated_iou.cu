// R1 — rotated IoU of (cx, cy, w, h, θ) boxes, in two forms: the dense IoU
// matrix, and the suppression bitmask of greedy NMS followed by N1's scan.
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
//   equal angles in index order (JAX's rank order);
// - the shoelace over them, area 0 below 3;
// - IoU = inter / max(area_a + area_b − inter, 1e-6), area = w·h; IoF =
//   inter / max(area_a, 1e-6).
// Rounding differs from the plain version's: each pair is translated to
// a's centre before its corners are formed (the corners of a about (0, 0),
// those of b about (cx_b − cx_a, cy_b − cy_a)), and the shoelace runs on
// the candidates less their centroid.  After `class_offset_boxes` the
// centres reach ~5·10⁴ px, where fp32's spacing is ~4·10⁻³ px: the plain
// version's corners carry that error, the kernel's do not.  FMA contraction
// (in the crossing points and the shoelace), sincosf and atan2f also round
// otherwise; chip_smoke.py phase 3g holds the kernel against the plain
// version in fp32 and in float64.  The corners and the cross products of the
// inside tests and of the crossings' parameters are rounded operation by
// operation, as the plain version's: the candidate method is exact only
// where equal boxes get equal corners and a corner on an edge gets a cross
// product of exactly 0; one ulp either way drops vertices of the polygon
// (two equal boxes at IoU 1/3, or ~0).
//
// The early exit (`apart`, whose plain version is ops/rotated_boxes.py
// `rbox_apart`, operation for operation): a pair of boxes that both have
// positive area (w > 0 and h > 0) and whose centres lie farther apart than
// the sum of their half-diagonals plus a margin, 1e-4 of (|dx| + |dy| + the
// sum), gets IoU 0 with no corners, crossings, inside tests or polygon.
// Each box lies within its half-diagonal of its centre, so the two are
// disjoint by at least the margin, and the corners, cross products and
// crossing parameters that the full path would compute carry rounding
// errors of a few fp32 ulps of that same scale (~1e-6 of it): none of the
// candidates can come out valid, and the full path returns 0 as well.  A
// box of zero area always takes the full path: its inside test passes all
// along its line.
//
// Launches, on the current stream, no host round trip:
// - dense (`mtp_rbox_iou`): a (B, N, 5), b (B, M, 5) → out (B, N, M), a
//   thread per pair, 128 threads over b's boxes (each box's sincos and
//   half-diagonal formed once a thread), a block's a box and its corners
//   formed once into shared memory;
// - mask (`mtp_nms_rotated`): boxes (B, N, 5) in score order → N1's 64×64
//   tile layout (csrc/nms_scan.cuh), one block of 8 warps per tile of the
//   upper triangle (the linear tile index N1 uses): the tile's 128 boxes
//   and its rows' corners formed once into shared memory; the separation
//   test over the tile's 4,096 pairs, the pairs it lets through queued in
//   shared memory (one atomicAdd a warp); the queue computed by
//   consecutive threads, each set bit an atomicOr on its row's word in
//   shared memory; the words written, and each row's bits past its own
//   tile appended to its list.  Then `nms_scan_kernel`, the same code that
//   N1 launches.
//
// What bounds it on the H100: operations.  The function needs, with the
// early exit, a box's corners once (~81 fp32 operations, its edge vectors
// included) and its half-diagonal (~10); every pair's separation test (15);
// the 16 crossings and the IoU (~309), the inside tests (6 an edge test,
// each corner tested up to the first edge it lies outside of) only for the
// pairs the test lets through; and, where the pair overlaps, its polygon:
// the centroid, the atan2s, the sort and the shoelace (~260 at the usual 8
// vertices) (chip_smoke.py `r1_ops`).  It reads 20 bytes a box and writes 4
// bytes a pair (dense) or one bit (mask).  At the predict's shape ~99% of
// pairs (different classes after `class_offset_boxes`) exit at once.  A
// pair let through costs far more than one that exits, so in the mask form
// a warp that met one among its 64 pairs ran its full path for one lane
// while 31 waited (a third of the warps at the predict's shape): the queue
// gives those pairs to consecutive threads instead.  The kernel still forms
// both quads of every pair it lets through (~146 operations a pair, for the
// translation), and computes the crossing parameters only where the test
// before them passed and crosses no zero-length edge (the padded gts of
// the assigner have four), decisions unchanged.  The candidate polygon
// stays in a local-memory frame (288 bytes, L1): held in registers instead
// (8 fixed slots, fully unrolled, a 24-slot fallback), it takes 159-170
// registers against 56-64, and the dense form at the assigner's shape runs
// ~1.5x slower on an H100 (PERF.md).

#include <stdint.h>

#include "common.cuh"
#include "nms_scan.cuh"

namespace {

using nms::kMaxBoxes;
using nms::kTile;
using nms::kWarp;
using nms::u64;

constexpr int kDenseThreads = 128;
constexpr int kMaskWarps = 8;                       // warps of a mask block
constexpr int kMaskThreads = kMaskWarps * kWarp;
constexpr int kCandidates = 24;
constexpr float kApartMargin = 1e-4f;

// A box with what every pair of it needs: sin θ, cos θ, the half-diagonal.
struct RBox {
  float cx, cy, w, h, s, c, reach;
};

__device__ __forceinline__ RBox rbox(const float* p) {
  RBox r;
  r.cx = p[0];
  r.cy = p[1];
  r.w = p[2];
  r.h = p[3];
  sincosf(p[4], &r.s, &r.c);
  r.reach = __fmul_rn(0.5f, __fsqrt_rn(__fadd_rn(__fmul_rn(r.w, r.w), __fmul_rn(r.h, r.h))));
  return r;
}

// The early exit: a and b of positive area, farther apart than they reach
// plus the margin; every operation rounded on its own, as `rbox_apart`.
__device__ __forceinline__ bool apart(const RBox& a, const RBox& b) {
  if (!(a.w > 0.f && a.h > 0.f && b.w > 0.f && b.h > 0.f)) return false;
  const float dx = __fsub_rn(b.cx, a.cx), dy = __fsub_rn(b.cy, a.cy);
  const float reach = __fadd_rn(a.reach, b.reach);
  const float gap = __fadd_rn(
      reach, __fmul_rn(kApartMargin, __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), reach)));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > __fmul_rn(gap, gap);
}

struct Quad {
  float x[4], y[4];
};

// The corners of a box of centre (cx, cy), counter-clockwise: the plain
// version's (cx + dx·cos) − dy·sin and (cy + dx·sin) + dy·cos, each operation
// rounded on its own, so that two equal boxes get equal corners whatever
// the compiler makes of a centre it knows to be 0.
__device__ __forceinline__ Quad corners(float cx, float cy, float w, float h, float s,
                                        float c) {
  const float dx[4] = {-0.5f * w, 0.5f * w, 0.5f * w, -0.5f * w};
  const float dy[4] = {-0.5f * h, -0.5f * h, 0.5f * h, 0.5f * h};
  Quad q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.x[k] = __fsub_rn(__fadd_rn(cx, __fmul_rn(dx[k], c)), __fmul_rn(dy[k], s));
    q.y[k] = __fadd_rn(__fadd_rn(cy, __fmul_rn(dx[k], s)), __fmul_rn(dy[k], c));
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
    const float s = __fsub_rn(__fmul_rn(q.x[f] - q.x[e], py - q.y[e]),
                              __fmul_rn(q.y[f] - q.y[e], px - q.x[e]));
    if (!(s >= 0.f)) return false;
  }
  return true;
}

// The edge vectors of a quad, corner k to corner k + 1.
struct Edges {
  float x[4], y[4];
};

__device__ __forceinline__ Edges edges(const Quad& q) {
  Edges e;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e.x[k] = q.x[(k + 1) & 3] - q.x[k];
    e.y[k] = q.y[(k + 1) & 3] - q.y[k];
  }
  return e;
}

// The crossing of A's edge i (vector r) with B's edge j (vector s): valid
// (not parallel, |r×s| > 1e-12, and t, u in [0, 1]), and the point.  The
// divisions run only where the test before them passed, which leaves every
// decision as it was.
__device__ __forceinline__ bool crossing(const Quad& A, const Edges& ea, const Quad& Bq,
                                         const Edges& eb, int i, int j, float& x, float& y) {
  const float rx = ea.x[i], ry = ea.y[i], sx = eb.x[j], sy = eb.y[j];
  const float rxs = __fsub_rn(__fmul_rn(rx, sy), __fmul_rn(ry, sx));
  if (!(fabsf(rxs) > 1e-12f)) return false;
  const float qpx = Bq.x[j] - A.x[i], qpy = Bq.y[j] - A.y[i];
  const float t = __fsub_rn(__fmul_rn(qpx, sy), __fmul_rn(qpy, sx)) / rxs;
  if (!(t >= 0.f && t <= 1.f)) return false;
  const float u = __fsub_rn(__fmul_rn(qpx, ry), __fmul_rn(qpy, rx)) / rxs;
  if (!(u >= 0.f && u <= 1.f)) return false;
  x = A.x[i] + t * rx;
  y = A.y[i] + t * ry;
  return true;
}

// A zero-length edge is parallel to every edge (r×s is exactly 0, or NaN
// past an infinite coordinate): it crosses none.
__device__ __forceinline__ bool zero_edge(const Edges& e, int k) {
  return e.x[k] == 0.f && e.y[k] == 0.f;
}

// The intersection area of two counter-clockwise quads: the valid
// candidates in index order (corners, then crossings; a zero-length edge
// crosses nothing), less their centroid, sorted by angle (a stable
// insertion sort: equal angles in index order), reduced with the shoelace.
__device__ __forceinline__ float intersection_area(const Quad& A, const Quad& Bq) {
  float px[kCandidates], py[kCandidates];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (inside(A.x[k], A.y[k], Bq)) { px[n] = A.x[k]; py[n] = A.y[k]; ++n; }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (inside(Bq.x[k], Bq.y[k], A)) { px[n] = Bq.x[k]; py[n] = Bq.y[k]; ++n; }
  const Edges ea = edges(A), eb = edges(Bq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (zero_edge(ea, i)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x, y;
      if (!zero_edge(eb, j) && crossing(A, ea, Bq, eb, i, j, x, y)) {
        px[n] = x;
        py[n] = y;
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

// The IoU (or IoF) of rboxes a and b that the early exit let through, A the
// corners of a about its own centre, b translated to a's centre.
__device__ __forceinline__ float rbox_iou(const RBox& a, const Quad& A, const RBox& b,
                                          bool iof) {
  const Quad Bq = corners(b.cx - a.cx, b.cy - a.cy, b.w, b.h, b.s, b.c);
  const float inter = intersection_area(A, Bq);
  const float area_a = a.w * a.h;
  const float denom = iof ? area_a : area_a + b.w * b.h - inter;
  return inter / fmaxf(denom, 1e-6f);
}

// a's corners about its own centre.
__device__ __forceinline__ Quad own_corners(const RBox& a) {
  return corners(0.f, 0.f, a.w, a.h, a.s, a.c);
}

__global__ void __launch_bounds__(kDenseThreads)
rbox_iou_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int N, int M, int iof) {
  __shared__ RBox sa;
  __shared__ Quad sA;
  const int j = blockIdx.x * kDenseThreads + threadIdx.x;
  const long long img = blockIdx.z;
  const RBox bj = rbox(b + (img * M + min(j, M - 1)) * 5);
  for (int i = blockIdx.y; i < N; i += gridDim.y) {
    __syncthreads();  // the previous row's readers are done
    if (threadIdx.x == 0) {
      sa = rbox(a + (img * N + i) * 5);
      sA = own_corners(sa);
    }
    __syncthreads();
    if (j < M)
      out[(img * N + i) * M + j] = apart(sa, bj) ? 0.f : rbox_iou(sa, sA, bj, iof != 0);
  }
}

__global__ void __launch_bounds__(kMaskThreads)
rbox_mask_kernel(const float* __restrict__ boxes, u64* __restrict__ mask,
                 int* __restrict__ lists, int B, int N, int words, float thr) {
  int row_tile, col_tile;
  nms::tile_of(blockIdx.x, row_tile, col_tile);
  const long long img = blockIdx.y;
  const float* bx = boxes + img * N * 5;
  __shared__ RBox rows[kTile], cols[kTile];
  __shared__ Quad row_quads[kTile];
  __shared__ u64 bits[kTile];
  __shared__ uint16_t queue[kTile * kTile];
  __shared__ int queued;
  const int row0 = row_tile * kTile, col0 = col_tile * kTile;
  const int nrow = min(kTile, N - row0), ncol = min(kTile, N - col0);
  const int tid = threadIdx.x, lane = tid % kWarp;
  if (tid < nrow) {
    rows[tid] = rbox(bx + (row0 + tid) * 5);
    row_quads[tid] = own_corners(rows[tid]);
  } else if (tid >= kTile && tid < kTile + ncol) {
    cols[tid - kTile] = rbox(bx + (col0 + tid - kTile) * 5);
  }
  if (tid < kTile) bits[tid] = 0;
  if (tid == 0) queued = 0;
  __syncthreads();
  // the separation test over the tile's pairs; the pairs it lets through
  // queued, a warp's with one atomicAdd
  const bool diag = row_tile == col_tile;
  for (int p0 = 0; p0 < kTile * kTile; p0 += kMaskThreads) {
    const int p = p0 + tid, r = p / kTile, c = p % kTile;
    const bool through = r < nrow && c < ncol && (!diag || c > r) && !apart(rows[r], cols[c]);
    const unsigned votes = __ballot_sync(0xffffffffu, through);
    if (votes) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&queued, __popc(votes));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (through) queue[base + __popc(votes & ((1u << lane) - 1))] = static_cast<uint16_t>(p);
    }
  }
  __syncthreads();
  // the full computation of the queued pairs, by consecutive threads
  for (int q = tid; q < queued; q += kMaskThreads) {
    const int p = queue[q], r = p / kTile, c = p % kTile;
    if (rbox_iou(rows[r], row_quads[r], cols[c], false) > thr)
      atomicOr(&bits[r], 1ull << c);
  }
  __syncthreads();
  if (tid < nrow) {
    mask[(img * N + row0 + tid) * words + col_tile] = bits[tid];
    if (!diag) nms::append_later(lists, B, words, img, row0 + tid, col0, bits[tid]);
  }
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
// order; mask (B, N, ⌈N/64⌉) 64-bit scratch; lists the scan's int32 scratch
// (nms_scan.cuh); keep (B, N) bytes, 0 or 1.
extern "C" int mtp_nms_rotated(const void* boxes, const void* scores, void* mask,
                               void* lists, void* keep, int B, int N, float thr, int dtype,
                               void* stream) {
  if (dtype != mtp::kFloat32 || N <= 0 || N > kMaxBoxes || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* lst = static_cast<int*>(lists);
  cudaError_t err = cudaMemsetAsync(nms::list_count(lst, B, words, 0, 0), 0,
                                    sizeof(int) * B * words * kTile, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rbox_mask_kernel<<<dim3(nms::upper_tiles(words), B), kMaskThreads, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<u64*>(mask), lst, B, N, words, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms::nms_scan_kernel<<<B, nms::kWarp, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const float*>(scores), lst,
      static_cast<uint8_t*>(keep), B, N, words);
  return static_cast<int>(cudaGetLastError());
}
