// The greedy scan of a suppression bitmask, shared by N1 (csrc/nms.cu,
// horizontal boxes) and R1's mask form (csrc/rotated_iou.cu, rotated boxes),
// and the mask's layout, which both mask kernels write.
//
// Layout: for each image b of a batch, boxes in stable descending score
// order, mask[b, i, w] is a 64-bit word whose bit t says that box i
// suppresses box w·64 + t: set iff w·64 + t > i and IoU(i, w·64 + t) > thr.
// Only the words at or past a row's own tile (w >= i / 64) are written and
// read.
//
// nms_scan_kernel: one block per image walks the rows 64 at a time.  The
// "removed" bits of all N boxes live in shared memory (N/64 words).  For
// each 64-row tile, thread 0 runs the greedy rule over its rows with the
// tile's diagonal words staged in shared memory (64 register steps), and the
// whole block then ORs the kept rows' words past the tile into the removed
// bits (a shared-memory atomicOr per word, rows and words spread over the
// threads).  It writes keep[b, i] = 1 for a box that is valid (score >
// NEG_INF / 2 = -5e9) and not removed by a kept earlier box.
#pragma once

#include <stdint.h>

namespace nms {

constexpr int kTile = 64;                  // boxes per tile side; bits per word
constexpr int kMaxBoxes = 1 << 16;         // the scan's removed bits: 8 KB of shared memory
constexpr int kMaxWords = kMaxBoxes / kTile;
constexpr int kScanThreads = 256;
constexpr float kValidMin = -5e9f;         // NEG_INF / 2

typedef unsigned long long u64;

namespace {

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int N, int words) {
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 diag[kTile];
  __shared__ float tile_scores[kTile];
  __shared__ int kept_rows[kTile];
  __shared__ int n_kept;
  const long long b = blockIdx.x;
  const u64* mk = mask + b * N * words;
  const float* sc = scores + b * N;
  uint8_t* kp = keep + b * N;
  const int tid = threadIdx.x;
  for (int w = tid; w < words; w += kScanThreads) removed[w] = 0;
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int row0 = w * kTile;
    const int nrow = min(kTile, N - row0);
    if (tid < nrow) {
      diag[tid] = mk[static_cast<long long>(row0 + tid) * words + w];
      tile_scores[tid] = sc[row0 + tid];
    }
    __syncthreads();
    if (tid == 0) {  // the greedy rule over the tile's rows, in order
      u64 cur = removed[w], kept = 0;
      int n = 0;
      for (int r = 0; r < nrow; ++r) {
        if (!((cur >> r) & 1ull) && tile_scores[r] > kValidMin) {
          kept |= 1ull << r;
          cur |= diag[r];
          kept_rows[n++] = r;
        }
      }
      n_kept = n;
      removed[w] = cur;
    }
    __syncthreads();
    if (tid < nrow) kp[row0 + tid] = (removed[w] >> tid) & 1ull ? 0 : tile_scores[tid] > kValidMin;
    // the kept rows suppress their later tiles: (row, word) pairs over the
    // threads, neighbouring threads on neighbouring words of one row
    const int nk = n_kept, later = words - w - 1;
#pragma unroll 4
    for (int p = tid; p < nk * later; p += kScanThreads) {
      const int r = kept_rows[p / later], j = w + 1 + p % later;
      const u64 bits = mk[static_cast<long long>(row0 + r) * words + j];
      if (bits) atomicOr(&removed[j], bits);
    }
    __syncthreads();
  }
}

}  // namespace

}  // namespace nms
