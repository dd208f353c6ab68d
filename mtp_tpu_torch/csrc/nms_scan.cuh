// The greedy scan of a suppression bitmask, shared by N1 (csrc/nms.cu,
// horizontal boxes) and R1's mask form (csrc/rotated_iou.cu, rotated boxes),
// the mask's layout, which both mask kernels write, the lists of later boxes
// they write beside it, and the order in which both launch the mask's tiles.
//
// Layout: for each image b of a batch, boxes in stable descending score
// order, mask[b, i, w] is a 64-bit word whose bit t says that box i
// suppresses box w·64 + t: set iff w·64 + t > i and IoU(i, w·64 + t) > thr.
// Only the words at or past a row's own tile (w >= i / 64) are written and
// read.  The mask kernels launch one block per tile of the upper triangle,
// by a linear index (`tile_of`), and none below it.
//
// Lists (int32 scratch of B·⌈N/64⌉·64·(kListCap + 1) ints, 16-byte
// aligned): beside the words, each row's boxes in later tiles that it
// suppresses, as indices: up to kListCap a row, in no order, slot-major
// within a tile ([b][tile][slot][64 rows], `list_slot`), then each row's
// count ([b][row], zeroed by the launcher before the mask kernel; a mask
// kernel adds a word's bits with one atomicAdd and writes them to the slots
// it gets, those below kListCap).  A row whose count passes kListCap is
// read from its words.
//
// nms_scan_kernel: one warp per image walks the rows 64 at a time and writes
// keep[b, i] = 1 for a box that is valid (score > NEG_INF / 2 = -5e9) and
// not removed by a kept earlier box.
//
// What bounds it on the H100: the walk is serial, tile after tile, and each
// tile's decision waits on the previous tiles' kept rows; the bytes (the
// kept rows' lists, a few hundred KB from L2) and the operations are
// microseconds.  So the time is the chain of latencies a tile puts on the
// critical path.  The design keeps that chain short:
// - one warp, no block barrier: the warp's lanes share the state through
//   shuffles, ballots and the warp's own shared memory (`__syncwarp` only);
// - what a tile needs that no decision changes is fetched a tile ahead: its
//   rows' diagonal words and scores into registers (lane l holds rows l and
//   l + 32), their lists and counts into one half of a shared double buffer
//   by `cp.async` (8.25 KB a tile);
// - the greedy rule by find-first-set over the tile's live rows (valid and
//   not removed): the live rows that suppress no row of the tile are kept
//   at once, and each live row that does is one iteration (its diagonal
//   word shuffled from the lane that holds it), so a tile costs the rows
//   that decide something, not 64 serial steps;
// - a kept row removes its later boxes through its list, one 32-bit
//   shared-memory atomicOr a box, the kept rows' entries spread evenly over
//   the lanes (a warp prefix sum of the rows' counts), so a tile costs its
//   entries / 32, not its longest list.  Most rows suppress a few boxes,
//   scattered over the later tiles: their words are mostly zeros, and
//   reading all of them (as the fallback does, for a row past kListCap)
//   costs ~kept · N/128 words an image through one warp's loads.
#pragma once

#include <stdint.h>

#include "tensor_core.cuh"

namespace nms {

constexpr int kTile = 64;                  // boxes per tile side; bits per word
constexpr int kMaxBoxes = 1 << 16;         // the scan's removed bits: 8 KB of shared memory
constexpr int kMaxWords = kMaxBoxes / kTile;
constexpr int kWarp = 32;
constexpr int kListCap = 32;               // later boxes a row's list holds
constexpr int kScanBatch = 16;             // the fallback's loads in flight a lane
constexpr int kApplyBatch = 4;             // list entries a lane reads before their atomics
constexpr float kValidMin = -5e9f;         // NEG_INF / 2

typedef unsigned long long u64;

namespace {

// The (row tile, column tile) of linear tile t of an image's upper triangle,
// column by column: t = c·(c + 1)/2 + r, r <= c.
__device__ __forceinline__ void tile_of(int t, int& row_tile, int& col_tile) {
  int c = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (c * (c + 1) / 2 > t) --c;
  while ((c + 1) * (c + 2) / 2 <= t) ++c;
  col_tile = c;
  row_tile = t - c * (c + 1) / 2;
}

// Tiles of the upper triangle of an image of `words` tiles a side.
__host__ __device__ __forceinline__ int upper_tiles(int words) {
  return words * (words + 1) / 2;
}

// The count of row `row` of image b, and its list's slot s.
__host__ __device__ __forceinline__ int* list_count(int* lists, int B, int words, long long b,
                                                    int row) {
  return lists + static_cast<long long>(B) * words * kTile * kListCap + b * words * kTile + row;
}
__host__ __device__ __forceinline__ int* list_slot(int* lists, int words, long long b, int row,
                                                   int s) {
  return lists + ((b * words + row / kTile) * kListCap + s) * kTile + row % kTile;
}

// Bits lo and hi of the lanes, lane l at bits l and l + 32.
__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return static_cast<u64>(__ballot_sync(0xffffffffu, lo)) |
         static_cast<u64>(__ballot_sync(0xffffffffu, hi)) << kWarp;
}

// Rows lane and lane + 32 of tile w: their diagonal words and scores (a row
// past N: no bits, invalid).
struct TileRows {
  u64 diag0, diag1;
  float s0, s1;
};

__device__ __forceinline__ TileRows load_tile(const u64* mk, const float* sc, int N,
                                              int words, int w, int lane) {
  const int r0 = w * kTile + lane, r1 = r0 + kWarp;
  TileRows t;
  t.diag0 = r0 < N ? mk[static_cast<long long>(r0) * words + w] : 0ull;
  t.diag1 = r1 < N ? mk[static_cast<long long>(r1) * words + w] : 0ull;
  t.s0 = r0 < N ? sc[r0] : kValidMin;
  t.s1 = r1 < N ? sc[r1] : kValidMin;
  return t;
}

// Tile w's lists and counts into a buffer: 8 KB and 256 bytes, contiguous
// (`entries` image b's first tile, `counts` its first row's count).
__device__ __forceinline__ void fetch_lists(int* buf_list, int* buf_count, const int* entries,
                                            const int* counts, int w, int lane) {
  const int* src = entries + static_cast<long long>(w) * kTile * kListCap;
#pragma unroll
  for (int k = 0; k < kTile * kListCap / 4 / kWarp; ++k) {
    const int q = (k * kWarp + lane) * 4;
    mtp::cp_async16(buf_list + q, src + q, true);
  }
  if (lane < kTile / 4) mtp::cp_async16(buf_count + lane * 4, counts + w * kTile + lane * 4, true);
  mtp::cp_async_commit();
}

__global__ void __launch_bounds__(kWarp)
nms_scan_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                int* __restrict__ lists, uint8_t* __restrict__ keep, int B, int N, int words) {
  // the removed bits, box j at bit j % 32 of word j / 32: tile w's u64 word
  // is words 2w (low half) and 2w + 1
  __shared__ unsigned removed[2 * kMaxWords];
  __shared__ __align__(16) int buf_list[2][kTile * kListCap];
  __shared__ __align__(16) int buf_count[2][kTile];
  __shared__ int dense_rows[kTile];
  __shared__ uint16_t slots[kTile * kListCap];  // the kept rows' list slots, flattened
  const long long b = blockIdx.x;
  const u64* mk = mask + b * N * words;
  const float* sc = scores + b * N;
  const int* entries = list_slot(lists, words, b, 0, 0);
  const int* counts = list_count(lists, B, words, b, 0);
  uint8_t* kp = keep + b * N;
  const int lane = threadIdx.x;
  for (int j = lane; j < 2 * words; j += kWarp) removed[j] = 0;
  fetch_lists(buf_list[0], buf_count[0], entries, counts, 0, lane);
  TileRows cur = load_tile(mk, sc, N, words, 0, lane);
  for (int w = 0; w < words; ++w) {
    mtp::cp_async_wait<0>();
    __syncwarp();
    if (w + 1 < words)
      fetch_lists(buf_list[(w + 1) & 1], buf_count[(w + 1) & 1], entries, counts, w + 1, lane);
    const TileRows next = w + 1 < words ? load_tile(mk, sc, N, words, w + 1, lane) : cur;
    // the greedy rule over the tile's live rows, in order: the quiet ones
    // (no bit in their diagonal word) kept as they come, each loud one kept
    // and its diagonal word applied
    const u64 quiet = ballot64(cur.diag0 == 0, cur.diag1 == 0);
    const u64 gone = static_cast<u64>(removed[2 * w + 1]) << kWarp | removed[2 * w];
    u64 live = ballot64(cur.s0 > kValidMin, cur.s1 > kValidMin) & ~gone;
    u64 kept = 0;
    while (live) {
      const u64 loud = live & ~quiet;
      if (!loud) {
        kept |= live;
        break;
      }
      const int r = __ffsll(static_cast<long long>(loud)) - 1;
      const u64 upto = (2ull << r) - 1;  // rows 0..r (all ones at r = 63)
      kept |= live & upto;
      const u64 d = __shfl_sync(0xffffffffu, r < kWarp ? cur.diag0 : cur.diag1, r & (kWarp - 1));
      live &= ~upto & ~d;
    }
    const int row0 = w * kTile;
    if (row0 + lane < N) kp[row0 + lane] = (kept >> lane) & 1ull;
    if (row0 + kWarp + lane < N) kp[row0 + kWarp + lane] = (kept >> (kWarp + lane)) & 1ull;
    // the kept rows remove their later boxes through their lists (lane l
    // holds rows l and l + 32); rows past kListCap go to their words
    const int* lst = buf_list[w & 1];
    const int* cnt = buf_count[w & 1];
    const bool later = w + 1 < words;
    const int c0 = later && (kept >> lane) & 1ull ? cnt[lane] : 0;
    const int c1 = later && (kept >> (kWarp + lane)) & 1ull ? cnt[kWarp + lane] : 0;
    const u64 dense = ballot64(c0 > kListCap, c1 > kListCap);
    const int n0 = c0 > kListCap ? 0 : c0, n1 = c1 > kListCap ? 0 : c1;
    // the lists' slots spread evenly over the lanes: each slot's position
    // in the buffer written at its place in the rows' running sum (rows
    // 0..63), then read back a lane each
    int inc0 = n0, inc1 = n1;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v0 = __shfl_up_sync(0xffffffffu, inc0, o);
      const int v1 = __shfl_up_sync(0xffffffffu, inc1, o);
      if (lane >= o) {
        inc0 += v0;
        inc1 += v1;
      }
    }
    const int total0 = __shfl_sync(0xffffffffu, inc0, kWarp - 1);
    const int total = total0 + __shfl_sync(0xffffffffu, inc1, kWarp - 1);
    for (int k = 0; k < n0; ++k) slots[inc0 - n0 + k] = k * kTile + lane;
    for (int k = 0; k < n1; ++k) slots[total0 + inc1 - n1 + k] = k * kTile + kWarp + lane;
    __syncwarp();
    for (int e0 = 0; e0 < total; e0 += kWarp * kApplyBatch) {
      int j[kApplyBatch];  // the batch's reads before its atomics
#pragma unroll
      for (int u = 0; u < kApplyBatch; ++u) {
        const int e = e0 + u * kWarp + lane;
        j[u] = e < total ? lst[slots[e]] : -1;
      }
#pragma unroll
      for (int u = 0; u < kApplyBatch; ++u)
        if (j[u] >= 0) atomicOr(&removed[j[u] >> 5], 1u << (j[u] & 31));
    }
    if (dense) {  // (row, 32-word chunk) pairs, lane l on word w + 1 + 32·chunk + l
      if ((dense >> lane) & 1ull)
        dense_rows[__popcll(dense & ((1ull << lane) - 1))] = lane;
      if ((dense >> (kWarp + lane)) & 1ull)
        dense_rows[__popcll(dense & ((1ull << (kWarp + lane)) - 1))] = kWarp + lane;
      __syncwarp();
      const int chunks = (words - w - 1 + kWarp - 1) / kWarp;
      const int pairs = __popcll(dense) * chunks;
      for (int p0 = 0; p0 < pairs; p0 += kScanBatch) {
        u64 bits[kScanBatch];
        int word[kScanBatch];
        int i = p0 / chunks, c = p0 - i * chunks;
#pragma unroll
        for (int u = 0; u < kScanBatch; ++u) {
          word[u] = w + 1 + c * kWarp + lane;
          const bool load = p0 + u < pairs && word[u] < words;
          bits[u] = load ? mk[static_cast<long long>(row0 + dense_rows[i]) * words + word[u]]
                         : 0ull;
          if (++c == chunks) {
            c = 0;
            i = min(i + 1, kTile - 1);
          }
        }
#pragma unroll
        for (int u = 0; u < kScanBatch; ++u) {
          if (bits[u]) {  // the word's lane owns both its halves
            removed[2 * word[u]] |= static_cast<unsigned>(bits[u]);
            removed[2 * word[u] + 1] |= static_cast<unsigned>(bits[u] >> kWarp);
          }
        }
      }
    }
    __syncwarp();
    cur = next;
  }
}

// A mask kernel's word of row i (image b) for column tile col_tile past the
// row's own: its boxes appended to the row's list.
__device__ __forceinline__ void append_later(int* lists, int B, int words, long long b, int i,
                                             int col0, u64 bits) {
  if (!bits) return;
  int slot = atomicAdd(list_count(lists, B, words, b, i), __popcll(bits));
  for (; bits && slot < kListCap; bits &= bits - 1, ++slot)
    *list_slot(lists, words, b, i, slot) = col0 + __ffsll(static_cast<long long>(bits)) - 1;
}

}  // namespace

}  // namespace nms
