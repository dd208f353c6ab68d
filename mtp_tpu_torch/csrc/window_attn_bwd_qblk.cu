// K7 — window attention, q-blocked backward, for windows too large for K4.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_win_backward_qblocked`
// (pallas_call at :271; kernel body `_win_bwd_qblk_kernel` :198-246), which
// `_fused_backward` takes at pack = 1 when round_up(N, 8) > 512 (:302-303).
// The port also takes it for the windows of JAX's one-shot range whose K4
// block (csrc/window_attn_bwd.cu: the whole window and two N×N tiles in
// shared memory) exceeds the 227 KB of one block — above N ≈ 117 at D = 64.
// Its forward is always K1L (csrc/window_attn_fwd_large.cu), whose output
// and per-row log-sum-exp it takes.  Its one caller on the main path is the
// backward of the ViT's full attention over grids wider than 128 tokens per
// axis: one window of N = H·W tokens, N = 16,900 at a 2080² input.
//
// Computes, per (window w, head h), for the output cotangent dO, the VJP of
// K1/K1L (the TPU kernel's :213-246) from the forward's out O and lse:
//     s = q·k^T · scale + bias,  P = exp(s − lse),  dP = dO · v^T,
//     delta = rowsum(dO ∘ O) (= rowsum(P ∘ dP), since O = P·V),
//     dS = P ∘ (dP − delta),
//     dQ = dS · k · scale,  dK = dS^T · q · scale,  dV = P^T · dO,  dbias = dS
// q/k/v/O/dO (W, nH, N, D) fp32 or bf16 with D <= 128, bias (W, nH, N, N)
// fp32, lse (W·nH, N) fp32; dQ/dK/dV in q's dtype, dbias fp32.
//
// What bounds it on the H100: the bias is read and dbias written, 8·N²
// bytes per (window, head) — 36.6 GB at nH = 16, N = 16,900, 10.9 ms at
// 3.35 TB/s — against 10·N²·D FLOPs (2.9 TFLOP there, 3 ms on the tensor
// cores).  The two passes below read the bias twice: 54.9 GB, 16.4 ms.
//
// The design.  On the TPU, dK/dV were carried across q-blocks in one
// resident output block, which relies on the grid running in order; Hopper
// runs blocks in no order.  So, as K5, the work is split into two passes,
// each block writing only what it owns — deterministic, no atomics:
//  (a) q-major, one block per (window·head, 64-query tile): delta of its
//      rows (written to a (W·nH, N) buffer of the wrapper for pass (b)), then
//      one sweep over the key tiles: S and dP, P = exp(s − lse), dS, written
//      to dbias, and dQ += dS·K.
//  (b) k-major, one block per (window·head, 64-key tile): sweeps the query
//      tiles, recomputes P and dS from lse and delta, and accumulates dK and
//      dV.
//
// bf16 (`window_bwd_{dq,dkv}_tc_kernel<D>`, D a multiple of 16 up to 128;
// the wrapper zero-pads other head dims): K5's design (csrc/flash_attn_bwd.cu)
// with the bias streamed from memory and dS stored to dbias in place of
// K5's binning.  4 warps a block, each warp 16 rows (queries in (a), keys in
// (b)) of the M of mma.m16n8k16, streaming 32-row tiles (keys in (a),
// queries in (b)) through 4-stage shared-memory rings filled by cp.async.
// A stage holds, beside the tile's bf16 rows, its bias tile — 64 queries ×
// 32 keys in (a), 32 queries × 64 keys in (b), 8 KB — three stages ahead of
// the one being computed, so that with two blocks an SM some 50–60 KB of
// bias reads are in flight an SM; 16-byte copies where every bias row is
// 16-byte aligned (N % 4 == 0, as at 16,900), 4-byte ones where not.  Every
// product runs on the tensor cores (mma.sync with ldmatrix, bf16 operands,
// fp32 accumulators): (a) S = Q·K^T, dP = dO·V^T, dQ += dS·K; (b)
// S^T = K·Q^T, dP^T = V·dO^T, dV += P^T·dO, dK += dS^T·Q.  P and dS are fp32
// in registers and rounded to bf16 only as the A operand of the next
// product; (b) keeps its warp's K and V rows as A fragments in registers.
// In (a) each warp puts its 16 rows of fp32 dS into its own rows of the
// stage's bias tile, which only it read, and writes them to dbias as
// 16-byte stores, 8 lanes a row's 32 keys: whole 32-byte sectors in half
// the store instructions of the fragments' 8-byte pairs, which
// tools/window_kernel_ablation.py times against this layout (PERF.md).
// delta comes from 16-byte loads of O and dO.
//
// fp32 (`window_bwd_{dq,dkv}_kernel<float>`): fp32 FMAs on the CUDA cores,
// no TF32 (the card-vs-CPU gradient checks hold the fp32 path to 1e-3).
// 256 threads as a 16×16 grid: each thread owns a 4×4 micro-tile of the score
// and dP tiles (query rows ty + 16a, keys tx + 16b) and a 4 × D/16 slice of
// its accumulators in registers; 64-row tiles staged as fp32 rows of D + 1;
// the bias read straight from device memory, coalesced along keys.
//
// Keys past N are masked (P = 0), as the TPU kernel's _NEG does; rows past N
// read no bias and contribute nothing.  Every bias and dbias offset is
// 64-bit: one call's bias holds more than 2^31 elements at the main path's
// shape.
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kB = 64;             // queries per q tile and keys per key tile
constexpr int kMaxD = 128;

// ------------------------------------------------------------ fp32 path --

constexpr int kThreads = 256;      // 16 × 16
constexpr int kR = kB / 16;        // rows (or keys) per thread
constexpr int kDC = kMaxD / 16;    // accumulator columns per thread, at most
constexpr int kSp = kB + 16;       // score row stride: rows ty, ty+1 land 16 banks apart

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int n, int D) {
  mtp::stage_rows<kThreads>(dst, src, row0, n, kB, D);
}

// The thread's 4×4 micro-tiles of q·k^T (into s) and dO·v^T (into dp) for
// query rows ty + 16a of (qs, dos) and keys tx + 16b of (ks, vs).
__device__ __forceinline__ void products(const float* qs, const float* dos, const float* ks,
                                         const float* vs, int D, float (&s)[kR][kR],
                                         float (&dp)[kR][kR]) {
  const int Dp = D + 1, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    float qr[kR], dr[kR], kc[kR], vc[kR];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      qr[a] = qs[(ty + 16 * a) * Dp + c];
      dr[a] = dos[(ty + 16 * a) * Dp + c];
      kc[a] = ks[(tx + 16 * a) * Dp + c];
      vc[a] = vs[(tx + 16 * a) * Dp + c];
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[a][j] = fmaf(qr[a], kc[j], s[a][j]);
        dp[a][j] = fmaf(dr[a], vc[j], dp[a][j]);
      }
  }
}

// (a) q-major pass: delta, dQ and dbias.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ out, const float* __restrict__ lse_in,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float* __restrict__ dbias, float* __restrict__ delta_out, int N, int D,
                     int q_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;              // kB × Dp
  float* dos = qs + kB * Dp;     // kB × Dp
  float* ks = dos + kB * Dp;     // kB × Dp
  float* vs = ks + kB * Dp;      // kB × Dp
  float* dss = vs + kB * Dp;     // kB × kSp dS of the tile
  float* lse_s = dss + kB * kSp; // kB
  float* d_s = lse_s + kB;       // kB: delta

  const long long wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kB;
  const int nq = min(kB, N - q0);
  const long long base = wh * N * D;
  const long long bbase = wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;

  stage(qs, q + base, q0, nq, D);
  stage(dos, dout + base, q0, nq, D);
  __syncthreads();
  // delta = rowsum(dO ∘ O); lse from the forward
  for (int r = warp; r < kB; r += kThreads / 32) {
    float acc = 0.f;
    if (r < nq)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dos[r * Dp + c], mtp::to_f32(out[base + static_cast<long long>(q0 + r) * D + c]),
                   acc);
    acc = mtp::warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = r < nq ? lse_in[wh * N + q0 + r] : 0.f;
      if (r < nq) delta_out[wh * N + q0 + r] = acc;
    }
  }
  __syncthreads();
  float lse[kR], delta[kR];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    lse[a] = lse_s[ty + 16 * a];
    delta[a] = d_s[ty + 16 * a];
  }

  // one sweep: dS (to dbias and shared memory), dQ
  float s[kR][kR], dp[kR][kR];
  float acc[kR][kDC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int d = 0; d < kDC; ++d) acc[a][d] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kB) {
    const int nk = min(kB, N - k0);
    __syncthreads();  // the previous tile's ks/vs/dss are consumed
    stage(ks, k + base, k0, nk, D);
    stage(vs, v + base, k0, nk, D);
    __syncthreads();
    products(qs, dos, ks, vs, D, s, dp);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = ty + 16 * a;
      const long long row = bbase + (static_cast<long long>(q0) + r) * N + k0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kk = tx + 16 * j;
        float ds = 0.f;
        if (kk < nk && r < nq) {
          const float p = expf(s[a][j] * scale + bias[row + kk] - lse[a]);
          ds = p * (dp[a][j] - delta[a]);
          dbias[row + kk] = ds;
        }
        dss[r * kSp + kk] = ds;
      }
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float dr[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) dr[a] = dss[(ty + 16 * a) * kSp + j];
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const int c = tx + 16 * d;
        if (c < D) {
          const float kv = ks[j * Dp + c];
#pragma unroll
          for (int a = 0; a < kR; ++a) acc[a][d] = fmaf(dr[a], kv, acc[a][d]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    T* row = dq + base + (static_cast<long long>(q0) + r) * D;
#pragma unroll
    for (int d = 0; d < kDC; ++d) {
      const int c = tx + 16 * d;
      if (c < D) row[c] = mtp::from_f32<T>(acc[a][d] * scale);
    }
  }
}

// (b) k-major pass: dK, dV from lse and delta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int N, int D, int k_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* ks = smem;              // kB × Dp
  float* vs = ks + kB * Dp;      // kB × Dp
  float* qs = vs + kB * Dp;      // kB × Dp
  float* dos = qs + kB * Dp;     // kB × Dp
  float* ps = dos + kB * Dp;     // kB × kSp P of the tile
  float* dss = ps + kB * kSp;    // kB × kSp dS of the tile
  float* lse_s = dss + kB * kSp; // kB
  float* delta_s = lse_s + kB;   // kB

  const long long wh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kB;
  const int nk = min(kB, N - k0);
  const long long base = wh * N * D;
  const long long bbase = wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  stage(ks, k + base, k0, nk, D);
  stage(vs, v + base, k0, nk, D);
  // accumulators of keys ty + 16a, columns tx + 16d
  float dka[kR][kDC], dva[kR][kDC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int d = 0; d < kDC; ++d) dka[a][d] = dva[a][d] = 0.f;
  float s[kR][kR], dp[kR][kR];

  for (int q0 = 0; q0 < N; q0 += kB) {
    const int nq = min(kB, N - q0);
    __syncthreads();  // the previous tile's qs/dos/ps/dss are consumed
    stage(qs, q + base, q0, nq, D);
    stage(dos, dout + base, q0, nq, D);
    for (int r = tid; r < kB; r += kThreads) {
      lse_s[r] = r < nq ? lse[wh * N + q0 + r] : 0.f;
      delta_s[r] = r < nq ? delta[wh * N + q0 + r] : 0.f;
    }
    __syncthreads();
    products(qs, dos, ks, vs, D, s, dp);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = ty + 16 * a;
      const long long row = bbase + (static_cast<long long>(q0) + r) * N + k0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kk = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (kk < nk && r < nq) {
          p = expf(s[a][j] * scale + bias[row + kk] - lse_s[r]);
          ds = p * (dp[a][j] - delta_s[r]);
        }
        ps[r * kSp + kk] = p;
        dss[r * kSp + kk] = ds;
      }
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      float pj[kR], dj[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        pj[a] = ps[r * kSp + ty + 16 * a];
        dj[a] = dss[r * kSp + ty + 16 * a];
      }
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const int c = tx + 16 * d;
        if (c < D) {
          const float qv = qs[r * Dp + c], dov = dos[r * Dp + c];
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            dva[a][d] = fmaf(pj[a], dov, dva[a][d]);
            dka[a][d] = fmaf(dj[a], qv, dka[a][d]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int j = ty + 16 * a;
    if (j >= nk) continue;
    const long long o = base + (static_cast<long long>(k0) + j) * D;
#pragma unroll
    for (int d = 0; d < kDC; ++d) {
      const int c = tx + 16 * d;
      if (c < D) {
        dk[o + c] = mtp::from_f32<T>(dka[a][d] * scale);
        dv[o + c] = mtp::from_f32<T>(dva[a][d]);
      }
    }
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* bias,
                       const float* out, const float* lse, const float* dout, float* dq,
                       float* dk, float* dv, float* dbias, float* delta, int WH, int N, int D,
                       float scale, cudaStream_t stream) {
  const int Dp = D + 1;
  const size_t smem_a = static_cast<size_t>(4 * kB * Dp + kB * kSp + 2 * kB) * sizeof(float);
  const size_t smem_b = static_cast<size_t>(4 * kB * Dp + 2 * kB * kSp + 2 * kB) * sizeof(float);
  auto ka = window_bwd_dq_kernel<float>;
  auto kb = window_bwd_dkv_kernel<float>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kB - 1) / kB;
  const unsigned blocks = static_cast<unsigned>(WH) * tiles;
  ka<<<blocks, kThreads, smem_a, stream>>>(q, k, v, bias, out, lse, dout, dq, dbias, delta, N,
                                           D, tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<blocks, kThreads, smem_b, stream>>>(q, k, v, bias, dout, lse, delta, dk, dv, N, D, tiles,
                                           scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 tensor cores --

using bf16 = __nv_bfloat16;
constexpr int kTC = 128;  // 4 warps, 16 rows each

template <int D>
struct Tc {
  static constexpr int LD = D + 8;       // bf16 row stride: ldmatrix rows hit distinct banks
  static constexpr int kStream = 32;     // rows of a streamed tile (keys in (a), queries in (b))
  static constexpr int kStages = 4;      // depth of both passes' rings
  // bias rows in shared memory, in floats: (a) reads 64-bit pairs along a
  // row (stride 8 mod 32), (b) single floats down a column (4 mod 32); both
  // hit distinct banks across a warp
  static constexpr int BSQ = kStream + 8;  // (a): 64 queries × 32 keys
  static constexpr int BSK = kB + 4;       // (b): 32 queries × 64 keys
  static constexpr int kTile = kStream * LD;  // elements of one streamed bf16 tile
  static constexpr int kStageQ = 2 * kTile * 2 + kB * BSQ * 4;  // (a) bytes: K, V, bias
  // (b) bytes: q, dO, lse, delta, bias
  static constexpr int kStageK = 2 * kTile * 2 + 2 * kStream * 4 + kStream * BSK * 4;
};

// (a) q-major pass.
template <int D>
__global__ void __launch_bounds__(kTC, 2)
window_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ out, const float* __restrict__ lse,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        float* __restrict__ dbias, float* __restrict__ delta_out, int N,
                        int q_tiles, float scale, bool vec) {
  using C = Tc<D>;
  constexpr int LD = C::LD, BK = C::kStream, S = C::kStages, BS = C::BSQ;
  constexpr int KD = D / 16, ND = D / 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st: K tile | V tile (bf16), then the bias tile (fp32)
  auto kt_at = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * C::kStageQ); };
  auto bt_at = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * C::kStageQ + 2 * C::kTile * 2);
  };
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + S * C::kStageQ);  // 64 × LD
  bf16* dos = qs + kB * LD;                                        // 64 × LD
  float* dls = reinterpret_cast<float*>(dos + kB * LD);            // 64: delta of the rows

  const long long wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kB;
  const long long base = wh * N * D;
  const long long lb = wh * N;
  const float* b = bias + wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  float* db = dbias + wh * N * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + BK - 1) / BK;

  auto load_tile = [&](int st, int k0) {
    bf16* kt = kt_at(st);
    mtp::load_rows_async<BK, D, LD, kTC>(kt, k + base, k0, N);
    mtp::load_rows_async<BK, D, LD, kTC>(kt + C::kTile, v + base, k0, N);
    mtp::load_bias_async<kB, BK, BS, kTC>(bt_at(st), b, q0, k0, N, vec);
  };
  // group 0: q, dO and tile 0; then one group per key tile, S - 1 ahead
  mtp::load_rows_async<kB, D, LD, kTC>(qs, q + base, q0, N);
  mtp::load_rows_async<kB, D, LD, kTC>(dos, dout + base, q0, N);
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_tiles) load_tile(st, st * BK);
    mtp::cp_async_commit();
  }

  const int row = warp * 16 + g;  // the thread's rows row and row + 8 of the tile
  const int r0 = q0 + row, r1 = r0 + 8;
  const float ls0 = r0 < N ? lse[lb + r0] * mtp::kLog2e : 0.f;
  const float ls1 = r1 < N ? lse[lb + r1] * mtp::kLog2e : 0.f;
  // delta = rowsum(dO ∘ O) of the block's rows, two threads a row, into
  // shared memory for the threads that hold the rows' fragments
  {
    const int r = tid >> 1, h = tid & 1;
    const long long o = base + static_cast<long long>(q0 + r) * D + h * (D / 2);
    float a = q0 + r < N ? mtp::half_row_dot<D>(out + o, dout + o) : 0.f;
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (h == 0) {
      dls[r] = a;
      if (q0 + r < N) delta_out[lb + q0 + r] = a;
    }
  }
  float dl0 = 0.f, dl1 = 0.f;  // read once the first barrier has passed

  const float sl2 = scale * mtp::kLog2e;
  uint32_t qf[KD][4], df[KD][4];
  float dqa[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    mtp::cp_async_wait<S - 2>();  // this tile (and on the first, q and dO) has landed
    __syncthreads();              // for every warp, which are all past tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
        mtp::ldmatrix_x4(df[kk], dos + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
      }
      dl0 = dls[row];
      dl1 = dls[row + 8];
    }
    if (it + S - 1 < n_tiles) load_tile((it + S - 1) % S, k0 + (S - 1) * BK);
    mtp::cp_async_commit();
    const bf16* kt = kt_at(it % S);
    const bf16* vt = kt + C::kTile;
    float* bt = bt_at(it % S);
    const float* b0 = bt + row * BS + 2 * t;
    const float* b1 = b0 + 8 * BS;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = dp[nb][0] = dp[nb][1] = dp[nb][2] =
          dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        const int off = mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD);
        mtp::ldmatrix_x4(bf, kt + off);
        mtp::mma_bf16(s[nb], qf[kk], bf[0], bf[1]);
        mtp::mma_bf16(s[nb + 1], qf[kk], bf[2], bf[3]);
        mtp::ldmatrix_x4(bf, vt + off);
        mtp::mma_bf16(dp[nb], df[kk], bf[0], bf[1]);
        mtp::mma_bf16(dp[nb + 1], df[kk], bf[2], bf[3]);
      }
    }

    // P = exp(s − lse), dS = P ∘ (dP − delta) into s; keys >= N give 0
    const bool edge = k0 + BK > N;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 x0 = *reinterpret_cast<const float2*>(b0 + nb * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(b1 + nb * 8);
      float p[4] = {
          mtp::exp2_approx(fmaf(s[nb][0], sl2, fmaf(x0.x, mtp::kLog2e, -ls0))),
          mtp::exp2_approx(fmaf(s[nb][1], sl2, fmaf(x0.y, mtp::kLog2e, -ls0))),
          mtp::exp2_approx(fmaf(s[nb][2], sl2, fmaf(x1.x, mtp::kLog2e, -ls1))),
          mtp::exp2_approx(fmaf(s[nb][3], sl2, fmaf(x1.y, mtp::kLog2e, -ls1)))};
      if (edge) {
        const int kk = k0 + nb * 8 + 2 * t;
        if (kk >= N) p[0] = p[2] = 0.f;
        if (kk + 1 >= N) p[1] = p[3] = 0.f;
      }
      s[nb][0] = p[0] * (dp[nb][0] - dl0);
      s[nb][1] = p[1] * (dp[nb][1] - dl0);
      s[nb][2] = p[2] * (dp[nb][2] - dl1);
      s[nb][3] = p[3] * (dp[nb][3] - dl1);
    }

    // dS to dbias.  vec: through the warp's own 16 rows of this stage's
    // bias tile, which only this warp read, then out as 16-byte stores, 8
    // lanes a row's 32 keys (a chunk of 4 keys is all in or all out of N);
    // else straight from the fragments, one float at a time.
    if (vec) {
      float* w0 = bt + row * BS + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        *reinterpret_cast<float2*>(w0 + nb * 8) = make_float2(s[nb][0], s[nb][1]);
        *reinterpret_cast<float2*>(w0 + 8 * BS + nb * 8) = make_float2(s[nb][2], s[nb][3]);
      }
      __syncwarp();
      const int c = (lane & 7) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = warp * 16 + (lane >> 3) + 4 * i, r = q0 + rr;
        if (r < N && k0 + c < N)
          *reinterpret_cast<float4*>(db + static_cast<long long>(r) * N + k0 + c) =
              *reinterpret_cast<const float4*>(bt + rr * BS + c);
      }
    } else {
      const long long o0 = static_cast<long long>(r0) * N + k0 + 2 * t;
      const long long o1 = o0 + 8LL * N;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int kk = k0 + nb * 8 + 2 * t;
        if (r0 < N && kk < N) db[o0 + nb * 8] = s[nb][0];
        if (r0 < N && kk + 1 < N) db[o0 + nb * 8 + 1] = s[nb][1];
        if (r1 < N && kk < N) db[o1 + nb * 8] = s[nb][2];
        if (r1 < N && kk + 1 < N) db[o1 + nb * 8 + 1] = s[nb][3];
      }
    }

    // dQ += dS·K on the tensor cores
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      mtp::a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        mtp::ldmatrix_x4_trans(bf, kt + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(dqa[nd], a, bf[0], bf[1]);
        mtp::mma_bf16(dqa[nd + 1], a, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dq + base + static_cast<long long>(r0) * D + c) =
          mtp::pack_bf16(dqa[nd][0] * scale, dqa[nd][1] * scale);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dq + base + static_cast<long long>(r1) * D + c) =
          mtp::pack_bf16(dqa[nd][2] * scale, dqa[nd][3] * scale);
  }
}

// (b) k-major pass.  The block's 64 K and V rows stay in shared memory; a
// stage holds a 32-query tile's q and dO rows (bf16), their lse and delta,
// and their bias rows over the block's 64 keys.
template <int D>
__global__ void __launch_bounds__(kTC, 2)
window_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int N, int k_tiles, float scale, bool vec) {
  using C = Tc<D>;
  constexpr int LD = C::LD, BQ = C::kStream, S = C::kStages, BS = C::BSK;
  constexpr int KD = D / 16, ND = D / 8, NB = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // 64 × LD, resident
  bf16* vs = ks + kB * LD;                       // 64 × LD, resident
  unsigned char* ring = smem_raw + 2 * kB * LD * 2;
  // stage st: q tile | dO tile (bf16), lse | delta (BQ fp32 each), bias (fp32)
  auto qt_at = [&](int st) { return reinterpret_cast<bf16*>(ring + st * C::kStageK); };
  auto ft_at = [&](int st) {
    return reinterpret_cast<float*>(ring + st * C::kStageK + 2 * C::kTile * 2);
  };

  const long long wh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kB;
  const long long base = wh * N * D;
  const long long lb = wh * N;
  const float* b = bias + wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  auto load_stage = [&](int st, int q0) {
    bf16* qt = qt_at(st);
    mtp::load_rows_async<BQ, D, LD, kTC>(qt, q + base, q0, N);
    mtp::load_rows_async<BQ, D, LD, kTC>(qt + C::kTile, dout + base, q0, N);
    float* f = ft_at(st);
    if (tid < 2 * BQ) {
      const int r = tid & (BQ - 1);
      const bool ok = q0 + r < N;
      mtp::cp_async4(f + tid, (tid < BQ ? lse : delta) + lb + (ok ? q0 + r : 0), ok);
    }
    mtp::load_bias_async<BQ, kB, BS, kTC>(f + 2 * BQ, b, q0, k0, N, vec);
  };

  const int n_tiles = (N + BQ - 1) / BQ;
  mtp::load_rows_async<kB, D, LD, kTC>(ks, k + base, k0, N);
  mtp::load_rows_async<kB, D, LD, kTC>(vs, v + base, k0, N);
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_tiles) load_stage(st, st * BQ);
    mtp::cp_async_commit();
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = dva[i][0] = dva[i][1] = dva[i][2] =
        dva[i][3] = 0.f;
  const int ka = warp * 16 + g, kb = ka + 8;  // the thread's keys in the tile
  const float sl2 = scale * mtp::kLog2e;
  uint32_t kf[KD][4], vf[KD][4];  // the warp's K and V rows, A fragments

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BQ;
    mtp::cp_async_wait<S - 2>();  // this stage (and on the first, K and V) has landed
    __syncthreads();              // for every warp, which are all past tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int aoff = mtp::a_frag_offset(lane, warp * 16, kk * 16, LD);
        mtp::ldmatrix_x4(kf[kk], ks + aoff);
        mtp::ldmatrix_x4(vf[kk], vs + aoff);
      }
    }
    if (it + S - 1 < n_tiles) load_stage((it + S - 1) % S, q0 + (S - 1) * BQ);
    mtp::cp_async_commit();
    const bf16* qt = qt_at(it % S);
    const bf16* dt = qt + C::kTile;
    const float* f = ft_at(it % S);
    const float* bt = f + 2 * BQ;

    // S^T = K·Q^T and dP^T = V·dO^T: rows the warp's 16 keys, columns the
    // tile's queries
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = dp[nb][0] = dp[nb][1] = dp[nb][2] =
          dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        const int off = mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD);
        mtp::ldmatrix_x4(bf, qt + off);
        mtp::mma_bf16(s[nb], kf[kk], bf[0], bf[1]);
        mtp::mma_bf16(s[nb + 1], kf[kk], bf[2], bf[3]);
        mtp::ldmatrix_x4(bf, dt + off);
        mtp::mma_bf16(dp[nb], vf[kk], bf[0], bf[1]);
        mtp::mma_bf16(dp[nb + 1], vf[kk], bf[2], bf[3]);
      }
    }

    // P = exp(s − lse) into s, dS = P ∘ (dP − delta) into dp; queries >= N
    // give 0
    const bool edge = q0 + BQ > N;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = nb * 8 + 2 * t + e;
        const float ls = f[qc] * mtp::kLog2e, dl = f[BQ + qc];
        const float* bq = bt + qc * BS;
        float pa = mtp::exp2_approx(fmaf(s[nb][e], sl2, fmaf(bq[ka], mtp::kLog2e, -ls)));
        float pb = mtp::exp2_approx(fmaf(s[nb][2 + e], sl2, fmaf(bq[kb], mtp::kLog2e, -ls)));
        if (edge && q0 + qc >= N) pa = pb = 0.f;
        s[nb][e] = pa;
        s[nb][2 + e] = pb;
        dp[nb][e] = pa * (dp[nb][e] - dl);
        dp[nb][2 + e] = pb * (dp[nb][2 + e] - dl);
      }
    }

    // dV += P^T·dO, dK += dS^T·Q on the tensor cores
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      mtp::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
      mtp::a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        const int off = mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD);
        mtp::ldmatrix_x4_trans(bf, dt + off);
        mtp::mma_bf16(dva[nd], pa, bf[0], bf[1]);
        mtp::mma_bf16(dva[nd + 1], pa, bf[2], bf[3]);
        mtp::ldmatrix_x4_trans(bf, qt + off);
        mtp::mma_bf16(dka[nd], da, bf[0], bf[1]);
        mtp::mma_bf16(dka[nd + 1], da, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (k0 + ka < N) {
      const long long o = base + static_cast<long long>(k0 + ka) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = mtp::pack_bf16(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = mtp::pack_bf16(dva[nd][0], dva[nd][1]);
    }
    if (k0 + kb < N) {
      const long long o = base + static_cast<long long>(k0 + kb) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = mtp::pack_bf16(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = mtp::pack_bf16(dva[nd][2], dva[nd][3]);
    }
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                      const bf16* out, const float* lse, const bf16* dout, bf16* dq, bf16* dk,
                      bf16* dv, float* dbias, float* delta, int WH, int N, float scale,
                      cudaStream_t stream) {
  using C = Tc<D>;
  const size_t smem_a = static_cast<size_t>(C::kStages) * C::kStageQ +
                        2 * static_cast<size_t>(kB) * C::LD * 2 + kB * sizeof(float);
  const size_t smem_b = 2 * static_cast<size_t>(kB) * C::LD * 2 +
                        static_cast<size_t>(C::kStages) * C::kStageK;
  auto ka = window_bwd_dq_tc_kernel<D>;
  auto kb = window_bwd_dkv_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dbias) % 16 == 0;
  const int tiles = (N + kB - 1) / kB;
  const unsigned blocks = static_cast<unsigned>(WH) * tiles;
  ka<<<blocks, kTC, smem_a, stream>>>(q, k, v, bias, out, lse, dout, dq, dbias, delta, N, tiles,
                                      scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<blocks, kTC, smem_b, stream>>>(q, k, v, bias, dout, lse, delta, dk, dv, N, tiles, scale,
                                      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_bwd_qblk(const void* q, const void* k, const void* v,
                                        const void* bias, const void* out, const void* lse,
                                        const void* dout, void* dq, void* dk, void* dv,
                                        void* dbias, void* delta, int WH, int N, int D,
                                        float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  float* dl = static_cast<float*>(delta);
  if (D < 1 || D > kMaxD || N < 1) return cudaErrorInvalidValue;
  if (dtype == mtp::kFloat32)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), b, static_cast<const float*>(out), ls,
                      static_cast<const float*>(dout), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), db, dl, WH, N, D,
                      scale, st);
  if (dtype != mtp::kBFloat16) return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(out);
  const bf16* dob = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  switch (D) {  // the wrapper pads D to a multiple of 16, at most 128
#define MTP_QBLK_BWD_D(d)                                                                    \
  case d:                                                                                    \
    return launch_tc<d>(qb, kb, vb, b, ob, ls, dob, dqb, dkb, dvb, db, dl, WH, N, scale, st);
    MTP_QBLK_BWD_D(16)
    MTP_QBLK_BWD_D(32)
    MTP_QBLK_BWD_D(48)
    MTP_QBLK_BWD_D(64)
    MTP_QBLK_BWD_D(80)
    MTP_QBLK_BWD_D(96)
    MTP_QBLK_BWD_D(112)
    MTP_QBLK_BWD_D(128)
#undef MTP_QBLK_BWD_D
    default:
      return cudaErrorInvalidValue;
  }
}
