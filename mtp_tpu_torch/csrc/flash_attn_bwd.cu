// K5 — flash full attention with the decomposed rel-pos bias, backward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_flash_backward`
// (pallas_call at :594; kernel body `_flash_bwd_kernel` :497-561).
//
// Computes, per (batch·head bh), for the output cotangent dO, from the
// forward's (K2's) out O and per-row log-sum-exp lse, with
//     s[q, k] = q·k^T · scale + rel_h[q, k / Wk] + rel_w[q, k % Wk],
//     P = exp(s − lse),  dP = dO · v^T,  delta = rowsum(dO ∘ O)
//     (= rowsum(P ∘ dP), since O = P·V),  dS = P ∘ (dP − delta):
//     dQ = dS · k · scale,  dK = dS^T · q · scale,  dV = P^T · dO,
//     d(rel_h)[q, ky] = Σ_kx dS[q, ky·Wk + kx],  d(rel_w)[q, kx] = Σ_ky dS[q, ky·Wk + kx]
// with q/k/v/O/dO (BH, N, D) in fp32 or bf16, rel_h (BH, N, Hk) and rel_w
// (BH, N, Wk) fp32, lse (BH, N) fp32, N = Hk·Wk; dQ/dK/dV in q's dtype,
// d(rel_h)/d(rel_w) fp32.  The (N, N) scores never exist in device memory.
//
// What bounds it on the H100: at the slice shape (BH = 128 at batch 8,
// N = 576, D = 64) the function needs 5 products of (N, N, D) per bh
// (recomputing S, then dP, dQ, dK, dV; the two passes below do 7, S and dP
// in both), ~27 GFLOP on ~40 MB of inputs and outputs: the tensor cores'
// rate in principle; in this kernel the fp32 work per score (bias, exp2,
// dS), the d(rel_h)/d(rel_w) binning and the latency of 12 warps an SM
// running mma.sync take most of the time.
//
// The design.  On the TPU, dK/dV were carried across q-blocks in one
// resident output block, which relies on the grid running in order; Hopper
// runs blocks in no order.  So the work is split into two passes, each
// block writing only what it owns — deterministic, no atomics:
//  (a) q-major, one block per (bh, query tile): delta = rowsum(dO ∘ O) of
//      its rows (written to the `delta` buffer for pass (b)), then one
//      sweep over the key tiles: S and dP, P = exp(s − lse), dS, dQ += dS·K;
//      each tile's dS sums per key row and key column go into the block's
//      own rows of d(rel_h) and d(rel_w), each (row, bin) with one owning
//      thread.
//  (b) k-major, one block per (bh, 64-key tile): sweeps the query tiles,
//      recomputes S, P and dS from the saved lse and delta, and accumulates
//      dK and dV.
//
// bf16 (`flash_bwd_{dq,dkv}_tc_kernel<D>`, D a multiple of 16 up to 128):
// 4 warps a block, each warp 16 rows (queries in (a), keys in (b)) of the
// M of mma.m16n8k16, streaming 32-row tiles (keys in (a), queries in (b))
// through shared-memory rings 3 (a) and 4 (b) stages deep, filled by
// cp.async: 16 B for the bf16 rows, 4 B for lse, delta and the rel rows,
// whose rows of consecutive queries are contiguous in device memory.  One
// barrier a tile: wait for the tile, barrier, refill the stage the previous
// tile left, compute.  Every product runs on the tensor cores (mma.sync with
// ldmatrix, bf16 operands, fp32 accumulators in registers): (a) S = Q·K^T,
// dP = dO·V^T, dQ += dS·K; (b) S^T = K·Q^T, dP^T = V·dO^T, dV += P^T·dO,
// dK += dS^T·Q.  P and dS are fp32 in registers and rounded to bf16 only as
// the A operand of the next product; for dQ, dS is that bf16 part plus the
// bf16 of its rest, two products (`a_split_from_c`).  In (a) the fp32 dS of two key tiles
// goes to shared memory (in the memory q and dO came through), where each
// (row, key-row bin) and (row, key-column bin) has one owning thread that
// adds its sum into the block's d(rel_h)/d(rel_w) rows, kept in shared
// memory and written once; a column bin takes a fixed number of predicated
// terms (no data-dependent loop).  Up to D = 64 the registers allow 3
// blocks (12 warps) an SM.
//
// fp32 (`flash_bwd_{dq,dkv}_kernel<float>`): fp32 FMAs on the CUDA cores,
// no TF32 (the card-vs-CPU gradient checks hold the fp32 path to 1e-3):
// q/k/v/dO staged as fp32 rows of D+1, 32-query and 64-key tiles.

#include <algorithm>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------ fp32 path --

constexpr int kBQ = 32;  // queries per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;

// Scores and dP of one (query tile, key tile) pair, into s/dp (kBQ × Sp);
// keys >= nk get s = -inf, dp = 0.
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, const float* rh, const float* rw,
                                       float* s, float* dp, int k0, int nk, int D, int Hk,
                                       int Wk, float scale) {
  const int Dp = D + 1, Sp = kBK + 1;
  for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK, j = i % kBK;
    float sv = -INFINITY, dv = 0.f;
    if (j < nk) {
      const float* qr = qs + r * Dp;
      const float* dor = dos + r * Dp;
      const float* kj = ks + j * Dp;
      const float* vj = vs + j * Dp;
      float a = 0.f;
      for (int c = 0; c < D; ++c) {
        a = fmaf(qr[c], kj[c], a);
        dv = fmaf(dor[c], vj[c], dv);
      }
      const int kk = k0 + j;
      sv = a * scale + rh[r * Hk + kk / Wk] + rw[r * Wk + kk % Wk];
    }
    s[r * Sp + j] = sv;
    dp[r * Sp + j] = dv;
  }
}

// Stage rows [r0, r0 + n) of a (rows, D) tensor as fp32 rows of D+1, zero
// past n.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int rows,
                                      int D) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * Dp + c] = r < n ? mtp::to_f32(src[static_cast<long long>(r0 + r) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ void stage_rel(float* dst, const float* src, int n, int cols) {
  for (int i = threadIdx.x; i < kBQ * cols; i += kThreads) dst[i] = i / cols < n ? src[i] : 0.f;
}

// (a) q-major pass: delta, dQ, d(rel_h), d(rel_w).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, const T* __restrict__ out,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ drel_h,
                    float* __restrict__ drel_w, float* __restrict__ delta_out, int N, int D,
                    int Hk, int Wk, int q_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1, Sp = kBK + 1;
  float* qs = smem;              // kBQ × Dp
  float* dos = qs + kBQ * Dp;    // kBQ × Dp
  float* dqs = dos + kBQ * Dp;   // kBQ × Dp accumulator
  float* ks = dqs + kBQ * Dp;    // kBK × Dp
  float* vs = ks + kBK * Dp;     // kBK × Dp
  float* s = vs + kBK * Dp;      // kBQ × Sp scores, then dS
  float* dp = s + kBQ * Sp;      // kBQ × Sp
  float* rh = dp + kBQ * Sp;     // kBQ × Hk
  float* rw = rh + kBQ * Hk;     // kBQ × Wk
  float* lse_s = rw + kBQ * Wk;  // kBQ
  float* d_s = lse_s + kBQ;      // kBQ: delta

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int nq = min(kBQ, N - q0);
  const long long base = static_cast<long long>(bh) * N * D;
  const long long rbase = static_cast<long long>(bh) * N + q0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage(qs, q + base, q0, nq, kBQ, D);
  stage(dos, dout + base, q0, nq, kBQ, D);
  for (int i = tid; i < kBQ * Dp; i += kThreads) dqs[i] = 0.f;
  stage_rel(rh, rel_h + rbase * Hk, nq, Hk);
  stage_rel(rw, rel_w + rbase * Wk, nq, Wk);
  __syncthreads();
  // delta = rowsum(dO ∘ O); lse from the forward
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float acc = 0.f;
    if (r < nq)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dos[r * Dp + c], mtp::to_f32(out[base + static_cast<long long>(q0 + r) * D + c]),
                   acc);
    acc = mtp::warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = r < nq ? lse[rbase + r] : 0.f;
      if (r < nq) delta_out[rbase + r] = acc;
    }
  }

  // one sweep: dS, dQ, d(rel_h), d(rel_w)
  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();
    stage(ks, k + base, k0, nk, kBK, D);
    stage(vs, v + base, k0, nk, kBK, D);
    __syncthreads();
    scores(qs, dos, ks, vs, rh, rw, s, dp, k0, nk, D, Hk, Wk, scale);
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const float p = j < nk && r < nq ? expf(s[r * Sp + j] - lse_s[r]) : 0.f;
      s[r * Sp + j] = p * (dp[r * Sp + j] - d_s[r]);
    }
    __syncthreads();
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* dsr = s + r * Sp;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(dsr[j], ks[j * Dp + c], acc);
      dqs[r * Dp + c] += acc;
    }
    // each (row, bin) has one owner thread in this block: no atomics
    for (int i = tid; i < nq * Hk; i += kThreads) {
      const int r = i / Hk, ky = i % Hk;
      const int jlo = max(0, ky * Wk - k0), jhi = min(nk, (ky + 1) * Wk - k0);
      if (jlo >= jhi) continue;
      float acc = 0.f;
      for (int j = jlo; j < jhi; ++j) acc += s[r * Sp + j];
      drel_h[(rbase + r) * Hk + ky] += acc;
    }
    for (int i = tid; i < nq * Wk; i += kThreads) {
      const int r = i / Wk, kx = i % Wk;
      const int j0 = ((kx - k0) % Wk + Wk) % Wk;
      if (j0 >= nk) continue;
      float acc = 0.f;
      for (int j = j0; j < nk; j += Wk) acc += s[r * Sp + j];
      drel_w[(rbase + r) * Wk + kx] += acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dq[base + static_cast<long long>(q0 + r) * D + c] = mtp::from_f32<T>(dqs[r * Dp + c] * scale);
  }
}

// (b) k-major pass: dK, dV from the saved lse and delta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ rel_h,
                     const float* __restrict__ rel_w, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int N, int D, int Hk,
                     int Wk, int k_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1, Sp = kBK + 1;
  float* ks = smem;              // kBK × Dp
  float* vs = ks + kBK * Dp;     // kBK × Dp
  float* dks = vs + kBK * Dp;    // kBK × Dp accumulator
  float* dvs = dks + kBK * Dp;   // kBK × Dp accumulator
  float* qs = dvs + kBK * Dp;    // kBQ × Dp
  float* dos = qs + kBQ * Dp;    // kBQ × Dp
  float* s = dos + kBQ * Dp;     // kBQ × Sp scores, then P
  float* dp = s + kBQ * Sp;      // kBQ × Sp dP, then dS
  float* rh = dp + kBQ * Sp;     // kBQ × Hk
  float* rw = rh + kBQ * Hk;     // kBQ × Wk
  float* lse_s = rw + kBQ * Wk;  // kBQ
  float* delta_s = lse_s + kBQ;  // kBQ

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBK;
  const int nk = min(kBK, N - k0);
  const long long base = static_cast<long long>(bh) * N * D;
  const int tid = threadIdx.x;

  stage(ks, k + base, k0, nk, kBK, D);
  stage(vs, v + base, k0, nk, kBK, D);
  for (int i = tid; i < kBK * Dp; i += kThreads) {
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    const int nq = min(kBQ, N - q0);
    const long long rbase = static_cast<long long>(bh) * N + q0;
    __syncthreads();  // the previous tile's qs/dos/s/dp are consumed
    stage(qs, q + base, q0, nq, kBQ, D);
    stage(dos, dout + base, q0, nq, kBQ, D);
    stage_rel(rh, rel_h + rbase * Hk, nq, Hk);
    stage_rel(rw, rel_w + rbase * Wk, nq, Wk);
    for (int r = tid; r < kBQ; r += kThreads) {
      lse_s[r] = r < nq ? lse[rbase + r] : 0.f;
      delta_s[r] = r < nq ? delta[rbase + r] : 0.f;
    }
    __syncthreads();
    scores(qs, dos, ks, vs, rh, rw, s, dp, k0, nk, D, Hk, Wk, scale);
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const float p = j < nk && r < nq ? expf(s[r * Sp + j] - lse_s[r]) : 0.f;
      s[r * Sp + j] = p;
      dp[r * Sp + j] = p * (dp[r * Sp + j] - delta_s[r]);
    }
    __syncthreads();
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, c = i % D;
      float av = 0.f, ak = 0.f;
      for (int r = 0; r < nq; ++r) {
        av = fmaf(s[r * Sp + j], dos[r * Dp + c], av);
        ak = fmaf(dp[r * Sp + j], qs[r * Dp + c], ak);
      }
      dvs[j * Dp + c] += av;
      dks[j * Dp + c] += ak;
    }
  }
  __syncthreads();
  for (int i = tid; i < nk * D; i += kThreads) {
    const int j = i / D, c = i % D;
    const long long o = base + static_cast<long long>(k0 + j) * D + c;
    dk[o] = mtp::from_f32<T>(dks[j * Dp + c] * scale);
    dv[o] = mtp::from_f32<T>(dvs[j * Dp + c]);
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* rh,
                       const float* rw, const float* out, const float* lse, const float* dout,
                       float* dq, float* dk, float* dv, float* drel_h, float* drel_w,
                       float* delta, int BH, int N, int D, int Hk, int Wk, float scale,
                       cudaStream_t stream) {
  const int Dp = D + 1, Sp = kBK + 1;
  const size_t smem_a = static_cast<size_t>(
      (3 * kBQ + 2 * kBK) * Dp + 2 * kBQ * Sp + kBQ * (Hk + Wk) + 2 * kBQ) * sizeof(float);
  const size_t smem_b = static_cast<size_t>(
      (4 * kBK + 2 * kBQ) * Dp + 2 * kBQ * Sp + kBQ * (Hk + Wk) + 2 * kBQ) * sizeof(float);
  auto ka = flash_bwd_dq_kernel<float>;
  auto kb = flash_bwd_dkv_kernel<float>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  // d(rel_h)/d(rel_w) are accumulated in place over the key tiles
  err = cudaMemsetAsync(drel_h, 0, sizeof(float) * BH * N * Hk, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(drel_w, 0, sizeof(float) * BH * N * Wk, stream);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ, k_tiles = (N + kBK - 1) / kBK;
  ka<<<BH * q_tiles, kThreads, smem_a, stream>>>(q, k, v, rh, rw, out, lse, dout, dq, drel_h,
                                                 drel_w, delta, N, D, Hk, Wk, q_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<BH * k_tiles, kThreads, smem_b, stream>>>(q, k, v, rh, rw, dout, lse, delta, dk, dv, N,
                                                 D, Hk, Wk, k_tiles, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 tensor cores --

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 64;  // rows a block owns: queries in (a), keys in (b)
constexpr int kTC = 128;     // 4 warps, 16 rows each

template <int D>
struct Tc {
  static constexpr int LD = D + 8;      // bf16 row stride: ldmatrix rows hit distinct banks
  static constexpr int kStream = 32;    // rows of a streamed tile (keys in (a), queries in (b))
  static constexpr int kStages = 3;   // depth of the shared-memory ring in (a)
  static constexpr int kStagesQ = 4;  // and in (b)
  // (a) bins the fp32 dS of two key tiles at a time, rows of stride DSS
  // (odd: rows hit distinct banks), in the memory q and dO came through
  static constexpr int DSS = 2 * kStream + 1;
  static constexpr int kRing = 2 * kStages * kStream * LD * 2;  // (a): K and V tiles, bytes
  static constexpr int kQdo = 2 * kTcRows * LD * 2 > kTcRows * DSS * 4
                                  ? 2 * kTcRows * LD * 2 : kTcRows * DSS * 4;
  // blocks per SM the registers must allow: 3 (12 warps) up to D = 64, where
  // the accumulators fit in 170 registers a thread
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};


// The key-column sums of a window of nk <= 64 keys of the fp32 dS rows
// `dst` (stride DSS), added into acc (stride RS, columns from Hk on): the
// thread owns row tid % 64 and the bins c = tid / 64 + 2u < nkx, bin c
// holding keys c, c + Wk, ... (at most T of them: T·Wk >= 64), four bins a
// round with their loads ahead of their (distinct) updates.
template <int T>
__device__ __forceinline__ void bin_columns(const float* dst, int DSS, float* acc, int RS, int Hk,
                                            int Wk, int kx_lo, int nk, int nkx) {
  const int r = threadIdx.x & 63;
  const float* row = dst + r * DSS;
  float* out = acc + r * RS + Hk;
  for (int c0 = threadIdx.x >> 6; c0 < nkx; c0 += 8) {
    float a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 2 * u;
      a[u] = 0.f;
#pragma unroll
      for (int m = 0; m < T; ++m) {
        const int j = c + m * Wk;
        if (c < nkx && j < nk) a[u] += row[j];
      }
    }
    float old[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kx = kx_lo + c0 + 2 * u;
      at[u] = kx < Wk ? kx : kx - Wk;
      old[u] = c0 + 2 * u < nkx ? out[at[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + 2 * u < nkx) out[at[u]] = old[u] + a[u];
  }
}

// (a) q-major pass.
template <int D>
__global__ void __launch_bounds__(kTC, Tc<D>::kMinBlocks)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ rel_h,
                       const float* __restrict__ rel_w, const bf16* __restrict__ out,
                       const float* __restrict__ lse, const bf16* __restrict__ dout,
                       bf16* __restrict__ dq, float* __restrict__ drel_h,
                       float* __restrict__ drel_w, float* __restrict__ delta_out, int N,
                       int Hk, int Wk, int q_tiles, float scale) {
  using C = Tc<D>;
  constexpr int LD = C::LD, BK = C::kStream, DSS = C::DSS, S = C::kStages;
  constexpr int KD = D / 16, ND = D / 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // S stages × BK × LD
  bf16* vs = ks + S * BK * LD;                   // S stages × BK × LD
  bf16* qs = vs + S * BK * LD;                   // 64 × LD
  bf16* dos = qs + kTcRows * LD;                 // 64 × LD
  float* dst = reinterpret_cast<float*>(qs);     // 64 × DSS fp32 dS, once q/dO are in registers
  float* rel = reinterpret_cast<float*>(smem_raw + C::kRing + C::kQdo);  // 64 × RS: [rel_h | rel_w]·log2 e
  const int RS = (Hk + Wk) | 1;  // odd: rows hit distinct banks
  float* acc = rel + kTcRows * RS;  // 64 × RS: d(rel_h) | d(rel_w)
  float* dls = acc + kTcRows * RS;  // 64: delta of the block's rows

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTcRows;
  const int nq = min(kTcRows, N - q0);
  const long long base = static_cast<long long>(bh) * N * D;
  const long long lb = static_cast<long long>(bh) * N;
  const long long rbase = lb + q0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + BK - 1) / BK;

  // group 0: q, dO, the rows' rel_h | rel_w values (contiguous in device
  // memory for the block's rows; scaled by log2 e once landed) and the first
  // key tile; then one group per key tile, S - 1 ahead
  mtp::load_rows_async<kTcRows, D, LD, kTC>(qs, q + base, q0, N);
  mtp::load_rows_async<kTcRows, D, LD, kTC>(dos, dout + base, q0, N);
  for (int r = warp; r < kTcRows; r += kTC / 32) {  // a warp a row, a lane a column
    const bool ok = r < nq;
    const float* src_h = rel_h + (rbase + (ok ? r : 0)) * Hk;
    const float* src_w = rel_w + (rbase + (ok ? r : 0)) * Wk - Hk;
    for (int c = lane; c < Hk + Wk; c += 32)
      mtp::cp_async4(rel + r * RS + c, c < Hk ? src_h + c : src_w + c, ok);
  }
  for (int i = tid; i < kTcRows * RS; i += kTC) acc[i] = 0.f;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_tiles) {
      mtp::load_rows_async<BK, D, LD, kTC>(ks + st * BK * LD, k + base, st * BK, N);
      mtp::load_rows_async<BK, D, LD, kTC>(vs + st * BK * LD, v + base, st * BK, N);
    }
    mtp::cp_async_commit();
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float ls0 = r0 < N ? lse[lb + r0] * mtp::kLog2e : 0.f;
  const float ls1 = r1 < N ? lse[lb + r1] * mtp::kLog2e : 0.f;
  // delta = rowsum(dO ∘ O) of the block's rows, two threads a row (16-byte
  // loads, every one issued before the first sum), into shared memory for
  // the threads that hold the rows' fragments
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

  const float* rel0 = rel + (warp * 16 + g) * RS;  // the thread's rows g and g+8
  const float* rel1 = rel0 + 8 * RS;
  const float sl2 = scale * mtp::kLog2e;
  uint32_t qf[KD][4], df[KD][4];
  float dqa[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    mtp::cp_async_wait<S - 2>();  // this tile (and on the first, group 0) has landed
    __syncthreads();              // for every warp, which are all past tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
        mtp::ldmatrix_x4(df[kk], dos + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
      }
      for (int i = tid; i < kTcRows * RS; i += kTC) rel[i] *= mtp::kLog2e;
      dl0 = dls[warp * 16 + g];
      dl1 = dls[warp * 16 + g + 8];
      __syncthreads();  // the dS tile reuses q's and dO's shared memory
    }
    if (it + S - 1 < n_tiles) {  // into the stage tile it - 1 left
      const int nx = (it + S - 1) % S;
      mtp::load_rows_async<BK, D, LD, kTC>(ks + nx * BK * LD, k + base, k0 + (S - 1) * BK, N);
      mtp::load_rows_async<BK, D, LD, kTC>(vs + nx * BK * LD, v + base, k0 + (S - 1) * BK, N);
    }
    mtp::cp_async_commit();
    const bf16* kt = ks + (it % S) * BK * LD;
    const bf16* vt = vs + (it % S) * BK * LD;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = dp[nb][0] = dp[nb][1] = dp[nb][2] =
          dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        const int off = mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD);
        mtp::ldmatrix_x4(b, kt + off);
        mtp::mma_bf16(s[nb], qf[kk], b[0], b[1]);
        mtp::mma_bf16(s[nb + 1], qf[kk], b[2], b[3]);
        mtp::ldmatrix_x4(b, vt + off);
        mtp::mma_bf16(dp[nb], df[kk], b[0], b[1]);
        mtp::mma_bf16(dp[nb + 1], df[kk], b[2], b[3]);
      }
    }

    // P = exp(s − lse), dS = P ∘ (dP − delta) into s; keys >= N give 0
    const bool edge = k0 + BK > N;
    int ky = (k0 + 2 * t) / Wk, kx = k0 + 2 * t - ky * Wk;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = 0.f, p1 = 0.f;
        if (!edge || k0 + nb * 8 + 2 * t + e < N) {
          p0 = mtp::exp2_approx(fmaf(s[nb][e], sl2, rel0[ky] + rel0[Hk + kx]) - ls0);
          p1 = mtp::exp2_approx(fmaf(s[nb][2 + e], sl2, rel1[ky] + rel1[Hk + kx]) - ls1);
        }
        s[nb][e] = p0 * (dp[nb][e] - dl0);
        s[nb][2 + e] = p1 * (dp[nb][2 + e] - dl1);
        mtp::advance_key(ky, kx, e == 0 ? 1 : 7, Wk);
      }
    }

    // dQ += dS·K on the tensor cores, dS as its bf16 part and the bf16 of
    // its rest (two products): dS is P·(dP − delta) with |dP| ~ ‖dO‖·‖V‖, and
    // rounded once to bf16 it put dQ two bf16 ulps off the fp32 product at
    // short rows (N = 36, the OSCD 96² recipes' grid)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4], rest[4];
      mtp::a_split_from_c(a, rest, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b[4];
        mtp::ldmatrix_x4_trans(b, kt + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(dqa[nd], a, b[0], b[1]);
        mtp::mma_bf16(dqa[nd], rest, b[0], b[1]);
        mtp::mma_bf16(dqa[nd + 1], a, b[2], b[3]);
        mtp::mma_bf16(dqa[nd + 1], rest, b[2], b[3]);
      }
    }

    // the fp32 dS into its half of the two-tile window; once the window is
    // full (or the keys end), its sums per (row, key row) and (row, key
    // column), each with one owning thread
    float* d0 = dst + (warp * 16 + g) * DSS + (it & 1) * BK + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      d0[nb * 8] = s[nb][0];
      d0[nb * 8 + 1] = s[nb][1];
      d0[8 * DSS + nb * 8] = s[nb][2];
      d0[8 * DSS + nb * 8 + 1] = s[nb][3];
    }
    if ((it & 1) == 0 && it + 1 < n_tiles)
      continue;  // the next tile's barrier comes before the window is read
    __syncthreads();
    const int w0 = (it & ~1) * BK, nk = min(2 * BK, N - w0);
    const int ky_lo = w0 / Wk, kx_lo = w0 - ky_lo * Wk;
    const int nky = (w0 + nk - 1) / Wk - ky_lo + 1, nkx = min(Wk, nk);
    {  // key-row sums: the thread owns row tid % 64 and the rows y = tid / 64 + 2u
      const int r = tid & (kTcRows - 1);
      const float* row = dst + r * DSS;
      for (int y = tid >> 6; y < nky; y += 2) {
        const int ky_i = ky_lo + y;
        const int jlo = max(0, ky_i * Wk - w0), jhi = min(nk, (ky_i + 1) * Wk - w0);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int j = jlo;
        for (; j + 3 < jhi; j += 4) {
          a0 += row[j];
          a1 += row[j + 1];
          a2 += row[j + 2];
          a3 += row[j + 3];
        }
        for (; j < jhi; ++j) a0 += row[j];
        acc[r * RS + ky_i] += (a0 + a1) + (a2 + a3);
      }
    }
    if (Wk >= 32)
      bin_columns<2>(dst, DSS, acc, RS, Hk, Wk, kx_lo, nk, nkx);
    else if (Wk >= 22)
      bin_columns<3>(dst, DSS, acc, RS, Hk, Wk, kx_lo, nk, nkx);
    else if (Wk >= 8)
      bin_columns<8>(dst, DSS, acc, RS, Hk, Wk, kx_lo, nk, nkx);
    else
      bin_columns<64>(dst, DSS, acc, RS, Hk, Wk, kx_lo, nk, nkx);
  }
  __syncthreads();  // the last window's sums are in

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
  for (int r = warp; r < nq; r += kTC / 32) {
    float* dst_h = drel_h + (rbase + r) * Hk;
    float* dst_w = drel_w + (rbase + r) * Wk - Hk;
    for (int c = lane; c < Hk + Wk; c += 32) (c < Hk ? dst_h : dst_w)[c] = acc[r * RS + c];
  }
}

// (b) k-major pass.  A stage holds a query tile's q and dO rows (bf16), its
// lse and delta, the rel_h columns ky_lo..ky_lo+nky_max-1 of its rows (the
// key rows this block's keys span) and its whole rel_w rows; the rel rows of
// consecutive queries are contiguous in device memory, so each thread's
// copies of a stage are fixed offsets from the tile's start.
template <int D>
__global__ void __launch_bounds__(kTC, Tc<D>::kMinBlocks)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ rel_h,
                        const float* __restrict__ rel_w, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int Hk, int Wk,
                        int k_tiles, int nky_max, float scale) {
  using C = Tc<D>;
  constexpr int LD = C::LD, BQ = C::kStream, S = C::kStagesQ;
  constexpr int KD = D / 16, ND = D / 8, NB = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // 64 × LD, resident
  bf16* vs = ks + kTcRows * LD;                  // 64 × LD, resident
  bf16* ring = vs + kTcRows * LD;                // S stages × [q | dO] × BQ × LD
  // S stages × [lse (BQ) | delta (BQ) | rel_h (BQ × nky_max) | rel_w (BQ × Wk)]
  float* fring = reinterpret_cast<float*>(ring + S * 2 * BQ * LD);
  const int FS = BQ * (2 + nky_max + Wk);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kTcRows;
  const long long base = static_cast<long long>(bh) * N * D;
  const long long lb = static_cast<long long>(bh) * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const int ky_lo = k0 / Wk;
  const int nky = min(Hk - 1, (k0 + kTcRows - 1) / Wk) - ky_lo + 1;
  // the stage offsets of the rel values of the thread's keys ka (row g) and
  // kb (row g+8)
  const int ka = warp * 16 + g, kb = ka + 8;
  const bool va = k0 + ka < N, vb = k0 + kb < N;
  const int cha = va ? (k0 + ka) / Wk - ky_lo : 0, cwa = va ? (k0 + ka) % Wk : 0;
  const int chb = vb ? (k0 + kb) / Wk - ky_lo : 0, cwb = vb ? (k0 + kb) % Wk : 0;

  const int n_rh = BQ * nky, n_rw = BQ * Wk;
  auto load_stage = [&](int stage, int q0) {
    bf16* qt = ring + stage * 2 * BQ * LD;
    mtp::load_rows_async<BQ, D, LD, kTC>(qt, q + base, q0, N);
    mtp::load_rows_async<BQ, D, LD, kTC>(qt + BQ * LD, dout + base, q0, N);
    float* f = fring + stage * FS;
    const int nv = min(BQ, N - q0);  // rows of the tile inside N
    if (tid < 2 * BQ) {
      const int r = tid & (BQ - 1);
      mtp::cp_async4(f + tid, (tid < BQ ? lse : delta) + lb + q0 + (r < nv ? r : 0), r < nv);
    }
    const float* src_h = rel_h + (lb + q0) * Hk + ky_lo;
    for (int i = tid; i < n_rh; i += kTC) {  // i = c·BQ + r: column c of row r
      const int r = i & (BQ - 1), c = i / BQ;
      mtp::cp_async4(f + 2 * BQ + r * nky_max + c, src_h + (r < nv ? r * Hk + c : 0), r < nv);
    }
    const float* src_w = rel_w + (lb + q0) * Wk;
    float* dst_w = f + BQ * (2 + nky_max);
    for (int i = tid; i < n_rw; i += kTC) mtp::cp_async4(dst_w + i, src_w + (i < nv * Wk ? i : 0), i < nv * Wk);
  };

  const int n_tiles = (N + BQ - 1) / BQ;
  mtp::load_rows_async<kTcRows, D, LD, kTC>(ks, k + base, k0, N);
  mtp::load_rows_async<kTcRows, D, LD, kTC>(vs, v + base, k0, N);
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

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BQ;
    mtp::cp_async_wait<S - 2>();  // this stage (and on the first, K and V) has landed
    __syncthreads();              // for every warp, which are all past tile it - 1
    if (it + S - 1 < n_tiles) load_stage((it + S - 1) % S, q0 + (S - 1) * BQ);
    mtp::cp_async_commit();
    const bf16* qt = ring + (it % S) * 2 * BQ * LD;
    const bf16* dt = qt + BQ * LD;
    const float* f = fring + (it % S) * FS;
    const float* rh = f + 2 * BQ;
    const float* rw = rh + BQ * nky_max;

    // S^T = K·Q^T and dP^T = V·dO^T: rows the warp's 16 keys, columns the
    // tile's queries
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = dp[nb][0] = dp[nb][1] = dp[nb][2] =
          dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4], vf[4];
      const int aoff = mtp::a_frag_offset(lane, warp * 16, kk * 16, LD);
      mtp::ldmatrix_x4(kf, ks + aoff);
      mtp::ldmatrix_x4(vf, vs + aoff);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        const int off = mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD);
        mtp::ldmatrix_x4(b, qt + off);
        mtp::mma_bf16(s[nb], kf, b[0], b[1]);
        mtp::mma_bf16(s[nb + 1], kf, b[2], b[3]);
        mtp::ldmatrix_x4(b, dt + off);
        mtp::mma_bf16(dp[nb], vf, b[0], b[1]);
        mtp::mma_bf16(dp[nb + 1], vf, b[2], b[3]);
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
        const float* rhq = rh + qc * nky_max;
        const float* rwq = rw + qc * Wk;
        const float ls = f[qc], dl = f[BQ + qc];
        float pa = mtp::exp2_approx((fmaf(s[nb][e], scale, rhq[cha] + rwq[cwa]) - ls) * mtp::kLog2e);
        float pb = mtp::exp2_approx((fmaf(s[nb][2 + e], scale, rhq[chb] + rwq[cwb]) - ls) * mtp::kLog2e);
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
        uint32_t b[4];
        const int off = mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD);
        mtp::ldmatrix_x4_trans(b, dt + off);
        mtp::mma_bf16(dva[nd], pa, b[0], b[1]);
        mtp::mma_bf16(dva[nd + 1], pa, b[2], b[3]);
        mtp::ldmatrix_x4_trans(b, qt + off);
        mtp::mma_bf16(dka[nd], da, b[0], b[1]);
        mtp::mma_bf16(dka[nd + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (va) {
      const long long o = base + static_cast<long long>(k0 + ka) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = mtp::pack_bf16(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = mtp::pack_bf16(dva[nd][0], dva[nd][1]);
    }
    if (vb) {
      const long long o = base + static_cast<long long>(k0 + kb) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = mtp::pack_bf16(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = mtp::pack_bf16(dva[nd][2], dva[nd][3]);
    }
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* rh,
                      const float* rw, const bf16* out, const float* lse, const bf16* dout,
                      bf16* dq, bf16* dk, bf16* dv, float* drel_h, float* drel_w, float* delta,
                      int BH, int N, int Hk, int Wk, float scale, cudaStream_t stream) {
  using C = Tc<D>;
  const size_t smem_a = static_cast<size_t>(C::kRing) + C::kQdo +
                        (2 * static_cast<size_t>(kTcRows) * ((Hk + Wk) | 1) + kTcRows) * sizeof(float);
  // key rows 64 consecutive keys span
  const int nky_max = std::min(Hk, (kTcRows - 1) / Wk + 2);
  const size_t smem_b =
      (2 * kTcRows + 2 * C::kStagesQ * C::kStream) * static_cast<size_t>(C::LD) * 2 +
      static_cast<size_t>(C::kStagesQ) * C::kStream * (2 + nky_max + Wk) * sizeof(float);
  auto ka = flash_bwd_dq_tc_kernel<D>;
  auto kb = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kTcRows - 1) / kTcRows, k_tiles = q_tiles;
  ka<<<BH * q_tiles, kTC, smem_a, stream>>>(q, k, v, rh, rw, out, lse, dout, dq, drel_h, drel_w,
                                            delta, N, Hk, Wk, q_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<BH * k_tiles, kTC, smem_b, stream>>>(q, k, v, rh, rw, dout, lse, delta, dk, dv, N, Hk,
                                            Wk, k_tiles, nky_max, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* rel_h, const void* rel_w, const void* out,
                                  const void* lse, const void* dout, void* dq, void* dk,
                                  void* dv, void* drel_h, void* drel_w, void* delta, int BH,
                                  int N, int D, int Hk, int Wk, float scale, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const float* ls = static_cast<const float*>(lse);
  float* drh = static_cast<float*>(drel_h);
  float* drw = static_cast<float*>(drel_w);
  float* dl = static_cast<float*>(delta);
  if (dtype == mtp::kFloat32)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), rh, rw, static_cast<const float*>(out), ls,
                      static_cast<const float*>(dout), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), drh, drw, dl, BH, N, D,
                      Hk, Wk, scale, st);
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
#define MTP_FLASH_BWD_D(d)                                                                  \
  case d:                                                                                   \
    return launch_tc<d>(qb, kb, vb, rh, rw, ob, ls, dob, dqb, dkb, dvb, drh, drw, dl, BH, N, \
                        Hk, Wk, scale, st);
    MTP_FLASH_BWD_D(16)
    MTP_FLASH_BWD_D(32)
    MTP_FLASH_BWD_D(48)
    MTP_FLASH_BWD_D(64)
    MTP_FLASH_BWD_D(80)
    MTP_FLASH_BWD_D(96)
    MTP_FLASH_BWD_D(112)
    MTP_FLASH_BWD_D(128)
#undef MTP_FLASH_BWD_D
    default:
      return cudaErrorInvalidValue;
  }
}
