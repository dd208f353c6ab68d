// K5 — flash full attention with the decomposed rel-pos bias, backward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_flash_backward`
// (pallas_call at :594; kernel body `_flash_bwd_kernel` :497-561).
//
// Computes, per (batch·head bh), for the output cotangent dO, with
//     s[q, k] = q·k^T · scale + rel_h[q, k / Wk] + rel_w[q, k % Wk],
//     P = softmax_k(s),  dP = dO · v^T,  dS = P ∘ (dP − rowsum(P ∘ dP)):
//     dQ = dS · k · scale,  dK = dS^T · q · scale,  dV = P^T · dO,
//     d(rel_h)[q, ky] = Σ_kx dS[q, ky·Wk + kx],  d(rel_w)[q, kx] = Σ_ky dS[q, ky·Wk + kx]
// with q/k/v/dO (BH, N, D) in fp32 or bf16, rel_h (BH, N, Hk) and rel_w
// (BH, N, Wk) fp32, N = Hk·Wk; dQ/dK/dV in q's dtype, d(rel_h)/d(rel_w)
// fp32.  The (N, N) scores never exist in device memory.
//
// What bounds it on the H100: at the slice shape (BH = 128 at batch 8,
// N = 576, D = 64) the two passes do 9 fp32 FMAs per (query, key, channel),
// ~24 GFLOP, on ~40 MB of inputs and outputs: the CUDA cores' fp32 rate and
// two shared-memory reads per FMA bound it, as they bound K2.
//
// The design.  On the TPU, dK/dV were carried across q-blocks in one
// resident output block, which relies on the grid running in order; Hopper
// runs blocks in no order.  So the work is split into two passes, each
// block writing only what it owns — deterministic, no atomics:
//  (a) q-major, one block per (bh, 32-query tile): a first sweep over the
//      64-key tiles keeps the running row max and sum (online softmax, as
//      K2) and the running rowsum(P ∘ dP), giving each row's log-sum-exp and
//      delta = rowsum(P ∘ dP) exactly; a second sweep recomputes P, forms
//      dS, accumulates dQ in shared memory, and adds each tile's dS sums per
//      key row and key column into the block's own rows of d(rel_h) and
//      d(rel_w) (zeroed by the wrapper).  The per-row log-sum-exp and delta
//      go to a (2, BH, N) buffer.
//  (b) k-major, one block per (bh, 64-key tile): sweeps the 32-query tiles,
//      recomputes P = exp(s − lse) and dS from the saved row statistics, and
//      accumulates dK and dV in shared memory.
// q/k/v/dO are staged in shared memory as fp32 rows of D+1 (column walks hit
// distinct banks); the bias is added from the query tile's rel_h/rel_w rows
// staged in shared memory at k / Wk, k % Wk, so, as in K2, nothing limits Hk
// or Wk but shared memory (checked by the wrapper).  Tensor cores (wgmma)
// and TMA are later work.

#include "common.cuh"

namespace {

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

// (a) q-major pass: row statistics, dQ, d(rel_h), d(rel_w).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ drel_h,
                    float* __restrict__ drel_w, float* __restrict__ lse_out,
                    float* __restrict__ delta_out, int N, int D, int Hk, int Wk,
                    int q_tiles, float scale) {
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
  float* m_run = rw + kBQ * Wk;  // running max, then log-sum-exp
  float* l_run = m_run + kBQ;    // running sum
  float* d_run = l_run + kBQ;    // running rowsum(exp(s − m) ∘ dP), then delta

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
  for (int i = tid; i < kBQ; i += kThreads) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
    d_run[i] = 0.f;
  }

  // sweep 1: log-sum-exp and delta of every row
  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();  // the previous tile's ks/vs/s/dp are consumed
    stage(ks, k + base, k0, nk, kBK, D);
    stage(vs, v + base, k0, nk, kBK, D);
    __syncthreads();
    scores(qs, dos, ks, vs, rh, rw, s, dp, k0, nk, D, Hk, Wk, scale);
    __syncthreads();
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float* sr = s + r * Sp;
      const float* dpr = dp + r * Sp;
      const float mx = mtp::warp_max(fmaxf(sr[lane], sr[lane + 32]));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);  // finite: nk >= 1
      const float e0 = expf(sr[lane] - m_new), e1 = expf(sr[lane + 32] - m_new);
      const float sum = mtp::warp_sum(e0 + e1);
      const float dsum = mtp::warp_sum(e0 * dpr[lane] + e1 * dpr[lane + 32]);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        l_run[r] = l_run[r] * a + sum;
        d_run[r] = d_run[r] * a + dsum;
        m_run[r] = m_new;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < kBQ; r += kThreads) {
    m_run[r] += logf(l_run[r]);
    d_run[r] /= l_run[r];
    if (r < nq) {
      lse_out[rbase + r] = m_run[r];
      delta_out[rbase + r] = d_run[r];
    }
  }

  // sweep 2: dS, dQ, d(rel_h), d(rel_w)
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
      const float p = j < nk && r < nq ? expf(s[r * Sp + j] - m_run[r]) : 0.f;
      s[r * Sp + j] = p * (dp[r * Sp + j] - d_run[r]);
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

// (b) k-major pass: dK, dV from the saved row statistics.
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rel_h,
                   const void* rel_w, const void* dout, void* dq, void* dk, void* dv,
                   void* drel_h, void* drel_w, void* stats, int BH, int N, int D,
                   int Hk, int Wk, float scale, cudaStream_t stream) {
  const int Dp = D + 1, Sp = kBK + 1;
  const size_t smem_a = static_cast<size_t>(
      (3 * kBQ + 2 * kBK) * Dp + 2 * kBQ * Sp + kBQ * (Hk + Wk) + 3 * kBQ) * sizeof(float);
  const size_t smem_b = static_cast<size_t>(
      (4 * kBK + 2 * kBQ) * Dp + 2 * kBQ * Sp + kBQ * (Hk + Wk) + 2 * kBQ) * sizeof(float);
  auto ka = flash_bwd_dq_kernel<T>;
  auto kb = flash_bwd_dkv_kernel<T>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<long long>(BH) * N;
  const int q_tiles = (N + kBQ - 1) / kBQ, k_tiles = (N + kBK - 1) / kBK;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  ka<<<BH * q_tiles, kThreads, smem_a, stream>>>(
      qt, kt, vt, rh, rw, dot, static_cast<T*>(dq), static_cast<float*>(drel_h),
      static_cast<float*>(drel_w), lse, delta, N, D, Hk, Wk, q_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<BH * k_tiles, kThreads, smem_b, stream>>>(
      qt, kt, vt, rh, rw, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N,
      D, Hk, Wk, k_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* rel_h, const void* rel_w, const void* dout,
                                  void* dq, void* dk, void* dv, void* drel_h,
                                  void* drel_w, void* stats, int BH, int N, int D,
                                  int Hk, int Wk, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(q, k, v, rel_h, rel_w, dout, dq, dk, dv, drel_h, drel_w, stats,
                           BH, N, D, Hk, Wk, scale, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, rel_h, rel_w, dout, dq, dk, dv, drel_h,
                                   drel_w, stats, BH, N, D, Hk, Wk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
