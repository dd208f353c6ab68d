// K7 — window attention, q-blocked backward, for windows too large for K4.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_win_backward_qblocked`
// (pallas_call at :271; kernel body `_win_bwd_qblk_kernel` :198-246), which
// `_fused_backward` takes at pack = 1 when round_up(N, 8) > 512 (:302-303).
// The port also takes it for the windows of JAX's one-shot range whose K4
// block (csrc/window_attn_bwd.cu: the whole window and two N×N tiles in
// shared memory) exceeds the 227 KB of one block — above N ≈ 117 at D = 64.
// Its one caller on the main path is the backward of the ViT's full
// attention over grids wider than 128 tokens per axis: one window of
// N = H·W tokens, N = 16,900 at a 2080² input.
//
// Computes, per (window w, head h), for the output cotangent dO, the VJP of
// K1/K1L (the TPU kernel's :213-246), with P recomputed from q, k and the bias:
//     s = q·k^T · scale + bias,  P = softmax_k(s),  dP = dO · v^T,
//     dS = P ∘ (dP − rowsum(P ∘ dP)),
//     dQ = dS · k · scale,  dK = dS^T · q · scale,  dV = P^T · dO,  dbias = dS
// q/k/v/dO (W, nH, N, D) fp32 or bf16 with D <= 128, bias (W, nH, N, N) fp32;
// dQ/dK/dV in q's dtype, dbias fp32.
//
// What bounds it on the H100: the bias is read and dbias written once, 8·N²
// bytes per (window, head) — 36.6 GB at nH = 16, N = 16,900, 10.9 ms at
// 3.35 TB/s — against 10·N²·D FLOPs of the VJP (2.9 TFLOP there); the two
// passes below do 9 fp32 FMAs per (query, key, channel) on the CUDA cores,
// so the arithmetic bounds it; tensor cores are later work.
//
// The design.  On the TPU, dK/dV were carried across q-blocks in one
// resident output block, which relies on the grid running in order; Hopper
// runs blocks in no order.  So, as K5, the work is split into two passes,
// each block writing only what it owns — deterministic, no atomics:
//  (a) q-major, one block per (window·head, 64-query tile): a first sweep
//      over the 64-key tiles keeps each row's running max and sum and the
//      running rowsum(exp(s − m) ∘ dP) (online softmax), giving the row's
//      log-sum-exp and delta = rowsum(P ∘ dP) exactly; a second sweep
//      recomputes P, forms dS, writes it to dbias and accumulates dQ.  The
//      row statistics go to a (2, W·nH, N) scratch buffer of the wrapper.
//  (b) k-major, one block per (window·head, 64-key tile): sweeps the 64-query
//      tiles, recomputes P = exp(s − lse) and dS from the row statistics, and
//      accumulates dK and dV.
// Both passes read the bias tile straight from device memory, 64 keys of a
// row by consecutive threads.  256 threads as a 16×16 grid: each thread owns
// a 4×4 micro-tile of the score and dP tiles (query rows ty + 16a, keys
// tx + 16b) and a 4 × D/16 slice of its accumulators in registers, so each
// shared-memory read feeds two FMAs.  Keys past N are masked to -1e30 as in
// the TPU kernel; rows past N read no bias and contribute nothing.  Every
// bias and dbias offset is 64-bit: one call's bias holds more than 2^31
// elements at the main path's shape.
#include "common.cuh"

namespace {

constexpr int kB = 64;             // queries per q tile and keys per key tile
constexpr int kThreads = 256;      // 16 × 16
constexpr int kR = kB / 16;        // rows (or keys) per thread
constexpr int kMaxD = 128;
constexpr int kDC = kMaxD / 16;    // accumulator columns per thread, at most
constexpr int kSp = kB + 16;       // score row stride: rows ty, ty+1 land 16 banks apart
constexpr float kMasked = -1e30f;  // padded keys, as the TPU kernel's _NEG

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

// (a) q-major pass: row statistics, dQ and dbias.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float* __restrict__ dbias, float* __restrict__ lse_out,
                     float* __restrict__ delta_out, int N, int D, int q_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;           // kB × Dp
  float* dos = qs + kB * Dp;  // kB × Dp
  float* ks = dos + kB * Dp;  // kB × Dp
  float* vs = ks + kB * Dp;   // kB × Dp
  float* dss = vs + kB * Dp;  // kB × kSp dS of the tile

  const long long wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kB;
  const int nq = min(kB, N - q0);
  const long long base = wh * N * D;
  const long long bbase = wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  stage(qs, q + base, q0, nq, D);
  stage(dos, dout + base, q0, nq, D);
  float m[kR], l[kR], dl[kR];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    m[a] = -INFINITY;
    l[a] = dl[a] = 0.f;
  }
  float s[kR][kR], dp[kR][kR];

  // sweep 1: log-sum-exp and delta of every row
  for (int k0 = 0; k0 < N; k0 += kB) {
    const int nk = min(kB, N - k0);
    __syncthreads();  // the previous tile's ks/vs are consumed
    stage(ks, k + base, k0, nk, D);
    stage(vs, v + base, k0, nk, D);
    __syncthreads();
    products(qs, dos, ks, vs, D, s, dp);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = ty + 16 * a;
      const long long row = bbase + (static_cast<long long>(q0) + r) * N + k0;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kk = tx + 16 * j;
        float val = kMasked;
        if (kk < nk) val = s[a][j] * scale + (r < nq ? bias[row + kk] : 0.f);
        s[a][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[a], mtp::half_warp_max(mx));  // finite: nk >= 1
      const float alpha = expf(m[a] - m_new);       // 0 on the first tile
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float e = expf(s[a][j] - m_new);
        sum += e;
        dsum += e * dp[a][j];
      }
      l[a] = l[a] * alpha + mtp::half_warp_sum(sum);
      dl[a] = dl[a] * alpha + mtp::half_warp_sum(dsum);
      m[a] = m_new;
    }
  }
  float lse[kR], delta[kR];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = ty + 16 * a;
    lse[a] = m[a] + logf(l[a]);
    delta[a] = dl[a] / l[a];
    if (tx == 0 && r < nq) {
      lse_out[wh * N + q0 + r] = lse[a];
      delta_out[wh * N + q0 + r] = delta[a];
    }
  }

  // sweep 2: dS (to dbias and shared memory), dQ
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

// (b) k-major pass: dK, dV from the row statistics.
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, void* dq, void* dk, void* dv, void* dbias, void* stats,
                   int WH, int N, int D, float scale, cudaStream_t stream) {
  if (D < 1 || D > kMaxD || N < 1) return cudaErrorInvalidValue;
  const int Dp = D + 1;
  const size_t smem_a = static_cast<size_t>(4 * kB * Dp + kB * kSp) * sizeof(float);
  const size_t smem_b = static_cast<size_t>(4 * kB * Dp + 2 * kB * kSp + 2 * kB) * sizeof(float);
  auto ka = window_bwd_dq_kernel<T>;
  auto kb = window_bwd_dkv_kernel<T>;
  cudaError_t err = mtp::allow_smem(ka, smem_a);
  if (err != cudaSuccess) return err;
  err = mtp::allow_smem(kb, smem_b);
  if (err != cudaSuccess) return err;
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<long long>(WH) * N;
  const int tiles = (N + kB - 1) / kB;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* bt = static_cast<const float*>(bias);
  const unsigned blocks = static_cast<unsigned>(WH) * tiles;
  ka<<<blocks, kThreads, smem_a, stream>>>(qt, kt, vt, bt, dot, static_cast<T*>(dq),
                                           static_cast<float*>(dbias), lse, delta, N, D,
                                           tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<blocks, kThreads, smem_b, stream>>>(qt, kt, vt, bt, dot, lse, delta,
                                           static_cast<T*>(dk), static_cast<T*>(dv), N, D,
                                           tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_bwd_qblk(const void* q, const void* k, const void* v,
                                        const void* bias, const void* dout, void* dq,
                                        void* dk, void* dv, void* dbias, void* stats,
                                        int WH, int N, int D, float scale, int dtype,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(q, k, v, bias, dout, dq, dk, dv, dbias, stats, WH, N, D, scale,
                           st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, dbias, stats, WH, N, D,
                                   scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
