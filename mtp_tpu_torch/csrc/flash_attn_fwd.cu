// K2 — flash full attention with the decomposed rel-pos bias, forward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_flash_forward`
// (pallas_call at :421; kernel body `_flash_kernel` :367-393).
//
// Computes, per (batch·head bh, query q):
//     s[q, k]  = q·k^T · scale + rel_h[q, k / Wk] + rel_w[q, k % Wk]
//     out[q]   = softmax_k(s[q, :]) · v
// with q/k/v (BH, N, D) in fp32 or bf16, rel_h (BH, N, Hk) and rel_w
// (BH, N, Wk) fp32, N = Hk·Wk, fp32 math, output in q's dtype.  The (N, N)
// scores and bias never exist in device memory.
//
// What bounds it on the H100: at the slice shape (BH = 64, N = 576, D = 64)
// the call does 2·2·64·576²·64 ≈ 5.4 GFLOP on ~21 MB of inputs (bf16 q/k/v,
// fp32 factors), about 250 FLOP/B — near the ridge, so in a tensor-core
// kernel the arithmetic would bound it; in this first version it is bound
// by the CUDA cores' fp32 rate (67 TFLOP/s) and two shared-memory reads per
// FMA.
// The design: one block per (bh, 64-query tile); keys are streamed in
// 64-key tiles through shared memory with an online softmax (running max
// and sum, fp32 accumulator in shared memory), so, unlike the TPU kernel
// that kept all of K/V resident and padded the bias factors to 128 columns
// (`_REL_PAD`), it has no limit on Hk, Wk or N beyond the shared-memory
// size of the rel_h/rel_w rows (checked by the wrapper).  The bias is added
// from the q-tile's rel_h/rel_w rows staged in shared memory; keys >= N
// are masked.  Tensor cores (wgmma) and TMA are later work.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile (two per lane in the softmax)
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ rel_h,
                      const float* __restrict__ rel_w, T* __restrict__ out,
                      int N, int D, int Hk, int Wk, int q_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1, Sp = kBK + 1;
  float* qs = smem;             // kBQ × Dp
  float* ks = qs + kBQ * Dp;    // kBK × Dp
  float* vs = ks + kBK * Dp;    // kBK × Dp
  float* os = vs + kBK * Dp;    // kBQ × Dp output accumulator
  float* s = os + kBQ * Dp;     // kBQ × Sp scores / probabilities
  float* rh = s + kBQ * Sp;     // kBQ × Hk
  float* rw = rh + kBQ * Hk;    // kBQ × Wk
  float* m_run = rw + kBQ * Wk;
  float* l_run = m_run + kBQ;
  float* alpha = l_run + kBQ;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int nq = min(kBQ, N - q0);
  const long long base = static_cast<long long>(bh) * N * D;
  const long long rbase = static_cast<long long>(bh) * N + q0;
  const int tid = threadIdx.x;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * Dp + c] = r < nq ? mtp::to_f32(q[base + static_cast<long long>(q0 + r) * D + c]) : 0.f;
    os[r * Dp + c] = 0.f;
  }
  for (int i = tid; i < kBQ * Hk; i += kThreads)
    rh[i] = i / Hk < nq ? rel_h[rbase * Hk + i] : 0.f;
  for (int i = tid; i < kBQ * Wk; i += kThreads)
    rw[i] = i / Wk < nq ? rel_w[rbase * Wk + i] : 0.f;
  for (int i = tid; i < kBQ; i += kThreads) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();  // the previous tile's ks/vs/s are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      const long long g = base + static_cast<long long>(k0 + r) * D + c;
      ks[r * Dp + c] = ok ? mtp::to_f32(k[g]) : 0.f;
      vs[r * Dp + c] = ok ? mtp::to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      float val = -INFINITY;
      if (j < nk) {
        const float* qr = qs + r * Dp;
        const float* kj = ks + j * Dp;
        float acc = 0.f;
        for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kj[c], acc);
        const int kk = k0 + j;
        val = acc * scale + rh[r * Hk + kk / Wk] + rw[r * Wk + kk % Wk];
      }
      s[r * Sp + j] = val;
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* sr = s + r * Sp;
      const float mx = mtp::warp_max(fmaxf(sr[lane], sr[lane + 32]));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);  // finite: nk >= 1
      const float p0 = expf(sr[lane] - m_new);
      const float p1 = expf(sr[lane + 32] - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = mtp::warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        alpha[r] = a;
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* pr = s + r * Sp;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], vs[j * Dp + c], acc);
      os[r * Dp + c] = os[r * Dp + c] * alpha[r] + acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, c = i % D;
    out[base + static_cast<long long>(q0 + r) * D + c] =
        mtp::from_f32<T>(os[r * Dp + c] / l_run[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rel_h,
                   const void* rel_w, void* out, int BH, int N, int D, int Hk,
                   int Wk, float scale, cudaStream_t stream) {
  const int Dp = D + 1;
  const size_t smem = static_cast<size_t>(
      (2 * kBQ + 2 * kBK) * Dp + kBQ * (kBK + 1) + kBQ * (Hk + Wk) + 3 * kBQ) * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<T>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<BH * q_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      static_cast<T*>(out), N, D, Hk, Wk, q_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* rel_h, const void* rel_w, void* out,
                                  int BH, int N, int D, int Hk, int Wk,
                                  float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(q, k, v, rel_h, rel_w, out, BH, N, D, Hk, Wk, scale, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, rel_h, rel_w, out, BH, N, D, Hk, Wk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
