// K4 — fused window attention, backward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_backward`
// (pallas_call at :327; kernel body `_win_bwd_kernel` :135-188).
//
// Computes, per (window w, head h), for the output cotangent dO:
//     P  = softmax(q · k^T · scale + bias)        (recomputed, fp32)
//     dV = P^T · dO,   dP = dO · v^T,   dS = P ∘ (dP − rowsum(P ∘ dP))
//     dQ = dS · k · scale,   dK = dS^T · q · scale,   dbias = dS
// with q/k/v/dO (W, nH, N, D) in fp32 or bf16, bias (W, nH, N, N) fp32,
// dQ/dK/dV in q's dtype and dbias fp32 (it feeds autograd into the
// q-dependent decomposed rel-pos bias and the Swin table).
//
// What bounds it on the H100: at the slice shape (W·nH = 2048 blocks at
// batch 8, N = 49, D = 64) a block reads 4·49·64 inputs and a 49·49 fp32
// bias and writes the same again (~50 KB in bf16) for 6·2·49²·64 ≈ 1.8
// MFLOP: ~36 FLOP per byte, far below the ~295 FLOP/B ridge, so memory
// traffic and latency bound it, as they bound K1.  The design: one block per
// (window, head), like K1.  The whole 49-key row is resident, so P is
// recomputed exactly from the same inputs (no saved statistics), and
// rowsum(P ∘ dP) is exact too.  q, k, v, dO are staged once in shared memory
// as fp32 rows of D+1 (column walks hit distinct banks); P and dP/dS stay in
// shared memory (70 KB at the slice shape); one warp normalises each softmax
// row and forms each dS row.  The three products dQ, dK, dV share one loop
// over the (row, channel) outputs.  Loops run over the exact N: the TPU
// kernel's padding to 64 rows and packing of two windows into one 128-row
// MXU tile are not carried over.  CUDA cores only; tensor cores are later
// work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dbias, int N, int D, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;
  float* ks = qs + N * Dp;
  float* vs = ks + N * Dp;
  float* dos = vs + N * Dp;
  float* p = dos + N * Dp;  // N×N probabilities
  float* ds = p + N * N;    // N×N dP, then dS

  const long long base = static_cast<long long>(blockIdx.x) * N * D;
  const long long bbase = static_cast<long long>(blockIdx.x) * N * N;

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r * Dp + c] = mtp::to_f32(q[base + i]);
    ks[r * Dp + c] = mtp::to_f32(k[base + i]);
    vs[r * Dp + c] = mtp::to_f32(v[base + i]);
    dos[r * Dp + c] = mtp::to_f32(dout[base + i]);
  }
  __syncthreads();

  // scores and dP = dO · v^T
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, j = i % N;
    const float* qr = qs + r * Dp;
    const float* kj = ks + j * Dp;
    const float* dor = dos + r * Dp;
    const float* vj = vs + j * Dp;
    float s = 0.f, dp = 0.f;
    for (int c = 0; c < D; ++c) {
      s = fmaf(qr[c], kj[c], s);
      dp = fmaf(dor[c], vj[c], dp);
    }
    p[i] = s * scale + bias[bbase + i];
    ds[i] = dp;
  }
  __syncthreads();

  // per row: softmax, delta = rowsum(P ∘ dP), dS = P ∘ (dP − delta)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += blockDim.x >> 5) {
    float* pr = p + r * N;
    float* dsr = ds + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, pr[j]);
    mx = mtp::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    const float inv = 1.f / mtp::warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < N; j += 32) {
      pr[j] *= inv;
      delta = fmaf(pr[j], dsr[j], delta);
    }
    delta = mtp::warp_sum(delta);
    for (int j = lane; j < N; j += 32) {
      const float g = pr[j] * (dsr[j] - delta);
      dsr[j] = g;
      dbias[bbase + r * N + j] = g;
    }
  }
  __syncthreads();

  // dQ[r] = scale·Σ_j dS[r, j] k[j];  dK[r] = scale·Σ_j dS[j, r] q[j];
  // dV[r] = Σ_j P[j, r] dO[j]
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int j = 0; j < N; ++j) {
      aq = fmaf(ds[r * N + j], ks[j * Dp + c], aq);
      ak = fmaf(ds[j * N + r], qs[j * Dp + c], ak);
      av = fmaf(p[j * N + r], dos[j * Dp + c], av);
    }
    dq[base + i] = mtp::from_f32<T>(aq * scale);
    dk[base + i] = mtp::from_f32<T>(ak * scale);
    dv[base + i] = mtp::from_f32<T>(av);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, void* dq, void* dk, void* dv, void* dbias,
                   int WH, int N, int D, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * N * (D + 1) + 2 * N * N) * sizeof(float);
  auto kernel = window_attn_bwd_kernel<T>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<WH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dbias), N, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, void* dq,
                                   void* dk, void* dv, void* dbias, int WH, int N,
                                   int D, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(q, k, v, bias, dout, dq, dk, dv, dbias, WH, N, D, scale, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, dbias, WH, N, D,
                                   scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
