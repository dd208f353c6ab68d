// K1 — fused window attention, forward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_forward`
// (pallas_call at :662; kernel bodies `_attn_kernel` :38-58 and
// `_attn_kernel_packed` :61-88).
//
// Computes, per (window w, head h):
//     out[w, h] = softmax(q[w, h] · k[w, h]^T · scale + bias[w, h]) · v[w, h]
// with q/k/v (W, nH, N, D) in fp32 or bf16, bias (W, nH, N, N) fp32, fp32
// math and softmax, and the output in q's dtype.
//
// What bounds it on the H100: at the slice shape (W·nH = 1024 blocks, N = 49,
// D = 64) a block reads 3·49·64 inputs plus a 49·49 fp32 bias (~28 KB in
// bf16) for 2·2·49²·64 ≈ 0.6 MFLOP, about 22 FLOP per byte — far below the
// ~295 FLOP/B ridge, so it is bound by memory traffic and latency, not by
// arithmetic.  The design reads every input exactly once: q, k and v are
// staged in shared memory as fp32 (rows padded to D+1 so the column walks
// of the score and value loops hit distinct banks), the N×N scores never
// leave shared memory, and one warp normalises each softmax row.  The loops
// run over the exact N: the TPU kernel's padding to 64 rows and its packing
// of two windows into one 128-row MXU tile are not carried over.  Products
// run on the CUDA cores; tensor cores (mma/wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ out, int N, int D, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;
  float* ks = qs + N * Dp;
  float* vs = ks + N * Dp;
  float* s = vs + N * Dp;  // N×N scores, then probabilities

  const long long base = static_cast<long long>(blockIdx.x) * N * D;
  const float* b = bias + static_cast<long long>(blockIdx.x) * N * N;

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r * Dp + c] = mtp::to_f32(q[base + i]);
    ks[r * Dp + c] = mtp::to_f32(k[base + i]);
    vs[r * Dp + c] = mtp::to_f32(v[base + i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, j = i % N;
    const float* qr = qs + r * Dp;
    const float* kj = ks + j * Dp;
    float acc = 0.f;
    for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kj[c], acc);
    s[i] = acc * scale + b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += blockDim.x >> 5) {
    float* sr = s + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
    mx = mtp::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    const float inv = 1.f / mtp::warp_sum(sum);
    for (int j = lane; j < N; j += 32) sr[j] *= inv;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const float* pr = s + r * N;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(pr[j], vs[j * Dp + c], acc);
    out[base + i] = mtp::from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, int WH, int N, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * N * (D + 1) + N * N) * sizeof(float);
  auto kernel = window_attn_fwd_kernel<T>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<WH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), N, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int WH, int N,
                                   int D, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(q, k, v, bias, out, WH, N, D, scale, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, bias, out, WH, N, D, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
