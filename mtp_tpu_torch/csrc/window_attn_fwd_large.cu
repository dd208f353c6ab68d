// K1L — fused window attention, forward, for windows too large for K1.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_forward`
// (pallas_call at :662; kernel body `_attn_kernel` :38-58) at pack = 1 for
// every window whose K1 block (csrc/window_attn_fwd.cu: the whole window's
// q, k, v and N×N scores in shared memory) exceeds the 227 KB of one block —
// above N ≈ 160 at D = 64.  Its one caller on the main path is the ViT's
// full attention over grids wider than 128 tokens per axis
// (models/vit_rvsa.py `FullAttention`), one window of N = H·W tokens with the
// materialised decomposed bias: N = 16,900 at a 2080² input.
//
// Computes, per (window w, head h), the same function as K1:
//     out[w, h] = softmax(q[w, h] · k[w, h]^T · scale + bias[w, h]) · v[w, h]
// q/k/v (W, nH, N, D) fp32 or bf16 with D <= 128, bias (W, nH, N, N) fp32,
// fp32 math and softmax, the output in q's dtype.
//
// What bounds it on the H100: the bias is read once, 4·N² bytes per (window,
// head) — 18.3 GB at nH = 16, N = 16,900, 5.5 ms at 3.35 TB/s — against
// 4·N²·D FLOPs (1.17 TFLOP there).  On the CUDA cores' 67 TFLOP/s fp32 the
// arithmetic bounds it (17 ms); tensor cores would move the bound to the
// bias bytes, and are later work.
//
// The design: one block per (window·head, 64-query tile), 256 threads as a
// 16×16 grid; keys are streamed in 64-key tiles through shared memory with
// an online softmax (running max and sum in fp32, as K2).  Each thread owns
// a 4×4 micro-tile of the score tile (query rows ty + 16a, keys tx + 16b) and
// the matching 4 × D/16 slice of the output accumulator in registers, so each
// shared-memory read feeds two FMAs.  The bias tile is read straight from
// device memory, each row's 64 keys by consecutive threads (coalesced along
// keys); keys past N are masked to -1e30 as in the TPU kernel, and rows past
// N read no bias.  Every bias offset is 64-bit: the bias of one call holds
// more than 2^31 elements at the main path's shape.  The wrapper saves no
// log-sum-exp (the backward, K7, recomputes the row statistics, as the TPU
// kernels do).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 × 16
constexpr int kR = kBQ / 16;       // query rows per thread
constexpr int kC = kBK / 16;       // keys per thread
constexpr int kMaxD = 128;
constexpr int kDC = kMaxD / 16;    // output columns per thread, at most
constexpr int kSp = kBK + 16;      // probability row stride: rows ty, ty+1 land 16 banks apart
constexpr float kMasked = -1e30f;  // padded keys, as the TPU kernel's _NEG

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_large_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, int N, int D, int q_tiles, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;           // kBQ × Dp
  float* ks = qs + kBQ * Dp;  // kBK × Dp
  float* vs = ks + kBK * Dp;  // kBK × Dp
  float* ps = vs + kBK * Dp;  // kBQ × kSp probabilities of the tile

  const long long wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int nq = min(kBQ, N - q0);
  const long long base = wh * N * D;
  const float* b = bias + wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  mtp::stage_rows<kThreads>(qs, q + base, q0, nq, kBQ, D);
  float m[kR], l[kR], o[kR][kDC];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int d = 0; d < kDC; ++d) o[a][d] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    mtp::stage_rows<kThreads>(ks, k + base, k0, nk, kBK, D);
    mtp::stage_rows<kThreads>(vs, v + base, k0, nk, kBK, D);
    __syncthreads();

    float s[kR][kC] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qr[kR], kc[kC];
#pragma unroll
      for (int a = 0; a < kR; ++a) qr[a] = qs[(ty + 16 * a) * Dp + c];
#pragma unroll
      for (int j = 0; j < kC; ++j) kc[j] = ks[(tx + 16 * j) * Dp + c];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[a][j] = fmaf(qr[a], kc[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = ty + 16 * a;
      const long long row = (static_cast<long long>(q0) + r) * N + k0;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kk = tx + 16 * j;
        float val = kMasked;
        if (kk < nk) val = s[a][j] * scale + (r < nq ? b[row + kk] : 0.f);
        s[a][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[a], mtp::half_warp_max(mx));  // finite: nk >= 1
      const float alpha = expf(m[a] - m_new);       // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = expf(s[a][j] - m_new);
        ps[r * kSp + tx + 16 * j] = p;
        sum += p;
      }
      l[a] = l[a] * alpha + mtp::half_warp_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int d = 0; d < kDC; ++d) o[a][d] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float pr[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) pr[a] = ps[(ty + 16 * a) * kSp + j];
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const int c = tx + 16 * d;
        if (c < D) {
          const float vv = vs[j * Dp + c];
#pragma unroll
          for (int a = 0; a < kR; ++a) o[a][d] = fmaf(pr[a], vv, o[a][d]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    const float inv = 1.f / l[a];
    T* orow = out + base + (static_cast<long long>(q0) + r) * D;
#pragma unroll
    for (int d = 0; d < kDC; ++d) {
      const int c = tx + 16 * d;
      if (c < D) orow[c] = mtp::from_f32<T>(o[a][d] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, int WH, int N, int D, float scale, cudaStream_t stream) {
  if (D < 1 || D > kMaxD || N < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(3 * kBQ * (D + 1) + kBQ * kSp) * sizeof(float);
  auto kernel = window_attn_fwd_large_kernel<T>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<static_cast<unsigned>(WH) * q_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), N, D, q_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_fwd_large(const void* q, const void* k, const void* v,
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
