// K1 — fused window attention, forward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_forward`
// (pallas_call at :662; kernel bodies `_attn_kernel` :38-58 and
// `_attn_kernel_packed` :61-88) for every window whose backward is K4
// (ops/fused_attn.py `window_fwd_route`): RVSA's 7×7 windows, N = 49.
//
// Computes, per (window w, head h):
//     out[w, h] = softmax(q[w, h] · k[w, h]^T · scale + bias[w, h]) · v[w, h]
// with q/k/v (W, nH, N, D) in fp32 or bf16, bias (W, nH, N, N) fp32, fp32
// math and softmax, and the output in q's dtype.
//
// What bounds it on the H100: at the serving shape (W·nH = 1024 pairs,
// N = 49, D = 64) a pair reads 3·49·64 bf16 inputs and a 49·49 fp32 bias
// and writes 49·64 bf16 (34.7 KB) for 4·49²·64 ≈ 0.6 MFLOP, about 18 FLOP
// per byte, far below the ~295 FLOP/B ridge: 35.5 MB a call, 0.0106 ms at
// 3.35 TB/s.  So the design is about keeping the copies in flight.
//
// bf16, N <= 64, D a multiple of 16 up to 128 (`window_attn_fwd_tc_kernel<D>`;
// the wrapper zero-pads other head dims; csrc/window_tile.cuh): a window is
// one 64-row tile, 4 warps of 16 query rows.  S = q·k^T and O = P·V run on
// the tensor cores (mma.sync m16n8k16 with ldmatrix, fp32 accumulators);
// the softmax stays in registers (a row's 64 keys span one quad's
// fragments: max and sum are quad shuffles) and P becomes the bf16 A
// operand of P·V without leaving them.  The output goes through the warp's
// own q rows for 16-byte coalesced stores.  Blocks are persistent, about
// SMs × 3 of them, each walking a run of (window, head) pairs through a
// two-stage cp.async ring: pair i + 1's q, k, v and bias (36.4 KB at
// N = 49, D = 64) load while pair i is computed.  The bias of a pair is
// 16-byte aligned for every 4th pair only at N = 49, so its N² floats go
// by 4-byte cp.async, which takes any alignment (window_tile.cuh).  The TPU kernel's packing
// of two windows into one 128-row MXU tile is not carried over.
//
// fp32, bf16 windows of 64 < N (up to ~160 at D = 64, where the block
// fits), and head dims over 128 (`window_attn_fwd_kernel<T>`): CUDA-core
// FMAs, no TF32 (the card-vs-CPU gradient checks hold fp32 to 1e-3).  One
// block per (window, head) stages q, k and v as fp32 rows of D + 1 (column
// walks hit distinct banks); the N×N scores stay in shared memory and one
// warp normalises each softmax row.

#include <stdint.h>

#include "common.cuh"
#include "window_tile.cuh"

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
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* bias,
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

// ------------------------------------------------------ bf16 tensor cores --

using mtp::win::bf16;
namespace win = mtp::win;

template <int D>
struct Fwd {
  static constexpr int kMinBlocks = D <= 64 ? 3 : 2;
  // bytes of one ring stage: the q, k, v tiles and the pair's flat bias
  __host__ __device__ static int stage_bytes(int N) {
    return 3 * win::Tile<D>::kBytes + win::bias_floats(N) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(win::kThreads, Fwd<D>::kMinBlocks)
window_attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          bf16* __restrict__ out, long long pairs, int N, float scale) {
  using T = win::Tile<D>;
  constexpr int LD = T::LD, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage = Fwd<D>::stage_bytes(N);
  // stage st: q | k | v tiles (bf16), then the bias run (fp32)
  auto tile = [&](int st, int i) {
    return reinterpret_cast<bf16*>(smem_raw + st * stage + i * T::kBytes);
  };
  auto bias_at = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * stage + 3 * T::kBytes);
  };
  const long long rows = static_cast<long long>(N) * D;
  auto load_pair = [&](int st, long long p) {
    win::load_tile_async<D>(tile(st, 0), q + p * rows, N);
    win::load_tile_async<D>(tile(st, 1), k + p * rows, N);
    win::load_tile_async<D>(tile(st, 2), v + p * rows, N);
    win::load_bias_async(bias_at(st), bias, p, N);
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sl2 = scale * mtp::kLog2e;

  long long p = blockIdx.x;  // the launch has at most `pairs` blocks
  load_pair(0, p);
  mtp::cp_async_commit();
  for (int it = 0; p < pairs; ++it, p += gridDim.x) {
    const int st = it & 1;
    mtp::cp_async_wait<0>();  // pair p has landed
    __syncthreads();          // and every warp is past pair p - gridDim.x, whose stage refills now
    if (p + gridDim.x < pairs) load_pair(st ^ 1, p + gridDim.x);
    mtp::cp_async_commit();
    bf16* qs = tile(st, 0);
    const float* bs = bias_at(st);

    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
    float s[win::kNB][4], l0, l1;
    win::softmax_rows<D>(s, qf, tile(st, 1), bs, N, sl2, l0, l1);

    const bf16* vs = tile(st, 2);
    float o[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < win::kRows / 16; ++kk) {
      uint32_t a[4];
      mtp::a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        mtp::ldmatrix_x4_trans(bf, vs + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(o[nd], a, bf[0], bf[1]);
        mtp::mma_bf16(o[nd + 1], a, bf[2], bf[3]);
      }
    }
    // out through the warp's own q rows, which only it read
    win::frag_rows_to_tile<D>(qs, o, 1.f / l0, 1.f / l1);
    __syncwarp();
    win::store_warp_rows<D>(out + p * rows, qs, N);
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
                      int WH, int N, float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(Fwd<D>::stage_bytes(N));
  auto kernel = window_attn_fwd_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  unsigned blocks = 0;
  err = win::persistent_grid(kernel, smem, WH, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, win::kThreads, smem, stream>>>(q, k, v, bias, out, WH, N, scale);
  return cudaGetLastError();
}

}  // namespace

// The body by `win::body`: the tensor cores for bf16 windows of N <= 64
// and D <= 128 (D padded to a multiple of 16 by the wrapper, else refused),
// the CUDA cores for everything else.
extern "C" int mtp_window_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int WH, int N,
                                   int D, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (WH < 1 || N < 1 || D < 1) return cudaErrorInvalidValue;
  const win::Body body = win::body(N, D, dtype);
  if (body == win::kUnpadded) return cudaErrorInvalidValue;
  if (body == win::kTensorCores) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const float* b = static_cast<const float*>(bias);
    bf16* ob = static_cast<bf16*>(out);
    switch (D) {
#define MTP_WIN_FWD_D(d) \
  case d:                \
    return launch_tc<d>(qb, kb, vb, b, ob, WH, N, scale, st);
      MTP_WIN_FWD_D(16)
      MTP_WIN_FWD_D(32)
      MTP_WIN_FWD_D(48)
      MTP_WIN_FWD_D(64)
      MTP_WIN_FWD_D(80)
      MTP_WIN_FWD_D(96)
      MTP_WIN_FWD_D(112)
      MTP_WIN_FWD_D(128)
#undef MTP_WIN_FWD_D
    }
    return cudaErrorInvalidValue;  // not reached: D is 16..128 in steps of 16
  }
  switch (dtype) {
    case mtp::kFloat32:
      return launch_simt<float>(q, k, v, bias, out, WH, N, D, scale, st);
    case mtp::kBFloat16:
      return launch_simt<__nv_bfloat16>(q, k, v, bias, out, WH, N, D, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
