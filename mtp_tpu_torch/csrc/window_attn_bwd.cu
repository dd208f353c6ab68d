// K4 — fused window attention, backward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_backward`
// (pallas_call at :327; kernel body `_win_bwd_kernel` :135-188) for every
// window JAX runs through its one-shot kernel and whose block fits here
// (ops/fused_attn.py `window_bwd_route`): RVSA's 7×7 windows, N = 49.
//
// Computes, per (window w, head h), for the output cotangent dO:
//     P  = softmax(q · k^T · scale + bias)        (recomputed, fp32)
//     dV = P^T · dO,   dP = dO · v^T,   dS = P ∘ (dP − rowsum(P ∘ dP))
//     dQ = dS · k · scale,   dK = dS^T · q · scale,   dbias = dS
// with q/k/v/dO (W, nH, N, D) in fp32 or bf16, bias (W, nH, N, N) fp32,
// dQ/dK/dV in q's dtype and dbias fp32 (it feeds autograd into the
// q-dependent decomposed rel-pos bias and the Swin table).
//
// What bounds it on the H100: at the train step's shape (W·nH = 2048 pairs
// at batch 8, N = 49, D = 64) a pair reads 4·49·64 bf16 inputs and a 49·49
// fp32 bias and writes 3·49·64 bf16 and a 49·49 fp32 dbias (63.1 KB) for
// 10·49²·64 ≈ 1.5 MFLOP: ~24 FLOP per byte, far below the ~295 FLOP/B
// ridge, so memory traffic bounds it: 129 MB a call, 0.0386 ms at
// 3.35 TB/s.  It takes no saved statistics: P is recomputed exactly from
// the same inputs, as on the TPU, so the bound holds no out and no lse.
//
// bf16, N <= 64, D a multiple of 16 up to 128 (`window_attn_bwd_tc_kernel<D>`;
// the wrapper zero-pads other head dims; csrc/window_tile.cuh): one pass, no
// atomics — a block owns a whole window, so every output is written once by
// one block and two launches give the same bits.  A window is one 64-row
// tile, 4 warps of 16 query rows; every product runs on the tensor cores
// (mma.sync m16n8k16 with ldmatrix, fp32 accumulators).  Per warp: S and P
// recomputed in registers (the softmax of K1), dP = dO·v^T, rowsum(P ∘ dP)
// by quad shuffles, dS; dS (fp32) overwrites the bias elements the thread
// read, and the pair's N² floats go out to dbias, coalesced; dQ =
// dS·k·scale takes dS from registers; P and dS go to shared memory as bf16,
// and after one barrier each warp computes 16 key rows of dV = P^T·dO and
// dK = dS^T·q·scale, its A operands through ldmatrix.trans.  dQ, dK and dV
// leave through the warp's own rows of the q, k and v tiles, 16-byte
// stores.  P and dS are rounded to bf16 only as tensor-core operands, as in
// K5 and K7.  Blocks are persistent, about SMs × 2, each walking a run of
// (window, head) pairs through a two-stage cp.async ring: pair i + 1's q,
// dO, k, v and bias (45.4 KB at N = 49, D = 64) load while pair i is
// computed; the bias goes as K1's does, by 4-byte cp.async
// (a pair's bias is 16-byte aligned for every 4th pair only at N = 49).
//
// fp32, bf16 windows of 64 < N <= ~117 at D = 64, and head dims over 128
// (`window_attn_bwd_kernel<T>`): CUDA-core FMAs, no TF32.  One block per
// (window, head) stages q, k, v, dO as fp32 rows of D + 1; P and dP/dS stay
// in shared memory (70 KB at N = 49, D = 64); one warp normalises each
// softmax row and forms each dS row; the three products dQ, dK, dV share
// one loop over the (row, channel) outputs.  The TPU kernel's packing of
// two windows into one 128-row MXU tile is not carried over by either body.

#include <stdint.h>

#include "common.cuh"
#include "window_tile.cuh"

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
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* bias,
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

// ------------------------------------------------------ bf16 tensor cores --

using mtp::win::bf16;
namespace win = mtp::win;

template <int D>
struct Bwd {
  static constexpr int kPLD = win::kRows + 8;  // row stride of the P and dS tiles
  static constexpr int kPSBytes = 2 * win::kRows * kPLD * 2;
  // bytes of one ring stage: the q, dO, k, v tiles and the pair's flat bias
  __host__ __device__ static int stage_bytes(int N) {
    return 4 * win::Tile<D>::kBytes + win::bias_floats(N) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(win::kThreads, 2)
window_attn_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ dout, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dbias, long long pairs, int N, float scale) {
  using T = win::Tile<D>;
  constexpr int LD = T::LD, KD = D / 16, ND = D / 8, PLD = Bwd<D>::kPLD, NB = win::kNB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage = Bwd<D>::stage_bytes(N);
  // stage st: q | dO | k | v tiles (bf16), then the bias run (fp32); after
  // the two stages, the P and dS tiles (bf16, 64 × PLD)
  auto tile = [&](int st, int i) {
    return reinterpret_cast<bf16*>(smem_raw + st * stage + i * T::kBytes);
  };
  auto bias_at = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * stage + 4 * T::kBytes);
  };
  bf16* p_tile = reinterpret_cast<bf16*>(smem_raw + 2 * stage);
  bf16* ds_tile = p_tile + win::kRows * PLD;
  const long long rows = static_cast<long long>(N) * D;
  auto load_pair = [&](int st, long long p) {
    win::load_tile_async<D>(tile(st, 0), q + p * rows, N);
    win::load_tile_async<D>(tile(st, 1), dout + p * rows, N);
    win::load_tile_async<D>(tile(st, 2), k + p * rows, N);
    win::load_tile_async<D>(tile(st, 3), v + p * rows, N);
    win::load_bias_async(bias_at(st), bias, p, N);
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // the thread's query rows
  const float sl2 = scale * mtp::kLog2e;

  long long p = blockIdx.x;  // the launch has at most `pairs` blocks
  load_pair(0, p);
  mtp::cp_async_commit();
  for (int it = 0; p < pairs; ++it, p += gridDim.x) {
    const int st = it & 1;
    mtp::cp_async_wait<0>();  // pair p has landed
    __syncthreads();          // and every warp is past pair p - gridDim.x
    if (p + gridDim.x < pairs) load_pair(st ^ 1, p + gridDim.x);
    mtp::cp_async_commit();
    bf16* qs = tile(st, 0);
    bf16* dos = tile(st, 1);
    bf16* ks = tile(st, 2);
    bf16* vs = tile(st, 3);
    float* bs = bias_at(st);

    // P, recomputed: the softmax of K1
    float s[NB][4], l0, l1;
    {
      uint32_t qf[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
      win::softmax_rows<D>(s, qf, ks, bs, N, sl2, l0, l1);
    }
    // dP = dO·v^T
    float dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    {
      uint32_t df[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mtp::ldmatrix_x4(df[kk], dos + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t bf[4];
          mtp::ldmatrix_x4(bf, vs + mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD));
          mtp::mma_bf16(dp[nb], df[kk], bf[0], bf[1]);
          mtp::mma_bf16(dp[nb + 1], df[kk], bf[2], bf[3]);
        }
      }
    }
    // P normalised; delta = rowsum(P ∘ dP); dS = P ∘ (dP − delta) into dp
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] *= i0;
      s[nb][1] *= i0;
      s[nb][2] *= i1;
      s[nb][3] *= i1;
      d0 = fmaf(s[nb][0], dp[nb][0], fmaf(s[nb][1], dp[nb][1], d0));
      d1 = fmaf(s[nb][2], dp[nb][2], fmaf(s[nb][3], dp[nb][3], d1));
    }
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      dp[nb][0] = s[nb][0] * (dp[nb][0] - d0);
      dp[nb][1] = s[nb][1] * (dp[nb][1] - d0);
      dp[nb][2] = s[nb][2] * (dp[nb][2] - d1);
      dp[nb][3] = s[nb][3] * (dp[nb][3] - d1);
    }
    // dS (fp32) over the bias elements this thread read, for dbias; P and
    // dS (bf16) into the warp's rows of the P and dS tiles
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nb * 8 + 2 * t + e;
        if (c < N) {
          if (r0 < N) bs[r0 * N + c] = dp[nb][e];
          if (r1 < N) bs[r1 * N + c] = dp[nb][2 + e];
        }
      }
      const int c = nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(p_tile + r0 * PLD + c) = mtp::pack_bf16(s[nb][0], s[nb][1]);
      *reinterpret_cast<uint32_t*>(p_tile + r1 * PLD + c) = mtp::pack_bf16(s[nb][2], s[nb][3]);
      *reinterpret_cast<uint32_t*>(ds_tile + r0 * PLD + c) = mtp::pack_bf16(dp[nb][0], dp[nb][1]);
      *reinterpret_cast<uint32_t*>(ds_tile + r1 * PLD + c) = mtp::pack_bf16(dp[nb][2], dp[nb][3]);
    }
    // dQ = dS·k (scaled on the way out), dS from registers
    float dqa[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < win::kRows / 16; ++kk) {
      uint32_t a[4];
      mtp::a_from_c(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        mtp::ldmatrix_x4_trans(bf, ks + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(dqa[nd], a, bf[0], bf[1]);
        mtp::mma_bf16(dqa[nd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the bias run holds all of dS; the P and dS tiles are whole

    win::store_bias_run(dbias, bs, p, N);
    // dV = P^T·dO and dK = dS^T·q (scaled on the way out): the warp's 16
    // keys, over the tile's 64 queries
    float dva[ND][4], dka[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
      dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = dka[i][0] = dka[i][1] = dka[i][2] =
          dka[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < win::kRows / 16; ++kk) {
      uint32_t pa[4], da[4];
      const int aoff = mtp::a_frag_offset_trans(lane, warp * 16, kk * 16, PLD);
      mtp::ldmatrix_x4_trans(pa, p_tile + aoff);
      mtp::ldmatrix_x4_trans(da, ds_tile + aoff);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        const int off = mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD);
        mtp::ldmatrix_x4_trans(bf, dos + off);
        mtp::mma_bf16(dva[nd], pa, bf[0], bf[1]);
        mtp::mma_bf16(dva[nd + 1], pa, bf[2], bf[3]);
        mtp::ldmatrix_x4_trans(bf, qs + off);
        mtp::mma_bf16(dka[nd], da, bf[0], bf[1]);
        mtp::mma_bf16(dka[nd + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with the q, dO, P and dS tiles

    // dQ, dK, dV through the warp's own rows of the q, k and v tiles
    win::frag_rows_to_tile<D>(qs, dqa, scale, scale);
    win::frag_rows_to_tile<D>(ks, dka, scale, scale);
    win::frag_rows_to_tile<D>(vs, dva, 1.f, 1.f);
    __syncwarp();
    win::store_warp_rows<D>(dq + p * rows, qs, N);
    win::store_warp_rows<D>(dk + p * rows, ks, N);
    win::store_warp_rows<D>(dv + p * rows, vs, N);
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                      const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* dbias, int WH, int N,
                      float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(Bwd<D>::stage_bytes(N)) + Bwd<D>::kPSBytes;
  auto kernel = window_attn_bwd_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  unsigned blocks = 0;
  err = win::persistent_grid(kernel, smem, WH, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, win::kThreads, smem, stream>>>(q, k, v, bias, dout, dq, dk, dv, dbias, WH, N,
                                                   scale);
  return cudaGetLastError();
}

}  // namespace

// The body by `win::body`: the tensor cores for bf16 windows of N <= 64
// and D <= 128 (D padded to a multiple of 16 by the wrapper, else refused),
// the CUDA cores for everything else.
extern "C" int mtp_window_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, void* dq,
                                   void* dk, void* dv, void* dbias, int WH, int N,
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
    const bf16* dob = static_cast<const bf16*>(dout);
    bf16* dqb = static_cast<bf16*>(dq);
    bf16* dkb = static_cast<bf16*>(dk);
    bf16* dvb = static_cast<bf16*>(dv);
    float* db = static_cast<float*>(dbias);
    switch (D) {
#define MTP_WIN_BWD_D(d) \
  case d:                \
    return launch_tc<d>(qb, kb, vb, b, dob, dqb, dkb, dvb, db, WH, N, scale, st);
      MTP_WIN_BWD_D(16)
      MTP_WIN_BWD_D(32)
      MTP_WIN_BWD_D(48)
      MTP_WIN_BWD_D(64)
      MTP_WIN_BWD_D(80)
      MTP_WIN_BWD_D(96)
      MTP_WIN_BWD_D(112)
      MTP_WIN_BWD_D(128)
#undef MTP_WIN_BWD_D
    }
    return cudaErrorInvalidValue;  // not reached: D is 16..128 in steps of 16
  }
  switch (dtype) {
    case mtp::kFloat32:
      return launch_simt<float>(q, k, v, bias, dout, dq, dk, dv, dbias, WH, N, D, scale, st);
    case mtp::kBFloat16:
      return launch_simt<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, dbias, WH, N, D,
                                        scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
