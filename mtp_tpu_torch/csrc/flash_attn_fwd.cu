// K2 — flash full attention with the decomposed rel-pos bias, forward.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_flash_forward`
// (pallas_call at :421; kernel body `_flash_kernel` :367-393).
//
// Computes, per (batch·head bh, query q):
//     s[q, k]  = q·k^T · scale + rel_h[q, k / Wk] + rel_w[q, k % Wk]
//     out[q]   = softmax_k(s[q, :]) · v,   lse[q] = log Σ_k exp(s[q, k])
// with q/k/v (BH, N, D) in fp32 or bf16, rel_h (BH, N, Hk) and rel_w
// (BH, N, Wk) fp32, N = Hk·Wk, fp32 math, out in q's dtype, lse fp32
// (BH, N) for the backward (K5).  The (N, N) scores and bias never exist in
// device memory.
//
// What bounds it on the H100: at the slice shape (BH = 64, N = 576, D = 64)
// the call does 2·2·64·576²·64 ≈ 5.4 GFLOP on ~21 MB of inputs (bf16 q/k/v,
// fp32 factors), about 250 FLOP/B, near the card's ridge: on the tensor
// cores the products bound it, and beside them the fp32 softmax and bias
// (an exp2, two shared-memory reads and two FMAs per score).
//
// bf16 (`flash_fwd_tc_kernel<D>`, D a multiple of 16 up to 128): one block
// of 4 warps per (bh, 64-query tile), each warp 16 query rows (the M of
// mma.m16n8k16), its q fragments in registers.  K and V stream in 64-key
// tiles through a two-stage shared-memory ring filled by 16-byte cp.async,
// one barrier a tile (wait for the tile, barrier, refill the other stage,
// compute), so the next tile's copy overlaps this tile's products; the q
// tile comes in through the second stage.  q·k^T and P·V run on the tensor
// cores (mma.sync with ldmatrix, bf16 operands, fp32 accumulators); the
// score fragment gets the bias from the query tile's rel_h/rel_w rows
// (staged once per block by 4-byte cp.async, then scaled by log2 e), and the
// online softmax (running max and sum per row, exp2) stays in registers; P
// is rounded to bf16 only as the A operand of P·V.  Keys >= N are -inf
// before the max; rows >= N are not written.  mma.sync rather than wgmma:
// its fragments live in registers with a fixed, documented layout, which
// the softmax and the bias need, and it could be written and checked
// without a compiler at hand; wgmma is the next step for speed.
//
// fp32 (`flash_attn_fwd_kernel<float>`): fp32 FMAs on the CUDA cores, no
// TF32 (the card-vs-CPU gradient checks hold the fp32 path to 1e-3):
// 64-query blocks stream 64-key tiles through shared memory as fp32 rows of
// D+1 with an online softmax.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;  // queries per block
constexpr int kBK = 64;  // keys per tile

// ------------------------------------------------------------ fp32 path --

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ rel_h,
                      const float* __restrict__ rel_w, T* __restrict__ out,
                      float* __restrict__ lse, int N, int D, int Hk, int Wk,
                      int q_tiles, float scale) {
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
  for (int r = tid; r < nq; r += kThreads) lse[rbase + r] = m_run[r] + logf(l_run[r]);
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* rel_h,
                       const float* rel_w, float* out, float* lse, int BH, int N, int D,
                       int Hk, int Wk, float scale, cudaStream_t stream) {
  const int Dp = D + 1;
  const size_t smem = static_cast<size_t>(
      (2 * kBQ + 2 * kBK) * Dp + kBQ * (kBK + 1) + kBQ * (Hk + Wk) + 3 * kBQ) * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<float>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<BH * q_tiles, kThreads, smem, stream>>>(q, k, v, rel_h, rel_w, out, lse, N, D, Hk,
                                                   Wk, q_tiles, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 tensor cores --

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kTC = 32 * kWarps;

template <int D>
__global__ void __launch_bounds__(kTC)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, bf16* __restrict__ out,
                    float* __restrict__ lse, int N, int Hk, int Wk, int q_tiles, float scale) {
  constexpr int LD = D + 8;  // 16 B of padding: ldmatrix rows hit distinct banks
  constexpr int KD = D / 16, ND = D / 8, NB = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // 2 stages × kBK × LD
  bf16* vs = ks + 2 * kBK * LD;                  // 2 stages × kBK × LD
  bf16* qs = ks + kBK * LD;  // kBQ × LD in stage 1's K tile, until q is in registers
  float* rel = reinterpret_cast<float*>(vs + 2 * kBK * LD);  // kBQ × RS: [rel_h | rel_w]·log2 e
  const int RS = (Hk + Wk) | 1;  // odd: the 8 rows of a fragment hit distinct banks

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const long long base = static_cast<long long>(bh) * N * D;
  const long long rbase = static_cast<long long>(bh) * N + q0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  mtp::load_rows_async<kBQ, D, LD, kTC>(qs, q + base, q0, N);
  mtp::load_rows_async<kBQ, D, LD, kTC>(ks, k + base, 0, N);
  mtp::load_rows_async<kBQ, D, LD, kTC>(vs, v + base, 0, N);
  const int nq = min(kBQ, N - q0);
  for (int r = warp; r < kBQ; r += kWarps) {  // a warp a row, a lane a column
    const bool ok = r < nq;
    const long long row = rbase + (ok ? r : 0);
    for (int c = lane; c < Hk + Wk; c += 32)
      mtp::cp_async4(rel + r * RS + c, c < Hk ? rel_h + row * Hk + c : rel_w + row * Wk + c - Hk,
                     ok);
  }
  mtp::cp_async_commit();

  const float* rel0 = rel + (warp * 16 + g) * RS;  // the thread's rows g and g+8
  const float* rel1 = rel0 + 8 * RS;
  const float sl2 = scale * mtp::kLog2e;
  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units

  const int n_tiles = (N + kBK - 1) / kBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * kBK;
    mtp::cp_async_wait<0>();  // this tile (and on the first, q and the rel rows) has landed
    __syncthreads();          // for every warp, which are all past tile it - 1
    if (it == 0) {  // q into registers, which frees stage 1 for the next tile
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
      for (int i = tid; i < kBQ * RS; i += kTC) rel[i] *= mtp::kLog2e;
      __syncthreads();
    }
    if (it + 1 < n_tiles) {  // into the stage tile it - 1 left
      mtp::load_rows_async<kBQ, D, LD, kTC>(ks + (st ^ 1) * kBK * LD, k + base, k0 + kBK, N);
      mtp::load_rows_async<kBQ, D, LD, kTC>(vs + (st ^ 1) * kBK * LD, v + base, k0 + kBK, N);
    }
    mtp::cp_async_commit();
    const bf16* kt = ks + st * kBK * LD;
    const bf16* vt = vs + st * kBK * LD;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        mtp::ldmatrix_x4(b, kt + mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD));
        mtp::mma_bf16(s[nb], qf[kk], b[0], b[1]);
        mtp::mma_bf16(s[nb + 1], qf[kk], b[2], b[3]);
      }
    }

    // s·log2 e with the bias; keys >= N to -inf.  (ky, kx) of the thread's
    // keys k0 + 8nb + 2t + e, stepped along the tile
    const bool edge = k0 + kBK > N;
    int ky = (k0 + 2 * t) / Wk, kx = k0 + 2 * t - ky * Wk;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!edge || k0 + nb * 8 + 2 * t + e < N) {
          s[nb][e] = fmaf(s[nb][e], sl2, rel0[ky] + rel0[Hk + kx]);
          s[nb][2 + e] = fmaf(s[nb][2 + e], sl2, rel1[ky] + rel1[Hk + kx]);
        } else {
          s[nb][e] = s[nb][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nb][e]);
        mx1 = fmaxf(mx1, s[nb][2 + e]);
        mtp::advance_key(ky, kx, e == 0 ? 1 : 7, Wk);
      }
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a tile has a key
    const float a0 = mtp::exp2_approx(m0 - mn0), a1 = mtp::exp2_approx(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = mtp::exp2_approx(s[nb][0] - mn0);
      s[nb][1] = mtp::exp2_approx(s[nb][1] - mn0);
      s[nb][2] = mtp::exp2_approx(s[nb][2] - mn1);
      s[nb][3] = mtp::exp2_approx(s[nb][3] - mn1);
      sum0 += s[nb][0] + s[nb][1];
      sum1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * a0 + sum0;  // the thread's part of the row sum; the quad's
    l1 = l1 * a1 + sum1;  // parts are added at the end
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      mtp::a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b[4];
        mtp::ldmatrix_x4_trans(b, vt + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(o[nd], a, b[0], b[1]);
        mtp::mma_bf16(o[nd + 1], a, b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<long long>(r0) * D + c) =
          mtp::pack_bf16(o[nd][0] * i0, o[nd][1] * i0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<long long>(r1) * D + c) =
          mtp::pack_bf16(o[nd][2] * i1, o[nd][3] * i1);
  }
  if (t == 0) {
    const long long lb = static_cast<long long>(bh) * N;
    if (r0 < N) lse[lb + r0] = (m0 + log2f(l0)) * mtp::kLn2;
    if (r1 < N) lse[lb + r1] = (m1 + log2f(l1)) * mtp::kLn2;
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* rel_h,
                      const float* rel_w, bf16* out, float* lse, int BH, int N, int Hk,
                      int Wk, float scale, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = static_cast<size_t>(4 * kBK) * LD * sizeof(bf16) +
                      static_cast<size_t>(kBQ) * ((Hk + Wk) | 1) * sizeof(float);
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<BH * q_tiles, kTC, smem, stream>>>(q, k, v, rel_h, rel_w, out, lse, N, Hk, Wk,
                                              q_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* rel_h, const void* rel_w, void* out, void* lse,
                                  int BH, int N, int D, int Hk, int Wk, float scale,
                                  int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  float* ls = static_cast<float*>(lse);
  if (dtype == mtp::kFloat32)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), rh, rw, static_cast<float*>(out), ls, BH,
                      N, D, Hk, Wk, scale, st);
  if (dtype != mtp::kBFloat16) return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  switch (D) {  // the wrapper pads D to a multiple of 16, at most 128
#define MTP_FLASH_FWD_D(d) \
  case d:                  \
    return launch_tc<d>(qb, kb, vb, rh, rw, ob, ls, BH, N, Hk, Wk, scale, st);
    MTP_FLASH_FWD_D(16)
    MTP_FLASH_FWD_D(32)
    MTP_FLASH_FWD_D(48)
    MTP_FLASH_FWD_D(64)
    MTP_FLASH_FWD_D(80)
    MTP_FLASH_FWD_D(96)
    MTP_FLASH_FWD_D(112)
    MTP_FLASH_FWD_D(128)
#undef MTP_FLASH_FWD_D
    default:
      return cudaErrorInvalidValue;
  }
}
