// K1L — fused window attention, forward, for windows too large for K1.
//
// Replaces the TPU kernel mtp_tpu/ops/pallas_attn.py `_fused_forward`
// (pallas_call at :662; kernel body `_attn_kernel` :38-58) at pack = 1 for
// every window whose backward is K7 (csrc/window_attn_bwd_qblk.cu), which
// takes the log-sum-exp this kernel writes; that covers every window whose
// K1 block (csrc/window_attn_fwd.cu: the whole window's q, k, v and N×N
// scores in shared memory) exceeds the 227 KB of one block.  Its one caller
// on the main path is the ViT's full attention over grids wider than 128
// tokens per axis (models/vit_rvsa.py `FullAttention`), one window of
// N = H·W tokens with the materialised decomposed bias: N = 16,900 at a
// 2080² input.
//
// Computes, per (window w, head h), the same function as K1, and each row's
// log-sum-exp for the backward (K7):
//     s = q[w, h] · k[w, h]^T · scale + bias[w, h]
//     out[w, h] = softmax(s) · v[w, h],   lse[w, h, i] = log Σ_j exp(s[i, j])
// q/k/v (W, nH, N, D) fp32 or bf16 with D <= 128, bias (W, nH, N, N) fp32,
// fp32 math and softmax, out in q's dtype, lse fp32 (W·nH, N).
//
// What bounds it on the H100: the bias, read once, 4·N² bytes per (window,
// head) — 18.3 GB at nH = 16, N = 16,900, 5.5 ms at 3.35 TB/s — against
// 4·N²·D FLOPs (1.17 TFLOP there, 1.2 ms on the tensor cores).  So the
// design stands or falls on streaming the bias.
//
// bf16 (`window_attn_fwd_large_tc_kernel<D>`, D a multiple of 16 up to 128;
// the wrapper zero-pads other head dims): K2's design (csrc/flash_attn_fwd.cu)
// with the bias read from memory.  One block of 4 warps per (window·head,
// 64-query tile), each warp 16 query rows (the M of mma.m16n8k16), its q
// fragments in registers.  Each 64-key tile's K and V rows (bf16) and the
// block's 64×64 bias tile (fp32, 16 KB) stream through one 3-stage
// shared-memory ring filled by cp.async — 16-byte copies where every bias row
// is 16-byte aligned (N % 4 == 0, as at 16,900), 4-byte ones where it is not
// (387, 910) — two tiles in flight while one is computed: with two blocks an
// SM that keeps 64 KB of bias reads in flight an SM, what the memory's
// latency needs at full rate.  q·k^T and P·V run on the tensor cores
// (mma.sync with ldmatrix, fp32 accumulators); the score fragments take
// their bias from the shared tile (rows of stride 72 floats: the fragments'
// 64-bit reads hit distinct banks); the online softmax runs in registers on
// ex2; P is rounded to bf16 only as the A operand of P·V.  Keys past N are
// masked to -1e30 as the TPU kernel's _NEG; rows past N read no bias and are
// not written.
//
// fp32 (`window_attn_fwd_large_kernel<float>`): fp32 FMAs on the CUDA cores,
// no TF32 (the card-vs-CPU gradient checks hold the fp32 path to 1e-3).  One
// block per (window·head, 64-query tile), 256 threads as a 16×16 grid; keys
// stream in 64-key tiles through shared memory with an online softmax; each
// thread owns a 4×4 micro-tile of the score tile (query rows ty + 16a, keys
// tx + 16b) and a 4 × D/16 slice of the output accumulator in registers; the
// bias is read straight from device memory, coalesced along keys.
//
// Every bias offset is 64-bit: the bias of one call holds more than 2^31
// elements at the main path's shape.
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kMaxD = 128;
constexpr float kMasked = -1e30f;  // padded keys, as the TPU kernel's _NEG

// ------------------------------------------------------------ fp32 path --

constexpr int kThreads = 256;      // 16 × 16
constexpr int kR = kBQ / 16;       // query rows per thread
constexpr int kC = kBK / 16;       // keys per thread
constexpr int kDC = kMaxD / 16;    // output columns per thread, at most
constexpr int kSp = kBK + 16;      // probability row stride: rows ty, ty+1 land 16 banks apart

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_large_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, float* __restrict__ lse, int N, int D,
                             int q_tiles, float scale) {
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
    if (tx == 0) lse[wh * N + q0 + r] = m[a] + logf(l[a]);
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* lse, int WH, int N, int D, float scale,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * kBQ * (D + 1) + kBQ * kSp) * sizeof(float);
  auto kernel = window_attn_fwd_large_kernel<float>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<static_cast<unsigned>(WH) * q_tiles, kThreads, smem, stream>>>(
      q, k, v, bias, out, lse, N, D, q_tiles, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 tensor cores --

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kTC = 32 * kWarps;

template <int D>
struct Tc {
  static constexpr int LD = D + 8;        // bf16 row stride: ldmatrix rows hit distinct banks
  static constexpr int BS = kBK + 8;      // bias row stride (floats), 8 mod 32: the 64-bit
                                          // fragment reads of a half-warp hit distinct banks
  static constexpr int kStages = 3;       // depth of the ring
  static constexpr int kTile = kBK * LD;  // elements of one K or V tile
  static constexpr int kStage = 2 * kTile * 2 + kBQ * BS * 4;  // bytes: K, V, bias
};

template <int D>
__global__ void __launch_bounds__(kTC, 2)
window_attn_fwd_large_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                bf16* __restrict__ out, float* __restrict__ lse, int N,
                                int q_tiles, float scale, bool vec) {
  using C = Tc<D>;
  constexpr int LD = C::LD, BS = C::BS, S = C::kStages;
  constexpr int KD = D / 16, ND = D / 8, NB = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st: K tile | V tile (bf16), then the bias tile (fp32)
  auto kt_at = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * C::kStage); };
  auto bt_at = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * C::kStage + 2 * C::kTile * 2);
  };
  bf16* qs = kt_at(S - 1);  // kBQ × LD in the last stage's K tile, until q is in registers

  const long long wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const long long base = wh * N * D;
  const float* b = bias + wh * N * N;  // 64-bit: W·nH·N² may exceed 2^31
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + kBK - 1) / kBK;

  auto load_tile = [&](int st, int k0) {
    bf16* kt = kt_at(st);
    mtp::load_rows_async<kBK, D, LD, kTC>(kt, k + base, k0, N);
    mtp::load_rows_async<kBK, D, LD, kTC>(kt + C::kTile, v + base, k0, N);
    mtp::load_bias_async<kBQ, kBK, BS, kTC>(bt_at(st), b, q0, k0, N, vec);
  };
  // group 0: q and tile 0; then one group per tile, S - 1 ahead
  mtp::load_rows_async<kBQ, D, LD, kTC>(qs, q + base, q0, N);
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_tiles) load_tile(st, st * kBK);
    mtp::cp_async_commit();
  }

  const float sl2 = scale * mtp::kLog2e;
  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units
  const int row = warp * 16 + g;  // the thread's rows row and row + 8 of the tile

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    mtp::cp_async_wait<S - 2>();  // this tile (and on the first, q) has landed
    __syncthreads();              // for every warp, which are all past tile it - 1
    if (it == 0) {  // q into registers, which frees the last stage for tile S - 1
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mtp::ldmatrix_x4(qf[kk], qs + mtp::a_frag_offset(lane, warp * 16, kk * 16, LD));
      __syncthreads();
    }
    if (it + S - 1 < n_tiles) load_tile((it + S - 1) % S, k0 + (S - 1) * kBK);
    mtp::cp_async_commit();
    const bf16* kt = kt_at(it % S);
    const bf16* vt = kt + C::kTile;
    const float* b0 = bt_at(it % S) + row * BS + 2 * t;
    const float* b1 = b0 + 8 * BS;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        mtp::ldmatrix_x4(bf, kt + mtp::b_frag_offset_nk(lane, nb * 8, kk * 16, LD));
        mtp::mma_bf16(s[nb], qf[kk], bf[0], bf[1]);
        mtp::mma_bf16(s[nb + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // (s·scale + bias)·log2 e; keys >= N to -1e30
    const bool edge = k0 + kBK > N;
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 x0 = *reinterpret_cast<const float2*>(b0 + nb * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(b1 + nb * 8);
      s[nb][0] = fmaf(s[nb][0], sl2, x0.x * mtp::kLog2e);
      s[nb][1] = fmaf(s[nb][1], sl2, x0.y * mtp::kLog2e);
      s[nb][2] = fmaf(s[nb][2], sl2, x1.x * mtp::kLog2e);
      s[nb][3] = fmaf(s[nb][3], sl2, x1.y * mtp::kLog2e);
      if (edge) {
        const int kk = k0 + nb * 8 + 2 * t;
        if (kk >= N) s[nb][0] = s[nb][2] = kMasked;
        if (kk + 1 >= N) s[nb][1] = s[nb][3] = kMasked;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
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
        uint32_t bf[4];
        mtp::ldmatrix_x4_trans(bf, vt + mtp::b_frag_offset_kn(lane, kk * 16, nd * 8, LD));
        mtp::mma_bf16(o[nd], a, bf[0], bf[1]);
        mtp::mma_bf16(o[nd + 1], a, bf[2], bf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + row, r1 = r0 + 8;
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
    if (r0 < N) lse[wh * N + r0] = (m0 + log2f(l0)) * mtp::kLn2;
    if (r1 < N) lse[wh * N + r1] = (m1 + log2f(l1)) * mtp::kLn2;
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                      bf16* out, float* lse, int WH, int N, float scale, cudaStream_t stream) {
  using C = Tc<D>;
  const size_t smem = static_cast<size_t>(C::kStages) * C::kStage;
  auto kernel = window_attn_fwd_large_tc_kernel<D>;
  cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  kernel<<<static_cast<unsigned>(WH) * q_tiles, kTC, smem, stream>>>(q, k, v, bias, out, lse,
                                                                     N, q_tiles, scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_attn_fwd_large(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, void* lse, int WH,
                                         int N, int D, float scale, int dtype,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  if (D < 1 || D > kMaxD || N < 1) return cudaErrorInvalidValue;
  if (dtype == mtp::kFloat32)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), b, static_cast<float*>(out), ls, WH, N,
                      D, scale, st);
  if (dtype != mtp::kBFloat16) return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  switch (D) {  // the wrapper pads D to a multiple of 16, at most 128
#define MTP_LARGE_FWD_D(d) \
  case d:                  \
    return launch_tc<d>(qb, kb, vb, b, ob, ls, WH, N, scale, st);
    MTP_LARGE_FWD_D(16)
    MTP_LARGE_FWD_D(32)
    MTP_LARGE_FWD_D(48)
    MTP_LARGE_FWD_D(64)
    MTP_LARGE_FWD_D(80)
    MTP_LARGE_FWD_D(96)
    MTP_LARGE_FWD_D(112)
    MTP_LARGE_FWD_D(128)
#undef MTP_LARGE_FWD_D
    default:
      return cudaErrorInvalidValue;
  }
}
