// K3 — bilinear multi-tap sampling with zero padding, forward.
//
// Replaces the TPU kernel mtp_tpu/ops/dcnv3_pallas.py `_forward` (pallas_call
// at :635; kernel body `_fwd_kernel` :153-209, tiers from `_plan` :424-439)
// and its bg-packed twin `_forward_bgpack` (pallas_call at :583; kernel
// `_fwd_kernel_bgpack` :484-502), which compute the same function.
//
// Computes, per (image·group bg, output pixel p, channel c):
//     out[bg, p, c] = sum_t m[bg, p, t] · bilinear(img[bg], py[bg, p, t], px[bg, p, t])[c]
// with img (BG, H·W, C) in fp32 or bf16, py/px/m (BG, HWo, P) fp32 absolute
// pixel coordinates on the map, corners outside the map contributing zero
// (grid_sample's "zeros" padding; a tap counts only where -1 < y < H and
// -1 < x < W, which also rejects NaN before the integer casts), fp32
// accumulation, output in img's dtype.  Any P >= 1 is taken: RVSA's K/V
// sampling runs P = 1 with a unit mask, DCNv3 (K8's forward) P = 9.
//
// What bounds it on the H100: a gather, about 2 FLOP per byte.  At K8's
// stage 0 (BG = 96, 128², gc = 16, P = 9, bf16) it must move 270 MB, 170 MB
// of it the fp32 coordinates and mask (0.081 ms at 3.35 TB/s); at RVSA's
// slice (BG = 64, 28², C = 64, P = 1) 13 MB.  Each corner read is a 32-byte
// (gc = 16) or 128-byte (C = 64) row that neighbouring taps share in L1 and
// L2, so the kernel is bound by how many independent reads it keeps in
// flight, not by device-memory bytes.
//
// The design (the kVector body of sample_body.cuh): one thread per (output
// pixel, 16-byte run of its channels) — 8 bf16 or 4 fp32, so 2 threads a
// pixel at gc = 16 and 8 at C = 64 — and every corner read and output store
// one 16-byte access.  A block's py/px/m are staged in shared memory by
// coalesced loads, once per pixel, not once per channel thread.  The taps
// are unrolled for P = 1 and P = 9 (the only values any recipe makes; a
// loop for other P): a thread computes all its corners' addresses and
// weights from the staged coordinates, then issues its 4·P corner loads,
// then accumulates, so no tap's loads wait on the one before (ptxas keeps
// as many in flight as the 48 registers it gives the P = 9 body hold).  The
// kScalar body (one thread per channel, scalar corner reads) serves a C
// whose rows are not whole 16-byte runs (C·sizeof(T) not 16 bytes times a
// power of two) and storage that is not 16-byte aligned.  On the TPU, with
// no vector gather, the sampling was a masked one-hot matrix product built
// in VMEM and split into tiers to fit it; none of that applies here.

#include "sample_body.cuh"

namespace {

constexpr int kScalarThreads = 256;

// The scalar body: one thread per (pixel, channel).
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
bilinear_sample_fwd_kernel(const T* __restrict__ img, const float* __restrict__ py,
                           const float* __restrict__ px, const float* __restrict__ m,
                           T* __restrict__ out, long long total, int H, int W,
                           int C, int HWo, int P) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const long long pix = idx / C;  // bg·HWo + p
  const long long bg = pix / HWo;
  const T* im = img + bg * H * W * C + c;
  const float* pyp = py + pix * P;
  const float* pxp = px + pix * P;
  const float* mp = m + pix * P;

  float acc = 0.f;
  for (int t = 0; t < P; ++t) {
    const float y = pyp[t], x = pxp[t];
    // every corner is off the map (also rejects NaN before the int casts)
    if (!(y > -1.f && y < H && x > -1.f && x < W)) continue;
    const float y0f = floorf(y), x0f = floorf(x);
    const float fy = y - y0f, fx = x - x0f;
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float w = mp[t];
    float tap = 0.f;
    if (y0 >= 0) {
      if (x0 >= 0) tap += (1.f - fy) * (1.f - fx) * mtp::to_f32(im[(static_cast<long long>(y0) * W + x0) * C]);
      if (x0 + 1 < W) tap += (1.f - fy) * fx * mtp::to_f32(im[(static_cast<long long>(y0) * W + x0 + 1) * C]);
    }
    if (y0 + 1 < H) {
      if (x0 >= 0) tap += fy * (1.f - fx) * mtp::to_f32(im[(static_cast<long long>(y0 + 1) * W + x0) * C]);
      if (x0 + 1 < W) tap += fy * fx * mtp::to_f32(im[(static_cast<long long>(y0 + 1) * W + x0 + 1) * C]);
    }
    acc = fmaf(w, tap, acc);
  }
  out[idx] = mtp::from_f32<T>(acc);
}

// The 4 corners of one tap by the forward's rule: the corner loads issued
// (an off-map corner, or every corner of a tap that does not count, reads
// nothing and gets weight 0; addresses are clamped into the map all the
// same) and the weights m·wy·wx.  `im` points at the thread's run of pixel 0.
template <typename T>
__device__ __forceinline__ void fwd_corners(const T* im, float y, float x, float mw, int H,
                                            int W, int C, uint4* v, float* w) {
  const bool tap = y > -1.f && y < H && x > -1.f && x < W;
  const float y0f = floorf(tap ? y : 0.f), x0f = floorf(tap ? x : 0.f);
  const float fy = y - y0f, fx = x - x0f;
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    const bool ok = tap && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const int at = min(max(yy, 0), H - 1) * W + min(max(xx, 0), W - 1);
    w[k] = ok ? mw * ((k >> 1) ? fy : 1.f - fy) * ((k & 1) ? fx : 1.f - fx) : 0.f;
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (ok) v[k] = smp::load_run(im + static_cast<long long>(at) * C);
  }
}

template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[smp::Run<T>::kN], const uint4& v,
                                           float w) {
  float f[smp::Run<T>::kN];
  smp::to_floats(v, f);
#pragma unroll
  for (int k = 0; k < smp::Run<T>::kN; ++k) acc[k] = fmaf(w, f[k], acc[k]);
}

// The vector body; kP = 1 or 9 unrolls the taps, kP = 0 loops over P.
template <typename T, int kP>
__global__ void __launch_bounds__(smp::kFwdThreads)
bilinear_sample_fwd_vec_kernel(const T* __restrict__ img, const float* __restrict__ py,
                               const float* __restrict__ px, const float* __restrict__ m,
                               T* __restrict__ out, long long n_pix, int H, int W, int C,
                               int HWo, int P) {
  extern __shared__ float stage[];
  constexpr int kN = smp::Run<T>::kN;
  const int taps = kP ? kP : P;
  const int runs = C / kN;
  const int per_block = smp::kFwdThreads / runs;
  const long long pix0 = static_cast<long long>(blockIdx.x) * per_block;
  const int n = static_cast<int>(min(static_cast<long long>(per_block), n_pix - pix0));
  float* sy = stage;
  float* sx = sy + per_block * taps;
  float* sm = sx + per_block * taps;
  const long long c0 = pix0 * taps;
  for (int j = threadIdx.x; j < n * taps; j += smp::kFwdThreads) {
    sy[j] = py[c0 + j];
    sx[j] = px[c0 + j];
    sm[j] = m[c0 + j];
  }
  __syncthreads();
  const int local = threadIdx.x / runs, run = threadIdx.x % runs;
  if (local >= n) return;
  const long long pix = pix0 + local;
  const T* im = img + (pix / HWo) * H * W * C + run * kN;
  const float *cy = sy + local * taps, *cx = sx + local * taps, *cm = sm + local * taps;

  float acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.f;
  if constexpr (kP > 0) {
    uint4 v[4 * kP];
    float w[4 * kP];
#pragma unroll
    for (int t = 0; t < kP; ++t)
      fwd_corners(im, cy[t], cx[t], cm[t], H, W, C, v + 4 * t, w + 4 * t);
#pragma unroll
    for (int i = 0; i < 4 * kP; ++i) accumulate<T>(acc, v[i], w[i]);
  } else {
    for (int t = 0; t < taps; ++t) {
      uint4 v[4];
      float w[4];
      fwd_corners(im, cy[t], cx[t], cm[t], H, W, C, v, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) accumulate<T>(acc, v[i], w[i]);
    }
  }
  *reinterpret_cast<uint4*>(out + pix * C + run * kN) = smp::from_floats(acc);
}

template <typename T, int kP>
cudaError_t launch_vec(const void* img, const void* py, const void* px, const void* m,
                       void* out, long long n_pix, int H, int W, int C, int HWo, int P,
                       int dtype, cudaStream_t stream) {
  const int per_block = smp::kFwdThreads / smp::run_threads(C, dtype);
  const size_t smem = smp::stage_bytes(C, P, dtype, false);
  auto kernel = bilinear_sample_fwd_vec_kernel<T, kP>;
  const cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_pix + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), smp::kFwdThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(m), static_cast<T*>(out),
      n_pix, H, W, C, HWo, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* img, const void* py, const void* px, const void* m,
                   void* out, int BG, int H, int W, int C, int HWo, int P, int body,
                   int dtype, cudaStream_t stream) {
  const bool aligned = smp::aligned16(img) && smp::aligned16(out);
  const cudaError_t refused = smp::refuse(body, C, P, dtype, aligned, false, HWo == H * W);
  if (refused != cudaSuccess) return refused;
  const long long n_pix = static_cast<long long>(BG) * HWo;
  if (n_pix == 0 || C == 0) return cudaSuccess;
  if (body == smp::kScalar) {
    const long long total = n_pix * C;
    const long long blocks = (total + kScalarThreads - 1) / kScalarThreads;
    bilinear_sample_fwd_kernel<T><<<static_cast<unsigned>(blocks), kScalarThreads, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const float*>(py),
        static_cast<const float*>(px), static_cast<const float*>(m), static_cast<T*>(out),
        total, H, W, C, HWo, P);
    return cudaGetLastError();
  }
  switch (P) {
    case 1:
      return launch_vec<T, 1>(img, py, px, m, out, n_pix, H, W, C, HWo, P, dtype, stream);
    case 9:
      return launch_vec<T, 9>(img, py, px, m, out, n_pix, H, W, C, HWo, P, dtype, stream);
    default:
      return launch_vec<T, 0>(img, py, px, m, out, n_pix, H, W, C, HWo, P, dtype, stream);
  }
}

}  // namespace

extern "C" int mtp_bilinear_sample_fwd(const void* img, const void* py,
                                       const void* px, const void* m, void* out,
                                       int BG, int H, int W, int C, int HWo,
                                       int P, int body, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(img, py, px, m, out, BG, H, W, C, HWo, P, body, dtype, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(img, py, px, m, out, BG, H, W, C, HWo, P, body, dtype,
                                   st);
    default:
      return cudaErrorInvalidValue;
  }
}
