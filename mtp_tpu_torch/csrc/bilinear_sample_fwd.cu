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
// (grid_sample's "zeros" padding), fp32 accumulation, output in img's dtype.
// Any P >= 1 is taken: RVSA's K/V sampling runs P = 1 with a unit mask,
// DCNv3 (K8's forward) P = 9.
//
// What bounds it on the H100: a gather with about 8 FLOP per tap per byte
// read; at the slice shape (BG = 64, HW = HWo = 784, C = 64, P = 1) it moves
// ~13 MB of reads and writes for ~13 MFLOP: memory-bound, and bound by how
// well the corner reads coalesce.  The design puts one thread on each output
// channel, with the channel fastest, so a warp reads each corner row as one
// contiguous span (128 bytes at C = 64 in bf16) and writes its output the
// same way; coordinates are read once per pixel through the cache.  This
// one gather replaces every TPU tier: the TPU has no vector gather, so
// there the sampling was a masked one-hot matrix product built in VMEM and
// split into unrolled / fori / lane-packed / bg-packed tiers to fit VMEM —
// none of that applies here.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
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

template <typename T>
cudaError_t launch(const void* img, const void* py, const void* px, const void* m,
                   void* out, int BG, int H, int W, int C, int HWo, int P,
                   cudaStream_t stream) {
  const long long total = static_cast<long long>(BG) * HWo * C;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  bilinear_sample_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(m),
      static_cast<T*>(out), total, H, W, C, HWo, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_bilinear_sample_fwd(const void* img, const void* py,
                                       const void* px, const void* m, void* out,
                                       int BG, int H, int W, int C, int HWo,
                                       int P, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(img, py, px, m, out, BG, H, W, C, HWo, P, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(img, py, px, m, out, BG, H, W, C, HWo, P, st);
    default:
      return cudaErrorInvalidValue;
  }
}
