// K6 — bilinear multi-tap sampling with zero padding, backward.
//
// Replaces the TPU kernel mtp_tpu/ops/dcnv3_pallas.py `_sample_bwd`
// (pallas_calls at :678, :701 and :710; kernel bodies `_bwd_kernel` :240,
// `_bwd_img_kernel` :285, `_bwd_coord_kernel` :330, their common
// `_coord_grads` :212-237) and its bg-packed twin `_backward_bgpack`
// (pallas_call at :606; kernel `_bwd_kernel_bgpack` :505), which compute the
// same function.
//
// Computes, for the forward out[bg, p] = Σ_t m·Σ_corner wy·wx·img[bg, corner]
// (K3) and its cotangent g (BG, HWo, C), per tap (bg, p, t) and in-map
// corner with a = <g[bg, p], img[bg, corner]>:
//     dimg[bg, corner] += m·wy·wx·g[bg, p]
//     dm  = Σ_corner wy·wx·a
//     dpy = m·Σ_corner dwy·wx·a,   dpx = m·Σ_corner wy·dwx·a
// where the corners are (floor(py) + {0, 1}, floor(px) + {0, 1}), wy/wx the
// bilinear weights and dwy/dwx = −1 on the floor corner, +1 on the next:
// grid_sample's floor/frac subgradient, which is the TPU kernel's rule at
// integer coordinates.  Corners off the map contribute nothing.  img and g
// are fp32 or bf16, py/px/m fp32; dimg is an fp32 buffer (zeroed by the
// wrapper, cast to img's dtype after), dpy/dpx/dm fp32.  Any P >= 1: RVSA's
// K/V sampling runs P = 1 with a unit mask, DCNv3 (K8) P = 9.
//
// What bounds it on the H100: at the slice shape (BG = 128 at batch 8, a 28²
// map, C = 64, HWo = 784, P = 1) it reads img and g (~26 MB in bf16) and
// adds ~100k·4·64 fp32 values into a 26 MB buffer, ~4 FLOP per byte:
// memory- and atomics-bound.  The design: one warp per output pixel, lanes
// over the channels, looping over the taps.  For each in-map corner the
// warp reads the corner's channel row (one 128-byte span at C = 64 in bf16)
// and g's row, reduces <g, img[corner]> with shuffles, and scatters
// m·wy·wx·g into dimg with fp32 atomicAdd (skipped where that weight is 0);
// lane 0 writes dpy, dpx, dm.  dimg is a scatter: a deterministic version
// would need the inverse of every tap's corners; the atomic scatter is
// chosen, so dimg's fp32 sums are order-dependent in their last bits.  On
// the TPU, with no scatter, all of this was a one-hot matrix product built
// in VMEM, split into tiers to fit VMEM; one kernel replaces every tier.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilinear_sample_bwd_kernel(const T* __restrict__ img, const float* __restrict__ py,
                           const float* __restrict__ px, const float* __restrict__ m,
                           const T* __restrict__ g, float* __restrict__ dimg,
                           float* __restrict__ dpy, float* __restrict__ dpx,
                           float* __restrict__ dm, long long n_pix, int H, int W, int C,
                           int HWo, int P) {
  const long long pix = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= n_pix) return;  // whole warps leave together
  const long long bg = pix / HWo;
  const long long map = bg * H * W * C;
  const T* gp = g + pix * C;

  for (int t = 0; t < P; ++t) {
    const long long tap = pix * P + t;
    const float y = py[tap], x = px[tap], w = m[tap];
    float d_m = 0.f, d_y = 0.f, d_x = 0.f;
    // a corner can be in the map (also rejects NaN before the int casts);
    // y == -1 keeps its row-(0) corner's gradient though its weight is 0
    if (y >= -1.f && y < H && x >= -1.f && x < W) {
      const float y0f = floorf(y), x0f = floorf(x);
      const float fy = y - y0f, fx = x - x0f;
      const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      for (int cy = 0; cy < 2; ++cy) {
        const int yy = y0 + cy;
        if (yy < 0 || yy >= H) continue;
        const float wy = cy ? fy : 1.f - fy, dwy = cy ? 1.f : -1.f;
        for (int cx = 0; cx < 2; ++cx) {
          const int xx = x0 + cx;
          if (xx < 0 || xx >= W) continue;
          const float wx = cx ? fx : 1.f - fx, dwx = cx ? 1.f : -1.f;
          const long long off = map + (static_cast<long long>(yy) * W + xx) * C;
          const float cw = w * wy * wx;
          float a = 0.f;
          for (int c = lane; c < C; c += 32) {
            const float gv = mtp::to_f32(gp[c]);
            a = fmaf(gv, mtp::to_f32(img[off + c]), a);
            if (cw != 0.f) atomicAdd(dimg + off + c, cw * gv);
          }
          a = mtp::warp_sum(a);
          d_m = fmaf(wy * wx, a, d_m);
          d_y = fmaf(dwy * wx, a, d_y);
          d_x = fmaf(wy * dwx, a, d_x);
        }
      }
    }
    if (lane == 0) {
      dm[tap] = d_m;
      dpy[tap] = w * d_y;
      dpx[tap] = w * d_x;
    }
  }
}

template <typename T>
cudaError_t launch(const void* img, const void* py, const void* px, const void* m,
                   const void* g, void* dimg, void* dpy, void* dpx, void* dm, int BG,
                   int H, int W, int C, int HWo, int P, cudaStream_t stream) {
  const long long n_pix = static_cast<long long>(BG) * HWo;
  if (n_pix == 0) return cudaSuccess;
  const long long blocks = (n_pix * 32 + kThreads - 1) / kThreads;
  bilinear_sample_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(m),
      static_cast<const T*>(g), static_cast<float*>(dimg), static_cast<float*>(dpy),
      static_cast<float*>(dpx), static_cast<float*>(dm), n_pix, H, W, C, HWo, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtp_bilinear_sample_bwd(const void* img, const void* py, const void* px,
                                       const void* m, const void* g, void* dimg,
                                       void* dpy, void* dpx, void* dm, int BG, int H,
                                       int W, int C, int HWo, int P, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, HWo, P, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C,
                                   HWo, P, st);
    default:
      return cudaErrorInvalidValue;
  }
}
