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
// integer coordinates (closed at 0 and −1, open at 1).  A tap counts where
// −1 <= y < H and −1 <= x < W (y = −1 keeps its row-0 corner's coordinate
// gradient though that corner's weight is 0; NaN is rejected before the
// integer casts); corners off the map contribute nothing.  img and g are
// fp32 or bf16, py/px/m fp32; dimg is an fp32 buffer (zeroed by the wrapper,
// cast to img's dtype after), dpy/dpx/dm fp32, all sums in fp32.  Any
// P >= 1: RVSA's K/V sampling runs P = 1 with a unit mask, DCNv3 (K8) P = 9.
//
// What bounds it on the H100: the image-gradient scatter.  At K8's stage 0
// (BG = 96, 128², gc = 16, P = 9, bf16) the function must move 490 MB
// (0.146 ms at 3.35 TB/s), but the scatter is 4·P adds of C values a pixel
// into a 100 MB fp32 buffer: one scalar global atomic per (corner,
// channel) was 9.1e8 atomics a launch, contended, since neighbouring
// pixels' taps land on the same corners.  At RVSA's slice (BG = 128, 28²,
// C = 64, P = 1) it moves 41 MB, 1.3e7 corner-channels.  fp32 adds into
// shared memory are no way out: the H100 has no native one (they compile
// to a compare-and-swap loop, ATOMS.CAST.SPIN), and a shared tile that took
// every corner's add there spent its time in those loops.
//
// The design, against the atomics (bodies and rule in sample_body.cuh):
// - kVector: one thread per (output pixel, 16-byte run of its channels),
//   8 bf16 or 4 fp32, as in K3; the block's py/px/m staged in shared memory
//   by coalesced loads.  A thread reads its run of g's row once, issues a
//   tap's 4 corner loads together (taps unrolled for P = 1 and 9), and
//   forms its part of each tap's dm, dy, dx; the pixel's 2 (gc = 16) or 8
//   (C = 64, bf16) threads sum them with 1–3 shuffles, and dm, dpy, dpx go
//   out through shared memory as coalesced fp32 stores.  Each corner's
//   m·wy·wx·g is added to dimg with 16-byte vector atomics (float4, sm_90):
//   2 a corner per bf16 thread, where the scalar body had 8.
// - kTiled (P = 9 on the map's own grid: every DCNv3 layer of the port), two
//   launches: kVector without its scatter for dm, dpy, dpx, then a kernel
//   for dimg alone, which reads no image.  Its block takes a 16×16 tile of
//   one (image·group)'s output pixels and owns the image gradient of their
//   region, the 32² map pixels within kHalo = 8 of the tile: it lists, per
//   region pixel, the tap corners that land there (native shared int
//   atomics count them, a scan places them: a weight and a pixel, 6 bytes a
//   corner), and a thread per (region pixel, 4 channels) sums its list's
//   m·wy·wx·g in registers and adds the sum to dimg with one 16-byte
//   atomic, a warp's atomics on contiguous bytes.  Corners outside the
//   region are added directly.  At stage 0's offsets the ~36 adds per
//   pixel-channel become (32/16)² = 4 per 4 channels.
// - kScalar: one warp per output pixel, lanes over the channels, scalar
//   fp32 atomics: for C not in whole 16-byte runs or unaligned storage.
// dimg is not deterministic: its fp32 sums depend on the order in which
// the device-memory atomics (and, tiled, a list's entries) land, in their
// last bits, as before; dm, dpy and dpx are.  On the TPU, with no scatter,
// all of this was a one-hot matrix product built in VMEM, split into tiers
// to fit VMEM.

#include "sample_body.cuh"

namespace {

// ------------------------------------------------------------- kScalar --

constexpr int kScalarThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
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

// ------------------------------------------------- kVector and kTiled --

// One corner of a tap by the backward's rule: its map pixel and whether it
// is on the map.
struct Corner {
  int yy, xx;
  bool ok;
};

// The 4 corners of tap (y, x): weights wy·wx and the subgradient factors
// dwy·wx, wy·dwx, the corner loads issued (an off-map corner reads nothing).
template <typename T>
__device__ __forceinline__ void bwd_corners(const T* im, float y, float x, int H, int W,
                                            int C, Corner* c, float* wyx, float* dy,
                                            float* dx, uint4* v) {
  const bool tap = y >= -1.f && y < H && x >= -1.f && x < W;
  const float y0f = floorf(tap ? y : 0.f), x0f = floorf(tap ? x : 0.f);
  const float fy = y - y0f, fx = x - x0f;
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cy = k >> 1, cx = k & 1;
    const int yy = y0 + cy, xx = x0 + cx;
    const bool ok = tap && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const float wy = cy ? fy : 1.f - fy, wx = cx ? fx : 1.f - fx;
    c[k] = {yy, xx, ok};
    wyx[k] = ok ? wy * wx : 0.f;
    dy[k] = ok ? (cy ? wx : -wx) : 0.f;
    dx[k] = ok ? (cx ? wy : -wy) : 0.f;
    const int at = min(max(yy, 0), H - 1) * W + min(max(xx, 0), W - 1);
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (ok) v[k] = smp::load_run(im + static_cast<long long>(at) * C);
  }
}

template <int kN>
__device__ __forceinline__ float dot_run(const float (&gv)[kN], const uint4& v) {
  float f[kN];
  smp::to_floats(v, f);
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < kN; ++k) a = fmaf(gv[k], f[k], a);
  return a;
}

// One tap's dm, dy, dx from its 4 corners' partial dot products, summed
// over the pixel's threads into the staging slots; with kScatter, the image
// gradient m·wy·wx·g of each corner added to dimg with vector atomics.
template <int kN, bool kScatter>
__device__ __forceinline__ void finish_tap(const float (&gv)[kN], const uint4* v,
                                           const Corner* c, const float* wyx,
                                           const float* dy, const float* dx, float mw,
                                           int runs, int W, int run, bool live,
                                           float* dimg_run, int C, float* om, float* oy,
                                           float* ox) {
  float d_m = 0.f, d_y = 0.f, d_x = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a = dot_run<kN>(gv, v[k]);
    d_m = fmaf(wyx[k], a, d_m);
    d_y = fmaf(dy[k], a, d_y);
    d_x = fmaf(dx[k], a, d_x);
  }
  d_m = smp::run_sum(d_m, runs);
  d_y = smp::run_sum(d_y, runs);
  d_x = smp::run_sum(d_x, runs);
  if (!live) return;
  if (run == 0) {
    *om = d_m;
    *oy = mw * d_y;
    *ox = mw * d_x;
  }
  if constexpr (kScatter) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cw = mw * wyx[k];
      if (!c[k].ok || cw == 0.f) continue;
      float add[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) add[i] = cw * gv[i];
      smp::atomic_add_run<kN>(dimg_run + (static_cast<long long>(c[k].yy) * W + c[k].xx) * C,
                              add);
    }
  }
}

// kVector: a block takes kBwdThreads / runs consecutive output pixels, a
// thread one (pixel, run), and computes dm, dpy, dpx and, with kScatter,
// adds the image gradient of every corner to dimg.  kP = 1 or 9 unrolls the
// taps, kP = 0 loops over P.
template <typename T, int kP, bool kScatter>
__global__ void __launch_bounds__(smp::kBwdThreads)
bilinear_sample_bwd_vec_kernel(const T* __restrict__ img, const float* __restrict__ py,
                               const float* __restrict__ px, const float* __restrict__ m,
                               const T* __restrict__ g, float* __restrict__ dimg,
                               float* __restrict__ dpy, float* __restrict__ dpx,
                               float* __restrict__ dm, long long n_pix, int H, int W, int C,
                               int HWo, int P) {
  extern __shared__ float smem[];
  constexpr int kN = smp::Run<T>::kN;
  const int taps = kP ? kP : P;
  const int runs = C / kN;
  const int per_block = smp::kBwdThreads / runs;
  const int n_slots = per_block * taps;
  float *sy = smem, *sx = sy + n_slots, *sm = sx + n_slots;
  float *oy = sm + n_slots, *ox = oy + n_slots, *om = ox + n_slots;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int n = static_cast<int>(min(static_cast<long long>(per_block), n_pix - first));
  const long long c0 = first * taps;
  for (int j = threadIdx.x; j < n * taps; j += smp::kBwdThreads) {
    sy[j] = py[c0 + j];
    sx[j] = px[c0 + j];
    sm[j] = m[c0 + j];
  }
  __syncthreads();
  const int local = threadIdx.x / runs, run = threadIdx.x % runs;
  const bool live = local < n;
  const long long p = first + (live ? local : 0);
  const long long map = p / HWo * H * W * C + run * kN;
  const T* im = img + map;
  float gv[kN];
  if (live) {
    smp::to_floats(smp::load_run(g + p * C + run * kN), gv);
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) gv[k] = 0.f;
  }
  // a pixel past the last has nothing staged: it reads a tap that does not
  // count, and writes nothing
  const int s = local * taps;
  const float *cy = sy + s, *cx = sx + s, *cm = sm + s;
  // a tap's 4 corner loads issue together; with the taps unrolled (kP = 1
  // or 9) the compiler hoists later taps' loads as registers allow (more
  // taps' loads held at once cost occupancy and gained nothing)
  if constexpr (kP > 0) {
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      uint4 v[4];
      Corner c[4];
      float wyx[4], dy[4], dx[4];
      bwd_corners(im, live ? cy[t] : -2.f, live ? cx[t] : -2.f, H, W, C, c, wyx, dy, dx, v);
      finish_tap<kN, kScatter>(gv, v, c, wyx, dy, dx, live ? cm[t] : 0.f, runs, W, run,
                               live, dimg + map, C, om + s + t, oy + s + t, ox + s + t);
    }
  } else {
    for (int t = 0; t < taps; ++t) {
      uint4 v[4];
      Corner c[4];
      float wyx[4], dy[4], dx[4];
      bwd_corners(im, live ? cy[t] : -2.f, live ? cx[t] : -2.f, H, W, C, c, wyx, dy, dx, v);
      finish_tap<kN, kScatter>(gv, v, c, wyx, dy, dx, live ? cm[t] : 0.f, runs, W, run,
                               live, dimg + map, C, om + s + t, oy + s + t, ox + s + t);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n * taps; j += smp::kBwdThreads) {
    dm[c0 + j] = om[j];
    dpy[c0 + j] = oy[j];
    dpx[c0 + j] = ox[j];
  }
}

// A tap's corners by the same rule, without the loads: corner k's map
// pixel and its image-gradient weight m·wy·wx, the same bits as
// bwd_corners' m·wyx, when it is on the map, else 0.
struct TapCorners {
  int y0, x0;
  float fy, fx;
  bool tap;
  __device__ __forceinline__ TapCorners(float y, float x, int H, int W) {
    tap = y >= -1.f && y < H && x >= -1.f && x < W;
    const float y0f = floorf(tap ? y : 0.f), x0f = floorf(tap ? x : 0.f);
    fy = y - y0f;
    fx = x - x0f;
    y0 = static_cast<int>(y0f);
    x0 = static_cast<int>(x0f);
  }
  __device__ __forceinline__ float add(int k, float mw, int H, int W) const {
    const int cy = k >> 1, cx = k & 1, yy = y0 + cy, xx = x0 + cx;
    const bool ok = tap && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const float wy = cy ? fy : 1.f - fy, wx = cx ? fx : 1.f - fx;
    return ok ? mw * (wy * wx) : 0.f;
  }
};

// kTiled's image gradient (P = 9, output pixel p = y·W + x at map pixel
// (y, x); dm, dpy, dpx come from kVector without kScatter): a block takes
// a kTile² tile of one map's output pixels and owns the image gradient of
// its region, the map pixels within kHalo of the tile.  No image read.
//   1. the tile's py, px, m and g's rows (as fp32) staged in shared memory;
//   2. per (pixel, tap): its corners in the region counted per region pixel
//      (native shared int atomics); corners outside the region added to
//      dimg directly, 16 bytes an atomic;
//   3. an exclusive scan of the counts, then each corner's (pixel, m·wy·wx)
//      written into its region pixel's list;
//   4. per (region pixel, run): its list's sum of m·wy·wx·g in registers,
//      added to dimg with vector atomics — one per 16 bytes per region
//      pixel, where the scatter had one per corner.
template <typename T>
__global__ void __launch_bounds__(smp::kTiledThreads)
bilinear_sample_bwd_tiled_kernel(const float* __restrict__ py,
                                 const float* __restrict__ px, const float* __restrict__ m,
                                 const T* __restrict__ g, float* __restrict__ dimg, int H,
                                 int W, int C) {
  extern __shared__ float smem[];
  constexpr int kN = smp::Run<T>::kN;
  constexpr int kP = 9;
  constexpr int kPixels = smp::kTile * smp::kTile;
  constexpr int kSlots = kPixels * kP;
  constexpr int kCells = smp::kRegion * smp::kRegion;
  static_assert(kCells <= 4 * smp::kTiledThreads, "the scan gives each thread 4 cells");
  float *sy = smem, *sx = sy + kSlots, *sm = sx + kSlots;
  float* gs = sm + kSlots;                              // kPixels × C
  float* wts = gs + kPixels * C;                        // 4·kSlots: lists' weights
  int* start = reinterpret_cast<int*>(wts + 4 * kSlots);  // kCells + 1
  int* cursor = start + kCells + 1;                     // kCells
  int* warp_total = cursor + kCells;                    // kTiledThreads / 32
  unsigned short* who = reinterpret_cast<unsigned short*>(warp_total + smp::kTiledThreads / 32);

  const int runs = C / kN;
  const int HW = H * W;
  const int tiles_x = (W + smp::kTile - 1) / smp::kTile;
  const int tiles = tiles_x * ((H + smp::kTile - 1) / smp::kTile);
  const long long bg = blockIdx.x / tiles;
  const int ty0 = blockIdx.x % tiles / tiles_x * smp::kTile;
  const int tx0 = blockIdx.x % tiles % tiles_x * smp::kTile;
  const int ry0 = ty0 - smp::kHalo, rx0 = tx0 - smp::kHalo;
  // region pixel of map pixel (yy, xx), or -1
  auto cell = [&](int yy, int xx) {
    const int ry = yy - ry0, rx = xx - rx0;
    return ry >= 0 && ry < smp::kRegion && rx >= 0 && rx < smp::kRegion
               ? ry * smp::kRegion + rx
               : -1;
  };
  // tile pixel i's output pixel (bg·HW + y·W + x), or -1 past the map
  auto pixel = [&](int i) -> long long {
    const int y = ty0 + i / smp::kTile, x = tx0 + i % smp::kTile;
    return y < H && x < W ? bg * HW + y * W + x : -1;
  };
  // 1
  for (int j = threadIdx.x; j < kSlots; j += smp::kTiledThreads) {
    const long long p = pixel(j / kP);
    if (p < 0) continue;
    sy[j] = py[p * kP + j % kP];
    sx[j] = px[p * kP + j % kP];
    sm[j] = m[p * kP + j % kP];
  }
  for (int w = threadIdx.x; w < kPixels * runs; w += smp::kTiledThreads) {
    const long long p = pixel(w / runs);
    float gv[kN];
    if (p >= 0) {
      smp::to_floats(smp::load_run(g + p * C + w % runs * kN), gv);
#pragma unroll
      for (int k = 0; k < kN; ++k) gs[w * kN + k] = gv[k];
    }
  }
  for (int j = threadIdx.x; j < kCells; j += smp::kTiledThreads) cursor[j] = 0;
  __syncthreads();
  // 2
  float* dmap = dimg + bg * HW * C;
  for (int j = threadIdx.x; j < kSlots; j += smp::kTiledThreads) {
    if (pixel(j / kP) < 0) continue;
    const TapCorners tc(sy[j], sx[j], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cw = tc.add(k, sm[j], H, W);
      if (cw == 0.f) continue;
      const int yy = tc.y0 + (k >> 1), xx = tc.x0 + (k & 1), q = cell(yy, xx);
      if (q >= 0) {
        atomicAdd(cursor + q, 1);
        continue;
      }
      const float* gr = gs + j / kP * C;
      float* out = dmap + static_cast<long long>(yy * W + xx) * C;
      for (int c = 0; c < C; c += 4)
        atomicAdd(reinterpret_cast<float4*>(out + c),
                  make_float4(cw * gr[c], cw * gr[c + 1], cw * gr[c + 2], cw * gr[c + 3]));
    }
  }
  __syncthreads();
  // 3
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, base = 4 * threadIdx.x;
    int count[4], own = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) own += count[u] = base + u < kCells ? cursor[base + u] : 0;
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = incl - own;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + u < kCells) start[base + u] = cursor[base + u] = before;
      before += count[u];
    }
    if (threadIdx.x == smp::kTiledThreads - 1) start[kCells] = before;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots; j += smp::kTiledThreads) {
    if (pixel(j / kP) < 0) continue;
    const TapCorners tc(sy[j], sx[j], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cw = tc.add(k, sm[j], H, W);
      const int q = cw != 0.f ? cell(tc.y0 + (k >> 1), tc.x0 + (k & 1)) : -1;
      if (q < 0) continue;
      const int e = atomicAdd(cursor + q, 1);
      wts[e] = cw;
      who[e] = static_cast<unsigned short>(j / kP);
    }
  }
  __syncthreads();
  // 4: a thread per (region pixel, 16 bytes of its fp32 channels), so that
  // a warp's atomics cover contiguous bytes
  const int quads = C / 4;
  for (int w = threadIdx.x; w < kCells * quads; w += smp::kTiledThreads) {
    const int q = w / quads, c4 = w % quads;
    const int lo = start[q], hi = start[q + 1];
    if (lo == hi) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      const float cw = wts[e];
      const float4 gr = *reinterpret_cast<const float4*>(gs + who[e] * C + 4 * c4);
      acc.x = fmaf(cw, gr.x, acc.x);
      acc.y = fmaf(cw, gr.y, acc.y);
      acc.z = fmaf(cw, gr.z, acc.z);
      acc.w = fmaf(cw, gr.w, acc.w);
    }
    const int yy = ry0 + q / smp::kRegion, xx = rx0 + q % smp::kRegion;
    atomicAdd(reinterpret_cast<float4*>(dmap + static_cast<long long>(yy * W + xx) * C + 4 * c4),
              acc);
  }
}

template <typename T, int kP, bool kScatter>
cudaError_t launch_vec(const void* img, const void* py, const void* px, const void* m,
                       const void* g, void* dimg, void* dpy, void* dpx, void* dm, int BG,
                       int H, int W, int C, int HWo, int P, int dtype, cudaStream_t stream) {
  const long long n_pix = static_cast<long long>(BG) * HWo;
  const int per_block = smp::kBwdThreads / smp::run_threads(C, dtype);
  const size_t smem = smp::smem_bytes(smp::kVector, C, P, dtype, true);
  auto kernel = bilinear_sample_bwd_vec_kernel<T, kP, kScatter>;
  const cudaError_t err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_pix + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), smp::kBwdThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(m),
      static_cast<const T*>(g), static_cast<float*>(dimg), static_cast<float*>(dpy),
      static_cast<float*>(dpx), static_cast<float*>(dm), n_pix, H, W, C, HWo, P);
  return cudaGetLastError();
}

// kTiled: dm, dpy, dpx by kVector without its scatter, then the image
// gradient by the tiled kernel.
template <typename T>
cudaError_t launch_tiled(const void* img, const void* py, const void* px, const void* m,
                         const void* g, void* dimg, void* dpy, void* dpx, void* dm, int BG,
                         int H, int W, int C, int dtype, cudaStream_t stream) {
  cudaError_t err = launch_vec<T, 9, false>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W,
                                            C, H * W, 9, dtype, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = smp::smem_bytes(smp::kTiled, C, 9, dtype, true);
  auto kernel = bilinear_sample_bwd_tiled_kernel<T>;
  err = mtp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(BG) *
                           ((H + smp::kTile - 1) / smp::kTile) *
                           ((W + smp::kTile - 1) / smp::kTile);
  kernel<<<static_cast<unsigned>(blocks), smp::kTiledThreads, smem, stream>>>(
      static_cast<const float*>(py), static_cast<const float*>(px),
      static_cast<const float*>(m), static_cast<const T*>(g), static_cast<float*>(dimg), H,
      W, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* img, const void* py, const void* px, const void* m,
                   const void* g, void* dimg, void* dpy, void* dpx, void* dm, int BG,
                   int H, int W, int C, int HWo, int P, int body, int dtype,
                   cudaStream_t stream) {
  const bool aligned = smp::aligned16(img) && smp::aligned16(g) && smp::aligned16(dimg);
  const cudaError_t refused = smp::refuse(body, C, P, dtype, aligned, true, HWo == H * W);
  if (refused != cudaSuccess) return refused;
  const long long n_pix = static_cast<long long>(BG) * HWo;
  if (n_pix == 0 || C == 0) return cudaSuccess;
  if (body == smp::kScalar) {
    const long long blocks = (n_pix * 32 + kScalarThreads - 1) / kScalarThreads;
    bilinear_sample_bwd_kernel<T><<<static_cast<unsigned>(blocks), kScalarThreads, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const float*>(py),
        static_cast<const float*>(px), static_cast<const float*>(m),
        static_cast<const T*>(g), static_cast<float*>(dimg), static_cast<float*>(dpy),
        static_cast<float*>(dpx), static_cast<float*>(dm), n_pix, H, W, C, HWo, P);
    return cudaGetLastError();
  }
  if (body == smp::kTiled)
    return launch_tiled<T>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, dtype, stream);
  switch (P) {
    case 1:
      return launch_vec<T, 1, true>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, HWo,
                                    P, dtype, stream);
    case 9:
      return launch_vec<T, 9, true>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, HWo,
                                    P, dtype, stream);
    default:
      return launch_vec<T, 0, true>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, HWo,
                                    P, dtype, stream);
  }
}

}  // namespace

extern "C" int mtp_bilinear_sample_bwd(const void* img, const void* py, const void* px,
                                       const void* m, const void* g, void* dimg,
                                       void* dpy, void* dpx, void* dm, int BG, int H,
                                       int W, int C, int HWo, int P, int body, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mtp::kFloat32:
      return launch<float>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C, HWo, P,
                           body, dtype, st);
    case mtp::kBFloat16:
      return launch<__nv_bfloat16>(img, py, px, m, g, dimg, dpy, dpx, dm, BG, H, W, C,
                                   HWo, P, body, dtype, st);
    default:
      return cudaErrorInvalidValue;
  }
}
