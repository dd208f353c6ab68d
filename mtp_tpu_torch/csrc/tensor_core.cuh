// Tensor-core and asynchronous-copy primitives of the bf16 attention
// kernels (K2 csrc/flash_attn_fwd.cu, K5 csrc/flash_attn_bwd.cu, K1L
// csrc/window_attn_fwd_large.cu, K7 csrc/window_attn_bwd_qblk.cu, and K1
// and K4 through csrc/window_tile.cuh; the NMS scan's prefetch of its lists,
// csrc/nms_scan.cuh):
// `cp.async` copies from device to shared memory (bf16 rows, fp32 bias
// tiles), `ldmatrix` loads of 8×8 bf16 tiles into the operand fragments of
// `mma.sync.m16n8k16` (bf16 inputs, fp32 accumulators).
//
// Fragment layout of m16n8k16 for the thread of lane l, g = l / 4, t = l % 4:
//   A (16×16, row-major) a[0]: (g, 2t..2t+1)  a[1]: (g+8, 2t..)  a[2]: (g, 2t+8..)  a[3]: (g+8, 2t+8..)
//   B (16×8, k × n)      b[0]: (2t..2t+1, g)  b[1]: (2t+8..2t+9, g)
//   C (16×8, fp32)       c[0..1]: (g, 2t..2t+1)  c[2..3]: (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column blocks are, rounded to
// bf16, the A fragment of one 16-deep step (`a_from_c`): a score tile
// becomes the left operand of the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mtp {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros where !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global to shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8×8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each tile transposed: a B fragment from a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a·b on the tensor cores: m16n8k16, bf16 × bf16 → fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from the C fragments of 8-column blocks 2kk
// and 2kk+1.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix addresses in a row-major bf16 tile of row stride ld (elements),
// for the thread of `lane`:
// the A fragment of rows r0..r0+15, columns c0..c0+15;
__device__ __forceinline__ int a_frag_offset(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// the B fragments of two 8-column blocks n0, n0+8 at depth k0..k0+15 from a
// tile stored (n, k) — row n holds column n of B (k·vᵀ-style operands);
__device__ __forceinline__ int b_frag_offset_nk(int lane, int n0, int k0, int ld) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// the same from a tile stored (k, n) — row k holds row k of B (P·V-style
// operands), loaded with ldmatrix_x4_trans;
__device__ __forceinline__ int b_frag_offset_kn(int lane, int k0, int n0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}
// the A fragment of rows m0..m0+15, columns k0..k0+15 of the transpose of a
// row-major tile (row k holds column k of A: Pᵀ·dO-style operands), loaded
// with ldmatrix_x4_trans.
__device__ __forceinline__ int a_frag_offset_trans(int lane, int m0, int k0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8;
}

// Rows [r0, r0 + ROWS) of a row-major (·, D) bf16 tensor into a shared
// tile of row stride LD, one 16-byte cp.async a chunk shared by the THREADS
// threads of the block, zeros from row N on.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int N) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < N;
    cp_async16(dst + r * LD + c, src + static_cast<long long>(ok ? r0 + r : 0) * D + c, ok);
  }
}

// The (ROWS queries × COLS keys) tile at (q0, k0) of one (N, N) fp32 bias
// matrix `b` into a shared tile of row stride BS floats, asynchronously, the
// THREADS threads of the block sharing the copies; zeros past N on either
// axis.  vec: 16-byte copies (every row 16-byte aligned: N % 4 == 0 and an
// aligned base), else 4-byte ones.  Row offsets are 64-bit: a call's bias
// may hold more than 2^31 elements.
template <int ROWS, int COLS, int BS, int THREADS>
__device__ __forceinline__ void load_bias_async(float* dst, const float* b, int q0, int k0,
                                                int N, bool vec) {
  if (vec) {
    constexpr int kChunks = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = q0 + r < N && k0 + c < N;  // a chunk is all in or all out
      cp_async16(dst + r * BS + c,
                 b + (ok ? static_cast<long long>(q0 + r) * N + k0 + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = q0 + r < N && k0 + c < N;
      cp_async4(dst + r * BS + c, b + (ok ? static_cast<long long>(q0 + r) * N + k0 + c : 0),
                ok);
    }
  }
}

// Σ a[i]·b[i] over D / 2 bf16 values (half of a row of head dim D), fp32,
// from 16-byte loads, every load issued before the first sum.
template <int D>
__device__ __forceinline__ float half_row_dot(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  constexpr int kV = D / 16;  // 16-byte vectors in half a row
  uint4 av[kV], bv[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    av[i] = reinterpret_cast<const uint4*>(a)[i];
    bv[i] = reinterpret_cast<const uint4*>(b)[i];
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av[i]);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
      s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
    }
  }
  return s;
}

// (ky, kx) of key index + step on a grid of Wk columns.
__device__ __forceinline__ void advance_key(int& ky, int& kx, int step, int Wk) {
  kx += step;
  if (kx >= Wk) {  // one wrap wherever step < Wk
    kx -= Wk;
    ++ky;
    while (kx >= Wk) {
      kx -= Wk;
      ++ky;
    }
  }
}

// 2^x by the special-function unit, flushing a subnormal result to 0 (a
// probability under 2^-126, which no output can tell from 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mtp
