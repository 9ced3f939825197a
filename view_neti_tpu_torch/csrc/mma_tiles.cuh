// Register-level building blocks of the hand-written kernels K1
// (flash_attention_fwd.cu), K2 (flash_attention_bwd_dq.cu), K3
// (flash_attention_bwd_dkv.cu) and K4 (fused_conv.cu): cp.async copies with
// zero fill, ldmatrix loads and the bf16 mma.sync.m16n8k16 tensor-core
// product with fp32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)    a[1]: (g + 8, 2t..2t+1)
//                          a[2]: (g, 2t+8..2t+9)  a[3]: (g + 8, 2t+8..2t+9)
//   B (16 x 8, col-major)  b[0]: (2t..2t+1, g)    b[1]: (2t+8..2t+9, g)
//   C (16 x 8, fp32)       c[0..1]: (g, 2t..2t+1) c[2..3]: (g + 8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column tiles, packed to bf16, are
// the A fragment of the 16-column k-step they cover (pack_a), and a row's
// values are spread over the 4 lanes of one quad.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mma_tiles {

using bf16 = __nv_bfloat16;

// Element strides of a (B, L, H, d) tensor with unit stride along d.
struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with ok false nothing is read and
// the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, zero-filled when ok is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of one head of a (B, L, H, d) bf16 tensor into a
// shared (ROWS x LD) tile, columns [0, DP), 16 bytes per copy: rows >= n and
// columns >= d are zero-filled by the copy itself.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                Strides s, int bidx, int h,
                                                int row0, int n, int d) {
  constexpr int kVec = DP / 8;
  const bf16* base = src + bidx * s.b + h * s.h;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVec; i += THREADS) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    const int row = row0 + r;
    const bool ok = row < n && c < d;
    cp_async_16(dst + r * LD + c,
                ok ? base + (long long)row * s.l + c : src, ok);
  }
}

// ldmatrix .x4: lanes 8i..8i+7 give the row addresses of 8x8 matrix i, and
// r[i] receives that matrix's fragment (row lane / 4, columns 2 (lane % 4)
// and the next); .trans delivers the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The lane's address for ldmatrix_x4 of the A fragment of the 16 x 16 block
// at (row0, col0) of a row-major shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* tile,
                                                   int row0, int col0,
                                                   int lane) {
  return tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8;
}

// B fragments of two 8-column tiles (n0 and n0 + 8) of B = T^T, where T is
// a row-major (n x k) shared tile: b[0], b[1] for columns n0..n0+7 and
// b[2], b[3] for n0+8..n0+15, over k0..k0+15. ldmatrix_x4, no transpose.
template <int LD>
__device__ __forceinline__ const bf16* bt_frag_addr(const bf16* tile, int n0,
                                                    int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}

// B fragments of two 8-column tiles of B = T itself, T a row-major (k x n)
// shared tile, over rows k0..k0+15 and columns n0..n0+15: ldmatrix_x4_trans,
// b[0], b[1] for n0..n0+7 and b[2], b[3] for n0+8..n0+15.
template <int LD>
__device__ __forceinline__ const bf16* b_frag_addr(const bf16* tile, int k0,
                                                   int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
         (lane >> 4) * 8;
}

// c += a b on the tensor cores, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit: one ex2.approx.ftz (relative error
// below 2^-22; 2^-inf is 0), where exp2f adds range handling for
// denormal results that a softmax never needs.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16-column k-step covered by the C fragments of the
// 8-column tiles c0 (columns 0..7) and c1 (columns 8..15), in bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Store a warp's 16 x DP fp32 accumulator (C fragments of DP / 8 column
// tiles, times mul) as bf16 into rows [row0, row0 + 16) of a shared tile
// with row stride LD.
template <int DP, int LD>
__device__ __forceinline__ void acc_to_smem(bf16* tile, int row0,
                                            const float (&acc)[DP / 8][4],
                                            float mul0, float mul1,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (row0 + g) * LD + c) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + (row0 + g + 8) * LD + c) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// One warp copies 16 rows of a shared tile to rows [row0, row0 + 16) of one
// head of a (B, L, H, d) bf16 tensor, 16 bytes per store; rows >= n and
// columns >= d are not written.
template <int DP, int LD>
__device__ __forceinline__ void store_rows_warp(bf16* dst, const bf16* tile,
                                                int tile_row0, Strides s,
                                                int bidx, int h, int row0,
                                                int n, int d, int lane) {
  constexpr int kVec = DP / 8;
  bf16* base = dst + bidx * s.b + h * s.h;
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    if (row0 + r < n && c < d)
      *reinterpret_cast<uint4*>(base + (long long)(row0 + r) * s.l + c) =
          *reinterpret_cast<const uint4*>(tile + (tile_row0 + r) * LD + c);
  }
}

// The opt-in shared-memory limit is a property of each function on each
// device: raise it once per (function, device), at the first launch there.
// Each template instantiation of a kernel passes its own `done` flags.
template <typename Kernel>
cudaError_t ensure_smem_limit(Kernel kernel, size_t bytes,
                              std::atomic<bool>* done) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace mma_tiles
