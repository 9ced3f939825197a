// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulators.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes, per (batch,
// head) and query row,
//     o   = softmax(scale * q k^T, keys >= Lk masked) v
//     lse = m + log(l)
// with the streaming (online) softmax: K/V tiles pass through shared memory
// while each row keeps its running max m, denominator l and output
// accumulator in fp32.
//
// What bounds it on an H100: at the UNet's self-attention shapes (L = 6912,
// d = 40..160) the work is 4*L*L*d operations against O(L*d) bytes, so the
// tensor cores bound it (989 TFLOP/s bf16); at cross-attention (Lk = 77)
// the q/o bytes dominate and memory (3.35 TB/s) bounds it.
//
// Design (simple and right first; a wgmma/TMA version is later work):
//   * one block of 4 warps per (64-query tile, batch*head); each warp owns
//     16 query rows, so the softmax needs no block-wide synchronisation;
//   * q k^T and p v run on the tensor cores through WMMA 16x16x16 bf16
//     fragments; the head dim is zero-padded to a multiple of 16 in shared
//     memory (d = 40 -> 48), which leaves every product unchanged;
//   * the fp32 output accumulator lives in shared memory, where each row is
//     rescaled by exp(m_old - m_new) before the next p v product is added;
//   * the (B, L, H, d) layout is read through strides (no transposes), and
//     rows past Lq or keys past Lk are bounds-checked (no padding copies):
//     out-of-range keys get -inf logits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 16: one WMMA row block
constexpr int kMaxDp = 256;

struct Strides {
  long long b, l, h;
};

__host__ __device__ constexpr size_t smem_bytes(int dp) {
  // Q, K, V tiles (bf16) + S (fp32) + P (bf16) + O accumulator (fp32)
  return size_t(kBQ + 2 * kBK) * dp * 2 + size_t(kBQ) * kBK * 4 +
         size_t(kBQ) * kBK * 2 + size_t(kBQ) * dp * 4;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + tile_rows) of one head into a (tile_rows x dp)
// shared tile, 8 bf16 (16 bytes) per load; rows >= n and columns >= d are 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          Strides s, int bidx, int h,
                                          int row0, int n, int d, int dp,
                                          int tile_rows) {
  const int vec_per_row = dp / 8;
  for (int i = threadIdx.x; i < tile_rows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && c < d) {
      const __nv_bfloat16* p =
          src + bidx * s.b + (long long)row * s.l + h * s.h + c;
      val = *reinterpret_cast<const uint4*>(p);
    }
    *reinterpret_cast<uint4*>(dst + r * dp + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int Lq, int Lk, int d, int dp, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * dp;
  __nv_bfloat16* Vs = Ks + kBK * dp;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * dp);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + kBQ * kBK);
  float* Os = reinterpret_cast<float*>(Ps + kBQ * kBK);

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * kRowsPerWarp;

  load_tile(Qs, q, qs, bidx, h, q0, Lq, d, dp, kBQ);
  for (int i = threadIdx.x; i < kBQ * dp; i += kThreads) Os[i] = 0.f;

  float m_i[kRowsPerWarp];
  float l_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
  }

  const int n_tiles = (Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile(Ks, k, ks, bidx, h, k0, Lk, d, dp, kBK);
    load_tile(Vs, v, vs, bidx, h, k0, Lk, d, dp, kBK);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32 accumulation)
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + wrow * dp + kk * 16, dp);
        wmma::load_matrix_sync(fb, Ks + n * 16 * dp + kk * 16, dp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + wrow * kBK + n * 16, acc, kBK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax; lane owns columns lane and lane + 32 of each row
    const bool ok0 = k0 + lane < Lk;
    const bool ok1 = k0 + lane + 32 < Lk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = wrow + r;
      const float s0 = ok0 ? Ss[row * kBK + lane] * scale : -INFINITY;
      const float s1 = ok1 ? Ss[row * kBK + lane + 32] * scale : -INFINITY;
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float alpha = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * alpha + warp_sum(p0 + p1);
      m_i[r] = m_new;
      Ps[row * kBK + lane] = __float2bfloat16(p0);
      Ps[row * kBK + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < dp; c += 32) Os[row * dp + c] *= alpha;
    }
    __syncwarp();

    // O += P V
    for (int n = 0; n < dp / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wrow * dp + n * 16, dp,
                             wmma::mem_row_major);
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + wrow * kBK + kk * 16, kBK);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * dp + n * 16, dp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + wrow * dp + n * 16, acc, dp,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // o = O / l in bf16, lse = m + log(l) in fp32
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = wrow + r;
    const int qi = q0 + row;
    if (qi < Lq) {
      const float inv = 1.f / l_i[r];
      __nv_bfloat16* dst = o + bidx * os.b + (long long)qi * os.l + h * os.h;
      for (int c = lane; c < d; c += 32)
        dst[c] = __float2bfloat16(Os[row * dp + c] * inv);
      if (lane == 0) lse[(long long)bh * Lq + qi] = m_i[r] + logf(l_i[r]);
    }
  }
}

// The opt-in shared-memory limit is a property of the function on each
// device: raise it once per device, at the first launch there.
cudaError_t ensure_smem_limit() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxDp)));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (B, Lq, H, d), k/v: (B, Lk, H, d), o: (B, Lq, H, d), all bf16 with unit
// stride along d and the given (batch, row, head) strides in elements;
// lse: (B, H, Lq) fp32, contiguous. Launches on `stream`; returns the
// launch's cudaError_t.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Lq, int Lk,
                             int d, long long q_sb, long long q_sl,
                             long long q_sh, long long k_sb, long long k_sl,
                             long long k_sh, long long v_sb, long long v_sl,
                             long long v_sh, long long o_sb, long long o_sl,
                             long long o_sh, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxDp || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
  const cudaError_t err = ensure_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, smem_bytes(dp),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Lq, Lk, d, dp, Strides{q_sb, q_sl, q_sh},
      Strides{k_sb, k_sl, k_sh}, Strides{v_sb, v_sl, v_sh},
      Strides{o_sb, o_sl, o_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
