// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulators.
//
// Two kernels replace the two TPU kernels of the custom_vjp backward in
// view_neti_tpu/ops/flash_attention.py (_flash_bwd_rule):
//   K2 flash_bwd_dq_kernel  <- _bwd_dq_kernel  (pallas_call at :250)
//   K3 flash_bwd_dkv_kernel <- _bwd_dkv_kernel (pallas_call at :275)
// Both recompute the probabilities from the logsumexp that the forward
// (K1, flash_attention_fwd.cu) wrote, instead of storing them:
//     s  = scale * q k^T          (keys >= Lk masked: p = 0)
//     p  = exp(s - lse)
//     ds = p * (do v^T - delta),  delta = rowsum(do * o)  (computed outside)
//     dq = scale * ds k           (K2)
//     dv = p^T do,  dk = scale * ds^T q   (K3)
// q is not pre-scaled: the scale enters in s and again in dq and dk.
//
// What bounds them on an H100: at the UNet's self-attention (L = 3072,
// d = 40) K2 does 6*L*L*d and K3 8*L*L*d operations per head against O(L*d)
// bytes, so the tensor cores bound them (989 TFLOP/s bf16); at the
// cross-attention (Lk = 77) the bytes of q, do and lse dominate and memory
// (3.35 TB/s) bounds them.
//
// Design (simple and right first; register-resident wgmma versions are
// later work):
//   * K2: one block of 4 warps per (64-query tile, batch*head), looping
//     over 64-key tiles; each warp owns 16 query rows. K3: one block per
//     (64-key tile, batch*head), looping over all 64-query tiles; each warp
//     owns 16 key rows. Every warp touches only its own rows of the score,
//     probability and accumulator tiles, so inside a tile only __syncwarp
//     is needed; __syncthreads guards the shared operand tiles;
//   * all four products of each kernel run on the tensor cores through
//     WMMA 16x16x16 bf16 fragments with fp32 accumulation; the head dim is
//     zero-padded to a multiple of 16 in shared memory, which leaves every
//     product unchanged;
//   * p stays in fp32 registers (2 columns x 16 rows per lane) between its
//     computation and the ds step, so the score tile's shared memory is
//     reused for do v^T; p (K3 only) and ds go to the tensor cores in bf16;
//   * the dq / dk / dv accumulators live in shared memory as fp32 and are
//     loaded, added to and stored by each tile's product, as K1 keeps its
//     output accumulator;
//   * the (B, L, H, d) layout is read through strides (no transposes), and
//     the ragged edges are bounds-checked (no padding copies): keys >= Lk
//     contribute p = 0, query rows >= Lq contribute p = 0 to dk / dv, and
//     rows past the end are never written.
// Shared memory caps the padded head dim at 192 (K3 holds K, V, Q, dO and
// two fp32 accumulators of 64 x dp: 1024*dp + 24 KB <= 227 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;                    // query rows per tile
constexpr int kBK = 64;                    // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;           // one WMMA row block
constexpr int kMaxDp = 192;

struct Strides {
  long long b, l, h;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// K2: Q, dO, K, V tiles (bf16) + score tile (fp32) + ds tile (bf16) + dq
// accumulator (fp32)
__host__ __device__ constexpr size_t dq_smem_bytes(int dp) {
  return size_t(2 * kBQ + 2 * kBK) * dp * 2 + size_t(kBQ) * kBK * 4 +
         size_t(kBQ) * kBK * 2 + size_t(kBQ) * dp * 4;
}

// K3: K, V, Q, dO tiles (bf16) + score tile (fp32) + p/ds tile (bf16) + dk
// and dv accumulators (fp32)
__host__ __device__ constexpr size_t dkv_smem_bytes(int dp) {
  return size_t(2 * kBK + 2 * kBQ) * dp * 2 + size_t(kBK) * kBQ * 4 +
         size_t(kBK) * kBQ * 2 + size_t(2 * kBK) * dp * 4;
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

// 64 per-row fp32 values of one head ((B*H, L) contiguous) into shared
// memory; rows >= n get 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long bh, int row0, int n,
                                          int L) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int row = row0 + i;
    dst[i] = row < n ? src[bh * L + row] : 0.f;
  }
}

// C (16 x 64, fp32, ldm kBK) = A (16 x dp rows of a row-major tile) times
// B^T, with B a (64 x dp) row-major tile read as a col-major dp x 64.
__device__ __forceinline__ void product_abt(float* C, const __nv_bfloat16* A,
                                            const __nv_bfloat16* B, int dp) {
  for (int n = 0; n < kBK / 16; ++n) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dp / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, A + kk * 16, dp);
      wmma::load_matrix_sync(fb, B + n * 16 * dp + kk * 16, dp);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + n * 16, acc, kBK, wmma::mem_row_major);
  }
}

// Acc (16 x dp, fp32, ldm dp) += A (16 x 64 bf16, ldm 64) times B (64 x dp
// bf16, row-major, ldm dp).
__device__ __forceinline__ void accumulate_ab(float* Acc,
                                              const __nv_bfloat16* A,
                                              const __nv_bfloat16* B,
                                              int dp) {
  for (int n = 0; n < dp / 16; ++n) {
    FragAcc acc;
    wmma::load_matrix_sync(acc, Acc + n * 16, dp, wmma::mem_row_major);
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, A + kk * 16, kBK);
      wmma::load_matrix_sync(fb, B + kk * 16 * dp + n * 16, dp);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Acc + n * 16, acc, dp, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                        int d, int dp, Strides qs, Strides ks, Strides vs,
                        Strides dos, Strides dqs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kBQ * dp;
  __nv_bfloat16* Ks = dOs + kBQ * dp;
  __nv_bfloat16* Vs = Ks + kBK * dp;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * dp);
  __nv_bfloat16* DSs = reinterpret_cast<__nv_bfloat16*>(Ss + kBQ * kBK);
  float* dQs = reinterpret_cast<float*>(DSs + kBQ * kBK);
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * kRowsPerWarp;

  load_tile(Qs, q, qs, bidx, h, q0, Lq, d, dp, kBQ);
  load_tile(dOs, dout, dos, bidx, h, q0, Lq, d, dp, kBQ);
  load_rows(lse_s, lse, bh, q0, Lq, Lq);
  load_rows(delta_s, delta, bh, q0, Lq, Lq);
  for (int i = threadIdx.x; i < kBQ * dp; i += kThreads) dQs[i] = 0.f;

  float* S = Ss + wrow * kBK;
  __nv_bfloat16* DS = DSs + wrow * kBK;
  const int n_tiles = (Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile(Ks, k, ks, bidx, h, k0, Lk, d, dp, kBK);
    load_tile(Vs, v, vs, bidx, h, k0, Lk, d, dp, kBK);
    __syncthreads();

    // S = Q K^T; p = exp(scale * S - lse), kept in registers
    product_abt(S, Qs + wrow * dp, Ks, dp);
    __syncwarp();
    const bool ok0 = k0 + lane < Lk;
    const bool ok1 = k0 + lane + 32 < Lk;
    float p0[kRowsPerWarp], p1[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float m = lse_s[wrow + r];
      p0[r] = ok0 ? expf(S[r * kBK + lane] * scale - m) : 0.f;
      p1[r] = ok1 ? expf(S[r * kBK + lane + 32] * scale - m) : 0.f;
    }
    __syncwarp();

    // dP = dO V^T into the score tile; ds = p (dP - delta) in bf16
    product_abt(S, dOs + wrow * dp, Vs, dp);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float dl = delta_s[wrow + r];
      DS[r * kBK + lane] = __float2bfloat16(p0[r] * (S[r * kBK + lane] - dl));
      DS[r * kBK + lane + 32] =
          __float2bfloat16(p1[r] * (S[r * kBK + lane + 32] - dl));
    }
    __syncwarp();

    // dQ += ds K
    accumulate_ab(dQs + wrow * dp, DS, Ks, dp);
    __syncwarp();
  }

  // dq = scale * dQ in q's dtype
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + wrow + r;
    if (qi >= Lq) break;
    __nv_bfloat16* dst = dq + bidx * dqs.b + (long long)qi * dqs.l + h * dqs.h;
    for (int c = lane; c < d; c += 32)
      dst[c] = __float2bfloat16(dQs[(wrow + r) * dp + c] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Lq,
                         int Lk, int d, int dp, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kBK * dp;
  __nv_bfloat16* Qs = Vs + kBK * dp;
  __nv_bfloat16* dOs = Qs + kBQ * dp;
  float* Ss = reinterpret_cast<float*>(dOs + kBQ * dp);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + kBK * kBQ);
  float* dKs = reinterpret_cast<float*>(Ps + kBK * kBQ);
  float* dVs = dKs + kBK * dp;
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * kRowsPerWarp;   // this warp's 16 key rows

  load_tile(Ks, k, ks, bidx, h, k0, Lk, d, dp, kBK);
  load_tile(Vs, v, vs, bidx, h, k0, Lk, d, dp, kBK);
  for (int i = threadIdx.x; i < 2 * kBK * dp; i += kThreads) dKs[i] = 0.f;

  float* S = Ss + wrow * kBQ;
  __nv_bfloat16* P = Ps + wrow * kBQ;
  const int n_tiles = (Lq + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's Q/dO/lse/delta reads are done
    load_tile(Qs, q, qs, bidx, h, q0, Lq, d, dp, kBQ);
    load_tile(dOs, dout, dos, bidx, h, q0, Lq, d, dp, kBQ);
    load_rows(lse_s, lse, bh, q0, Lq, Lq);
    load_rows(delta_s, delta, bh, q0, Lq, Lq);
    __syncthreads();

    // S^T = K Q^T (keys x queries); p^T = exp(scale * S^T - lse[query]);
    // query columns >= Lq contribute nothing
    product_abt(S, Ks + wrow * dp, Qs, dp);
    __syncwarp();
    const bool ok0 = q0 + lane < Lq;
    const bool ok1 = q0 + lane + 32 < Lq;
    const float m0 = lse_s[lane], m1 = lse_s[lane + 32];
    float p0[kRowsPerWarp], p1[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      p0[r] = ok0 ? expf(S[r * kBQ + lane] * scale - m0) : 0.f;
      p1[r] = ok1 ? expf(S[r * kBQ + lane + 32] * scale - m1) : 0.f;
      P[r * kBQ + lane] = __float2bfloat16(p0[r]);
      P[r * kBQ + lane + 32] = __float2bfloat16(p1[r]);
    }
    __syncwarp();

    // dV += p^T dO
    accumulate_ab(dVs + wrow * dp, P, dOs, dp);
    __syncwarp();

    // dP^T = V dO^T into the score tile; ds^T = p^T (dP^T - delta[query])
    // over p in the same tile
    product_abt(S, Vs + wrow * dp, dOs, dp);
    __syncwarp();
    const float dl0 = delta_s[lane], dl1 = delta_s[lane + 32];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      P[r * kBQ + lane] = __float2bfloat16(p0[r] * (S[r * kBQ + lane] - dl0));
      P[r * kBQ + lane + 32] =
          __float2bfloat16(p1[r] * (S[r * kBQ + lane + 32] - dl1));
    }
    __syncwarp();

    // dK += ds^T Q
    accumulate_ab(dKs + wrow * dp, P, Qs, dp);
    __syncwarp();
  }

  // dk = scale * dK, dv = dV in k's / v's dtype
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int ki = k0 + wrow + r;
    if (ki >= Lk) break;
    __nv_bfloat16* dkd = dk + bidx * dks.b + (long long)ki * dks.l + h * dks.h;
    __nv_bfloat16* dvd = dv + bidx * dvs.b + (long long)ki * dvs.l + h * dvs.h;
    for (int c = lane; c < d; c += 32) {
      dkd[c] = __float2bfloat16(dKs[(wrow + r) * dp + c] * scale);
      dvd[c] = __float2bfloat16(dVs[(wrow + r) * dp + c]);
    }
  }
}

// The opt-in shared-memory limit is a property of each function on each
// device: raise it once per (function, device), at the first launch there.
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

std::atomic<bool> dq_smem_done[64];
std::atomic<bool> dkv_smem_done[64];

bool bad_shape(int B, int H, int Lq, int Lk, int d) {
  return d <= 0 || d % 8 != 0 || d > kMaxDp || Lq <= 0 || Lk <= 0 ||
         B <= 0 || H <= 0 || (long long)B * H > 65535;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout: (B, Lq, H, d); k, v: (B, Lk, H, d); dq: (B, Lq, H, d); all bf16
// with unit stride along d and the given (batch, row, head) strides in
// elements. lse, delta: (B, H, Lq) fp32, contiguous. Launches K2 on
// `stream`; returns the launch's cudaError_t.
int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq,
    int Lk, int d, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, long long dq_sb, long long dq_sl, long long dq_sh,
    float scale, void* stream) {
  if (bad_shape(B, H, Lq, Lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
  const cudaError_t err = ensure_smem_limit(
      flash_bwd_dq_kernel, dq_smem_bytes(kMaxDp), dq_smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, dq_smem_bytes(dp),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Lq, Lk, d, dp,
      Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
      Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
      Strides{dq_sb, dq_sl, dq_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}

// The same inputs; dk, dv: (B, Lk, H, d) bf16 with the given strides.
// Launches K3 on `stream`; returns the launch's cudaError_t.
int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Lq, int Lk, int d, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, long long dk_sb, long long dk_sl, long long dk_sh,
    long long dv_sb, long long dv_sl, long long dv_sh, float scale,
    void* stream) {
  if (bad_shape(B, H, Lq, Lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
  const cudaError_t err = ensure_smem_limit(
      flash_bwd_dkv_kernel, dkv_smem_bytes(kMaxDp), dkv_smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + kBK - 1) / kBK, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, dkv_smem_bytes(dp),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Lq, Lk, d, dp, Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
      Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
      Strides{dk_sb, dk_sl, dk_sh}, Strides{dv_sb, dv_sl, dv_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
