// Flash-attention forward (K1) for Hopper (sm_90a), bf16 in, fp32
// accumulators in registers.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes, per (batch,
// head) and query row,
//     o   = softmax(scale * q k^T, keys >= Lk masked) v     (bf16)
//     lse = m + log(l)                                    (fp32, natural log)
// with the streaming (online) softmax: K/V tiles pass through shared memory
// while each row keeps its running max m, denominator l and output
// accumulator. lse is written (B, H, Lq) contiguous: K2 and K3 read it back.
//
// Which shapes take it: ops/flash_attention.py::fwd_design sends the
// head-dim buckets no UNet path uses here (16, 32, 96 to 144, 192, 256).
// Every path shape (buckets 48, 64, 80 and 160: SD-1.5's d = 40, 80, 160,
// SD-2.1's 64) goes to the Hopper design of flash_attention_fwd_sm90.cu,
// beside which chip_smoke.py still checks and times this one.
//
// What bounds it on an H100: at the UNet's self-attention (L = 6912,
// d = 40..160) the work is 4*L*L*d operations against O(L*d) bytes, so the
// tensor cores bound it (989 TFLOP/s bf16); at d = 40 the exponentials
// (one per score, 16 per SM per clock) come close to that bound as well. At
// the cross-attention (Lk = 77) the q/o bytes dominate and memory
// (3.35 TB/s) bounds it.
//
// Design (FlashAttention-2 style, mma.sync rather than wgmma: a 16-row warp
// tile lets the score fragment be repacked in registers as the A operand of
// P V with no shared-memory round trip, needs no warpgroup-wide
// synchronisation inside the online softmax, and keeps the head-dim buckets
// that are not multiples of 64 (48, 80, 160) as cheap as the others):
//   * one block per (128-query tile, batch*head); each warp owns MT row
//     blocks of 16 query rows: MT = 2 (4 warps) for head dims up to 64,
//     where every K/V fragment read from shared memory then feeds two
//     products (shared-memory bandwidth, not the tensor cores, limits the
//     16-row design at d = 40), MT = 1 (8 warps) above, where the
//     accumulators need the registers. S = Q K^T, P and the O accumulator
//     live in registers as mma.sync.m16n8k16 fragments; S's C fragments are
//     packed to bf16 as P V's A fragments (mma_tiles.cuh), and O is
//     rescaled in registers;
//   * a row's max and sum are reduced over the 4 lanes of its quad (two
//     shuffles); scale * log2(e) is folded into one multiply and the
//     exponential is one ex2.approx, lse is turned back into the natural
//     log;
//   * K/V tiles stream through a two-stage cp.async ring: tile j + 1 is in
//     flight while tile j is multiplied. Rows past Lk and columns past d are
//     zero-filled by the copy; keys past Lk still get -inf logits before
//     the max;
//   * operands sit in shared memory with rows padded by 8 elements (16
//     bytes), so the ldmatrix reads of a row block are free of bank
//     conflicts; the head dim is padded to the bucket DP (a multiple of 16)
//     with zeros, which leaves every product unchanged;
//   * one instantiation per head-dim bucket (16, 32, ..., 160: 64-key
//     tiles; 192 and 256: 32-key tiles, so the accumulators fit in
//     registers), plus an 80-key single-tile variant (MT = 1) for
//     Lk <= 80: the 77-token cross-attention in one tile instead of two of
//     64 takes 18-22 % less device time at d = 80 and 160 and 4-5 % less
//     at d = 40 (PERF.md, section 6);
//   * the (B, L, H, d) layout is read and written through strides (no
//     transposes, no padding copies); o leaves through shared memory (each
//     warp's own Q rows) in 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int kMt2MaxDp = 64;  // widest bucket with two row blocks a warp
constexpr int kBQ = 128;  // query rows per block
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
__host__ __device__ constexpr int row_ld() {
  return DP + 8;
}

template <int DP, int BK>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return size_t(kBQ + 2 * kStages * BK) * row_ld<DP>() * sizeof(bf16);
}

// Each warp owns MT row blocks of 16 query rows (16 * MT rows), so a block
// of 128 rows has 8 / MT warps. With MT = 2 every K and V fragment read
// from shared memory feeds two products, which halves the shared-memory
// traffic per score.
template <int DP, int BK, int MT, int MINB>
__global__ void __launch_bounds__(kBQ / 16 / MT * 32, MINB)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Lq, int Lk, int d,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2) {
  constexpr int THREADS = kBQ / 16 / MT * 32;
  constexpr int LD = row_ld<DP>();
  constexpr int NT = DP / 8;   // 8-column tiles of the head dim
  constexpr int ST = BK / 8;   // 8-column tiles of a score row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LD;            // stage s at Ks + s * BK * LD
  bf16* Vs = Ks + kStages * BK * LD;

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wrow = warp * 16 * MT;
  const int n_tiles = (Lk + BK - 1) / BK;

  load_rows_async<kBQ, DP, LD, THREADS>(Qs, q, qs, bidx, h, q0, Lq, d);
  load_rows_async<BK, DP, LD, THREADS>(Ks, k, ks, bidx, h, 0, Lk, d);
  load_rows_async<BK, DP, LD, THREADS>(Vs, v, vs, bidx, h, 0, Lk, d);
  cp_async_commit();

  float acc[MT][NT][4];
  // rows g and g + 8 of each row block: running max (log2 units, scaled)
  // and this lane's part of the denominator
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * BK * LD;
      load_rows_async<BK, DP, LD, THREADS>(Ks + nxt, k, ks, bidx, h,
                                           (j + 1) * BK, Lk, d);
      load_rows_async<BK, DP, LD, THREADS>(Vs + nxt, v, vs, bidx, h,
                                           (j + 1) * BK, Lk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q K^T for the warp's rows
    float s[MT][ST][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < ST; ++n)
        s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], a_frag_addr<LD>(Qs, wrow + 16 * i, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < ST / 2; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_frag_addr<LD>(Kt, nn * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(s[i][2 * nn], a[i], b[0], b[1]);
          mma_16816(s[i][2 * nn + 1], a[i], b[2], b[3]);
        }
      }
    }

    // keys >= Lk get -inf before the max
    const int k0 = j * BK;
    if (k0 + BK > Lk) {
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const int col = k0 + n * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (col >= Lk) s[i][n][0] = s[i][n][2] = -INFINITY;
          if (col + 1 >= Lk) s[i][n][1] = s[i][n][3] = -INFINITY;
        }
      }
    }

    // online softmax over the quad that holds each row; every tile holds
    // at least one valid key, so the new max is finite
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[i][n][0], s[i][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][n][2], s[i][n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m[i][0], mx0 * scale_log2);
      const float mn1 = fmaxf(m[i][1], mx1 * scale_log2);
      const float alpha0 = exp2_fast(m[i][0] - mn0);
      const float alpha1 = exp2_fast(m[i][1] - mn1);
      m[i][0] = mn0;
      m[i][1] = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        s[i][n][0] = exp2_fast(fmaf(s[i][n][0], scale_log2, -mn0));
        s[i][n][1] = exp2_fast(fmaf(s[i][n][1], scale_log2, -mn0));
        s[i][n][2] = exp2_fast(fmaf(s[i][n][2], scale_log2, -mn1));
        s[i][n][3] = exp2_fast(fmaf(s[i][n][3], scale_log2, -mn1));
        sum0 += s[i][n][0] + s[i][n][1];
        sum1 += s[i][n][2] + s[i][n][3];
      }
      l[i][0] = l[i][0] * alpha0 + sum0;
      l[i][1] = l[i][1] * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[i][n][0] *= alpha0;
        acc[i][n][1] *= alpha0;
        acc[i][n][2] *= alpha1;
        acc[i][n][3] *= alpha1;
      }
    }

    // O += P V, P repacked from S's fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) pack_a(a[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_frag_addr<LD>(Vt, kk * 16, nn * 16, lane));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][2 * nn], a[i], b[0], b[1]);
          mma_16816(acc[i][2 * nn + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration
  }

  // the denominators over the quad; o = O / l in bf16 through the warp's
  // own Q rows, lse = (m + log2 l) ln 2
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float l0 = l[i][0], l1 = l[i][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    acc_to_smem<DP, LD>(Qs, wrow + 16 * i, acc[i], 1.f / l0, 1.f / l1, lane);
    const int r0 = q0 + wrow + 16 * i + g;
    if (t == 0 && r0 < Lq)
      lse[(long long)bh * Lq + r0] = (m[i][0] + log2f(l0)) * kLn2;
    if (t == 0 && r0 + 8 < Lq)
      lse[(long long)bh * Lq + r0 + 8] = (m[i][1] + log2f(l1)) * kLn2;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MT; ++i)
    store_rows_warp<DP, LD>(o, Qs, wrow + 16 * i, os, bidx, h,
                            q0 + wrow + 16 * i, Lq, d, lane);
}

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  int B, H, Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

template <int DP, int BK, int MT>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  // blocks per SM to reserve registers for, as many as leave O and S
  // unspilled (ptxas -v): MT = 1 (8 warps) two up to DP = 64 (at most 128
  // registers a thread); MT = 2 (4 warps) three up to DP = 48 (at most
  // 168), two above
  constexpr int MINB = MT == 2 ? (DP <= 48 ? 3 : 2) : (DP <= 64 ? 2 : 1);
  constexpr int THREADS = kBQ / 16 / MT * 32;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_fwd_kernel<DP, BK, MT, MINB>;
  constexpr size_t smem = fwd_smem_bytes<DP, BK>();
  const cudaError_t err = ensure_smem_limit(kernel, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(a.q, a.k, a.v, a.o, a.lse, a.H,
                                          a.Lq, a.Lk, a.d, a.qs, a.ks, a.vs,
                                          a.os, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Lk <= 80 fits one 80-key tile; longer key ranges stream 64-key tiles
// (32-key tiles for the two widest buckets), two row blocks a warp where
// the accumulators leave room (DP <= kMt2MaxDp).
template <int DP>
int launch_bucket(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (DP > 160) {
    return launch_fwd<DP, 32, 1>(a, stream);
  } else if constexpr (DP <= kMt2MaxDp) {
    return a.Lk <= 80 ? launch_fwd<DP, 80, 1>(a, stream)
                      : launch_fwd<DP, 64, 2>(a, stream);
  } else {
    return a.Lk <= 80 ? launch_fwd<DP, 80, 1>(a, stream)
                      : launch_fwd<DP, 64, 1>(a, stream);
  }
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
  if (d <= 0 || d % 8 != 0 || d > 256 || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o),
                  static_cast<float*>(lse), B, H, Lq, Lk, d,
                  Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                  Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh},
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_bucket<16>(a, s);
  if (d <= 32) return launch_bucket<32>(a, s);
  if (d <= 48) return launch_bucket<48>(a, s);
  if (d <= 64) return launch_bucket<64>(a, s);
  if (d <= 80) return launch_bucket<80>(a, s);
  if (d <= 96) return launch_bucket<96>(a, s);
  if (d <= 128) return launch_bucket<128>(a, s);
  if (d <= 160) return launch_bucket<160>(a, s);
  if (d <= 192) return launch_bucket<192>(a, s);
  return launch_bucket<256>(a, s);
}

}  // extern "C"
