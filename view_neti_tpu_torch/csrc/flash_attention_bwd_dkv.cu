// Flash-attention backward, dk and dv (K3), for Hopper (sm_90a), bf16 in,
// fp32 accumulators in registers.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (pallas_call at :275, in the custom_vjp backward
// _flash_bwd_rule). From the forward's logsumexp (K1, flash_attention_fwd.cu)
// it recomputes, per key row,
//     p  = exp(scale * q k^T - lse)             (queries >= Lq contribute 0)
//     ds = p * (do v^T - delta),  delta = rowsum(do * o)  (computed outside)
//     dv = p^T do,   dk = scale * ds^T q
// q is not pre-scaled: the scale enters in p and again in dk.
//
// What bounds it on an H100: at the UNet's self-attention (L = 3072,
// d = 40) it does 8*L*L*d operations per head against O(L*d) bytes, so the
// tensor cores bound it (989 TFLOP/s bf16); at the cross-attention
// (Lk = 77) the bytes of q, do, lse and delta dominate and memory
// (3.35 TB/s) bounds it.
//
// Design (FlashAttention-2 style, mma.sync.m16n8k16 as in K1):
//   * one block of 8 warps per (128-key tile, batch*head, query split);
//     each warp owns 16 key rows and keeps their dK and dV accumulators in
//     registers. Per query tile, S^T = K Q^T and dP^T = V dO^T stay in
//     registers as C fragments; P^T and dS^T are packed to bf16 in
//     registers as the A operands of dV += P^T dO and dK += dS^T Q;
//   * lse and delta are read per query column from shared memory; p uses
//     ex2.approx with scale * log2(e) folded into one multiply;
//   * Q, dO, lse and delta stream through a two-stage cp.async ring, tile
//     j + 1 in flight while tile j is multiplied; rows past Lq are
//     zero-filled by the copy and their p is set to 0;
//   * a warp whose 16 key rows all lie past Lk skips the products (the
//     77-token cross-attention leaves 3 of the 8 warps idle, not a second
//     block);
//   * when the key tiles times B*H fill less than about two waves of the
//     card, the wrapper splits Lq across blocks (dkv_splits in
//     ops/flash_attention.py): each split writes fp32 partial dK/dV into a
//     scratch tensor the wrapper allocated, and flash_bwd_dkv_reduce_kernel
//     (part of K3) sums the splits in a fixed order and writes bf16 dk/dv
//     through their strides. No atomics: the result is bit-identical from
//     run to run;
//   * rows padded by 8 elements in shared memory (conflict-free ldmatrix),
//     head dim zero-padded to the bucket DP (a multiple of 16); one
//     instantiation per bucket up to 192, 64-query tiles up to DP = 128 and
//     16-query tiles above, so that dK, dV, S^T and dP^T fit in registers;
//   * the (B, L, H, d) layout is read and written through strides (no
//     transposes, no padding copies); unsplit, dk/dv leave through shared
//     memory (each warp's own K/V rows) in 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dkv_reduce.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;
using dkv_reduce::launch_dkv_reduce;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = kWarps * 16;  // 128 key rows per block
constexpr int kStages = 2;
constexpr int kMaxDp = 192;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__host__ __device__ constexpr int row_ld() {
  return DP + 8;
}

// Query rows per ring stage: the dK and dV accumulators take DP registers
// a thread, the fp32 S^T/P^T and dP^T fragments BQ more.
template <int DP>
__host__ __device__ constexpr int q_tile() {
  return DP <= 128 ? 64 : 16;
}

// A query split is whole granules, so that each split's tiles start on a
// tile boundary of every bucket.
constexpr int kQueryGranule = 64;
static_assert(kQueryGranule % q_tile<16>() == 0 &&
              kQueryGranule % q_tile<kMaxDp>() == 0);

template <int DP>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = q_tile<DP>();
  return size_t(2 * kBK + 2 * kStages * BQ) * row_ld<DP>() * sizeof(bf16) +
         size_t(2 * kStages * BQ) * sizeof(float);
}

// Q/dO rows [q0, q0 + BQ) and their lse and delta into one ring stage.
template <int DP, int BQ>
__device__ __forceinline__ void load_q_stage(
    bf16* Qst, bf16* dOst, float* lse_st, float* delta_st, const bf16* q,
    const bf16* dout, const float* lse, const float* delta, Strides qs,
    Strides dos, int bidx, int h, long long bh, int q0, int Lq, int d) {
  constexpr int LD = row_ld<DP>();
  load_rows_async<BQ, DP, LD, kThreads>(Qst, q, qs, bidx, h, q0, Lq, d);
  load_rows_async<BQ, DP, LD, kThreads>(dOst, dout, dos, bidx, h, q0, Lq, d);
  const int i = threadIdx.x;
  if (i < 2 * BQ) {
    const int r = i < BQ ? i : i - BQ;
    const float* src = i < BQ ? lse : delta;
    float* dst = i < BQ ? lse_st : delta_st;
    const bool ok = q0 + r < Lq;
    cp_async_4(dst + r, ok ? src + bh * Lq + q0 + r : src, ok);
  }
}

// part: null, or fp32 scratch (2, splits, B*H, Lk, d): dK then dV partial
// sums of query split blockIdx.z, which covers q_split queries.
template <int DP, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ part, int H, int Lq, int Lk,
                         int d, int q_split, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         float scale) {
  constexpr int LD = row_ld<DP>();
  constexpr int BQ = q_tile<DP>();
  constexpr int NT = DP / 8;   // 8-column tiles of the head dim
  constexpr int ST = BQ / 8;   // 8-column tiles of a score row (queries)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * LD;
  bf16* Qs = Vs + kBK * LD;            // stage s at Qs + s * BQ * LD
  bf16* dOs = Qs + kStages * BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * BQ * LD);
  float* delta_s = lse_s + kStages * BQ;

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int k0 = blockIdx.x * kBK;
  const int qb = blockIdx.z * q_split;
  const int qe = min(Lq, qb + q_split);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wrow = warp * 16;
  const bool active = k0 + wrow < Lk;
  const int n_tiles = (qe - qb + BQ - 1) / BQ;
  const float scale_log2 = scale * kLog2e;

  load_rows_async<kBK, DP, LD, kThreads>(Ks, k, ks, bidx, h, k0, Lk, d);
  load_rows_async<kBK, DP, LD, kThreads>(Vs, v, vs, bidx, h, k0, Lk, d);
  load_q_stage<DP, BQ>(Qs, dOs, lse_s, delta_s, q, dout, lse, delta, qs, dos,
                       bidx, h, bh, qb, Lq, d);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    const int q0 = qb + j * BQ;
    if (j + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      load_q_stage<DP, BQ>(Qs + nxt * BQ * LD, dOs + nxt * BQ * LD,
                           lse_s + nxt * BQ, delta_s + nxt * BQ, q, dout,
                           lse, delta, qs, dos, bidx, h, bh, q0 + BQ, Lq, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* Qt = Qs + stage * BQ * LD;
      const bf16* dOt = dOs + stage * BQ * LD;
      const float* lse_t = lse_s + stage * BQ;
      const float* delta_t = delta_s + stage * BQ;

      // S^T = K Q^T for the warp's 16 keys; p^T = exp2(S^T scale log2e -
      // lse log2e), 0 for queries >= Lq
      float p[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_frag_addr<LD>(Ks, wrow, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < ST / 2; ++nn) {
          uint32_t b[4];
          ldmatrix_x4(b, bt_frag_addr<LD>(Qt, nn * 16, kk * 16, lane));
          mma_16816(p[2 * nn], a, b[0], b[1]);
          mma_16816(p[2 * nn + 1], a, b[2], b[3]);
        }
      }
      const bool ragged = q0 + BQ > Lq;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const int c = n * 8 + 2 * t;
        const float m0 = lse_t[c] * kLog2e, m1 = lse_t[c + 1] * kLog2e;
        p[n][0] = exp2_fast(fmaf(p[n][0], scale_log2, -m0));
        p[n][1] = exp2_fast(fmaf(p[n][1], scale_log2, -m1));
        p[n][2] = exp2_fast(fmaf(p[n][2], scale_log2, -m0));
        p[n][3] = exp2_fast(fmaf(p[n][3], scale_log2, -m1));
        if (ragged) {
          if (q0 + c >= Lq) p[n][0] = p[n][2] = 0.f;
          if (q0 + c + 1 >= Lq) p[n][1] = p[n][3] = 0.f;
        }
      }

      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < DP / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_frag_addr<LD>(dOt, kk * 16, nn * 16, lane));
          mma_16816(dv_acc[2 * nn], a, b[0], b[1]);
          mma_16816(dv_acc[2 * nn + 1], a, b[2], b[3]);
        }
      }

      // dP^T = V dO^T; dS^T = P^T (dP^T - delta), in place
      float ds[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n)
        ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_frag_addr<LD>(Vs, wrow, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < ST / 2; ++nn) {
          uint32_t b[4];
          ldmatrix_x4(b, bt_frag_addr<LD>(dOt, nn * 16, kk * 16, lane));
          mma_16816(ds[2 * nn], a, b[0], b[1]);
          mma_16816(ds[2 * nn + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const int c = n * 8 + 2 * t;
        const float dl0 = delta_t[c], dl1 = delta_t[c + 1];
        ds[n][0] = p[n][0] * (ds[n][0] - dl0);
        ds[n][1] = p[n][1] * (ds[n][1] - dl1);
        ds[n][2] = p[n][2] * (ds[n][2] - dl0);
        ds[n][3] = p[n][3] * (ds[n][3] - dl1);
      }

      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < DP / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_frag_addr<LD>(Qt, kk * 16, nn * 16, lane));
          mma_16816(dk_acc[2 * nn], a, b[0], b[1]);
          mma_16816(dk_acc[2 * nn + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration
  }
  if (!active) return;

  const int g = lane >> 2;
  if (part == nullptr) {
    // dk = scale dK, dv = dV in bf16, through the warp's own K/V rows
    acc_to_smem<DP, LD>(Ks, wrow, dk_acc, scale, scale, lane);
    acc_to_smem<DP, LD>(Vs, wrow, dv_acc, 1.f, 1.f, lane);
    __syncwarp();
    store_rows_warp<DP, LD>(dk, Ks, wrow, dks, bidx, h, k0 + wrow, Lk, d,
                            lane);
    store_rows_warp<DP, LD>(dv, Vs, wrow, dvs, bidx, h, k0 + wrow, Lk, d,
                            lane);
    return;
  }
  // fp32 partial sums of this split, (B*H, Lk, d) slices
  const long long slice = (long long)gridDim.y * Lk * d;
  float* pk = part + blockIdx.z * slice + (long long)bh * Lk * d;
  float* pv = pk + gridDim.z * slice;
  const int r0 = k0 + wrow + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (n * 8 >= d) break;
    if (r0 < Lk) {
      *reinterpret_cast<float2*>(pk + (long long)r0 * d + c) =
          make_float2(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<float2*>(pv + (long long)r0 * d + c) =
          make_float2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (r0 + 8 < Lk) {
      *reinterpret_cast<float2*>(pk + (long long)(r0 + 8) * d + c) =
          make_float2(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<float2*>(pv + (long long)(r0 + 8) * d + c) =
          make_float2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

struct DkvArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dk, *dv;
  float* part;
  int B, H, Lq, Lk, d, splits, q_split;
  Strides qs, ks, vs, dos, dks, dvs;
  float scale;
};

template <int DP>
int launch_dkv(const DkvArgs& a, cudaStream_t stream) {
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dkv_kernel<DP, 1>;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = ensure_smem_limit(kernel, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
      a.splits > 1 ? a.part : nullptr, a.H, a.Lq, a.Lk, a.d, a.q_split, a.qs,
      a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_dkv_reduce(a.part, a.dk, a.dv, a.splits,
                                            a.B * a.H, a.H, a.Lk, a.d, a.dks,
                                            a.dvs, a.scale, stream));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tile sizes that the wrapper's split policy (dkv_splits) assumes: the
// key rows a block (at any head dim d), and the query granule.
int flash_attention_bwd_dkv_key_tile(int) { return kBK; }
int flash_attention_bwd_dkv_query_granule() { return kQueryGranule; }

// q, dout: (B, Lq, H, d); k, v: (B, Lk, H, d); dk, dv: (B, Lk, H, d); all
// bf16 with unit stride along d and the given (batch, row, head) strides in
// elements. lse, delta: (B, H, Lq) fp32, contiguous. splits query splits of
// q_split queries each (whole query granules; (splits - 1) * q_split < Lq);
// with splits > 1, part is fp32 scratch of 2 * splits * B * H * Lk * d
// elements. Launches K3 (and its reduction) on `stream`; returns the
// launches' cudaError_t.
int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int B, int H, int Lq, int Lk, int d, int splits, int q_split,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long do_sb, long long do_sl, long long do_sh,
    long long dk_sb, long long dk_sl, long long dk_sh, long long dv_sb,
    long long dv_sl, long long dv_sh, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxDp || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535 || splits < 1 || splits > 65535 ||
      q_split <= 0 || q_split % kQueryGranule != 0 ||
      (long long)(splits - 1) * q_split >= Lq ||
      (long long)splits * q_split < Lq || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs a{static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),
                  static_cast<float*>(part),
                  B, H, Lq, Lk, d, splits, q_split,
                  Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                  Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
                  Strides{dk_sb, dk_sl, dk_sh}, Strides{dv_sb, dv_sl, dv_sh},
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_dkv<16>(a, s);
  if (d <= 32) return launch_dkv<32>(a, s);
  if (d <= 48) return launch_dkv<48>(a, s);
  if (d <= 64) return launch_dkv<64>(a, s);
  if (d <= 80) return launch_dkv<80>(a, s);
  if (d <= 96) return launch_dkv<96>(a, s);
  if (d <= 128) return launch_dkv<128>(a, s);
  if (d <= 160) return launch_dkv<160>(a, s);
  return launch_dkv<192>(a, s);
}

}  // extern "C"
