// Flash-attention backward, dq (K2), for Hopper (sm_90a), bf16 in, fp32
// accumulators in registers.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (pallas_call at :250), one of the two kernels of the
// custom_vjp backward _flash_bwd_rule; the other, _bwd_dkv_kernel, is K3 in
// flash_attention_bwd_dkv.cu. It recomputes the probabilities from the
// logsumexp that the forward (K1, flash_attention_fwd.cu) wrote, instead of
// storing them:
//     s  = scale * q k^T          (keys >= Lk masked: p = 0)
//     p  = exp(s - lse)
//     ds = p * (do v^T - delta),  delta = rowsum(do * o)  (computed outside)
//     dq = scale * ds k
// q is not pre-scaled: the scale enters in s and again in dq.
//
// What bounds it on an H100: at the UNet's self-attention (L = 3072,
// d = 40) it does 6*L*L*d operations per head against O(L*d) bytes, so the
// tensor cores bound it (989 TFLOP/s bf16); at the cross-attention
// (Lk = 77) the bytes of q, do and lse dominate and memory (3.35 TB/s)
// bounds it.
//
// Design (FlashAttention-2's dq kernel, mma.sync.m16n8k16 as in K1 and K3):
//   * one block per (128-query tile, batch*head); each warp owns MT row
//     blocks of 16 query rows: MT = 2 (4 warps) for head dims up to 64, so
//     every K and V fragment read from shared memory feeds two row blocks
//     (shared-memory bandwidth, not the tensor cores, limits the 16-row
//     design there), MT = 1 (8 warps) above;
//   * the dQ accumulator stays in registers; keys are taken 16 at a time,
//     so S = Q K^T and dP = dO V^T of those keys are two C fragments each,
//     p = exp2(S scale log2(e) - lse log2(e)) (one ex2.approx, each row's
//     lse and delta held in registers), and ds = p (dP - delta) is packed
//     to bf16 in registers as the A fragment of dQ += ds K (pack_a), with K
//     the B operand through ldmatrix .trans: no score tile touches shared
//     memory;
//   * Q and dO fragments stay in registers for the whole key loop up to
//     DP = 128; at DP 160 and 192 they come from shared memory per k-step,
//     which leaves the registers to the 80..96-value dQ accumulator;
//   * K and V stream through a two-stage cp.async ring of 64-key tiles,
//     tile j + 1 in flight while tile j is multiplied. Rows past Lk (and
//     past Lq, for Q and dO) and columns past d are zero-filled by the
//     copy; keys past Lk get p = 0, and a warp whose rows all lie past Lq
//     skips the products;
//   * operands sit in shared memory with rows padded by 8 elements, so
//     the ldmatrix reads are free of bank conflicts; the head dim is padded
//     to the bucket DP (a multiple of 16) with zeros, which leaves every
//     product unchanged; one instantiation per bucket up to 192;
//   * the (B, L, H, d) layout is read and written through strides (no
//     transposes, no padding copies); dq leaves through shared memory (each
//     warp's own Q rows) in 16-byte stores, rows past Lq never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int kBQ = 128;  // query rows per block
constexpr int kBK = 64;   // keys per ring stage
constexpr int kStages = 2;
constexpr int kMaxDp = 192;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__host__ __device__ constexpr int row_ld() {
  return DP + 8;
}

// 16-row blocks per warp
template <int DP>
__host__ __device__ constexpr int row_blocks() {
  return DP <= 64 ? 2 : 1;
}

// Q and dO as register-resident A fragments for the whole key loop
template <int DP>
__host__ __device__ constexpr bool q_in_registers() {
  return DP <= 128;
}

// Q and dO tiles + the K/V ring
template <int DP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return size_t(2 * kBQ + 2 * kStages * kBK) * row_ld<DP>() * sizeof(bf16);
}

template <int DP, int MT, int MINB>
__global__ void __launch_bounds__(kBQ / 16 / MT * 32, MINB)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Lq, int Lk, int d,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, float scale) {
  constexpr int THREADS = kBQ / 16 / MT * 32;
  constexpr int LD = row_ld<DP>();
  constexpr int NT = DP / 8;   // 8-column tiles of the head dim
  constexpr int KT = DP / 16;  // 16-column k-steps of the head dim
  constexpr bool QREG = q_in_registers<DP>();
  constexpr int QF = QREG ? KT : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LD;
  bf16* Ks = dOs + kBQ * LD;  // stage s at Ks + s * kBK * LD
  bf16* Vs = Ks + kStages * kBK * LD;

  const int bh = blockIdx.y;
  const int bidx = bh / H;
  const int h = bh - bidx * H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * MT;
  const bool active = q0 + wrow < Lq;
  const int n_tiles = (Lk + kBK - 1) / kBK;
  const float scale_log2 = scale * kLog2e;

  load_rows_async<kBQ, DP, LD, THREADS>(Qs, q, qs, bidx, h, q0, Lq, d);
  load_rows_async<kBQ, DP, LD, THREADS>(dOs, dout, dos, bidx, h, q0, Lq, d);
  load_rows_async<kBK, DP, LD, THREADS>(Ks, k, ks, bidx, h, 0, Lk, d);
  load_rows_async<kBK, DP, LD, THREADS>(Vs, v, vs, bidx, h, 0, Lk, d);
  cp_async_commit();

  // rows g and g + 8 of each row block: lse in log2 units and delta
  float m[MT][2], dl[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + wrow + 16 * i + g + 8 * half;
      const bool ok = r < Lq;
      m[i][half] = ok ? lse[(long long)bh * Lq + r] * kLog2e : 0.f;
      dl[i][half] = ok ? delta[(long long)bh * Lq + r] : 0.f;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  uint32_t qf[MT][QF][4], df[MT][QF][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * kBK * LD;
      load_rows_async<kBK, DP, LD, THREADS>(Ks + nxt, k, ks, bidx, h,
                                            (j + 1) * kBK, Lk, d);
      load_rows_async<kBK, DP, LD, THREADS>(Vs + nxt, v, vs, bidx, h,
                                            (j + 1) * kBK, Lk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if constexpr (QREG) {
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              ldmatrix_x4(qf[i][kk],
                          a_frag_addr<LD>(Qs, wrow + 16 * i, kk * 16, lane));
              ldmatrix_x4(df[i][kk],
                          a_frag_addr<LD>(dOs, wrow + 16 * i, kk * 16, lane));
            }
        }
      }
      const bf16* Kt = Ks + stage * kBK * LD;
      const bf16* Vt = Vs + stage * kBK * LD;
      const int k0 = j * kBK;
      const bool ragged = k0 + kBK > Lk;
#pragma unroll
      for (int kb = 0; kb < kBK / 16; ++kb) {
        // S = Q K^T and dP = dO V^T for keys k0 + 16 kb .. + 15
        float s[MT][2][4], dp[MT][2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[i][n][c] = dp[i][n][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, bt_frag_addr<LD>(Kt, kb * 16, kk * 16, lane));
          ldmatrix_x4(vf, bt_frag_addr<LD>(Vt, kb * 16, kk * 16, lane));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t qa[4], da[4];
            if constexpr (QREG) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                qa[c] = qf[i][kk][c];
                da[c] = df[i][kk][c];
              }
            } else {
              ldmatrix_x4(qa, a_frag_addr<LD>(Qs, wrow + 16 * i, kk * 16,
                                              lane));
              ldmatrix_x4(da, a_frag_addr<LD>(dOs, wrow + 16 * i, kk * 16,
                                              lane));
            }
            mma_16816(s[i][0], qa, kf[0], kf[1]);
            mma_16816(s[i][1], qa, kf[2], kf[3]);
            mma_16816(dp[i][0], da, vf[0], vf[1]);
            mma_16816(dp[i][1], da, vf[2], vf[3]);
          }
        }
        // p = exp2(S scale log2e - lse log2e), 0 for keys >= Lk;
        // ds = p (dP - delta), in place of S, packed to bf16 A fragments
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = k0 + kb * 16 + n * 8 + 2 * t;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float pr = exp2_fast(fmaf(s[i][n][c], scale_log2, -m[i][c >> 1]));
              if (ragged && col + (c & 1) >= Lk) pr = 0.f;
              s[i][n][c] = pr * (dp[i][n][c] - dl[i][c >> 1]);
            }
          }
          pack_a(a[i], s[i][0], s[i][1]);
        }
        // dQ += ds K
#pragma unroll
        for (int nn = 0; nn < KT; ++nn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_frag_addr<LD>(Kt, kb * 16, nn * 16, lane));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_16816(acc[i][2 * nn], a[i], b[0], b[1]);
            mma_16816(acc[i][2 * nn + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration
  }
  if (!active) return;

  // dq = scale dQ in bf16 through the warp's own Q rows
#pragma unroll
  for (int i = 0; i < MT; ++i)
    acc_to_smem<DP, LD>(Qs, wrow + 16 * i, acc[i], scale, scale, lane);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MT; ++i)
    store_rows_warp<DP, LD>(dq, Qs, wrow + 16 * i, dqs, bidx, h,
                            q0 + wrow + 16 * i, Lq, d, lane);
}

struct DqArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16* dq;
  int B, H, Lq, Lk, d;
  Strides qs, ks, vs, dos, dqs;
  float scale;
};

template <int DP>
int launch_dq(const DqArgs& a, cudaStream_t stream) {
  constexpr int MT = row_blocks<DP>();
  // blocks per SM to reserve registers for, as many as leave the
  // accumulators unspilled (ptxas -v): three at DP <= 48 (at most 168
  // registers a thread, 4 warps), two up to 80, one above
  constexpr int MINB = DP <= 48 ? 3 : DP <= 80 ? 2 : 1;
  constexpr int THREADS = kBQ / 16 / MT * 32;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dq_kernel<DP, MT, MINB>;
  constexpr size_t smem = dq_smem_bytes<DP>();
  const cudaError_t err = ensure_smem_limit(kernel, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                          a.delta, a.dq, a.H, a.Lq, a.Lk,
                                          a.d, a.qs, a.ks, a.vs, a.dos, a.dqs,
                                          a.scale);
  return static_cast<int>(cudaGetLastError());
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
  if (d <= 0 || d % 8 != 0 || d > kMaxDp || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs a{static_cast<const bf16*>(q),
                 static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),
                 static_cast<const bf16*>(dout),
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<bf16*>(dq),
                 B, H, Lq, Lk, d,
                 Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                 Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
                 Strides{dq_sb, dq_sl, dq_sh}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_dq<16>(a, s);
  if (d <= 32) return launch_dq<32>(a, s);
  if (d <= 48) return launch_dq<48>(a, s);
  if (d <= 64) return launch_dq<64>(a, s);
  if (d <= 80) return launch_dq<80>(a, s);
  if (d <= 96) return launch_dq<96>(a, s);
  if (d <= 128) return launch_dq<128>(a, s);
  if (d <= 160) return launch_dq<160>(a, s);
  return launch_dq<192>(a, s);
}

}  // extern "C"
