// Flash-attention backward, dq (K2), redesigned for Hopper (sm_90a) on wgmma
// and TMA at the head-dim buckets 48 (SD-1.5's d = 40) and 64 (SD-2.1's
// d = 64) above 80 keys: the self-attentions of the train steps (SD-1.5's
// 3072 keys, 4096 on the folder path; SD-2.1's 3072, 768 and 192).
// ops/flash_attention.py::bwd_design sends those shapes here; the mma.sync
// design of flash_attention_bwd_dq.cu keeps the rest (the 77-key
// cross-attentions, the buckets 80 and 160, SD-2.1's 48-key mid block).
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (pallas_call at :250, in the custom_vjp backward
// _flash_bwd_rule). From the forward's log-sum-exp (K1) it recomputes, per
// query row,
//     s  = scale q k^T          (keys >= Lk masked: p = 0)
//     p  = exp(s - lse)
//     ds = p (do v^T - delta),  delta = rowsum(do o)  (computed outside)
//     dq = scale ds k
//
// What bounds it on an H100: 6 B H Lq Lk d operations on the tensor cores
// (0.293 ms at 4096^2 B9 H8 d40) and B H Lq Lk exponentials on the
// special-function units (0.289 ms there): at d = 40 the two are equally
// loaded, so the kernel gains only where the exponentials run under the
// products.
//
// Design (a producer warp and two consumer warpgroups in ping-pong, as the
// forward's long-key kernel in flash_attention_fwd_sm90.cu):
//   * one block per (128-query tile, batch * head), 384 threads. Warpgroup 0
//     is the producer (setmaxnreg 40): its thread 0 loads the block's Q and
//     dO tiles once by TMA, then streams K and V tiles of kBK keys through a
//     ring of kStages stages. Warpgroups 1 and 2 are the consumers (232
//     registers a thread), 64 query rows each, with their rows' lse and
//     delta in registers and dQ (64 x DP fp32) in registers;
//   * per key tile a consumer computes S = Q K^T and dP = dO V^T
//     (wgmma.m64n64k16, both operands from shared memory, K-major), then in
//     registers P = exp2(S scale log2 e - lse log2 e), 0 for keys >= Lk,
//     and dS = P (dP - delta); dS, packed to bf16 in registers, is the A
//     operand of dQ += dS K (wgmma.m64nDPk16, K MN-major from shared
//     memory): dS never passes through shared memory;
//   * ping-pong: in turn j a consumer issues S_j and dP_j and tile j - 1's
//     dS K, hands the turn to the other consumer, and computes P_j and dS_j
//     while the other's products run, so that one consumer's exponentials
//     hide under the other's products; tile j - 1's stage goes back once its
//     product is done. One more turn issues the last dS K;
//   * dq = scale dQ leaves through the consumer's own Q rows in shared
//     memory by a TMA store that clips rows >= Lq and columns >= d.
// No atomics and a fixed order of every sum: the result is the same from
// run to run and in a CUDA graph (the tensor maps are kernel parameters,
// encoded on the host at each call).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

using namespace mma_tiles;
using namespace sm90_tiles;

constexpr int kBQ = 128;     // query rows a block
constexpr int kWgRows = 64;  // query rows a consumer warpgroup
constexpr int kBK = 64;      // keys a ring stage
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
// the producer's 128 x (168 - 40) registers go to the 256 consumer threads
constexpr int kConsumerRegs = 232;
constexpr uint32_t kQBytes = kBQ * kRowBytes;   // a Q or dO tile: 16 KB
constexpr uint32_t kKvBytes = kBK * kRowBytes;  // a K or V stage: 8 KB
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// named barriers: the consumers' turns, and each consumer's epilogue
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr float kLog2e = 1.4426950408889634f;

struct Barriers {
  uint64_t q_full;
  uint64_t kv_full[kStages];
  uint64_t kv_empty[kStages];  // one arrival per consumer warp
};
// Q, dO, the K and V rings, the barriers, and room to align the tiles to
// 1024 bytes (the swizzle atom)
constexpr size_t kSmemBytes =
    1024 + 2 * kQBytes + 2 * kStages * kKvBytes + sizeof(Barriers);
static_assert(kSmemBytes <= kMaxSmem, "K2's tiles exceed 227 KB");

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_sm90(__grid_constant__ const CUtensorMap qmap,
                             __grid_constant__ const CUtensorMap kmap,
                             __grid_constant__ const CUtensorMap vmap,
                             __grid_constant__ const CUtensorMap domap,
                             __grid_constant__ const CUtensorMap dqmap,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, int H, int Lq,
                             int Lk, float scale_log2, float scale) {
  static_assert(DP == 48 || DP == 64, "buckets 48 and 64");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t k_s = do_s + kQBytes;  // stage s at k_s + s * kKvBytes
  const uint32_t v_s = k_s + kStages * kKvBytes;
  const uint32_t bars = v_s + kStages * kKvBytes;
  const uint32_t q_full = bars + offsetof(Barriers, q_full);
  const uint32_t kv_full = bars + offsetof(Barriers, kv_full);  // + 8 s
  const uint32_t kv_empty = bars + offsetof(Barriers, kv_empty);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = (Lk + kBK - 1) / kBK;
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kQBytes);
      tma_load_4d(q_s, &qmap, q_full, 0, q0, h, b);
      tma_load_4d(do_s, &domap, q_full, 0, q0, h, b);
      int s = 0, round = 0;
      for (int j = 0; j < n_tiles; ++j) {
        // stage s held tile j - kStages: wait until both consumers freed it
        if (round > 0) mbar_wait(kv_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(kv_full + 8 * s, 2 * kKvBytes);
        tma_load_4d(k_s + s * kKvBytes, &kmap, kv_full + 8 * s, 0, j * kBK,
                    h, b);
        tma_load_4d(v_s + s * kKvBytes, &vmap, kv_full + 8 * s, 0, j * kBK,
                    h, b);
        if (++s == kStages) {
          s = 0;
          ++round;
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers ----
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r = 16 * warp + g;  // and r + 8
    const int row0 = q0 + c * kWgRows;
    // this consumer's 64 rows of the Q and dO tiles
    const uint32_t q_wg = q_s + c * kWgRows * kRowBytes;
    const uint32_t do_wg = do_s + c * kWgRows * kRowBytes;
    // rows r and r + 8: lse in log2 units and delta (rows >= Lq: 0, their
    // dq is never stored)
    const float* lse_bh = lse + (long long)bh * Lq;
    const float* delta_bh = delta + (long long)bh * Lq;
    const bool ok0 = row0 + r < Lq, ok1 = row0 + r + 8 < Lq;
    const float m0 = ok0 ? lse_bh[row0 + r] * kLog2e : 0.f;
    const float m1 = ok1 ? lse_bh[row0 + r + 8] * kLog2e : 0.f;
    const float dl0 = ok0 ? delta_bh[row0 + r] : 0.f;
    const float dl1 = ok1 ? delta_bh[row0 + r + 8] : 0.f;

    float dq[DP / 2];    // 64 x DP fp32
    float s[kBK / 2];    // S, then P in fp32: 64 x kBK
    float dp[kBK / 2];   // dP, then dS in fp32
    uint32_t ds[kBK / 4];  // dS in bf16: the A operand of kBK / 16 k-steps
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    // The steps of a turn. Every product is issued outside any branch:
    // ptxas serialises wgmma in paths it cannot prove warp-uniform.
    auto issue_s = [&](int stage, int round) {
      mbar_wait(kv_full + 8 * stage, round & 1);
      pin_regs(s);
      pin_regs(dp);
      qk_products<DP, kBK>(s, q_wg, 0, k_s + stage * kKvBytes, 0);
      qk_products<DP, kBK>(dp, do_wg, 0, v_s + stage * kKvBytes, 0);
      wgmma_commit();
    };
    auto issue_dq = [&](int stage) {
      pin_regs(dq);
      pin_regs(ds);
      // K MN-major: the k-steps walk its rows (keys)
      const uint64_t k_desc = sw128_desc(k_s + stage * kKvBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_mn<DP>(dq, ds + 4 * kk, k_desc + 128 * kk, 1);
      wgmma_commit();
    };
    // P and dS of key tile j (S and dP complete), in place
    auto grads = [&](int j) {
      pin_regs(s);
      pin_regs(dp);
      // keys >= Lk get -inf, so p = 0 (in the last tile, a uniform branch;
      // selects inside it)
      if ((j + 1) * kBK > Lk) mask_keys<kBK>(s, Lk - j * kBK - 2 * t);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float p0 = exp2_fast(fmaf(s[4 * n], scale_log2, -m0));
        const float p1 = exp2_fast(fmaf(s[4 * n + 1], scale_log2, -m0));
        const float p2 = exp2_fast(fmaf(s[4 * n + 2], scale_log2, -m1));
        const float p3 = exp2_fast(fmaf(s[4 * n + 3], scale_log2, -m1));
        dp[4 * n] = p0 * (dp[4 * n] - dl0);
        dp[4 * n + 1] = p1 * (dp[4 * n + 1] - dl0);
        dp[4 * n + 2] = p2 * (dp[4 * n + 2] - dl1);
        dp[4 * n + 3] = p3 * (dp[4 * n + 3] - dl1);
      }
    };
    // tile j - 1's dS K complete: its stage goes back, dS is free
    auto release = [&](int stage) {
      pin_regs(dq);
      pin_regs(ds);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * stage);
    };
    const int my_turn = kTurnBar + c, other_turn = kTurnBar + 1 - c;

    // consumer 0 takes the first turn
    if (c == 1) named_bar_arrive(kTurnBar, 256);
    mbar_wait(q_full, 0);

    // turn 0: S_0 and dP_0
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_s(0, 0);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    grads(0);
    pack_p<kBK>(dp, ds);
    // turn j: S_j, dP_j and tile j - 1's dS K
    int s_prev = 0, r_prev = 0;  // tile j - 1's stage and round
    for (int j = 1; j < n_tiles; ++j) {
      const int s_cur = s_prev + 1 == kStages ? 0 : s_prev + 1;
      const int r_cur = s_cur == 0 ? r_prev + 1 : r_prev;
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(s_cur, r_cur);
      issue_dq(s_prev);
      named_bar_arrive(other_turn, 256);
      wgmma_wait<1>();  // S_j and dP_j; tile j - 1's dS K may still run
      grads(j);
      wgmma_wait<0>();
      release(s_prev);
      pack_p<kBK>(dp, ds);
      s_prev = s_cur;
      r_prev = r_cur;
    }
    // the last turn: the last dS K (consumer 1's last turn is the last of
    // all: nobody waits for it)
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_dq(s_prev);
    if (c == 0) named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    release(s_prev);

    // dq = scale dQ in bf16 into this consumer's Q rows (the 128-byte
    // swizzle the dq tensor map reads), out by a TMA store
    write_rows<DP>(smem_raw + (q_wg - raw), 0, dq, scale, scale, r, g, t);
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < Lq) {
      tma_store_4d(&dqmap, q_wg, 0, row0, h, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

struct DqArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* dq;
  int B, H, Lq, Lk, d;
  Strides qs, ks, vs, dos, dqs;
  float scale;
};

template <int DP>
int launch(const DqArgs& a, cudaStream_t stream) {
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dq_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Q and dO in boxes of a block's rows, K and V of a stage's, dq of a
  // consumer's
  CUtensorMap qm, km, vm, dom, dqm;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, kBK)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, kBK)) ||
      (err = tensor_map(&dom, a.dout, a.B, a.Lq, a.H, a.d, a.dos, kBQ)) ||
      (err = tensor_map(&dqm, a.dq, a.B, a.Lq, a.H, a.d, a.dqs, kWgRows)))
    return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qm, km, vm, dom, dqm, a.lse, a.delta, a.H, a.Lq, a.Lk,
      a.scale * kLog2e, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of flash_attention_bwd_dq_bf16 (flash_attention_bwd_dq.cu):
// q, dout, dq (B, Lq, H, d); k, v (B, Lk, H, d); all bf16 with unit stride
// along d and the given (batch, row, head) strides in elements, which TMA
// needs as multiples of 8 with 16-byte aligned bases. lse, delta:
// (B, H, Lq) fp32, contiguous. Head dims 8..64 (buckets 48 and 64).
// Launches K2 on `stream`; returns the launch's cudaError_t.
int flash_attention_bwd_dq_sm90_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq,
    int Lk, int d, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, long long dq_sb, long long dq_sl, long long dq_sh,
    float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 64 || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs a{q, k, v, dout,
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 dq, B, H, Lq, Lk, d,
                 Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                 Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
                 Strides{dq_sb, dq_sl, dq_sh}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 48 ? launch<48>(a, s) : launch<64>(a, s);
}

}  // extern "C"
