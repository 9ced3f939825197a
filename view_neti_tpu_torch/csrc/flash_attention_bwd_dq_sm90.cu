// Flash-attention backward, dq (K2), redesigned for Hopper (sm_90a) on wgmma
// and TMA at every attention shape of the training paths: the head-dim
// buckets 48 (SD-1.5's d = 40), 64 (SD-2.1's d = 64), 80 (SD-1.5's d = 80)
// and 160 (SD-1.5's d = 160), at any number of keys (the self-attentions,
// the 77-key cross-attentions and the mid blocks' 48- and 64-key
// self-attentions). ops/flash_attention.py::bwd_design sends those buckets
// here; the mma.sync design of flash_attention_bwd_dq.cu keeps the buckets
// no path uses (16, 32, 96 to 144, 192).
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
// What bounds it on an H100: at the long self-attentions, 6 B H Lq Lk d
// operations on the tensor cores (0.293 ms at 4096^2 B9 H8 d40) and
// B H Lq Lk exponentials on the special-function units (0.289 ms there): at
// d = 40 the two are equally loaded, so the kernel gains only where the
// exponentials run under the products. At the 77-key cross-attentions and
// the short self-attentions of the lower levels, the bytes: Q, dO and dq
// pass once (3072 x 77 B9 H8 d40: 0.0166 ms at 3.35 TB/s).
//
// Layout of the tiles (as K1's, flash_attention_fwd_sm90.cu): the tensor
// maps have the real head dim d as their inner extent and a 64-wide box, so
// a head dim is held as chunks of 64 columns (1 at buckets 48 and 64, 2 at
// 80, 3 at 160), each its own 1024-byte aligned tile, the last zero-filled
// past d. S and dP step their k-steps across the chunks; dS K reads K
// MN-major with the chunk step as the descriptor's leading byte offset.
//
// Design (a producer warp and two consumer warpgroups in ping-pong, as the
// forward's long-key kernel):
//   * one block per (128-query tile, batch * head), 384 threads. Warpgroup 0
//     is the producer (setmaxnreg 40): its thread 0 loads the block's Q and
//     dO tiles once by TMA, then streams K and V tiles of kBK keys (64; 32
//     at bucket 160, where dQ takes 80 registers a thread and ptxas gives
//     a thread of such a block 168) through a ring of 4 stages.
//     Warpgroups 1 and 2 are the consumers, 64 query rows each, with their
//     rows' lse and delta in registers and dQ (64 x DP fp32) in registers;
//   * per key tile a consumer computes S = Q K^T and dP = dO V^T
//     (wgmma.m64nkBKk16, both operands from shared memory, K-major), then in
//     registers P = exp2(S scale log2 e - lse log2 e), 0 for keys >= Lk,
//     and dS = P (dP - delta); dS, packed to bf16 in registers, is the A
//     operand of dQ += dS K (wgmma.m64nDPk16, K MN-major from shared
//     memory): dS never passes through shared memory;
//   * ping-pong: in turn j a consumer issues S_j and dP_j and tile j - 1's
//     dS K, hands the turn to the other consumer, and computes P_j and dS_j
//     while the other's products run, so that one consumer's exponentials
//     hide under the other's products; tile j - 1's stage goes back once its
//     product is done. One more turn issues the last dS K;
//   * up to 80 keys the block's work is its Q and dO loads, a few products
//     and its dq store, each waiting for the one before: at buckets 48 and
//     64 (SD-1.5's 77-key cross-attentions of the first level, 1728
//     blocks at B9 H8, and SD-2.1's) the C entry takes a short-key kernel
//     instead (flash_bwd_dq_kernel_sm90_short, below: persistent blocks
//     that keep the loads of the next tiles and the store of the last one
//     in flight); at buckets 80 and 160 the long-key kernel runs there too,
//     its last key tile masked;
//   * dq = scale dQ leaves through the consumer's own Q rows in shared
//     memory by one TMA store a chunk, which clips rows >= Lq and columns
//     >= d.
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
constexpr int kStages = 4;   // the K and V ring
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
// the producer's 128 x (168 - 40) registers go to the 256 consumer threads
constexpr int kConsumerRegs = 232;
constexpr uint32_t kQChunkBytes = kBQ * kRowBytes;  // 128 rows, one chunk
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// named barriers: the consumers' turns, and each consumer's epilogue
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr float kLog2e = 1.4426950408889634f;

// the 64-column chunks of a head-dim bucket
constexpr int chunks_of(int dp) { return (dp + kBoxD - 1) / kBoxD; }

// The tiles at bucket DP.
template <int DP>
struct Tiles {
  static constexpr int kChunks = chunks_of(DP);
  // keys a ring stage: 32 at bucket 160, where a consumer's dQ takes 80
  // registers a thread and S and dP of 64 keys 32 + 32 more, over the 168
  // that ptxas gives a thread of a block with a producer warpgroup
  static constexpr int kBK = DP > 128 ? 32 : 64;
  static constexpr uint32_t kKvChunkBytes = kBK * kRowBytes;
  static constexpr uint32_t kQBytes = kChunks * kQChunkBytes;   // Q or dO
  static constexpr uint32_t kKvBytes = kChunks * kKvChunkBytes;  // K or V
  struct Barriers {
    uint64_t q_full;
    uint64_t kv_full[kStages];
    uint64_t kv_empty[kStages];  // one arrival per consumer warp
  };
  // Q, dO, the K and V rings, the barriers, and room to align the tiles to
  // 1024 bytes (the swizzle atom)
  static constexpr size_t kSmemBytes =
      1024 + 2 * kQBytes + 2 * kStages * kKvBytes + sizeof(Barriers);
  static_assert(kSmemBytes <= kMaxSmem, "K2's tiles exceed 227 KB");
};

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
  static_assert(DP == 48 || DP == 64 || DP == 80 || DP == 160,
                "buckets 48, 64, 80 and 160");
  using T = Tiles<DP>;
  constexpr int kBK = T::kBK;
  constexpr uint32_t kKvChunkBytes = T::kKvChunkBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // chunk ch at + ch * 16 KB
  const uint32_t do_s = q_s + T::kQBytes;
  const uint32_t k_s = do_s + T::kQBytes;  // stage s at k_s + s * kKvBytes
  const uint32_t v_s = k_s + kStages * T::kKvBytes;
  const uint32_t bars = v_s + kStages * T::kKvBytes;
  using Bars = typename T::Barriers;
  const uint32_t q_full = bars + offsetof(Bars, q_full);
  const uint32_t kv_full = bars + offsetof(Bars, kv_full);  // + 8 s
  const uint32_t kv_empty = bars + offsetof(Bars, kv_empty);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = (Lk + kBK - 1) / kBK;
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
    prefetch_tensor_map(&domap);
    prefetch_tensor_map(&dqmap);
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
      mbar_arrive_expect_tx(q_full, 2 * T::kQBytes);
      tma_load_chunks<T::kChunks>(q_s, kQChunkBytes, &qmap, q_full, q0, h,
                                  b);
      tma_load_chunks<T::kChunks>(do_s, kQChunkBytes, &domap, q_full, q0, h,
                                  b);
      int s = 0, round = 0;
      for (int j = 0; j < n_tiles; ++j) {
        // stage s held tile j - kStages: wait until both consumers freed it
        if (round > 0) mbar_wait(kv_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(kv_full + 8 * s, 2 * T::kKvBytes);
        tma_load_chunks<T::kChunks>(k_s + s * T::kKvBytes, kKvChunkBytes,
                                    &kmap, kv_full + 8 * s, j * kBK, h, b);
        tma_load_chunks<T::kChunks>(v_s + s * T::kKvBytes, kKvChunkBytes,
                                    &vmap, kv_full + 8 * s, j * kBK, h, b);
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
    // this consumer's 64 rows of chunk 0 of the Q and dO tiles; chunk ch
    // at + ch * kQChunkBytes
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
      qk_products<DP, kBK>(s, q_wg, kQChunkBytes, k_s + stage * T::kKvBytes,
                           kKvChunkBytes);
      qk_products<DP, kBK>(dp, do_wg, kQChunkBytes,
                           v_s + stage * T::kKvBytes, kKvChunkBytes);
      wgmma_commit();
    };
    auto issue_dq = [&](int stage) {
      pin_regs(dq);
      pin_regs(ds);
      // K MN-major: the k-steps walk its rows (keys), the leading byte
      // offset steps between its 64-column chunks
      const uint64_t k_desc =
          sw128_desc(k_s + stage * T::kKvBytes, kKvChunkBytes);
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
    // swizzle the dq tensor map reads), out by one TMA store a chunk
    write_rows<DP>(smem_raw + (q_wg - raw), kQChunkBytes, dq, scale, scale,
                   r, g, t);
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < Lq) {
      tma_store_chunks<T::kChunks>(&dqmap, q_wg, kQChunkBytes, row0, h, b);
      tma_store_wait_read();
    }
  }
}

// The short-key kernel's tiles at bucket DP (48 or 64).
template <int DP>
struct ShortTiles {
  static constexpr int kKeys = 80;  // every key of a (batch, head)
  static constexpr uint32_t kKvBytes = kKeys * kRowBytes;  // K or V
  static constexpr int kKvSlots = 2;
  static constexpr int kQStages = 4;
  static constexpr uint32_t kOBytes = kWgRows * kRowBytes;  // a dq tile
  static constexpr int kOBufs = 2;  // a consumer's dq tiles, in turns
  struct Barriers {
    uint64_t q_full[kQStages];
    uint64_t q_empty[kQStages];  // one arrival per consumer warp
    uint64_t kv_full[kKvSlots];
    uint64_t kv_empty[kKvSlots];
  };
  // the K and V slots, the Q and dO ring, the consumers' dq tiles, the
  // barriers, and room to align the tiles
  static constexpr size_t kSmemBytes = 1024 + 2 * kKvSlots * kKvBytes +
                                       2 * kQStages * kQChunkBytes +
                                       2 * kOBufs * kOBytes +
                                       sizeof(Barriers);
  static_assert(kSmemBytes <= kMaxSmem, "K2's short-key tiles exceed 227 KB");
};

// Tile i of the short-key kernel's list, (batch, 128-query tile, head)
// with the heads fastest: its batch, head, batch * head and first query
// row.
struct Tile {
  int b, h, bh, q0;
};

__device__ __forceinline__ Tile short_tile(int i, int H, int q_tiles) {
  const int rest = i / H;
  const int b = rest / q_tiles;
  const int h = i - rest * H;
  return Tile{b, h, b * H + h, (rest - b * q_tiles) * kBQ};
}

// Up to 80 keys at buckets 48 and 64 (the 77-key cross-attentions of
// SD-1.5's first level and of SD-2.1's, SD-2.1's 48-key mid block): bound
// by the bytes of Q, dO and dq. Persistent blocks, one an SM, each walking
// a contiguous run of the (batch, 128-query tile, head) list, heads
// fastest: the blocks at work read the neighbouring heads of the same rows
// together, a row's whole 640 bytes (B9 H8 d40) where (batch, head) major
// runs read 80 of them (0.0606 against 0.0495 ms at 4096 x 77 B9 H8 d40,
// tools/ab_times.py backward). K and V (80 rows, zero-filled past Lk; their
// (batch, head) changes from tile to tile, and they come from L2) load into
// one of two slots, the next tile's while this one's runs; the producer
// thread streams Q and dO through a ring of 4 stages. A consumer's tile:
// S = Q K^T and
// dP = dO V^T over every key (wgmma.m64n80k16 from shared memory), the
// stage given back as soon as both are done, P and dS in registers (keys
// >= Lk masked), dQ = dS K (5 k-steps of wgmma.m64nDPk16, K MN-major),
// dq = scale dQ into one of the consumer's two dq tiles and out by a TMA
// store that clips rows >= Lq, waited on only when that tile is needed
// again, two tiles later.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_sm90_short(__grid_constant__ const CUtensorMap qmap,
                                   __grid_constant__ const CUtensorMap kmap,
                                   __grid_constant__ const CUtensorMap vmap,
                                   __grid_constant__ const CUtensorMap domap,
                                   __grid_constant__ const CUtensorMap dqmap,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, int H,
                                   int Lq, int Lk, int q_tiles, int total,
                                   float scale_log2, float scale) {
  static_assert(DP == 48 || DP == 64, "buckets 48 and 64");
  using T = ShortTiles<DP>;
  constexpr int kKeys = T::kKeys;
  constexpr int kQStages = T::kQStages;
  constexpr int kKvSlots = T::kKvSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;  // slot at + slot * kKvBytes
  const uint32_t v_s = k_s + kKvSlots * T::kKvBytes;
  const uint32_t q_s = v_s + kKvSlots * T::kKvBytes;  // + stage * 16 KB
  const uint32_t do_s = q_s + kQStages * kQChunkBytes;
  // consumer c's dq tile o at + (c * kOBufs + o) * kOBytes
  const uint32_t o_s = do_s + kQStages * kQChunkBytes;
  const uint32_t bars = o_s + 2 * T::kOBufs * T::kOBytes;
  using Bars = typename T::Barriers;
  const uint32_t q_full = bars + offsetof(Bars, q_full);  // + 8 stage
  const uint32_t q_empty = bars + offsetof(Bars, q_empty);
  const uint32_t kv_full = bars + offsetof(Bars, kv_full);  // + 8 slot
  const uint32_t kv_empty = bars + offsetof(Bars, kv_empty);

  // this block's tiles: a contiguous run of the list
  const int first = static_cast<int>((long long)blockIdx.x * total /
                                     gridDim.x);
  const int last = static_cast<int>((long long)(blockIdx.x + 1) * total /
                                    gridDim.x);
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
    prefetch_tensor_map(&domap);
    prefetch_tensor_map(&dqmap);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);
    }
    for (int s = 0; s < kKvSlots; ++s) {
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
      int cur = -1, gen = -1, s = 0, round = 0;
      for (int i = first; i < last; ++i) {
        const Tile tile = short_tile(i, H, q_tiles);
        if (tile.bh != cur) {
          // K and V of the next (batch, head) into the slot that held
          // generation gen - kKvSlots, once both consumers are done with it
          cur = tile.bh;
          ++gen;
          const int slot = gen % kKvSlots, use = gen / kKvSlots;
          if (use > 0) mbar_wait(kv_empty + 8 * slot, (use - 1) & 1);
          mbar_arrive_expect_tx(kv_full + 8 * slot, 2 * T::kKvBytes);
          tma_load_4d(k_s + slot * T::kKvBytes, &kmap, kv_full + 8 * slot, 0,
                      0, tile.h, tile.b);
          tma_load_4d(v_s + slot * T::kKvBytes, &vmap, kv_full + 8 * slot, 0,
                      0, tile.h, tile.b);
        }
        // stage s held tile i - kQStages: wait until both consumers read it
        if (round > 0) mbar_wait(q_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(q_full + 8 * s, 2 * kQChunkBytes);
        tma_load_4d(q_s + s * kQChunkBytes, &qmap, q_full + 8 * s, 0,
                    tile.q0, tile.h, tile.b);
        tma_load_4d(do_s + s * kQChunkBytes, &domap, q_full + 8 * s, 0,
                    tile.q0, tile.h, tile.b);
        if (++s == kQStages) {
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

    float dq[DP / 2];      // 64 x DP fp32
    float s[kKeys / 2];    // S, then P in fp32: 64 x 80
    float dp[kKeys / 2];   // dP, then dS in fp32
    uint32_t ds[kKeys / 4];  // dS in bf16: the A operand of 5 k-steps
    // rows r and r + 8 of tile i: lse and delta (rows >= Lq: 0, their dq
    // is never stored), loaded a tile ahead, under the products of the tile
    // before: nothing reads them until that tile's turn
    float rows[4];
    auto load_rows = [&](int i) {
      const Tile tile = short_tile(i, H, q_tiles);
      const int row = tile.q0 + c * kWgRows + r;
      const float* lse_bh = lse + (long long)tile.bh * Lq;
      const float* delta_bh = delta + (long long)tile.bh * Lq;
      rows[0] = row < Lq ? lse_bh[row] : 0.f;
      rows[1] = row + 8 < Lq ? lse_bh[row + 8] : 0.f;
      rows[2] = row < Lq ? delta_bh[row] : 0.f;
      rows[3] = row + 8 < Lq ? delta_bh[row + 8] : 0.f;
    };
    if (first < last) load_rows(first);
    int cur = -1, gen = -1, st = 0, round = 0, n = 0;
    for (int i = first; i < last; ++i, ++n) {
      const Tile tile = short_tile(i, H, q_tiles);
      const int row0 = tile.q0 + c * kWgRows;
      const float m0 = rows[0] * kLog2e, m1 = rows[1] * kLog2e;
      const float dl0 = rows[2], dl1 = rows[3];
      if (tile.bh != cur) {
        // the previous (batch, head)'s K and V slot goes back
        if (gen >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(kv_empty + 8 * (gen % kKvSlots));
        }
        cur = tile.bh;
        ++gen;
        mbar_wait(kv_full + 8 * (gen % kKvSlots), (gen / kKvSlots) & 1);
      }
      const int slot = gen % kKvSlots;
      const uint32_t k_slot = k_s + slot * T::kKvBytes;
      const uint32_t v_slot = v_s + slot * T::kKvBytes;
      const uint32_t q_wg = q_s + st * kQChunkBytes + c * kWgRows * kRowBytes;
      const uint32_t do_wg =
          do_s + st * kQChunkBytes + c * kWgRows * kRowBytes;

      // S = Q K^T and dP = dO V^T over every key: the products issued
      // outside any branch
      mbar_wait(q_full + 8 * st, round & 1);
      wgmma_fence();
      pin_regs(s);
      pin_regs(dp);
      qk_products<DP, kKeys>(s, q_wg, 0, k_slot, 0);
      qk_products<DP, kKeys>(dp, do_wg, 0, v_slot, 0);
      wgmma_commit();
      if (i + 1 < last) load_rows(i + 1);
      wgmma_wait<0>();
      pin_regs(s);
      pin_regs(dp);
      // the stage is read: it goes back
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * st);
      if (++st == kQStages) {
        st = 0;
        ++round;
      }

      // P and dS in place: keys >= Lk get -inf, so p = 0 (a uniform
      // branch)
      if (Lk < kKeys) mask_keys<kKeys>(s, Lk - 2 * t);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float p0 = exp2_fast(fmaf(s[4 * j], scale_log2, -m0));
        const float p1 = exp2_fast(fmaf(s[4 * j + 1], scale_log2, -m0));
        const float p2 = exp2_fast(fmaf(s[4 * j + 2], scale_log2, -m1));
        const float p3 = exp2_fast(fmaf(s[4 * j + 3], scale_log2, -m1));
        dp[4 * j] = p0 * (dp[4 * j] - dl0);
        dp[4 * j + 1] = p1 * (dp[4 * j + 1] - dl0);
        dp[4 * j + 2] = p2 * (dp[4 * j + 2] - dl1);
        dp[4 * j + 3] = p3 * (dp[4 * j + 3] - dl1);
      }
      pack_p<kKeys>(dp, ds);

      // dQ = dS K, K MN-major: the k-steps walk its rows (keys)
      wgmma_fence();
      pin_regs(dq);
      pin_regs(ds);
      const uint64_t k_desc = sw128_desc(k_slot);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn<DP>(dq, ds + 4 * kk, k_desc + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin_regs(dq);
      pin_regs(ds);

      // dq = scale dQ into this consumer's dq tile n % 2 once the store
      // that last read it (two tiles ago) is done, out by a TMA store (a
      // tile wholly past Lq stores nothing: one committed group a tile)
      const uint32_t o_wg = o_s + (c * T::kOBufs + n % T::kOBufs) * T::kOBytes;
      if (tid == 0) tma_store_wait_read<T::kOBufs - 1>();
      named_bar_sync(kEpilogueBar + c, 128);
      write_rows<DP>(smem_raw + (o_wg - raw), 0, dq, scale, scale, r, g, t);
      fence_proxy_async();
      named_bar_sync(kEpilogueBar + c, 128);
      if (tid == 0) tma_store_chunks<1>(&dqmap, o_wg, 0, row0, tile.h, tile.b);
    }
    // the shared memory stays until the last store has read it
    if (tid == 0) tma_store_wait_read();
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
  using T = Tiles<DP>;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dq_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, T::kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Q and dO in boxes of a block's rows, K and V of a stage's, dq of a
  // consumer's
  CUtensorMap qm, km, vm, dom, dqm;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, T::kBK)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, T::kBK)) ||
      (err = tensor_map(&dom, a.dout, a.B, a.Lq, a.H, a.d, a.dos, kBQ)) ||
      (err = tensor_map(&dqm, a.dq, a.B, a.Lq, a.H, a.d, a.dqs, kWgRows)))
    return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, dom, dqm, a.lse, a.delta, a.H, a.Lq, a.Lk,
      a.scale * kLog2e, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_short(const DqArgs& a, cudaStream_t stream) {
  using T = ShortTiles<DP>;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dq_kernel_sm90_short<DP>;
  cudaError_t err = ensure_smem_limit(kernel, T::kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return static_cast<int>(err);
  const int q_tiles = (a.Lq + kBQ - 1) / kBQ;
  const long long total = (long long)a.B * a.H * q_tiles;
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // Q and dO in boxes of a tile's rows, K and V of all 80 keys, dq of a
  // consumer's rows
  CUtensorMap qm, km, vm, dom, dqm;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, T::kKeys)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, T::kKeys)) ||
      (err = tensor_map(&dom, a.dout, a.B, a.Lq, a.H, a.d, a.dos, kBQ)) ||
      (err = tensor_map(&dqm, a.dq, a.B, a.Lq, a.H, a.d, a.dqs, kWgRows)))
    return static_cast<int>(err);
  // one block an SM (the registers of 384 threads), each a run of tiles
  const int grid = total < sms ? static_cast<int>(total) : sms;
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, dom, dqm, a.lse, a.delta, a.H, a.Lq, a.Lk, q_tiles,
      static_cast<int>(total), a.scale * kLog2e, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Up to 80 keys at buckets 48 and 64 the short-key kernel, else the
// long-key one.
template <int DP>
int launch_bucket(const DqArgs& a, cudaStream_t stream) {
  if constexpr (DP <= 64)
    if (a.Lk <= ShortTiles<DP>::kKeys) return launch_short<DP>(a, stream);
  return launch<DP>(a, stream);
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
// (B, H, Lq) fp32, contiguous. Head dims 8..80 (buckets 48, 64 and 80) and
// 152..160 (bucket 160), any Lk. Launches K2 on `stream`; returns the
// launch's cudaError_t.
int flash_attention_bwd_dq_sm90_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq,
    int Lk, int d, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, long long dq_sb, long long dq_sl, long long dq_sh,
    float scale, void* stream) {
  const bool bucket =
      d > 0 && d % 8 == 0 && (d <= 80 || (d > 144 && d <= 160));
  if (!bucket || Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 ||
      (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs a{q, k, v, dout,
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 dq, B, H, Lq, Lk, d,
                 Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                 Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
                 Strides{dq_sb, dq_sl, dq_sh}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 48) return launch_bucket<48>(a, s);
  if (d <= 64) return launch_bucket<64>(a, s);
  if (d <= 80) return launch_bucket<80>(a, s);
  return launch_bucket<160>(a, s);
}

}  // extern "C"
