// Flash-attention forward (K1) redesigned for Hopper (sm_90a) on wgmma and
// TMA, at every attention shape of the UNet paths: the head-dim buckets 48
// (SD-1.5's d = 40), 64 (SD-2.1's d = 64), 80 (SD-1.5's d = 80) and 160
// (SD-1.5's d = 160), at any number of keys. ops/flash_attention.py::
// fwd_design sends those buckets here; the mma.sync design of
// flash_attention_fwd.cu keeps the buckets no path uses (16, 32, 96 to 144,
// 192, 256). The one C entry picks one of two kernels by Lk:
//   * flash_fwd_kernel_sm90<DP>, Lk > 80: the self-attentions (SD-1.5's
//     6912 to 3072 keys at d = 40, 1728 to 768 at d = 80, 432 to 108 at
//     d = 160; SD-2.1's 6912 to 108 at d = 64), K and V streamed in tiles
//     through the online softmax;
//   * flash_fwd_kernel_sm90_short<DP>, Lk <= 80: the 77-token
//     cross-attentions of every level of both models and the mid blocks'
//     48- and 64-key self-attentions, where K and V of one (batch, head)
//     fit in one tile.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes, per (batch,
// head) and query row,
//     o   = softmax(scale * q k^T, keys >= Lk masked) v     (bf16)
//     lse = m + log(l)                                    (fp32, natural log)
// lse is written (B, H, Lq) contiguous, as K2 and K3 read it.
//
// What bounds it on an H100:
//   * the self-attentions: one exponential per score on the special-function
//     units (16 a clock on each SM) against 4 d operations per score on the
//     tensor cores. At d = 40 the exponentials (B H Lq Lk over about 4.2e12
//     a second) take longer than the products (4 B H Lq Lk d over 989e12),
//     at d = 64 and above the products do (d = 80, 1728 keys, B6 H8: 0.046
//     ms of products, 0.034 of exponentials). Studies of variants on the
//     card (PERF.md, section 6) found that neither unit binds yet: at
//     d = 40 the TMA stream of 80-byte head rows takes about the kernel's
//     whole time, and at d = 64 the products and the exponentials add up
//     more than they overlap;
//   * the short-key kernel: the bytes of Q and O, each read or written once
//     (K and V are at most 80 rows of a (batch, head)), at 3.35 TB/s: at
//     6912 queries x 77 keys, B6 H8 d40, 54 MB or 0.016 ms, against 0.004 ms
//     of products and 0.006 of exponentials. On the card it runs at about a
//     third of that bound there: per 128-query tile, waiting for the TMA
//     stores of the previous tile's 80-byte output rows takes about as long
//     as the products and the softmax together, and the two consumers'
//     exponentials share the special-function units. Double-buffered
//     output tiles, plain 16-byte stores, a head-major tile order and no
//     L2 promotion were tried (PERF.md, section 6): none gained more than
//     a few per cent at every cross-attention shape.
//
// Layout of the tiles: the tensor maps have the real head dim d as their
// inner extent and a 64-wide box (one 128-byte swizzle row), so a head dim
// is held as chunks of 64 columns (1 at buckets 48 and 64, 2 at 80, 3 at
// 160), each chunk its own 1024-byte aligned tile, the last zero-filled past
// d; keys past Lk and queries past Lq arrive as zero rows, and keys past Lk
// get -inf logits before the max. S = Q K^T steps its k-steps across the
// chunks (d / 16 of them: 3 at bucket 48, 5 at 80, 10 at 160); P V reads V
// MN-major with the chunk step as the descriptor's leading byte offset.
//
// Design of the long-key kernel (FlashAttention-3's shape: a producer warp,
// two consumer warpgroups in ping-pong):
//   * one block per (128-query tile, batch * head), 384 threads: warpgroup
//     0 is the producer, which gives up its registers (setmaxnreg 40) and
//     whose thread 0 issues every TMA copy; warpgroups 1 and 2 are the
//     consumers, 64 query rows each, with 232 registers a thread;
//   * the producer loads the 128-row Q tile once, then streams K and V
//     tiles of kBK keys (128; 64 at bucket 160, where Q and one stage of
//     128-key tiles alone would take 240 KB) through a ring of kStages
//     stages (4 at buckets 48 and 64, 3 at 80 and 160: the 227 KB of shared
//     memory): full barriers (one for K, one for V, so that S can start
//     before V lands) complete on the copies' bytes, an empty barrier on one
//     arrival of each consumer warp once both warpgroups have read the
//     stage;
//   * a consumer computes S = Q K^T (64 x kBK, fp32 in registers) with
//     wgmma.m64nkBKk16 from shared memory (both K-major), runs the online
//     softmax in registers (a row over the 4 lanes of a quad: two shuffles;
//     scale * log2 e folded into one FMA before each ex2.approx), packs P
//     to bf16 in registers as the A operand of O += P V (wgmma.m64nDPk16, A
//     from registers, V MN-major from shared memory): P never passes
//     through shared memory;
//   * ping-pong: the two consumers take turns on the tensor cores through
//     two named barriers. In turn j a consumer issues S_j = Q K_j^T and
//     O += P_{j-1} V_{j-1}, hands the turn over, and runs the softmax of
//     S_j while the other consumer's products run; it rescales O once
//     P_{j-1} V_{j-1} has completed, then frees the stage of tile j - 1.
//     One more turn issues the last P V;
//   * o = O / l leaves through the consumer's own Q rows in shared memory
//     (the swizzled layout) by one TMA store a chunk, which clips rows >= Lq
//     and columns >= d; lse from registers.
//
// Design of the short-key kernel (memory-bound: read each Q byte once,
// write each O byte once, keep the copies in flight):
//   * persistent blocks, one an SM, each walking a contiguous run of the
//     (batch * head, 128-query tile) list, (batch, head) major, so that K
//     and V (80 rows, zero-filled past Lk) load once per (batch, head) a
//     block, into one of kKvSlots slots (2 where they fit: the next (batch,
//     head)'s load overlaps the last tiles of the previous one);
//   * the producer thread streams the Q tiles through a ring of kQStages
//     stages (6 at buckets 48 and 64, 3 at 80, 2 at 160) with full and
//     empty barriers, as above;
//   * a consumer's tile: S = Q K^T over all the keys (wgmma.m64n80k16 from
//     shared memory), the Q stage given back as soon as S is done, a
//     single-pass softmax (the row's every key is here: no running max, no
//     rescale), P packed in registers as the A operand of O = P V (5
//     k-steps of wgmma.m64nDPk16), o = O / l into the consumer's own output
//     tile and out by TMA stores that clip, lse from registers. A store is
//     waited on only when the consumer's next tile needs its output tile
//     again, so it runs beside the next tile's products.
//
// Both kernels: no atomics and a fixed order of every sum, so the result is
// the same from run to run and in a CUDA graph (the tensor maps are kernel
// parameters, encoded on the host at each call).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time through cudaGetDriverEntryPoint (no -lcuda)
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

constexpr int kBQ = 128;        // query rows a block, or a short-key tile
constexpr int kWgRows = 64;     // query rows a consumer warpgroup
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
// the producer's 128 x (168 - 40) registers go to the 256 consumer threads
constexpr int kConsumerRegs = 232;
constexpr uint32_t kQChunkBytes = kBQ * kRowBytes;     // 128 rows, 64 columns
constexpr uint32_t kOChunkBytes = kWgRows * kRowBytes;  // 64 rows, 64 columns
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// named barriers: the consumers' turns, and each consumer's epilogue
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the 64-column chunks of a head-dim bucket
constexpr int chunks_of(int dp) { return (dp + kBoxD - 1) / kBoxD; }

// The long-key kernel's tiles at bucket DP.
template <int DP>
struct LongTiles {
  static constexpr int kChunks = chunks_of(DP);
  static constexpr int kBK = DP > 128 ? 64 : 128;  // keys a tile
  // 2 ran 16 % slower than 4 at d = 40 (PERF.md); 3 is what fits above 64
  static constexpr int kStages = DP <= 64 ? 4 : 3;
  static constexpr uint32_t kQBytes = kChunks * kQChunkBytes;
  static constexpr uint32_t kChunkBytes = kBK * kRowBytes;
  static constexpr uint32_t kTileBytes = kChunks * kChunkBytes;
  struct Barriers {
    uint64_t q_full;
    uint64_t k_full[kStages];
    uint64_t v_full[kStages];
    uint64_t kv_empty[kStages];
  };
  // Q, the K ring, the V ring, the barriers, and room to align the tiles
  // to 1024 bytes (the swizzle atom)
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + sizeof(Barriers);
  static_assert(kSmemBytes <= kMaxSmem, "long-key tiles exceed 227 KB");
};

// The short-key kernel's tiles at bucket DP.
template <int DP>
struct ShortTiles {
  static constexpr int kChunks = chunks_of(DP);
  static constexpr int kKeys = 80;  // every key of a (batch, head)
  static constexpr uint32_t kKvChunkBytes = kKeys * kRowBytes;
  static constexpr uint32_t kKvBytes = kChunks * kKvChunkBytes;
  static constexpr int kKvSlots = DP <= 80 ? 2 : 1;
  static constexpr int kQStages = DP <= 64 ? 6 : DP <= 80 ? 3 : 2;
  static constexpr uint32_t kQBytes = kChunks * kQChunkBytes;
  static constexpr uint32_t kOBytes = kChunks * kOChunkBytes;  // a consumer's
  struct Barriers {
    uint64_t q_full[kQStages];
    uint64_t q_empty[kQStages];
    uint64_t kv_full[kKvSlots];
    uint64_t kv_empty[kKvSlots];
  };
  // the K and V slots, the Q ring, the two consumers' output tiles, the
  // barriers, and room to align the tiles
  static constexpr size_t kSmemBytes = 1024 + 2 * kKvSlots * kKvBytes +
                                       kQStages * kQBytes + 2 * kOBytes +
                                       sizeof(Barriers);
  static_assert(kSmemBytes <= kMaxSmem, "short-key tiles exceed 227 KB");
};

// The max of rows g (mx0) and g + 8 (mx1) of a 64 x N score tile over the
// quad, as 4 independent chains: two warps an SM quarter leave little else
// to hide a long chain's latency.
template <int N>
__device__ __forceinline__ void row_max(const float (&s)[N / 2], float& mx0,
                                        float& mx1) {
  float mp0[4], mp1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mp0[i] = mp1[i] = -INFINITY;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    mp0[n % 4] = fmaxf(mp0[n % 4], fmaxf(s[4 * n], s[4 * n + 1]));
    mp1[n % 4] = fmaxf(mp1[n % 4], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(fmaxf(mp0[0], mp0[1]), fmaxf(mp0[2], mp0[3]));
  mx1 = fmaxf(fmaxf(mp1[0], mp1[1]), fmaxf(mp1[2], mp1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// s = 2^(s scale_log2 - m) in place (m in scaled log2 units), and this
// lane's part of each row's sum, as 4 chains.
template <int N>
__device__ __forceinline__ void exponentiate(float (&s)[N / 2],
                                             float scale_log2, float m0,
                                             float m1, float& sum0,
                                             float& sum1) {
  float part0[4] = {0.f, 0.f, 0.f, 0.f}, part1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    s[4 * n] = exp2_fast(fmaf(s[4 * n], scale_log2, -m0));
    s[4 * n + 1] = exp2_fast(fmaf(s[4 * n + 1], scale_log2, -m0));
    s[4 * n + 2] = exp2_fast(fmaf(s[4 * n + 2], scale_log2, -m1));
    s[4 * n + 3] = exp2_fast(fmaf(s[4 * n + 3], scale_log2, -m1));
    part0[n % 4] += s[4 * n] + s[4 * n + 1];
    part1[n % 4] += s[4 * n + 2] + s[4 * n + 3];
  }
  sum0 = (part0[0] + part0[1]) + (part0[2] + part0[3]);
  sum1 = (part1[0] + part1[1]) + (part1[2] + part1[3]);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap omap,
                          float* __restrict__ lse, int H, int Lq, int Lk,
                          float scale_log2) {
  static_assert(DP == 48 || DP == 64 || DP == 80 || DP == 160,
                "buckets 48, 64, 80 and 160");
  using T = LongTiles<DP>;
  constexpr int kBK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // chunk ch at + ch * 16 KB
  const uint32_t k_s = q_s + T::kQBytes;  // stage s at k_s + s * kTileBytes
  const uint32_t v_s = k_s + kStages * T::kTileBytes;
  const uint32_t bars = v_s + kStages * T::kTileBytes;
  using Bars = typename T::Barriers;
  const uint32_t q_full = bars + offsetof(Bars, q_full);
  const uint32_t k_full = bars + offsetof(Bars, k_full);  // + 8 s
  const uint32_t v_full = bars + offsetof(Bars, v_full);
  const uint32_t kv_empty = bars + offsetof(Bars, kv_empty);

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
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, T::kQBytes);
      tma_load_chunks<T::kChunks>(q_s, kQChunkBytes, &qmap, q_full, q0, h,
                                  b);
      int s = 0, round = 0;
      for (int j = 0; j < n_tiles; ++j) {
        // stage s held tile j - kStages: wait until both consumers freed it
        if (round > 0) mbar_wait(kv_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(k_full + 8 * s, T::kTileBytes);
        tma_load_chunks<T::kChunks>(k_s + s * T::kTileBytes, T::kChunkBytes,
                                    &kmap, k_full + 8 * s, j * kBK, h, b);
        mbar_arrive_expect_tx(v_full + 8 * s, T::kTileBytes);
        tma_load_chunks<T::kChunks>(v_s + s * T::kTileBytes, T::kChunkBytes,
                                    &vmap, v_full + 8 * s, j * kBK, h, b);
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
    // this consumer's rows of Q chunk 0; chunk ch at + ch * kQChunkBytes
    const uint32_t q_wg = q_s + c * kWgRows * kRowBytes;

    float o[DP / 2];  // O: 64 x DP fp32, DP / 8 column tiles
    float s[kBK / 2];  // S, then P in fp32: 64 x kBK
    uint32_t p[kBK / 4];  // P in bf16 pairs: the A operand of kBK / 16 k-steps
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // rows g and g + 8 of the warp's 16: running max (log2 units, scaled)
    // and this lane's part of the denominator
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float alpha0, alpha1, sum0, sum1;

    // The steps of a turn. Every product is issued outside any branch:
    // ptxas serialises wgmma in paths it cannot prove warp-uniform.
    auto issue_s = [&](int stage, int round) {
      mbar_wait(k_full + 8 * stage, round & 1);
      pin_regs(s);
      qk_products<DP, kBK>(s, q_wg, kQChunkBytes,
                           k_s + stage * T::kTileBytes, T::kChunkBytes);
      wgmma_commit();
    };
    auto issue_pv = [&](int stage, int round) {
      mbar_wait(v_full + 8 * stage, round & 1);
      pin_regs(o);
      pin_regs(p);
      // the leading byte offset steps between V's 64-column chunks
      const uint64_t v_desc =
          sw128_desc(v_s + stage * T::kTileBytes, T::kChunkBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_mn<DP>(o, p + 4 * kk, v_desc + 128 * kk, 1);
      wgmma_commit();
    };
    // the online softmax of S (tile j, its product complete): P in place
    auto softmax = [&](int j) {
      pin_regs(s);
      // keys >= Lk get -inf before the max (in the last tile, a uniform
      // branch; selects inside it); every tile holds a valid key
      if ((j + 1) * kBK > Lk) mask_keys<kBK>(s, Lk - j * kBK - 2 * t);
      float mx0, mx1;
      row_max<kBK>(s, mx0, mx1);
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      alpha0 = exp2_fast(m0 - mn0);
      alpha1 = exp2_fast(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      exponentiate<kBK>(s, scale_log2, mn0, mn1, sum0, sum1);
    };
    // P_{j-1} V_{j-1} complete: O and P are free, the stage goes back
    auto release = [&](int stage) {
      pin_regs(o);
      pin_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * stage);
    };
    // O rescaled to the new max, P packed to bf16 as the next A operand
    auto rescale_pack = [&]() {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      pack_p<kBK>(s, p);
    };
    const int my_turn = kTurnBar + c, other_turn = kTurnBar + 1 - c;

    // consumer 0 takes the first turn
    if (c == 1) named_bar_arrive(kTurnBar, 256);
    mbar_wait(q_full, 0);

    // turn 0: S_0
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_s(0, 0);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    softmax(0);
    rescale_pack();
    // turn j: S_j and P_{j-1} V_{j-1}
    int s_prev = 0, r_prev = 0;  // tile j - 1's stage and round
    for (int j = 1; j < n_tiles; ++j) {
      const int s_cur = s_prev + 1 == kStages ? 0 : s_prev + 1;
      const int r_cur = s_cur == 0 ? r_prev + 1 : r_prev;
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(s_cur, r_cur);
      issue_pv(s_prev, r_prev);
      named_bar_arrive(other_turn, 256);
      wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
      softmax(j);
      wgmma_wait<0>();
      release(s_prev);
      rescale_pack();
      s_prev = s_cur;
      r_prev = r_cur;
    }
    // the last turn: the last P V (consumer 1's last turn is the last of
    // all: nobody waits for it)
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_pv(s_prev, r_prev);
    if (c == 0) named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    release(s_prev);

    // the denominators over the quad; o = O / l in bf16 into this
    // consumer's Q rows (the 128-byte swizzle the O tensor map reads),
    // lse = (m + log2 l) ln 2
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r = 16 * warp + g;
    write_rows<DP>(smem_raw + (q_wg - raw), kQChunkBytes, o, 1.f / l0,
                1.f / l1, r, g, t);
    const int row0 = q0 + c * kWgRows;
    if (t == 0 && row0 + r < Lq)
      lse[(long long)bh * Lq + row0 + r] = (m0 + log2f(l0)) * kLn2;
    if (t == 0 && row0 + r + 8 < Lq)
      lse[(long long)bh * Lq + row0 + r + 8] = (m1 + log2f(l1)) * kLn2;
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < Lq) {
      tma_store_chunks<T::kChunks>(&omap, q_wg, kQChunkBytes, row0, h, b);
      tma_store_wait_read();
    }
  }
}

// Tile i of the short-key kernel's list: its batch, head, batch * head and
// first query row.
struct Tile {
  int b, h, bh, q0;
};

__device__ __forceinline__ Tile short_tile(int i, int H, int q_tiles) {
  const int bh = i / q_tiles;
  const int b = bh / H;
  return Tile{b, bh - b * H, bh, (i - bh * q_tiles) * kBQ};
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90_short(__grid_constant__ const CUtensorMap qmap,
                                __grid_constant__ const CUtensorMap kmap,
                                __grid_constant__ const CUtensorMap vmap,
                                __grid_constant__ const CUtensorMap omap,
                                float* __restrict__ lse, int H, int Lq,
                                int Lk, int q_tiles, int total,
                                float scale_log2) {
  static_assert(DP == 48 || DP == 64 || DP == 80 || DP == 160,
                "buckets 48, 64, 80 and 160");
  using T = ShortTiles<DP>;
  constexpr int kKeys = T::kKeys;
  constexpr int kQStages = T::kQStages;
  constexpr int kKvSlots = T::kKvSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;  // slot at + slot * kKvBytes
  const uint32_t v_s = k_s + kKvSlots * T::kKvBytes;
  const uint32_t q_s = v_s + kKvSlots * T::kKvBytes;  // + stage * kQBytes
  const uint32_t o_s = q_s + kQStages * T::kQBytes;  // + consumer * kOBytes
  const uint32_t bars = o_s + 2 * T::kOBytes;
  using Bars = typename T::Barriers;
  const uint32_t q_full = bars + offsetof(Bars, q_full);  // + 8 stage
  const uint32_t q_empty = bars + offsetof(Bars, q_empty);
  const uint32_t kv_full = bars + offsetof(Bars, kv_full);  // + 8 slot
  const uint32_t kv_empty = bars + offsetof(Bars, kv_empty);

  // this block's tiles: a contiguous run of the (batch * head, 128-query
  // tile) list; a (batch, head)'s K and V load once the block
  const int first = static_cast<int>((long long)blockIdx.x * total /
                                     gridDim.x);
  const int last = static_cast<int>((long long)(blockIdx.x + 1) * total /
                                    gridDim.x);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);  // one arrival per consumer warp
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
        const int b = tile.b, h = tile.h;
        if (tile.bh != cur) {
          // K and V of the next (batch, head) into the slot that held
          // generation gen - kKvSlots, once both consumers are done with it
          cur = tile.bh;
          ++gen;
          const int slot = gen % kKvSlots, use = gen / kKvSlots;
          if (use > 0) mbar_wait(kv_empty + 8 * slot, (use - 1) & 1);
          mbar_arrive_expect_tx(kv_full + 8 * slot, 2 * T::kKvBytes);
          tma_load_chunks<T::kChunks>(k_s + slot * T::kKvBytes,
                                      T::kKvChunkBytes, &kmap,
                                      kv_full + 8 * slot, 0, h, b);
          tma_load_chunks<T::kChunks>(v_s + slot * T::kKvBytes,
                                      T::kKvChunkBytes, &vmap,
                                      kv_full + 8 * slot, 0, h, b);
        }
        // stage s held tile i - kQStages: wait until both consumers read it
        if (round > 0) mbar_wait(q_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(q_full + 8 * s, T::kQBytes);
        tma_load_chunks<T::kChunks>(q_s + s * T::kQBytes, kQChunkBytes,
                                    &qmap, q_full + 8 * s, tile.q0, h, b);
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
    const uint32_t o_wg = o_s + c * T::kOBytes;

    float o[DP / 2];      // O: 64 x DP fp32
    float sc[kKeys / 2];  // S, then P in fp32: 64 x 80
    uint32_t p[kKeys / 4];  // P in bf16 pairs: the A operand of 5 k-steps
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    int cur = -1, gen = -1, s = 0, round = 0;
    for (int i = first; i < last; ++i) {
      const Tile tile = short_tile(i, H, q_tiles);
      const int b = tile.b, h = tile.h, bh = tile.bh;
      if (bh != cur) {
        // the previous (batch, head)'s K and V slot goes back
        if (gen >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(kv_empty + 8 * (gen % kKvSlots));
        }
        cur = bh;
        ++gen;
        mbar_wait(kv_full + 8 * (gen % kKvSlots), (gen / kKvSlots) & 1);
      }
      const int slot = gen % kKvSlots;
      const uint32_t q_wg = q_s + s * T::kQBytes + c * kWgRows * kRowBytes;

      // S = Q K^T over every key: the products issued outside any branch
      mbar_wait(q_full + 8 * s, round & 1);
      wgmma_fence();
      pin_regs(sc);
      qk_products<DP, kKeys>(sc, q_wg, kQChunkBytes,
                             k_s + slot * T::kKvBytes, T::kKvChunkBytes);
      wgmma_commit();
      wgmma_wait<0>();
      pin_regs(sc);
      // the Q stage is read: it goes back
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * s);
      if (++s == kQStages) {
        s = 0;
        ++round;
      }

      // the softmax in one pass: keys >= Lk get -inf (a uniform branch)
      if (Lk < kKeys) mask_keys<kKeys>(sc, Lk - 2 * t);
      float mx0, mx1, l0, l1;
      row_max<kKeys>(sc, mx0, mx1);
      const float m0 = mx0 * scale_log2, m1 = mx1 * scale_log2;
      exponentiate<kKeys>(sc, scale_log2, m0, m1, l0, l1);
      pack_p<kKeys>(sc, p);

      // O = P V, V MN-major with the chunk step as the leading byte offset
      wgmma_fence();
      pin_regs(o);
      pin_regs(p);
      const uint64_t v_desc =
          sw128_desc(v_s + slot * T::kKvBytes, T::kKvChunkBytes);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn<DP>(o, p + 4 * kk, v_desc + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin_regs(o);
      pin_regs(p);

      // o = O / l into this consumer's output tile once its last store
      // has read it; lse = (m + log2 l) ln 2
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const int row0 = tile.q0 + c * kWgRows;
      if (tid == 0) tma_store_wait_read();
      named_bar_sync(kEpilogueBar + c, 128);
      write_rows<DP>(smem_raw + (o_wg - raw), kOChunkBytes, o, 1.f / l0,
                  1.f / l1, r, g, t);
      if (t == 0 && row0 + r < Lq)
        lse[(long long)bh * Lq + row0 + r] = (m0 + log2f(l0)) * kLn2;
      if (t == 0 && row0 + r + 8 < Lq)
        lse[(long long)bh * Lq + row0 + r + 8] = (m1 + log2f(l1)) * kLn2;
      fence_proxy_async();
      named_bar_sync(kEpilogueBar + c, 128);
      if (tid == 0 && row0 < Lq)
        tma_store_chunks<T::kChunks>(&omap, o_wg, kOChunkBytes, row0, h, b);
    }
    // the shared memory stays until the last store has read it
    if (tid == 0) tma_store_wait_read();
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

// The four tensor maps of a launch: Q in boxes of q_rows rows, K and V of
// kv_rows, O of a consumer's 64.
cudaError_t tensor_maps(const FwdArgs& a, int q_rows, int kv_rows,
                        CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm,
                        CUtensorMap* om) {
  // the L2 promotion of the tile loads (tools/fwd_short_variants.py times
  // the kernels without it)
  const CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  cudaError_t err;
  if ((err = tensor_map(qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, q_rows, l2)) ||
      (err = tensor_map(km, a.k, a.B, a.Lk, a.H, a.d, a.ks, kv_rows, l2)) ||
      (err = tensor_map(vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, kv_rows, l2)) ||
      (err = tensor_map(om, a.o, a.B, a.Lq, a.H, a.d, a.os, kWgRows, l2)))
    return err;
  return cudaSuccess;
}

template <int DP>
int launch_long(const FwdArgs& a, cudaStream_t stream) {
  using T = LongTiles<DP>;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_fwd_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, T::kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm, om;
  if ((err = tensor_maps(a, kBQ, T::kBK, &qm, &km, &vm, &om)))
    return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, om, a.lse, a.H, a.Lq, a.Lk, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_short(const FwdArgs& a, cudaStream_t stream) {
  using T = ShortTiles<DP>;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_fwd_kernel_sm90_short<DP>;
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
  CUtensorMap qm, km, vm, om;
  if ((err = tensor_maps(a, kBQ, T::kKeys, &qm, &km, &vm, &om)))
    return static_cast<int>(err);
  // one block an SM (the registers of 384 threads), each a run of tiles
  const int grid = total < sms ? static_cast<int>(total) : sms;
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, om, a.lse, a.H, a.Lq, a.Lk, q_tiles,
      static_cast<int>(total), a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bucket(const FwdArgs& a, cudaStream_t stream) {
  return a.Lk <= ShortTiles<DP>::kKeys ? launch_short<DP>(a, stream)
                                       : launch_long<DP>(a, stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of flash_attention_fwd_bf16 (flash_attention_fwd.cu): q
// (B, Lq, H, d), k/v (B, Lk, H, d), o (B, Lq, H, d), bf16 with unit stride
// along d and the given (batch, row, head) strides in elements, which TMA
// needs as multiples of 8 with 16-byte aligned bases; lse (B, H, Lq) fp32,
// contiguous. Head dims 8..80 (buckets 48, 64 and 80) and 152..160 (bucket
// 160); Lk <= 80 takes the short-key kernel, more the long-key one.
// Launches on `stream`; returns the launch's cudaError_t.
int flash_attention_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Lq, int Lk, int d, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, float scale, void* stream) {
  const bool bucket =
      d > 0 && d % 8 == 0 && (d <= 80 || (d > 144 && d <= 160));
  if (!bucket || Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 ||
      (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), B, H, Lq, Lk, d,
                  Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                  Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh},
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 48) return launch_bucket<48>(a, s);
  if (d <= 64) return launch_bucket<64>(a, s);
  if (d <= 80) return launch_bucket<80>(a, s);
  return launch_bucket<160>(a, s);
}

}  // extern "C"
