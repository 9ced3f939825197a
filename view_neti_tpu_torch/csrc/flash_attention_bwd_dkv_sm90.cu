// Flash-attention backward, dk and dv (K3), redesigned for Hopper (sm_90a) on
// wgmma and TMA at every attention shape of the training paths: the head-dim
// buckets 48 (SD-1.5's d = 40), 64 (SD-2.1's d = 64), 80 (SD-1.5's d = 80)
// and 160 (SD-1.5's d = 160), at any number of keys (the self-attentions,
// the 77-key cross-attentions and the mid blocks' 48- and 64-key
// self-attentions). ops/flash_attention.py::bwd_design sends those buckets
// here; the mma.sync design of flash_attention_bwd_dkv.cu keeps the buckets
// no path uses (16, 32, 96 to 144, 192).
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (pallas_call at :275, in the custom_vjp backward
// _flash_bwd_rule). From the forward's log-sum-exp (K1) it recomputes, per
// key row,
//     p  = exp(scale q k^T - lse)             (queries >= Lq contribute 0)
//     ds = p (do v^T - delta),  delta = rowsum(do o)  (computed outside)
//     dv = p^T do,   dk = scale ds^T q
//
// What bounds it on an H100: at the long self-attentions, 8 B H Lq Lk d
// operations on the tensor cores (0.391 ms at 4096^2 B9 H8 d40) and
// B H Lq Lk exponentials on the special-function units (0.289 ms there);
// its bytes, O((Lq + Lk) d), are far less. Reaching either bound needs the
// exponentials to run under the products, which the mma.sync design's one
// stream per warp cannot do. At the 77-key cross-attentions and the short
// self-attentions of the lower levels the bytes of Q and dO bound it
// (3072 x 77 B9 H8 d40: 0.0116 ms at 3.35 TB/s).
//
// Layout of the tiles (as K1's, flash_attention_fwd_sm90.cu): the tensor
// maps have the real head dim d as their inner extent and a 64-wide box, so
// a head dim is held as chunks of 64 columns (1 at buckets 48 and 64, 2 at
// 80, 3 at 160), each its own 1024-byte aligned tile, the last zero-filled
// past d. S^T and dP^T step their k-steps across the chunks; dV += P^T dO
// and dK += dS^T Q read dO and Q MN-major with the chunk step as the
// descriptor's leading byte offset.
//
// Design (two warpgroups in ping-pong, as the forward's long-key kernel in
// flash_attention_fwd_sm90.cu, but without its producer warpgroup):
//   * one block per (key tile, batch * head, query split), 256 threads:
//     warpgroups 0 and 1. The block's K and V tiles load once by TMA, then
//     64-query tiles of Q and dO stream through a ring of kStages stages (4
//     up to bucket 80, 3 at 160), each tile's lse and delta (fp32, zero
//     past Lq) copied into its stage with cp.async by the 32 lanes of warp
//     4 (the loader), each lane arriving on the stage's full barrier when
//     its copies land. The loader refills a stage in warpgroup 1's turn,
//     after both have freed it (warpgroup 1 is the later of the two to
//     finish a tile);
//   * up to bucket 80 the key tile is 128 rows, 64 a warpgroup, each with
//     its dK and dV (64 x DP fp32 each) in registers. At bucket 160 these
//     two accumulators alone would take 80 + 80 registers a thread, and
//     S^T and dP^T 32 + 32 more: the key tile is 64 rows, shared by both
//     warpgroups; warpgroup 0 accumulates dV and warpgroup 1 dK. Both
//     compute S^T and dP^T and issue the same product on other operands
//     (P^T and dO, or dS^T and Q, picked by selects), so that no wgmma
//     sits in a branch: with each role's own code ptxas serialised the
//     products (C7520). That costs 1.5x the products and twice the
//     exponentials of one warpgroup doing both, on shapes bound by bytes;
//     no P^T or dS^T passes through shared memory;
//   * why no producer warp: a warpgroup holds dK, dV, S^T and dP^T (four
//     64 x 64 fp32 tiles at DP = 64) and P^T and dS^T in bf16, about 190
//     registers a thread. A quarter of an SM has 16384 registers, and a
//     block with a producer warp puts three warps on one quarter: 168
//     registers a thread at most. With a producer warpgroup, ptxas
//     compiled the consumers at 168 whatever setmaxnreg granted (40 / 232
//     and 24 / 240 alike), spilled and serialised the products; with two
//     warps a quarter each thread may take 255;
//   * per query tile a warpgroup computes S^T = K Q^T and dP^T = V dO^T
//     (wgmma.m64n64k16, both operands from shared memory, K-major), then in
//     registers P^T = exp2(S^T scale log2 e - lse log2 e), with lse and
//     delta read per column (query) from the stage and P^T = 0 for queries
//     >= Lq, and dS^T = P^T (dP^T - delta). P^T and dS^T, packed to bf16 in
//     registers, are the A operands of dV += P^T dO and dK += dS^T Q
//     (wgmma.m64nDPk16 with dO and Q MN-major from shared memory): P and dS
//     never pass through shared memory;
//   * ping-pong: in turn j a warpgroup issues S^T_j and dP^T_j and tile
//     j - 1's products into dV and dK, hands the turn to the other, waits
//     for its four products, gives tile j - 1's stage back and computes
//     P^T_j and dS^T_j while the other's products run (waiting for all
//     four, not for S^T_j and dP^T_j alone as the forward waits for S,
//     keeps P^T_{j-1} and dS^T_{j-1} out of the registers meanwhile). One
//     more turn issues the last tile's products;
//   * up to 80 keys (Lk <= 80) the same kernel runs: one key tile, its
//     rows past Lk zero-filled by TMA and never stored;
//   * dk = scale dK and dv leave through the warpgroup's own K and V rows in
//     shared memory by TMA stores (one a chunk) that clip rows >= Lk and
//     columns >= d. Where the wrapper splits the queries across blocks
//     (dkv_splits in ops/flash_attention.py: the key tiles fill less than
//     two waves of the card), each split writes fp32 partials from
//     registers instead and dkv_reduce.cuh sums them in a fixed order.
// No atomics and a fixed order of every sum: the result is the same from
// run to run and in a CUDA graph (the tensor maps are kernel parameters,
// encoded on the host at each call).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "dkv_reduce.cuh"
#include "mma_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

using namespace mma_tiles;
using namespace sm90_tiles;
using dkv_reduce::launch_dkv_reduce;

constexpr int kWgRows = 64;  // key rows a warpgroup
constexpr int kBQ = 64;      // query rows a ring stage
constexpr int kQueryGranule = kBQ;  // a query split is whole stages
constexpr int kThreads = 256;  // warpgroups 0 and 1
constexpr int kLoaderWarp = 4;  // warp 0 of warpgroup 1
constexpr int kRowCopiers = 32;
constexpr uint32_t kQChunkBytes = kBQ * kRowBytes;  // a stage's rows, a chunk
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// named barriers: the warpgroups' turns, each one's epilogue, and both
// warpgroups' before they overwrite the K and V tiles they share
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr int kSharedTilesBar = 5;
constexpr float kLog2e = 1.4426950408889634f;

// the 64-column chunks of a head-dim bucket
constexpr int chunks_of(int dp) { return (dp + kBoxD - 1) / kBoxD; }

// What a warpgroup accumulates: dK and dV of its own 64 of the block's 128
// key rows (kBoth), or one of them over the block's 64 key rows (kOne, at
// bucket 160): warpgroup 0 dV, warpgroup 1 dK.
enum Role { kBoth, kOne };

// The tiles at bucket DP.
template <int DP>
struct Tiles {
  static constexpr int kChunks = chunks_of(DP);
  static constexpr int kRole = DP > 128 ? kOne : kBoth;
  static constexpr int kBK = kRole == kOne ? kWgRows : 2 * kWgRows;  // keys
  // Q and dO take 16 KB a chunk a stage: 4 stages fit up to bucket 80
  static constexpr int kStages = DP <= 80 ? 4 : 3;
  static constexpr uint32_t kKvChunkBytes = kBK * kRowBytes;
  static constexpr uint32_t kKvBytes = kChunks * kKvChunkBytes;  // K or V
  static constexpr uint32_t kStageBytes = kChunks * kQChunkBytes;  // Q or dO
  struct Barriers {
    uint64_t kv_full;
    // the TMA lane's arrival with its bytes, and one arrival a lane of the
    // loader warp for its lse and delta copies
    uint64_t q_full[kStages];
    uint64_t q_empty[kStages];  // one arrival per warp
  };
  // K, V, the Q and dO rings, each stage's lse and delta, the barriers, and
  // room to align the tiles to 1024 bytes (the swizzle atom)
  static constexpr size_t kSmemBytes = 1024 + 2 * kKvBytes +
                                       2 * kStages * kStageBytes +
                                       2 * kStages * kBQ * sizeof(float) +
                                       sizeof(Barriers);
  static_assert(kSmemBytes <= kMaxSmem, "K3's tiles exceed 227 KB");
};

// A block's shared memory and its place in the grid, as both warpgroups
// see them.
struct Block {
  unsigned char* smem;  // the dynamic shared memory, at shared address raw
  uint32_t raw;
  uint32_t k_s, v_s;    // chunk ch at + ch * kKvChunkBytes
  uint32_t q_s, do_s;   // stage s at + s * kStageBytes
  uint32_t kv_full, q_full, q_empty;  // stage s's barriers at + 8 s
  float* lse_s;         // stage s's lse at + s * kBQ
  float* delta_s;
  const float* lse_bh;  // this (batch, head)'s rows
  const float* delta_bh;
  const CUtensorMap *qmap, *domap, *dkmap, *dvmap;
  float* part;
  int b, h, bh, k0, qb, qe, n_tiles, Lq, Lk, d;
  float scale_log2, scale;
};

// The loader warp's copies of query tile j into its stage: Q and dO by TMA,
// lse and delta (zero-filled past Lq) by cp.async, one arrival a lane.
template <int DP>
__device__ __forceinline__ void load_tile(const Block& x, int j, int stage,
                                          int lane) {
  using T = Tiles<DP>;
  const int q0 = x.qb + j * kBQ;
  const uint32_t full = x.q_full + 8 * stage;
  if (lane == 0) {
    mbar_arrive_expect_tx(full, 2 * T::kStageBytes);
    tma_load_chunks<T::kChunks>(x.q_s + stage * T::kStageBytes,
                                kQChunkBytes, x.qmap, full, q0, x.h, x.b);
    tma_load_chunks<T::kChunks>(x.do_s + stage * T::kStageBytes,
                                kQChunkBytes, x.domap, full, q0, x.h, x.b);
  }
  for (int i = lane; i < kBQ; i += kRowCopiers) {
    const bool ok = q0 + i < x.Lq;
    cp_async_4(x.lse_s + stage * kBQ + i, x.lse_bh + (ok ? q0 + i : 0), ok);
    cp_async_4(x.delta_s + stage * kBQ + i, x.delta_bh + (ok ? q0 + i : 0),
               ok);
  }
  cp_async_mbar_arrive(full);
}

// A warp's rows r and r + 8 of a 64 x DP fp32 accumulator (C fragments)
// into the fp32 rows of a (Lk, d) slice of K3's split scratch, rows >= Lk
// and columns >= d left out.
template <int DP>
__device__ __forceinline__ void put_rows(float* slice,
                                         const float (&acc)[DP / 2], int r0,
                                         int t, int Lk, int d) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= d) break;
    if (r0 < Lk)
      *reinterpret_cast<float2*>(slice + (long long)r0 * d + col) =
          make_float2(acc[4 * n], acc[4 * n + 1]);
    if (r0 + 8 < Lk)
      *reinterpret_cast<float2*>(slice + (long long)(r0 + 8) * d + col) =
          make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// Warpgroup c's part of the block in role ROLE: the query loop in turns
// with the other warpgroup, then its gradients out.
template <int DP, int ROLE>
__device__ __forceinline__ void consume(const Block& x, int c) {
  using T = Tiles<DP>;
  constexpr int kStages = T::kStages;
  constexpr bool kBothGrads = ROLE == kBoth;
  const int tid = threadIdx.x - 128 * c;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // warp-uniform to the compiler (a broadcast): the loader's branch holds
  // no product, but ptxas serialises the products after a branch it
  // cannot prove warp-uniform (C7520)
  const bool loader =
      __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == kLoaderWarp;
  // this warpgroup's rows of chunk 0 of the K and V tiles
  const uint32_t rows = kBothGrads ? c * kWgRows * kRowBytes : 0;
  const uint32_t k_wg = x.k_s + rows;
  const uint32_t v_wg = x.v_s + rows;

  // kBoth: acc is dK and acc2 dV, a is dS^T and a2 P^T. kOne: acc is
  // warpgroup 0's dV or warpgroup 1's dK, a its P^T or dS^T; acc2 and a2
  // are one register, never read
  float acc[DP / 2], acc2[kBothGrads ? DP / 2 : 1];  // 64 x DP fp32 each
  float s[kBQ / 2];   // S^T, then P^T in fp32: 64 keys x 64
  float dp[kBQ / 2];  // dP^T, then dS^T in fp32
  uint32_t a[kBQ / 4], a2[kBothGrads ? kBQ / 4 : 1];  // A operands, bf16
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if constexpr (kBothGrads) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc2[i] = 0.f;
  }

  // The steps of a turn. Every product is issued outside any branch:
  // ptxas serialises wgmma in paths it cannot prove warp-uniform (both
  // roles of kOne run the same products, on other registers and operands).
  auto issue_s = [&](int stage, int round) {
    mbar_wait(x.q_full + 8 * stage, round & 1);
    pin_regs(s);
    pin_regs(dp);
    qk_products<DP, kBQ>(s, k_wg, T::kKvChunkBytes,
                         x.q_s + stage * T::kStageBytes, kQChunkBytes);
    qk_products<DP, kBQ>(dp, v_wg, T::kKvChunkBytes,
                         x.do_s + stage * T::kStageBytes, kQChunkBytes);
    wgmma_commit();
  };
  auto pin_accumulators = [&]() {
    pin_regs(acc);
    pin_regs(a);
    if constexpr (kBothGrads) {
      pin_regs(acc2);
      pin_regs(a2);
    }
  };
  auto issue_dkv = [&](int stage) {
    pin_accumulators();
    // Q and dO MN-major: the k-steps walk their rows (queries), the
    // leading byte offset steps between their 64-column chunks. kBoth:
    // dK += dS^T Q and dV += P^T dO; kOne: warpgroup 1's dK += dS^T Q or
    // warpgroup 0's dV += P^T dO
    const uint64_t q_desc =
        sw128_desc(x.q_s + stage * T::kStageBytes, kQChunkBytes);
    const uint64_t do_desc =
        sw128_desc(x.do_s + stage * T::kStageBytes, kQChunkBytes);
    const uint64_t desc = kBothGrads || c == 1 ? q_desc : do_desc;
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_mn<DP>(acc, a + 4 * kk, desc + 128 * kk, 1);
    if constexpr (kBothGrads) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs_mn<DP>(acc2, a2 + 4 * kk, do_desc + 128 * kk, 1);
    }
    wgmma_commit();
  };
  // P^T and dS^T of query tile j (its products complete), in place
  auto grads = [&](int j, int stage) {
    pin_regs(s);
    pin_regs(dp);
    const float* lse_t = x.lse_s + stage * kBQ;
    const float* delta_t = x.delta_s + stage * kBQ;
    // queries >= qe (Lq, or the split's end) get p = 0, in the last tile
    // of a split only (a uniform branch; selects inside it)
    const bool ragged = x.qb + (j + 1) * kBQ > x.qe;
    const int valid = x.qe - x.qb - j * kBQ - 2 * t;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      // columns 8 n + 2 t and + 1 of rows g and g + 8
      const float2 l =
          *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_t + 8 * n + 2 * t);
      const float m0 = l.x * kLog2e, m1 = l.y * kLog2e;
      float p0 = exp2_fast(fmaf(s[4 * n], x.scale_log2, -m0));
      float p1 = exp2_fast(fmaf(s[4 * n + 1], x.scale_log2, -m1));
      float p2 = exp2_fast(fmaf(s[4 * n + 2], x.scale_log2, -m0));
      float p3 = exp2_fast(fmaf(s[4 * n + 3], x.scale_log2, -m1));
      if (ragged) {
        p0 = 8 * n < valid ? p0 : 0.f;
        p2 = 8 * n < valid ? p2 : 0.f;
        p1 = 8 * n + 1 < valid ? p1 : 0.f;
        p3 = 8 * n + 1 < valid ? p3 : 0.f;
      }
      s[4 * n] = p0;
      s[4 * n + 1] = p1;
      s[4 * n + 2] = p2;
      s[4 * n + 3] = p3;
      dp[4 * n] = p0 * (dp[4 * n] - dl.x);
      dp[4 * n + 1] = p1 * (dp[4 * n + 1] - dl.y);
      dp[4 * n + 2] = p2 * (dp[4 * n + 2] - dl.x);
      dp[4 * n + 3] = p3 * (dp[4 * n + 3] - dl.y);
    }
  };
  // tile j - 1's products complete: its stage goes back, the A operands
  // are free
  auto release = [&](int stage) {
    pin_accumulators();
    __syncwarp();
    if (lane == 0) mbar_arrive(x.q_empty + 8 * stage);
  };
  auto pack = [&]() {
    if constexpr (kBothGrads) {
      pack_p<kBQ>(dp, a);
      pack_p<kBQ>(s, a2);
    } else {
      // dS^T for warpgroup 1's dK, P^T for warpgroup 0's dV: selects
#pragma unroll
      for (int i = 0; i < kBQ / 4; ++i)
        a[i] = pack_bf16(c == 1 ? dp[2 * i] : s[2 * i],
                         c == 1 ? dp[2 * i + 1] : s[2 * i + 1]);
    }
  };
  const int my_turn = kTurnBar + c, other_turn = kTurnBar + 1 - c;

  // warpgroup 0 takes the first turn
  if (c == 1) named_bar_arrive(kTurnBar, 256);
  mbar_wait(x.kv_full, 0);

  // turn 0: S^T_0 and dP^T_0
  named_bar_sync(my_turn, 256);
  wgmma_fence();
  issue_s(0, 0);
  named_bar_arrive(other_turn, 256);
  wgmma_wait<0>();
  grads(0, 0);
  pack();
  // turn j: S^T_j, dP^T_j and tile j - 1's dV and dK
  int s_prev = 0, r_prev = 0;  // tile j - 1's stage and round
  for (int j = 1; j < x.n_tiles; ++j) {
    const int s_cur = s_prev + 1 == kStages ? 0 : s_prev + 1;
    const int r_cur = s_cur == 0 ? r_prev + 1 : r_prev;
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_s(s_cur, r_cur);
    issue_dkv(s_prev);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    release(s_prev);
    // tile j - 1's stage takes tile j - 1 + kStages once both warpgroups
    // freed it
    if (loader && j - 1 + kStages < x.n_tiles) {
      mbar_wait(x.q_empty + 8 * s_prev, r_prev & 1);
      load_tile<DP>(x, j - 1 + kStages, s_prev, lane);
    }
    grads(j, s_cur);
    pack();
    s_prev = s_cur;
    r_prev = r_cur;
  }
  // the last turn: the last tile's products (warpgroup 1's last turn is
  // the last of all: nobody waits for it)
  named_bar_sync(my_turn, 256);
  wgmma_fence();
  issue_dkv(s_prev);
  if (c == 0) named_bar_arrive(other_turn, 256);
  wgmma_wait<0>();
  release(s_prev);

  const int r = 16 * warp + g;  // and r + 8
  const int row0 = x.k0 + (kBothGrads ? c * kWgRows : 0);
  // kOne: warpgroup 1's dK goes out through the K rows, warpgroup 0's dV
  // through the V rows
  const bool is_dk = kBothGrads || c == 1;
  const uint32_t tile = is_dk ? k_wg : v_wg;
  if (x.part == nullptr) {
    // kOne: the other warpgroup's last products read these K and V rows
    if constexpr (!kBothGrads) named_bar_sync(kSharedTilesBar, 256);
    // dk = scale dK and dv in bf16 into these K and V rows (the 128-byte
    // swizzle the tensor maps read), out by one TMA store a chunk
    const float acc_scale = is_dk ? x.scale : 1.f;
    write_rows<DP>(x.smem + (tile - x.raw), T::kKvChunkBytes, acc, acc_scale,
                   acc_scale, r, g, t);
    if constexpr (kBothGrads)
      write_rows<DP>(x.smem + (v_wg - x.raw), T::kKvChunkBytes, acc2, 1.f,
                     1.f, r, g, t);
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < x.Lk) {
      tma_store_chunks<T::kChunks>(is_dk ? x.dkmap : x.dvmap, tile,
                                   T::kKvChunkBytes, row0, x.h, x.b);
      if constexpr (kBothGrads)
        tma_store_chunks<T::kChunks>(x.dvmap, v_wg, T::kKvChunkBytes, row0,
                                     x.h, x.b);
      tma_store_wait_read();
    }
    return;
  }
  // fp32 partial sums of this split: its (B*H, Lk, d) slices of dK and dV
  const long long slice = (long long)gridDim.y * x.Lk * x.d;
  float* pk = x.part + blockIdx.z * slice + (long long)x.bh * x.Lk * x.d;
  float* pv = pk + gridDim.z * slice;
  put_rows<DP>(is_dk ? pk : pv, acc, row0 + r, t, x.Lk, x.d);
  if constexpr (kBothGrads) put_rows<DP>(pv, acc2, row0 + r, t, x.Lk, x.d);
}

// part: null, or fp32 scratch (2, splits, B*H, Lk, d): dK then dV partial
// sums of query split blockIdx.z, which covers q_split queries.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_sm90(__grid_constant__ const CUtensorMap qmap,
                              __grid_constant__ const CUtensorMap kmap,
                              __grid_constant__ const CUtensorMap vmap,
                              __grid_constant__ const CUtensorMap domap,
                              __grid_constant__ const CUtensorMap dkmap,
                              __grid_constant__ const CUtensorMap dvmap,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ part, int H, int Lq,
                              int Lk, int d, int q_split, float scale_log2,
                              float scale) {
  static_assert(DP == 48 || DP == 64 || DP == 80 || DP == 160,
                "buckets 48, 64, 80 and 160");
  using T = Tiles<DP>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  Block x;
  x.smem = smem_raw;
  x.raw = smem_addr(smem_raw);
  x.k_s = (x.raw + 1023) & ~1023u;
  x.v_s = x.k_s + T::kKvBytes;
  x.q_s = x.v_s + T::kKvBytes;
  x.do_s = x.q_s + kStages * T::kStageBytes;
  const uint32_t rows_s = x.do_s + kStages * T::kStageBytes;
  const uint32_t bars = rows_s + 2 * kStages * kBQ * sizeof(float);
  using Bars = typename T::Barriers;
  x.kv_full = bars + offsetof(Bars, kv_full);
  x.q_full = bars + offsetof(Bars, q_full);
  x.q_empty = bars + offsetof(Bars, q_empty);
  x.lse_s = reinterpret_cast<float*>(smem_raw + (rows_s - x.raw));
  x.delta_s = x.lse_s + kStages * kBQ;
  x.qmap = &qmap;
  x.domap = &domap;
  x.dkmap = &dkmap;
  x.dvmap = &dvmap;
  x.part = part;
  x.bh = blockIdx.y;
  x.b = x.bh / H;
  x.h = x.bh - x.b * H;
  x.k0 = blockIdx.x * T::kBK;
  x.qb = blockIdx.z * q_split;
  x.qe = min(Lq, x.qb + q_split);
  x.n_tiles = (x.qe - x.qb + kBQ - 1) / kBQ;
  x.lse_bh = lse + (long long)x.bh * Lq;
  x.delta_bh = delta + (long long)x.bh * Lq;
  x.Lq = Lq;
  x.Lk = Lk;
  x.d = d;
  x.scale_log2 = scale_log2;
  x.scale = scale;
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
    prefetch_tensor_map(&domap);
    prefetch_tensor_map(&dkmap);
    prefetch_tensor_map(&dvmap);
    mbar_init(x.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(x.q_full + 8 * s, 1 + kRowCopiers);
      mbar_init(x.q_empty + 8 * s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == kLoaderWarp) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(x.kv_full, 2 * T::kKvBytes);
      tma_load_chunks<T::kChunks>(x.k_s, T::kKvChunkBytes, &kmap, x.kv_full,
                                  x.k0, x.h, x.b);
      tma_load_chunks<T::kChunks>(x.v_s, T::kKvChunkBytes, &vmap, x.kv_full,
                                  x.k0, x.h, x.b);
    }
    for (int j = 0; j < kStages && j < x.n_tiles; ++j)
      load_tile<DP>(x, j, j, lane);
  }
  consume<DP, T::kRole>(x, wg);
}

struct DkvArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  float* part;
  int B, H, Lq, Lk, d, splits, q_split;
  Strides qs, ks, vs, dos, dks, dvs;
  float scale;
};

template <int DP>
int launch(const DkvArgs& a, cudaStream_t stream) {
  using T = Tiles<DP>;
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dkv_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, T::kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Q and dO in boxes of a stage's rows, K and V of a block's, dk and dv
  // of a warpgroup's
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, T::kBK)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, T::kBK)) ||
      (err = tensor_map(&dom, a.dout, a.B, a.Lq, a.H, a.d, a.dos, kBQ)) ||
      (err = tensor_map(&dkm, a.dk, a.B, a.Lk, a.H, a.d, a.dks, kWgRows)) ||
      (err = tensor_map(&dvm, a.dv, a.B, a.Lk, a.H, a.d, a.dvs, kWgRows)))
    return static_cast<int>(err);
  const dim3 grid((a.Lk + T::kBK - 1) / T::kBK, a.B * a.H, a.splits);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, dom, dkm, dvm, a.lse, a.delta,
      a.splits > 1 ? a.part : nullptr, a.H, a.Lq, a.Lk, a.d, a.q_split,
      a.scale * kLog2e, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_dkv_reduce(
      a.part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.splits,
      a.B * a.H, a.H, a.Lk, a.d, a.dks, a.dvs, a.scale, stream));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tile sizes that the wrapper's split policy (dkv_splits) assumes: the
// key rows a block at head dim d (a bucket's), and the query granule.
int flash_attention_bwd_dkv_sm90_key_tile(int d) {
  return d > 128 ? Tiles<160>::kBK : Tiles<64>::kBK;
}
int flash_attention_bwd_dkv_sm90_query_granule() { return kQueryGranule; }

// The arguments of flash_attention_bwd_dkv_bf16 (flash_attention_bwd_dkv.cu):
// q, dout (B, Lq, H, d); k, v, dk, dv (B, Lk, H, d); all bf16 with unit
// stride along d and the given (batch, row, head) strides in elements, which
// TMA needs as multiples of 8 with 16-byte aligned bases. lse, delta:
// (B, H, Lq) fp32, contiguous. splits query splits of q_split queries each
// (whole 64-query granules; (splits - 1) * q_split < Lq); with splits > 1,
// part is fp32 scratch of 2 * splits * B * H * Lk * d elements. Head dims
// 8..80 (buckets 48, 64 and 80) and 152..160 (bucket 160), any Lk; the key
// tile is flash_attention_bwd_dkv_sm90_key_tile(d). Launches K3 (and its
// reduction) on `stream`; returns the launches' cudaError_t.
int flash_attention_bwd_dkv_sm90_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int B, int H, int Lq, int Lk, int d, int splits, int q_split,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long do_sb, long long do_sl, long long do_sh,
    long long dk_sb, long long dk_sl, long long dk_sh, long long dv_sb,
    long long dv_sl, long long dv_sh, float scale, void* stream) {
  const bool bucket =
      d > 0 && d % 8 == 0 && (d <= 80 || (d > 144 && d <= 160));
  if (!bucket || Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 ||
      (long long)B * H > 65535 || splits < 1 || splits > 65535 ||
      q_split <= 0 || q_split % kQueryGranule != 0 ||
      (long long)(splits - 1) * q_split >= Lq ||
      (long long)splits * q_split < Lq || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs a{q, k, v, dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  dk, dv, static_cast<float*>(part),
                  B, H, Lq, Lk, d, splits, q_split,
                  Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                  Strides{v_sb, v_sl, v_sh}, Strides{do_sb, do_sl, do_sh},
                  Strides{dk_sb, dk_sl, dk_sh}, Strides{dv_sb, dv_sl, dv_sh},
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 48) return launch<48>(a, s);
  if (d <= 64) return launch<64>(a, s);
  if (d <= 80) return launch<80>(a, s);
  return launch<160>(a, s);
}

}  // extern "C"
