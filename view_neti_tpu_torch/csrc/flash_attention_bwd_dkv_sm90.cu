// Flash-attention backward, dk and dv (K3), redesigned for Hopper (sm_90a) on
// wgmma and TMA at the head-dim buckets 48 (SD-1.5's d = 40) and 64 (SD-2.1's
// d = 64) above 80 keys: the self-attentions of the train steps (SD-1.5's
// 3072 keys, 4096 on the folder path; SD-2.1's 3072, 768 and 192).
// ops/flash_attention.py::bwd_design sends those shapes here; the mma.sync
// design of flash_attention_bwd_dkv.cu keeps the rest (the 77-key
// cross-attentions, the buckets 80 and 160, SD-2.1's 48-key mid block).
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (pallas_call at :275, in the custom_vjp backward
// _flash_bwd_rule). From the forward's log-sum-exp (K1) it recomputes, per
// key row,
//     p  = exp(scale q k^T - lse)             (queries >= Lq contribute 0)
//     ds = p (do v^T - delta),  delta = rowsum(do o)  (computed outside)
//     dv = p^T do,   dk = scale ds^T q
//
// What bounds it on an H100: 8 B H Lq Lk d operations on the tensor cores
// (0.391 ms at 4096^2 B9 H8 d40) and B H Lq Lk exponentials on the
// special-function units (0.289 ms there); its bytes, O((Lq + Lk) d), are
// far less. Reaching either bound needs the exponentials to run under the
// products, which the mma.sync design's one stream per warp cannot do.
//
// Design (two warpgroups in ping-pong, as the forward's long-key kernel in
// flash_attention_fwd_sm90.cu, but without its producer warpgroup):
//   * one block per (128-key tile, batch * head, query split), 256
//     threads: warpgroups 0 and 1, 64 key rows each, with their dK and dV
//     (64 x DP fp32 each) in registers. The block's K and V tiles load once
//     by TMA, then 64-query tiles of Q and dO stream through a ring of
//     kStages stages, each tile's lse and delta (fp32, zero past Lq) copied
//     into its stage with cp.async by the 32 lanes of warp 4 (the loader),
//     each lane arriving on the stage's full barrier when its copies land.
//     The loader refills a stage in warpgroup 1's turn, after both have
//     freed it (warpgroup 1 is the later of the two to finish a tile);
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
//   * dk = scale dK and dv leave through the warpgroup's own K and V rows in
//     shared memory by TMA stores that clip rows >= Lk and columns >= d.
//     Where the wrapper splits the queries across blocks (dkv_splits in
//     ops/flash_attention.py: the key tiles fill less than two waves of the
//     card), each split writes fp32 partials from registers instead and
//     dkv_reduce.cuh sums them in a fixed order.
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

constexpr int kBK = 128;     // key rows a block
constexpr int kWgRows = 64;  // key rows a warpgroup
constexpr int kBQ = 64;      // query rows a ring stage
constexpr int kStages = 4;
constexpr int kQueryGranule = kBQ;  // a query split is whole stages
constexpr int kThreads = 256;  // warpgroups 0 and 1
constexpr int kLoaderWarp = 4;  // warp 0 of warpgroup 1
constexpr uint32_t kKvBytes = kBK * kRowBytes;  // a K or V tile: 16 KB
constexpr uint32_t kQBytes = kBQ * kRowBytes;   // a Q or dO stage: 8 KB
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// named barriers: the warpgroups' turns, and each one's epilogue
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr float kLog2e = 1.4426950408889634f;

struct Barriers {
  uint64_t kv_full;
  // the TMA lane's arrival with its bytes, and one arrival a lane of the
  // loader warp for its lse and delta copies
  uint64_t q_full[kStages];
  uint64_t q_empty[kStages];  // one arrival per warp
};
constexpr int kRowCopiers = 32;
// K, V, the Q and dO rings, each stage's lse and delta, the barriers, and
// room to align the tiles to 1024 bytes (the swizzle atom)
constexpr size_t kSmemBytes = 1024 + 2 * kKvBytes + 2 * kStages * kQBytes +
                              2 * kStages * kBQ * sizeof(float) +
                              sizeof(Barriers);
static_assert(kSmemBytes <= kMaxSmem, "K3's tiles exceed 227 KB");

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
  static_assert(DP == 48 || DP == 64, "buckets 48 and 64");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kKvBytes;
  const uint32_t q_s = v_s + kKvBytes;  // stage s at q_s + s * kQBytes
  const uint32_t do_s = q_s + kStages * kQBytes;
  const uint32_t rows_s = do_s + kStages * kQBytes;
  const uint32_t bars = rows_s + 2 * kStages * kBQ * sizeof(float);
  const uint32_t kv_full = bars + offsetof(Barriers, kv_full);
  const uint32_t q_full = bars + offsetof(Barriers, q_full);  // + 8 s
  const uint32_t q_empty = bars + offsetof(Barriers, q_empty);
  // stage s's lse at lse_s + s * kBQ, its delta at delta_s + s * kBQ
  float* lse_s = reinterpret_cast<float*>(smem_raw + (rows_s - raw));
  float* delta_s = lse_s + kStages * kBQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const int qb = blockIdx.z * q_split;
  const int qe = min(Lq, qb + q_split);
  const int n_tiles = (qe - qb + kBQ - 1) / kBQ;
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1 + kRowCopiers);
      mbar_init(q_empty + 8 * s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int c = wg;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool loader = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) ==
                      kLoaderWarp;
  // this warpgroup's 64 rows of the K and V tiles
  const uint32_t k_wg = k_s + c * kWgRows * kRowBytes;
  const uint32_t v_wg = v_s + c * kWgRows * kRowBytes;

  // The loader's copies of query tile j into its stage: Q and dO by TMA,
  // lse and delta (zero-filled past Lq) by cp.async, one arrival a lane.
  const float* lse_bh = lse + (long long)bh * Lq;
  const float* delta_bh = delta + (long long)bh * Lq;
  auto load_tile = [&](int j, int stage) {
    const int q0 = qb + j * kBQ;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full + 8 * stage, 2 * kQBytes);
      tma_load_4d(q_s + stage * kQBytes, &qmap, q_full + 8 * stage, 0, q0,
                  h, b);
      tma_load_4d(do_s + stage * kQBytes, &domap, q_full + 8 * stage, 0,
                  q0, h, b);
    }
    for (int i = lane; i < kBQ; i += kRowCopiers) {
      const bool ok = q0 + i < Lq;
      cp_async_4(lse_s + stage * kBQ + i, ok ? lse_bh + q0 + i : lse, ok);
      cp_async_4(delta_s + stage * kBQ + i, ok ? delta_bh + q0 + i : delta,
                 ok);
    }
    cp_async_mbar_arrive(q_full + 8 * stage);
  };
  if (loader) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKvBytes);
      tma_load_4d(k_s, &kmap, kv_full, 0, k0, h, b);
      tma_load_4d(v_s, &vmap, kv_full, 0, k0, h, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j, j);
  }
  float dk[DP / 2], dv[DP / 2];  // 64 x DP fp32 each
  float s[kBQ / 2];              // S^T, then P^T in fp32: 64 keys x 64
  float dp[kBQ / 2];             // dP^T, then dS^T in fp32
  uint32_t p[kBQ / 4], ds[kBQ / 4];  // P^T, dS^T in bf16: A operands
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  // The steps of a turn. Every product is issued outside any branch:
  // ptxas serialises wgmma in paths it cannot prove warp-uniform.
  auto issue_s = [&](int stage, int round) {
    mbar_wait(q_full + 8 * stage, round & 1);
    pin_regs(s);
    pin_regs(dp);
    qk_products<DP, kBQ>(s, k_wg, 0, q_s + stage * kQBytes, 0);
    qk_products<DP, kBQ>(dp, v_wg, 0, do_s + stage * kQBytes, 0);
    wgmma_commit();
  };
  auto issue_dkv = [&](int stage) {
    pin_regs(dk);
    pin_regs(dv);
    pin_regs(p);
    pin_regs(ds);
    const uint64_t do_desc = sw128_desc(do_s + stage * kQBytes);
    const uint64_t q_desc = sw128_desc(q_s + stage * kQBytes);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_mn<DP>(dv, p + 4 * kk, do_desc + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_mn<DP>(dk, ds + 4 * kk, q_desc + 128 * kk, 1);
    wgmma_commit();
  };
  // P^T and dS^T of query tile j (S^T and dP^T complete), in place
  auto grads = [&](int j, int stage) {
    pin_regs(s);
    pin_regs(dp);
    const float* lse_t = lse_s + stage * kBQ;
    const float* delta_t = delta_s + stage * kBQ;
    // queries >= qe (Lq, or the split's end) get p = 0, in the last tile
    // of a split only (a uniform branch; selects inside it)
    const bool ragged = qb + (j + 1) * kBQ > qe;
    const int valid = qe - qb - j * kBQ - 2 * t;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      // columns 8 n + 2 t and + 1 of rows g and g + 8
      const float2 l =
          *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_t + 8 * n + 2 * t);
      const float m0 = l.x * kLog2e, m1 = l.y * kLog2e;
      float p0 = exp2_fast(fmaf(s[4 * n], scale_log2, -m0));
      float p1 = exp2_fast(fmaf(s[4 * n + 1], scale_log2, -m1));
      float p2 = exp2_fast(fmaf(s[4 * n + 2], scale_log2, -m0));
      float p3 = exp2_fast(fmaf(s[4 * n + 3], scale_log2, -m1));
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
  // tile j - 1's products complete: its stage goes back, P^T and dS^T
  // are free
  auto release = [&](int stage) {
    pin_regs(dk);
    pin_regs(dv);
    pin_regs(p);
    pin_regs(ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * stage);
  };
  auto pack = [&]() {
    pack_p<kBQ>(s, p);
    pack_p<kBQ>(dp, ds);
  };
  const int my_turn = kTurnBar + c, other_turn = kTurnBar + 1 - c;

  // warpgroup 0 takes the first turn
  if (c == 1) named_bar_arrive(kTurnBar, 256);
  mbar_wait(kv_full, 0);

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
  for (int j = 1; j < n_tiles; ++j) {
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
    if (loader && j - 1 + kStages < n_tiles) {
      mbar_wait(q_empty + 8 * s_prev, r_prev & 1);
      load_tile(j - 1 + kStages, s_prev);
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
  const int row0 = k0 + c * kWgRows;
  if (part == nullptr) {
    // dk = scale dK and dv in bf16 into this warpgroup's K and V rows (the
    // 128-byte swizzle the tensor maps read), out by TMA stores
    write_rows<DP>(smem_raw + (k_wg - raw), 0, dk, scale, scale, r, g, t);
    write_rows<DP>(smem_raw + (v_wg - raw), 0, dv, 1.f, 1.f, r, g, t);
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < Lk) {
      tma_store_4d(&dkmap, k_wg, 0, row0, h, b);
      tma_store_4d(&dvmap, v_wg, 0, row0, h, b);
      tma_store_commit();
      tma_store_wait_read();
    }
    return;
  }
  // fp32 partial sums of this split, (B*H, Lk, d) slices
  const long long slice = (long long)gridDim.y * Lk * d;
  float* pk = part + blockIdx.z * slice + (long long)bh * Lk * d;
  float* pv = pk + gridDim.z * slice;
  const int r0 = row0 + r;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= d) break;
    if (r0 < Lk) {
      *reinterpret_cast<float2*>(pk + (long long)r0 * d + col) =
          make_float2(dk[4 * n], dk[4 * n + 1]);
      *reinterpret_cast<float2*>(pv + (long long)r0 * d + col) =
          make_float2(dv[4 * n], dv[4 * n + 1]);
    }
    if (r0 + 8 < Lk) {
      *reinterpret_cast<float2*>(pk + (long long)(r0 + 8) * d + col) =
          make_float2(dk[4 * n + 2], dk[4 * n + 3]);
      *reinterpret_cast<float2*>(pv + (long long)(r0 + 8) * d + col) =
          make_float2(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
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
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_bwd_dkv_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Q and dO in boxes of a stage's rows, K and V of a block's, dk and dv
  // of a warpgroup's
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, kBK)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, kBK)) ||
      (err = tensor_map(&dom, a.dout, a.B, a.Lq, a.H, a.d, a.dos, kBQ)) ||
      (err = tensor_map(&dkm, a.dk, a.B, a.Lk, a.H, a.d, a.dks, kWgRows)) ||
      (err = tensor_map(&dvm, a.dv, a.B, a.Lk, a.H, a.d, a.dvs, kWgRows)))
    return static_cast<int>(err);
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H, a.splits);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
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

// The tile sizes that the wrapper's split policy (dkv_splits) assumes.
int flash_attention_bwd_dkv_sm90_key_tile() { return kBK; }
int flash_attention_bwd_dkv_sm90_query_granule() { return kQueryGranule; }

// The arguments of flash_attention_bwd_dkv_bf16 (flash_attention_bwd_dkv.cu):
// q, dout (B, Lq, H, d); k, v, dk, dv (B, Lk, H, d); all bf16 with unit
// stride along d and the given (batch, row, head) strides in elements, which
// TMA needs as multiples of 8 with 16-byte aligned bases. lse, delta:
// (B, H, Lq) fp32, contiguous. splits query splits of q_split queries each
// (whole 64-query granules; (splits - 1) * q_split < Lq); with splits > 1,
// part is fp32 scratch of 2 * splits * B * H * Lk * d elements. Head dims
// 8..64 (buckets 48 and 64). Launches K3 (and its reduction) on `stream`;
// returns the launches' cudaError_t.
int flash_attention_bwd_dkv_sm90_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int B, int H, int Lq, int Lk, int d, int splits, int q_split,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long do_sb, long long do_sl, long long do_sh,
    long long dk_sb, long long dk_sl, long long dk_sh, long long dv_sb,
    long long dv_sl, long long dv_sh, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 64 || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535 || splits < 1 || splits > 65535 ||
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
  return d <= 48 ? launch<48>(a, s) : launch<64>(a, s);
}

}  // extern "C"
