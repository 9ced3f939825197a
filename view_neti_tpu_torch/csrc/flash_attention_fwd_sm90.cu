// Flash-attention forward (K1) redesigned for Hopper (sm_90a) on wgmma and
// TMA, at the head-dim buckets 48 (SD-1.5's d = 40) and 64 (SD-2.1's
// d = 64) and key ranges above 80: the self-attentions that carry most of
// K1's time. ops/flash_attention.py::fwd_design sends those shapes here;
// the 77-key cross-attention and the other buckets stay on the mma.sync
// design of flash_attention_fwd.cu.
//
// Replaces the TPU kernel view_neti_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes, per (batch,
// head) and query row,
//     o   = softmax(scale * q k^T, keys >= Lk masked) v     (bf16)
//     lse = m + log(l)                                    (fp32, natural log)
// with the streaming (online) softmax; lse is written (B, H, Lq)
// contiguous, as K2 and K3 read it.
//
// What bounds it on an H100: one exponential per score on the
// special-function units (16 a clock on each SM) against 4 d operations
// per score on the tensor cores: at d = 40 the exponentials (B H Lq Lk over
// about 4.2e12 a second) take longer than the products (4 B H Lq Lk d over
// 989e12), at d = 64 the products do. So at d = 40 the softmax has to stay
// busy while the products run in its shadow. A study of variants on the
// card (PERF.md, PR 17) found that neither unit binds yet. At d = 40 TMA
// copies the 80-byte, 16-byte aligned head rows about 4 times slower than
// d = 64's 128-byte rows, and the loads alone take about the kernel's
// whole time; copying them with cp.async instead leaves the kernel where
// it is, since the consumers' own path takes as long. At d = 64 the
// products and the exponentials add up more than they overlap: two
// consumer warps a quarter SM leave little to hide a turn's waits.
//
// Design (FlashAttention-3's shape: a producer warp, two consumer
// warpgroups in ping-pong):
//   * one block per (128-query tile, batch * head), 384 threads: warpgroup
//     0 is the producer, which gives up its registers (setmaxnreg 40) and
//     whose thread 0 issues every TMA copy; warpgroups 1 and 2 are the
//     consumers, 64 query rows each, with 232 registers a thread;
//   * the producer loads the 128 x 64 Q box once, then streams 128-key
//     K and V boxes through a ring of kStages stages: full barriers (one
//     for K, one for V, so that S can start before V lands) complete on
//     the copies' bytes, an empty barrier on one arrival of each consumer
//     warp once both warpgroups have read the stage;
//   * TMA pads: the tensor maps have the real head dim d as their inner
//     extent and a 64-wide box (one 128-byte swizzle row), so columns
//     d..63 arrive as zeros, and keys past Lk and queries past Lq as zero
//     rows; keys past Lk still get -inf logits before the max. Bucket 48
//     reads only the first 48 columns: 3 k-steps of S and a 48-wide P V;
//   * a consumer computes S = Q K^T (64 x 128, fp32, 64 registers a
//     thread) with wgmma.m64n128k16 from shared memory (both K-major), runs
//     the online softmax in registers (a row over the 4 lanes of a quad:
//     two shuffles; scale * log2 e folded into one FMA before each
//     ex2.approx), packs P to bf16 in registers as the A operand of
//     O += P V (wgmma.m64nDPk16, A from registers, V MN-major from shared
//     memory): P never passes through shared memory;
//   * ping-pong: the two consumers take turns on the tensor cores through
//     two named barriers. In turn j a consumer issues S_j = Q K_j^T and
//     O += P_{j-1} V_{j-1}, hands the turn over, and runs the softmax of
//     S_j while the other consumer's products run; it rescales O once
//     P_{j-1} V_{j-1} has completed, then frees the stage of tile j - 1.
//     One more turn issues the last P V;
//   * o = O / l leaves through the consumer's own Q rows in shared memory
//     (the swizzled layout) by a TMA store that clips rows >= Lq and
//     columns >= d; lse from registers;
//   * no atomics and a fixed order of every sum: the result is the same
//     from run to run, and in a CUDA graph (the tensor maps are kernel
//     parameters, encoded on the host at each call).
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

constexpr int kBQ = 128;        // query rows a block
constexpr int kWgRows = 64;     // query rows a consumer warpgroup
constexpr int kBK = 128;        // keys a tile
constexpr int kBoxD = 64;       // head-dim columns a box: one 128-byte row
constexpr int kRowBytes = kBoxD * 2;
constexpr int kStages = 4;      // 2 ran 16 % slower at d = 40 (PERF.md)
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
// the producer's 128 x (168 - 40) registers go to the 256 consumer threads
constexpr int kConsumerRegs = 232;
constexpr uint32_t kQBytes = kBQ * kRowBytes;
constexpr uint32_t kTileBytes = kBK * kRowBytes;
// named barriers: the consumers' turns, and each consumer's epilogue
constexpr int kTurnBar = 1;
constexpr int kEpilogueBar = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t kv_empty[kStages];
};

// Q, the K ring, the V ring, the barriers, and room to align the tiles to
// 1024 bytes (the swizzle atom).
constexpr size_t kSmemBytes =
    1024 + kQBytes + 2 * kStages * kTileBytes + sizeof(Barriers);

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap omap,
                          float* __restrict__ lse, int H, int Lq, int Lk,
                          float scale_log2) {
  static_assert(DP == 48 || DP == 64, "buckets 48 and 64");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;  // stage s at k_s + s * kTileBytes
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t bars = v_s + kStages * kTileBytes;
  const uint32_t q_full = bars + offsetof(Barriers, q_full);
  const uint32_t k_full = bars + offsetof(Barriers, k_full);  // + 8 s
  const uint32_t v_full = bars + offsetof(Barriers, v_full);
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
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_4d(q_s, &qmap, q_full, 0, q0, h, b);
      int s = 0, round = 0;
      for (int j = 0; j < n_tiles; ++j) {
        // stage s held tile j - kStages: wait until both consumers freed it
        if (round > 0) mbar_wait(kv_empty + 8 * s, (round - 1) & 1);
        mbar_arrive_expect_tx(k_full + 8 * s, kTileBytes);
        tma_load_4d(k_s + s * kTileBytes, &kmap, k_full + 8 * s, 0, j * kBK,
                    h, b);
        mbar_arrive_expect_tx(v_full + 8 * s, kTileBytes);
        tma_load_4d(v_s + s * kTileBytes, &vmap, v_full + 8 * s, 0, j * kBK,
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
    const uint32_t q_wg = q_s + c * kWgRows * kRowBytes;
    const uint64_t q_desc = sw128_desc(q_wg);

    float o[DP / 2];  // O: 64 x DP fp32, DP / 8 column tiles
    float s[kBK / 2];  // S, then P in fp32: 64 x 128
    uint32_t p[kBK / 4];  // P in bf16 pairs: the A operand of 8 k-steps
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
      const uint64_t k_desc = sw128_desc(k_s + stage * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_m64n128k16(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int stage, int round) {
      mbar_wait(v_full + 8 * stage, round & 1);
      pin_regs(o);
      pin_regs(p);
      const uint64_t v_desc = sw128_desc(v_s + stage * kTileBytes);
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
      if ((j + 1) * kBK > Lk) {
        const int valid = Lk - j * kBK - 2 * t;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          s[4 * n] = 8 * n < valid ? s[4 * n] : -INFINITY;
          s[4 * n + 2] = 8 * n < valid ? s[4 * n + 2] : -INFINITY;
          s[4 * n + 1] = 8 * n + 1 < valid ? s[4 * n + 1] : -INFINITY;
          s[4 * n + 3] = 8 * n + 1 < valid ? s[4 * n + 3] : -INFINITY;
        }
      }
      // the row max and sum as 4 independent chains each: two warps an
      // SM quarter leave little else to hide a 32-deep chain's latency
      float mp0[4], mp1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mp0[i] = mp1[i] = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        mp0[n % 4] = fmaxf(mp0[n % 4], fmaxf(s[4 * n], s[4 * n + 1]));
        mp1[n % 4] = fmaxf(mp1[n % 4], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      float mx0 = fmaxf(fmaxf(mp0[0], mp0[1]), fmaxf(mp0[2], mp0[3]));
      float mx1 = fmaxf(fmaxf(mp1[0], mp1[1]), fmaxf(mp1[2], mp1[3]));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      alpha0 = exp2_fast(m0 - mn0);
      alpha1 = exp2_fast(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float part0[4] = {0.f, 0.f, 0.f, 0.f}, part1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        s[4 * n] = exp2_fast(fmaf(s[4 * n], scale_log2, -mn0));
        s[4 * n + 1] = exp2_fast(fmaf(s[4 * n + 1], scale_log2, -mn0));
        s[4 * n + 2] = exp2_fast(fmaf(s[4 * n + 2], scale_log2, -mn1));
        s[4 * n + 3] = exp2_fast(fmaf(s[4 * n + 3], scale_log2, -mn1));
        part0[n % 4] += s[4 * n] + s[4 * n + 1];
        part1[n % 4] += s[4 * n + 2] + s[4 * n + 3];
      }
      sum0 = (part0[0] + part0[1]) + (part0[2] + part0[3]);
      sum1 = (part1[0] + part1[1]) + (part1[2] + part1[3]);
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
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
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
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r = 16 * warp + g;  // and r + 8: the same chunk swizzle g
    unsigned char* o_tile = smem_raw + (q_wg - raw);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int off = ((n ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(o_tile + r * kRowBytes + off) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(o_tile + (r + 8) * kRowBytes + off) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    const int row0 = q0 + c * kWgRows;
    if (t == 0 && row0 + r < Lq)
      lse[(long long)bh * Lq + row0 + r] = (m0 + log2f(l0)) * kLn2;
    if (t == 0 && row0 + r + 8 < Lq)
      lse[(long long)bh * Lq + row0 + r + 8] = (m1 + log2f(l1)) * kLn2;
    fence_proxy_async();
    named_bar_sync(kEpilogueBar + c, 128);
    if (tid == 0 && row0 < Lq) {
      tma_store_4d(&omap, q_wg, 0, row0, h, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one (B, L, H, d) bf16 tensor with the given element
// strides: inner extent d, boxes of 64 columns by `rows` rows of one
// (batch, head), 128-byte swizzle, zeros outside the tensor.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int B, int L,
                       int H, int d, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(L), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.l) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {kBoxD, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

template <int DP>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  static std::atomic<bool> smem_done[64];
  auto kernel = flash_fwd_kernel_sm90<DP>;
  cudaError_t err = ensure_smem_limit(kernel, kSmemBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm, om;
  if ((err = tensor_map(&qm, a.q, a.B, a.Lq, a.H, a.d, a.qs, kBQ)) ||
      (err = tensor_map(&km, a.k, a.B, a.Lk, a.H, a.d, a.ks, kBK)) ||
      (err = tensor_map(&vm, a.v, a.B, a.Lk, a.H, a.d, a.vs, kBK)) ||
      (err = tensor_map(&om, a.o, a.B, a.Lq, a.H, a.d, a.os, kWgRows)))
    return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(qm, km, vm, om, a.lse, a.H,
                                                 a.Lq, a.Lk,
                                                 a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
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
// contiguous. Head dims 8..64 (buckets 48 and 64). Launches on `stream`;
// returns the launch's cudaError_t.
int flash_attention_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Lq, int Lk, int d, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 64 || Lq <= 0 || Lk <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), B, H, Lq, Lk, d,
                  Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                  Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh},
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 48 ? launch_fwd<48>(a, s) : launch_fwd<64>(a, s);
}

}  // extern "C"
