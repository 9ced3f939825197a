// Fused GroupNorm-affine + SiLU + 3x3 convolution (K4), redesigned for
// Hopper (sm_90a) on wgmma and TMA: every ResNet conv of the VAE and, with
// UNetConfig.fuse_conv on the inference paths, of the UNet (Cout > 16,
// ops/fused_conv.py::conv_design). The mma.sync design of fused_conv.cu
// keeps the two narrow convs (the decoder's conv_out, Cout 3, and the
// encoder's last conv, Cout 8), which the bytes of x bound.
//
// Replaces the TPU kernel view_neti_tpu/ops/fused_conv.py::_kernel
// (launched by fused_affine_silu_conv3x3 through pl.pallas_call). It
// computes, on NHWC tensors, stride 1, zero padding 1 applied to the
// post-SiLU tensor,
//     out = conv3x3(silu(a*x + b)) + bias + add_bc[batch] + residual
// in the TPU kernel's rounding order (fused_conv.py:221-232): bf16(a x + b)
// from fp32, times bf16(sigmoid(fp32 y)), rounded to bf16; fp32 sums; an
// fp32 epilogue with one cast.
//
// What bounds it on an H100: 2 * 9 * Cin * Cout operations an output pixel
// against (Cin + Cout [+ Cout residual]) * 2 bytes: at the VAE's 128..512
// channels the tensor cores (989 TFLOP/s bf16). What held the mma.sync
// design to 0.19-0.24 of that bound: every warp fetched its A and B
// fragments from shared memory by ldmatrix each 16-deep step (about 21
// operations a byte of shared memory), the SiLU pass stopped the block,
// and a __syncthreads on every tap.
//
// Design: the implicit GEMM (M = output pixels, N = output channels, K = 9
// taps x Cin) on wgmma.mma_async with A from registers. What holds it
// below that bound, as far as the variants of tools/conv_variants.py show,
// is what the SM's warps share, not latency: issue slots (the SiLU) and
// shared memory (at the tensor cores' rate each m64 product reads its B
// tile, 64 bytes a clock, the A fragments 32 more at BN 128, the TMA copies
// and the SiLU pass the rest of 128); the kept tile measured 0.36-0.44 of
// the operations bound at the paths' wide shapes (chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//   * a block takes TH x 32 output pixels of one image and BN output
//     channels; 256 threads, two warpgroups of TH / 2 pixel rows each, its
//     m64 blocks' accumulators (64 x BN fp32) in registers. No producer warp:
//     with one, three warps share a quarter of the SM and ptxas caps a
//     thread at 168 registers; two warpgroups may take 255. Thread 0 issues
//     the TMA copies;
//   * each 64-channel chunk of Cin: the raw (TH + 2) x 34 halo of x arrives
//     by one TMA box of a 4-d map (Cin, W, H, B) at (c, x0 - 1, y0 - 1, b),
//     zero-filled outside the image and past Cin; the block writes
//     silu(a x + b) of it into a bf16 tile whose pixel rows are padded to 72
//     elements (ldmatrix reads 8 neighbouring pixels free of bank
//     conflicts), and zeroes the out-of-image positions after the SiLU
//     (silu(a 0 + b) is not 0). The SiLU works on bf16 pairs (one
//     conversion a pair, bf16(y s) by one bf16x2 multiply) with exp2 and
//     reciprocal from the special-function units, within the rounding order
//     above. The SiLU'd tile is double-buffered: while chunk c's products
//     run, the same threads SiLU chunk c + 1 between their taps, so no pass
//     stops the block;
//   * a tap's A fragment is an ldmatrix at the tap's shifted pixel address
//     of the SiLU'd tile (any row address works, which is what wgmma's
//     shared-memory A layout could not take), fed to wgmma.m64nBNk16 with A
//     in registers; B, the weight tile of (tap, chunk), is MN-major in
//     shared memory: 64 x 64 boxes of a 3-d map (Cout, Cin, 9) in the
//     128-byte swizzle (rows past Cin read zeros, not the next tap's rows),
//     one per 64 output channels, the descriptor's leading byte offset
//     stepping between them. The tiles stream through a ring of STAGES
//     stages on mbarriers: a warpgroup waits for its tap's products and
//     frees the stage, and thread 0 refills the previous tap's stage, so
//     one chunk-end __syncthreads is the only block barrier of the loop;
//   * a bf16 residual arrives by TMA (64-channel boxes of the block's
//     pixels, 128-byte swizzle) during the last chunk, into the raw halo's
//     tile and the SiLU'd tile that chunk leaves free; the epilogue adds it
//     to the accumulators, stages them as fp32 in shared memory, then adds
//     bias and add_bc (and an fp32 residual) and stores with 16-byte
//     accesses, all in fp32, one cast;
//   * ragged edges: any H and W (TMA zero-fills, the SiLU masks, the
//     epilogue clips), any Cin that is a multiple of 8, any Cout (the
//     wrapper pads the weights to a multiple of 8 columns when Cout is not
//     one: the weight map's row pitch must be a multiple of 16 bytes), bf16
//     or fp32 residual and output.
// The tensor maps are encoded on the host at every call and passed by value,
// so a CUDA graph captures them. The tile (TH, BN), the stages, the
// overlap and a 2-block cluster sharing the weight stream (multicast) are
// template arguments; view_neti_tpu_torch/tools/conv_variants.py rebuilds
// the launch line with others and times them side by side.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

using namespace mma_tiles;
using namespace sm90_tiles;

constexpr int kTW = 32;        // output columns a block
constexpr int kHW = kTW + 2;   // halo columns
constexpr int kCH = 64;        // input channels a chunk: one 128-byte row
constexpr int kLDA = kCH + 8;  // padded pixel row of the SiLU'd tile
constexpr int kThreads = 256;  // two warpgroups
constexpr uint32_t kWBoxBytes = kCH * kRowBytes;  // a 64 x 64 weight box
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory plan of a block, from a 1024-byte aligned base: the
// weight ring, the raw halo, the two SiLU'd tiles, the barriers (full and
// empty per stage, then the raw halo's and the residual's).
template <int TH, int BN, int STAGES>
struct Plan {
  static constexpr int kHalo = (TH + 2) * kHW;  // halo pixels
  static constexpr uint32_t kRawBytes = kHalo * kCH * 2;
  // 1024-byte aligned tiles: the residual's swizzled boxes land in them
  static constexpr uint32_t kActBytes = (kHalo * kLDA * 2 + 1023) / 1024 * 1024;
  static constexpr int kBoxes = BN / 64;  // weight boxes a stage
  static constexpr uint32_t kStageBytes = kBoxes * kWBoxBytes;
  static constexpr uint32_t kRaw = STAGES * kStageBytes;
  static constexpr uint32_t kAct = kRaw + (kRawBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kBars = kAct + 2 * kActBytes;
  static constexpr size_t kSmem = 1024 + kBars + (2 * STAGES + 2) * 8;
  // a residual box: 64 channels of the block's TH x 32 pixels
  static constexpr uint32_t kResBoxBytes = TH * kTW * kRowBytes;
  static_assert(TH == 4 || TH == 8, "two warpgroups of 2 or 4 pixel rows");
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static_assert(kSmem <= kMaxSmem, "K4's tiles exceed 227 KB");
  static_assert(STAGES >= 2, "the refill takes the previous step's stage");
};

__device__ __forceinline__ float rcp_fast(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// silu(a x + b) of two channels (a packed bf16 pair of x) in the TPU
// kernel's rounding order, packed: y = bf16(a x + b) from fp32, the
// sigmoid from the special-function units' exp2 and reciprocal rounded to
// bf16, and bf16(y s) by one bf16x2 multiply (the exact product of two bf16
// values, rounded once, as an fp32 product then rounded to bf16)
__device__ __forceinline__ uint32_t affine_silu2(uint32_t x2, float a0,
                                                 float a1, float b0,
                                                 float b1) {
  const uint32_t y2 = pack_bf16(fmaf(__uint_as_float(x2 << 16), a0, b0),
                                fmaf(__uint_as_float(x2 & 0xffff0000u), a1,
                                     b1));
  const float y0 = __uint_as_float(y2 << 16);
  const float y1 = __uint_as_float(y2 & 0xffff0000u);
  const uint32_t s2 = pack_bf16(rcp_fast(1.f + exp2_fast(-kLog2e * y0)),
                                rcp_fast(1.f + exp2_fast(-kLog2e * y1)));
  uint32_t out;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(y2), "r"(s2));
  return out;
}

// ldmatrix .x4 at a shared-memory address (mma_tiles::ldmatrix_x4's layout)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

struct ConvArgs {
  const float *a, *b;
  const bf16* bias;
  const float* add_bc;
  const void* residual;
  void* out;
  int residual_f32, out_f32, H, W, Cin, Cout;
  int vec8;  // Cout % 8 == 0 and residual/out 16-byte aligned
  int res_tma;  // the bf16 residual arrives by TMA (rmap) during the last chunk
};

// The block's pixel tile (TH x kTW) is blockIdx.x / n_tiles, its
// output-channel tile blockIdx.x % n_tiles (neighbouring blocks share a
// halo in L2), its image blockIdx.y. With CLUSTER 2, a cluster of two
// blocks takes two neighbouring pixel tiles of one output-channel tile and
// each block loads half the weight boxes of a stage into both (multicast),
// a stage refilled once both have freed it; a block past the last pixel
// tile repeats the last one and stores nothing.
template <int TH, int BN, int STAGES, bool OVERLAP, int CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
    fused_conv_kernel_sm90(__grid_constant__ const CUtensorMap xmap,
                           __grid_constant__ const CUtensorMap wmap,
                           __grid_constant__ const CUtensorMap rmap,
                           const ConvArgs p, int tiles_w, int n_tiles,
                           int n_pt) {
  static_assert(CLUSTER == 1 || CLUSTER == 2, "clusters of 1 or 2 blocks");
  using P = Plan<TH, BN, STAGES>;
  constexpr int MB = TH / 4;  // m64 blocks a warpgroup
  constexpr int HALO = P::kHalo;
  // a SiLU pass covers 32 halo pixels x 8 vectors of 8 channels; the next
  // chunk's passes run between taps kSiluTap0..8, after its raw halo (issued
  // at the chunk's start) has had kSiluTap0 taps to land
  constexpr int kPasses = (HALO + 31) / 32;
  constexpr int kSiluTap0 = 3;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);
  const uint32_t w_s = base;
  const uint32_t raw_s = base + P::kRaw;
  const bf16* raw = reinterpret_cast<const bf16*>(gbase + P::kRaw);
  const uint32_t act_s = base + P::kAct;
  const uint32_t full = base + P::kBars;     // + 8 stage
  const uint32_t empty = full + 8 * STAGES;  // + 8 stage
  const uint32_t raw_full = empty + 8 * STAGES;
  const uint32_t res_full = raw_full + 8;

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int bidx = blockIdx.y;
  int pt = blockIdx.x / n_tiles;
  int nt = blockIdx.x - pt * n_tiles;
  uint32_t rank = 0;
  if constexpr (CLUSTER > 1) {
    const int pair = blockIdx.x / CLUSTER;
    pt = pair / n_tiles;
    nt = pair - pt * n_tiles;
    rank = cluster_ctarank();
    pt = pt * CLUSTER + rank;
  }
  const bool ghost = pt >= n_pt;
  if (ghost) pt = n_pt - 1;
  const int n0 = nt * BN;
  const int ty = pt / tiles_w;
  const int y0 = ty * TH;
  const int x0 = (pt - ty * tiles_w) * kTW;
  const int n_chunks = (Cin + kCH - 1) / kCH;
  const int n_steps = 9 * n_chunks;  // (chunk, tap), tap fastest
  const int tid = threadIdx.x;
  // warp-uniform to the compiler (a broadcast), as wgmma needs
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid >> 5) & 3;  // in the warpgroup
  const int lane = tid & 31;
  // the weight boxes of a stage that start below Cout, and their bytes
  const int w_boxes = min(P::kBoxes, (Cout - n0 + 63) / 64);
  const uint32_t w_bytes = w_boxes * kWBoxBytes;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * CLUSTER);  // one arrival a warp
    }
    mbar_init(raw_full, 1);
    mbar_init(res_full, 1);
    fence_mbar_init();
  }
  if constexpr (CLUSTER > 1)
    cluster_sync();  // the peer's copies and arrivals find them set up
  else
    __syncthreads();

  // thread 0's copies: chunk c's raw halo; step s's weight boxes
  auto load_raw = [&](int c) {
    mbar_arrive_expect_tx(raw_full, P::kRawBytes);
    tma_load_4d(raw_s, &xmap, raw_full, c * kCH, x0 - 1, y0 - 1, bidx);
  };
  // the residual's boxes (bf16, 64 channels each, 128-byte swizzle) into
  // the tiles the last chunk leaves free: the raw halo's and the SiLU'd
  // tile the last chunk does not read
  auto res_box = [&](int q) {
    return q == 0 ? raw_s : act_s + (n_chunks & 1) * P::kActBytes;
  };
  auto load_res = [&]() {
    mbar_arrive_expect_tx(res_full, w_boxes * P::kResBoxBytes);
    for (int q = 0; q < w_boxes; ++q)
      tma_load_4d(res_box(q), &rmap, res_full, n0 + q * 64, x0, y0, bidx);
  };
  auto load_w = [&](int s) {
    const int c = s / 9;
    const int stage = s % STAGES;
    const uint32_t bar = full + 8 * stage;
    mbar_arrive_expect_tx(bar, w_bytes);
    for (int q = 0; q < w_boxes; ++q) {
      const uint32_t dst = w_s + stage * P::kStageBytes + q * kWBoxBytes;
      if constexpr (CLUSTER > 1) {
        if (q % CLUSTER == static_cast<int>(rank))
          tma_load_3d_multicast(dst, &wmap, bar, n0 + q * 64, c * kCH,
                                s - 9 * c, (1u << CLUSTER) - 1);
      } else {
        tma_load_3d(dst, &wmap, bar, n0 + q * 64, c * kCH, s - 9 * c);
      }
    }
  };

  // silu(a x + b) of chunk c into the SiLU'd tile `act`, passes [it0, it1):
  // a thread always takes the same 8 channels of its pixels
  const int vec = tid & 7;
  const int pix = tid >> 3;
  // the thread's a and b of chunk c, in registers through the chunk's
  // SiLU passes
  float av[8], bv[8];
  auto load_ab = [&](int c) {
    const int ch = c * kCH + vec * 8;
    const bool ok = ch < Cin;  // Cin % 8 == 0: all 8 or none
    const long long off = (long long)bidx * Cin + ch;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      av[j] = ok ? __ldg(p.a + off + j) : 0.f;
      bv[j] = ok ? __ldg(p.b + off + j) : 0.f;
    }
  };
  auto silu = [&](bf16* act, int it0, int it1) {
    for (int it = it0; it < it1; ++it) {
      const int hp = pix + 32 * it;
      if (hp >= HALO) break;
      const int yy = y0 - 1 + hp / kHW;
      const int xx = x0 - 1 + hp % kHW;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const uint4 rv = *reinterpret_cast<const uint4*>(raw + hp * kCH +
                                                         vec * 8);
        packed.x = affine_silu2(rv.x, av[0], av[1], bv[0], bv[1]);
        packed.y = affine_silu2(rv.y, av[2], av[3], bv[2], bv[3]);
        packed.z = affine_silu2(rv.z, av[4], av[5], bv[4], bv[5]);
        packed.w = affine_silu2(rv.w, av[6], av[7], bv[6], bv[7]);
      }
      *reinterpret_cast<uint4*>(act + hp * kLDA + vec * 8) = packed;
    }
  };
  auto act_tile = [&](int c) {
    return reinterpret_cast<bf16*>(gbase + P::kAct + (c & 1) * P::kActBytes);
  };

  float acc[MB][BN / 2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
  // the lane's ldmatrix row address in a SiLU'd tile at tap (0, 0), per m64
  // block: row r of block i is the warpgroup's pixel 64 i + r, the warp's
  // rows 16 warp .. + 15 (lanes 0-15 their first 8 channels of the k-step,
  // lanes 16-31 the next 8)
  uint32_t a_off[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int px = 64 * i + 16 * warp + (lane & 15);
    const int row = wg * (TH / 2) + px / kTW;
    a_off[i] = ((row * kHW + px % kTW) * kLDA + (lane >> 4) * 8) * 2;
  }

  if (tid == 0) {
    load_raw(0);
    for (int s = 0; s < STAGES && s < n_steps; ++s) load_w(s);
  }
  mbar_wait(raw_full, 0);
  load_ab(0);
  silu(act_tile(0), 0, kPasses);
  __syncthreads();
  if (tid == 0 && n_chunks > 1) load_raw(1);
  if (tid == 0 && n_chunks == 1 && p.res_tma) load_res();

  // step s's stage is free in this warp: it arrives; thread 0 then refills
  // the stage of step s - 1, once both warpgroups freed it, with step
  // s - 1 + STAGES
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) {
      if constexpr (CLUSTER > 1) {
        for (int r = 0; r < CLUSTER; ++r)
          mbar_arrive_cluster(map_to_rank(empty + 8 * (s % STAGES), r));
      } else {
        mbar_arrive(empty + 8 * (s % STAGES));
      }
    }
    if (tid == 0 && s >= 1 && s - 1 + STAGES < n_steps) {
      mbar_wait(empty + 8 * ((s - 1) % STAGES), ((s - 1) / STAGES) & 1);
      load_w(s - 1 + STAGES);
    }
    __syncwarp();
  };
  // the next chunk's SiLU passes a tap, from tap kSiluTap0 on
  constexpr int kPerTap = (kPasses + 8 - kSiluTap0) / (9 - kSiluTap0);

  int s = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t act_c = act_s + (c & 1) * P::kActBytes;
    for (int tap = 0; tap < 9; ++tap, ++s) {
      const int stage = s % STAGES;
      mbar_wait(full + 8 * stage, (s / STAGES) & 1);
      const uint32_t at = act_c + ((tap / 3) * kHW + tap % 3) * kLDA * 2;
      uint32_t af[MB][kCH / 16][4];
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int kk = 0; kk < kCH / 16; ++kk)
          ldsm_x4(af[i][kk], at + a_off[i] + kk * 32);
      // k-step kk's 16 rows of the MN-major weight tile start kk * 2048
      // bytes in (descriptor units of 16 bytes); the leading byte offset
      // steps between the 64-column boxes
      const uint64_t desc =
          sw128_desc(w_s + stage * P::kStageBytes, kWBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCH / 16; ++kk)
#pragma unroll
        for (int i = 0; i < MB; ++i)
          wgmma_rs_mn<BN>(acc[i], af[i][kk], desc + 128 * kk, 1);
      wgmma_commit();
      if (OVERLAP && c + 1 < n_chunks && tap >= kSiluTap0) {
        // the next chunk's SiLU on the CUDA cores under the products
        if (tap == kSiluTap0) {
          mbar_wait(raw_full, (c + 1) & 1);
          load_ab(c + 1);
        }
        const int it0 = (tap - kSiluTap0) * kPerTap;
        silu(act_tile(c + 1), it0, min(it0 + kPerTap, kPasses));
      }
      // the tap's products are complete: its A fragments and its stage
      // are free (keeping a tap's products in flight across the next one's
      // loads measured slower, PERF.md)
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        pin_regs(acc[i]);
#pragma unroll
        for (int kk = 0; kk < kCH / 16; ++kk) pin_regs(af[i][kk]);
      }
      release(s);
    }
    if (!OVERLAP && c + 1 < n_chunks) {
      mbar_wait(raw_full, (c + 1) & 1);
      load_ab(c + 1);
      silu(act_tile(c + 1), 0, kPasses);
    }
    // chunk c + 1's SiLU'd tile is whole, chunk c's tile and the raw halo
    // are read: the halo takes chunk c + 2
    __syncthreads();
    if (tid == 0 && c + 2 < n_chunks) load_raw(c + 2);
    if (tid == 0 && c + 2 == n_chunks && p.res_tma) load_res();
  }

  if constexpr (CLUSTER > 1) {
    // the peer's copies into this block and arrivals on its barriers are
    // done before either block moves on or leaves
    cluster_sync();
    if (ghost) return;
  }

  // epilogue: the accumulators (with the residual where it came by TMA:
  // each thread reads its own pixels and channels from the swizzled boxes,
  // free of bank conflicts) go to shared memory as fp32, the loop's tiles
  // being free once every warp is past its last products, each warpgroup
  // its own pixels; then its threads add bias, add_bc and the residual
  // (where it did not come by TMA) and store, 8 channels of a pixel a
  // thread: 16 bytes an access where Cout and the pointers allow (whole
  // sectors, many loads in flight), one channel an access elsewhere. All
  // in fp32, one cast.
  constexpr int kLDO = BN + 4;  // the staged tile's fp32 row, padded 16 bytes
  constexpr int kWgPix = TH / 2 * kTW;
  static_assert(2 * kWgPix * kLDO * 4 <= P::kBars, "the staged output tile");
  const int g = lane >> 2, t = lane & 3;
  if (p.res_tma) {
    mbar_wait(res_full, 0);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the block's pixel; its row of a box holds 8 16-byte chunks of 8
        // channels, chunk k at k ^ (pixel % 8), and pixel % 8 is g
        const int px = wg * kWgPix + 64 * i + 16 * warp + g + 8 * half;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          const uint32_t r2 = ld_shared_u32(
              res_box(n / 8) + px * kRowBytes + (((n % 8) ^ g) << 4) + 4 * t);
          acc[i][4 * n + 2 * half] += __uint_as_float(r2 << 16);
          acc[i][4 * n + 2 * half + 1] += __uint_as_float(r2 & 0xffff0000u);
        }
      }
    }
  }
  __syncthreads();
  float* tile = reinterpret_cast<float*>(gbase) + wg * kWgPix * kLDO;
#pragma unroll
  for (int i = 0; i < MB; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = 64 * i + 16 * warp + g + 8 * half;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        *reinterpret_cast<float2*>(tile + px * kLDO + n * 8 + 2 * t) =
            make_float2(acc[i][4 * n + 2 * half],
                        acc[i][4 * n + 2 * half + 1]);
    }
  }
  named_bar_sync(1 + wg, 128);
  constexpr int kVecs = BN / 8;          // 8-channel vectors a pixel
  constexpr int kPixPass = 128 / kVecs;  // pixels a pass of the warpgroup
  const int tw = tid - 128 * wg;
  const int vv = tw % kVecs;
  const int co = n0 + 8 * vv;
  if (co >= Cout) return;
  // the thread's 8 channels of bias and add_bc, the same at every pixel
  float bias[8], add[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cj = min(co + j, Cout - 1);  // channels past Cout: not stored
    bias[j] = p.bias != nullptr ? __bfloat162float(p.bias[cj]) : 0.f;
    add[j] = p.add_bc != nullptr ? p.add_bc[(long long)bidx * Cout + cj]
                                 : 0.f;
  }
  const bool add_res = p.residual != nullptr && !p.res_tma;
#pragma unroll 4
  for (int px = tw / kVecs; px < kWgPix; px += kPixPass) {
    const int yy = y0 + wg * (TH / 2) + px / kTW, xx = x0 + px % kTW;
    if (yy >= H || xx >= W) continue;
    const long long off = (((long long)bidx * H + yy) * W + xx) * Cout + co;
    float v[8];
    *reinterpret_cast<float4*>(v) =
        *reinterpret_cast<const float4*>(tile + px * kLDO + 8 * vv);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(tile + px * kLDO + 8 * vv + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = v[j] + bias[j] + add[j];
    if (p.vec8) {
      if (add_res) {
        if (p.residual_f32) {
          const float4* r = reinterpret_cast<const float4*>(
              static_cast<const float*>(p.residual) + off);
          const float4 r0 = r[0], r1 = r[1];
          v[0] += r0.x; v[1] += r0.y; v[2] += r0.z; v[3] += r0.w;
          v[4] += r1.x; v[5] += r1.y; v[6] += r1.z; v[7] += r1.w;
        } else {
          const uint4 rv = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(p.residual) + off);
          const bf16* r = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(r[j]);
        }
      }
      if (p.out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                              off);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + off) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (co + j >= Cout) break;
      float r = 0.f;
      if (add_res)
        r = p.residual_f32
                ? static_cast<const float*>(p.residual)[off + j]
                : __bfloat162float(static_cast<const bf16*>(p.residual)[off + j]);
      if (p.out_f32)
        static_cast<float*>(p.out)[off + j] = v[j] + r;
      else
        static_cast<bf16*>(p.out)[off + j] = __float2bfloat16(v[j] + r);
    }
  }
}

// The tensor maps of x, (B, H, W, Cin) in boxes of one chunk's raw halo,
// of the weights, (9, Cin, w_cols) in 64 x 64 boxes in the 128-byte
// swizzle, and of a bf16 residual, (B, H, W, Cout) in boxes of 64 channels
// of a block's pixels in the 128-byte swizzle (x's map where there is
// none); zeros outside each tensor.
template <int TH>
cudaError_t conv_maps(CUtensorMap* xm, CUtensorMap* wm, CUtensorMap* rm,
                      const void* x, const void* w, const void* res, int B,
                      int H, int W, int Cin, int Cout, int w_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t xdims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H),
                               cuuint64_t(B)};
  const cuuint64_t xstrides[3] = {cuuint64_t(Cin) * 2,
                                  cuuint64_t(W) * Cin * 2,
                                  cuuint64_t(H) * W * Cin * 2};
  const cuuint32_t xbox[4] = {kCH, kHW, TH + 2, 1};
  const cuuint64_t wdims[3] = {cuuint64_t(w_cols), cuuint64_t(Cin), 9};
  const cuuint64_t wstrides[2] = {cuuint64_t(w_cols) * 2,
                                  cuuint64_t(Cin) * w_cols * 2};
  const cuuint32_t wbox[3] = {64, kCH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(x), xdims, xstrides, xbox, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  r = encode(wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             wdims, wstrides, wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (res == nullptr) {
    *rm = *xm;
    return cudaSuccess;
  }
  const cuuint64_t rdims[4] = {cuuint64_t(Cout), cuuint64_t(W),
                               cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t rstrides[3] = {cuuint64_t(Cout) * 2,
                                  cuuint64_t(W) * Cout * 2,
                                  cuuint64_t(H) * W * Cout * 2};
  const cuuint32_t rbox[4] = {64, kTW, TH, 1};
  r = encode(rm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(res),
             rdims, rstrides, rbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TH, int BN, int STAGES, bool OVERLAP, int CLUSTER>
int launch_conv(ConvArgs p, const void* x, const void* w, int w_cols, int B,
                cudaStream_t stream) {
  static std::atomic<bool> smem_done[64];
  auto kernel = fused_conv_kernel_sm90<TH, BN, STAGES, OVERLAP, CLUSTER>;
  constexpr size_t smem = Plan<TH, BN, STAGES>::kSmem;
  cudaError_t err = ensure_smem_limit(kernel, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a bf16 residual of 16-byte rows comes by TMA: its boxes, two of 64
  // channels at BN 128, fit the raw halo's tile and a SiLU'd one
  p.res_tma = p.residual != nullptr && !p.residual_f32 && p.vec8 &&
              BN == 128 &&
              Plan<TH, BN, STAGES>::kResBoxBytes <=
                  Plan<TH, BN, STAGES>::kRawBytes;
  CUtensorMap xm, wm, rm;
  err = conv_maps<TH>(&xm, &wm, &rm, x, w, p.res_tma ? p.residual : nullptr,
                      B, p.H, p.W, p.Cin, p.Cout, w_cols);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int n_tiles = (p.Cout + BN - 1) / BN;
  const long long n_pt = (long long)tiles_w * ((p.H + TH - 1) / TH);
  const long long blocks =
      (n_pt + CLUSTER - 1) / CLUSTER * CLUSTER * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), B);
  if constexpr (CLUSTER == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(xm, wm, rm, p, tiles_w, n_tiles,
                                             static_cast<int>(n_pt));
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, xm, wm, rm, p,
                                               tiles_w, n_tiles,
                                               static_cast<int>(n_pt)));
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The input channels of one staged chunk, which the wrapper's callers
// (chip_smoke.py's control) assume.
int fused_conv_sm90_cin_chunk() { return kCH; }

// The arguments of fused_affine_silu_conv3x3_bf16 (fused_conv.cu), with the
// weights (3, 3, Cin, w_cols) bf16, 16-byte aligned, w_cols >= Cout a
// multiple of 8 (columns past Cout are never read into the output), in
// place of the output-channel tile. x: (B, H, W, Cin) bf16 contiguous,
// Cin % 8 == 0, 16-byte aligned. Launches on `stream`; returns the
// launch's cudaError_t.
int fused_affine_silu_conv3x3_sm90_bf16(
    const void* x, const void* a, const void* b, const void* w,
    const void* bias, const void* add_bc, const void* residual,
    int residual_f32, void* out, int out_f32, int B, int H, int W, int Cin,
    int Cout, int w_cols, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 8 != 0 ||
      Cout <= 0 || w_cols < Cout || w_cols % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t res = reinterpret_cast<uintptr_t>(residual);
  const uintptr_t dst = reinterpret_cast<uintptr_t>(out);
  const ConvArgs p{static_cast<const float*>(a),
                   static_cast<const float*>(b),
                   static_cast<const bf16*>(bias),
                   static_cast<const float*>(add_bc),
                   residual,
                   out,
                   residual_f32,
                   out_f32,
                   H,
                   W,
                   Cin,
                   Cout,
                   Cout % 8 == 0 && res % 16 == 0 && dst % 16 == 0,
                   0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_conv<8, 128, 4, true, 1>(p, x, w, w_cols, B, s);
}

}  // extern "C"
