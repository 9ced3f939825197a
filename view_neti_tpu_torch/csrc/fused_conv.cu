// Fused GroupNorm-affine + SiLU + 3x3 convolution (K4) for Hopper
// (sm_90a), bf16 operands, fp32 accumulators in registers: the mma.sync
// design. ops/fused_conv.py::conv_design sends the two narrow convs of the
// VAE (Cout <= 16) here; every wider conv takes the wgmma and TMA design of
// fused_conv_sm90.cu, and this one is checked and timed beside it there.
//
// Replaces the TPU kernel view_neti_tpu/ops/fused_conv.py::_kernel
// (launched by fused_affine_silu_conv3x3 through pl.pallas_call). It
// computes, on NHWC tensors, stride 1, zero padding 1,
//     out = conv3x3(silu(a*x + b)) + bias + add_bc[batch] + residual
// so the normalised and SiLU'd tensor never goes to device memory.
//
// What bounds it on an H100: 2*9*Cin*Cout operations per output pixel
// against (Cin + Cout [+ Cout residual]) * 2 bytes, so at the VAE's
// 128..512 channels it sits above the bf16 ridge (about 295 operations per
// byte): the tensor cores bound it (989 TFLOP/s bf16). The decoder's
// conv_out (Cout 3) and the encoder's last conv (Cout 8) are bound by the
// bytes of x.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K = 9
// taps x Cin, on mma.sync.m16n8k16 (mma_tiles.cuh) with the accumulators in
// registers. A tap's view of the staged halo tile is a per-row shifted
// address, which ldmatrix takes and wgmma's shared-memory A layout does
// not; wgmma takes it with A in registers, filled by the same ldmatrix
// (fused_conv_sm90.cu), and that design is 1.7-1.9x faster at the ResNet
// convs. Here every warp fetches its A and B fragments by ldmatrix each
// 16-deep step, which holds it to 0.19-0.24 of the operations bound there.
//   * a block takes a 2-D tile of TH x kTW output pixels of one image and
//     BN output channels, in two instantiations that the wrapper chooses
//     by Cout: 4 x 32 pixels x 128 channels (8 warps of 64 pixels x 32
//     channels) for the ResNet convs, and 8 x 32 x 16 (8 warps of 32 x 16)
//     for Cout <= 16, the decoder's conv_out (3) and the encoder's last
//     conv (8), where a 128-channel tile would be 94-98 % padding. Every
//     VAE width is a multiple of 32 and every height of 8, so the paths
//     waste no pixel; a 4 x 32 tile stages a 6 x 34 halo, 1.59 pixels per
//     output pixel (2.06 for 2 x 64), 8 x 32 a 10 x 34 one, 1.33;
//   * for each 64-channel chunk of Cin the raw (TH+2) x (kTW+2) halo of x
//     arrives by 16-byte cp.async (positions outside the image and
//     channels past Cin zero-filled by the copy), with the chunk's a and b;
//     one pass then writes silu(a x + b) in the TPU kernel's rounding order
//     into a bf16 tile -- a*x + b in fp32 rounded to bf16, then
//     y * bf16(sigmoid(f32 y)) rounded to bf16 (fused_conv.py:221-232) --
//     and zeroes the out-of-image positions after the SiLU (the padding
//     applies to the post-SiLU tensor). Each input element is normalised
//     and SiLU'd 1.59 * ceil(Cout / 128) times, not 9 * ceil(Cout / 64);
//   * the nine taps are address offsets into that tile: each pixel is one
//     row, padded to 72 elements so the ldmatrix reads of 8 neighbouring
//     pixels are free of bank conflicts;
//   * the (tap, chunk) weight tiles (64 x BN) stream through a three-stage
//     cp.async ring, tile s + 2 in flight while tile s is multiplied, one
//     __syncthreads per tap, each thread copying one column of fixed rows;
//     the next chunk's raw halo is issued in eight slices with the weight
//     tiles of taps 0..7, so it lands while this chunk's taps run;
//   * the epilogue runs from the accumulators: bias, add_bc and residual
//     added in fp32 and one cast, two channels per store;
//   * ragged edges: any H and W (masked at image edges and tile seams), any
//     Cin that is a multiple of 8, any Cout (weight tiles by scalar loads
//     when Cout % 8 != 0), bf16 or fp32 residual and output.
// The two instantiations and the alternatives to them are timed side by
// side by view_neti_tpu_torch/tools/conv_variants.py (PERF.md, section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int kTW = 32;        // output columns per block
constexpr int kHW = kTW + 2;   // halo tile columns
constexpr int kCH = 64;        // input channels per chunk
constexpr int kVec = kCH / 8;  // 16-byte vectors of a pixel's chunk
constexpr int kLDA = kCH + 8;  // padded row of the SiLU'd tile
constexpr int kStages = 3;     // weight ring
// the next chunk's raw halo goes out in slices with the weight tiles of
// taps 0..kSlices-1; the last by tap 7, so it has landed when the chunk ends
constexpr int kSlices = 8;
static_assert(kSlices <= 8);

template <int BN>
__host__ __device__ constexpr int ldb() {
  return BN + 8;
}

// pixels of the halo tile of TH output rows
template <int TH>
__host__ __device__ constexpr int halo_pixels() {
  return (TH + 2) * kHW;
}

// raw halo + SiLU'd halo + weight ring (bf16) + a chunk's a and b (fp32)
template <int TH, int BN>
__host__ __device__ constexpr size_t conv_smem_bytes() {
  return (size_t(halo_pixels<TH>()) * (kCH + kLDA) +
          size_t(kStages) * kCH * ldb<BN>()) * sizeof(bf16) +
         size_t(2) * kCH * sizeof(float);
}

// The offset in the act tile of a warp's 16-pixel row block i from its
// first one, for a warp whose pixels start on a row of the output tile.
__host__ __device__ constexpr int a_step(int i) {
  return ((i * 16) / kTW * kHW + (i * 16) % kTW) * kLDA;
}

__device__ __forceinline__ bf16 affine_silu(float x, float a, float b) {
  const float y = __bfloat162float(__float2bfloat16(x * a + b));
  const float s = __bfloat162float(__float2bfloat16(1.f / (1.f + expf(-y))));
  return __float2bfloat16(y * s);
}

struct ConvArgs {
  const bf16* x;
  const float *a, *b;
  const bf16 *w, *bias;
  const float* add_bc;
  const void* residual;
  void* out;
  int residual_f32, out_f32, B, H, W, Cin, Cout;
  int w_vec;  // Cout % 8 == 0 and w 16-byte aligned: 16-byte weight copies
  int pairs;  // Cout even and residual/out aligned: two channels per access
};

// The block's pixel tile (TH x kTW) is blockIdx.x / n_tiles, its
// output-channel tile blockIdx.x % n_tiles (neighbouring blocks share a
// halo in L2), its image blockIdx.y. Warps are WM (pixels) x WN (channels).
template <int TH, int BN, int WM, int WN, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
    fused_conv_kernel(const ConvArgs p, int tiles_w, int n_tiles) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int HALO = halo_pixels<TH>();
  constexpr int SLICE = (HALO * kVec + kSlices - 1) / kSlices;  // vectors
  constexpr int LDB = ldb<BN>();
  constexpr int WPIX = TH * kTW / WM;  // pixels per warp
  constexpr int WCH = BN / WN;         // output channels per warp
  constexpr int MT = WPIX / 16;        // 16-pixel row blocks per warp
  constexpr int NT = WCH / 8;          // 8-channel tiles per warp
  static_assert(NT % 2 == 0 && kTW % 16 == 0 && THREADS >= 2 * kCH &&
                (MT == 1 || WPIX % kTW == 0) && THREADS % kVec == 0);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);
  bf16* act = raw + HALO * kCH;
  bf16* wring = act + HALO * kLDA;  // stage s at wring + s * kCH * LDB
  float* a_s = reinterpret_cast<float*>(wring + kStages * kCH * LDB);
  float* b_s = a_s + kCH;

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int bidx = blockIdx.y;
  const int pt = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x - pt * n_tiles) * BN;
  const int y0 = (pt / tiles_w) * TH;
  const int x0 = (pt - (pt / tiles_w) * tiles_w) * kTW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const int n_chunks = (Cin + kCH - 1) / kCH;
  const int n_steps = 9 * n_chunks;  // (chunk, tap), tap fastest
  const bf16* xb = p.x + (long long)bidx * H * W * Cin;

  // halo vectors [v0, v1) of chunk c into the raw tile
  auto load_halo = [&](int c, int v0, int v1) {
    for (int i = v0 + threadIdx.x; i < v1; i += THREADS) {
      const int hp = i / kVec;
      const int ch = c * kCH + (i - hp * kVec) * 8;
      const int yy = y0 - 1 + hp / kHW;
      const int xx = x0 - 1 + hp % kHW;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && ch < Cin;
      cp_async_16(raw + i * 8,
                  ok ? xb + ((long long)yy * W + xx) * Cin + ch : p.x, ok);
    }
  };
  auto load_ab = [&](int c) {
    const int i = threadIdx.x;
    if (i < 2 * kCH) {
      const int j = i & (kCH - 1);
      const int ch = c * kCH + j;
      const float* src = (i < kCH ? p.a : p.b) + (long long)bidx * Cin;
      const bool ok = ch < Cin;
      cp_async_4((i < kCH ? a_s : b_s) + j, ok ? src + ch : p.a, ok);
    }
  };
  // the weight tile of step s: rows [c * kCH, +kCH) of tap s % 9,
  // columns [n0, n0 + BN); rows past Cin and columns past Cout are 0. A
  // thread copies one column of rows w_row, w_row + W_ROWS, ...
  constexpr int W_VECS = BN / 8;            // 16-byte vectors of a row
  constexpr int W_ROWS = THREADS / W_VECS;  // rows per pass of the block
  static_assert(THREADS % W_VECS == 0);
  const int w_row = threadIdx.x / W_VECS;
  const int w_col = (threadIdx.x - w_row * W_VECS) * 8;
  const bool w_col_ok = n0 + w_col < Cout;
  const long long w_pass = (long long)W_ROWS * Cout;
  auto load_w = [&](int s) {
    bf16* dst = wring + (s % kStages) * kCH * LDB;
    const int c = s / 9;
    const int k0 = c * kCH;
    if (p.w_vec) {
      const bf16* src =
          p.w + ((long long)(s - 9 * c) * Cin + k0 + w_row) * Cout + n0 + w_col;
#pragma unroll
      for (int k = 0; k < (kCH + W_ROWS - 1) / W_ROWS; ++k) {
        const int r = w_row + k * W_ROWS;
        if (r >= kCH) break;
        const bool ok = w_col_ok && k0 + r < Cin;
        cp_async_16(dst + r * LDB + w_col, ok ? src + k * w_pass : p.w, ok);
      }
    } else {
      const bf16* src = p.w + (long long)(s - 9 * c) * Cin * Cout;
      for (int i = threadIdx.x; i < kCH * BN; i += THREADS) {
        const int r = i / BN;
        const int col = i - r * BN;
        dst[r * LDB + col] = k0 + r < Cin && n0 + col < Cout
                                 ? src[(long long)(k0 + r) * Cout + n0 + col]
                                 : __float2bfloat16(0.f);
      }
    }
  };
  // silu(a x + b) of the chunk into the act tile, 0 outside the image; a
  // thread always takes the same 8 channels (THREADS % kVec == 0), so its
  // a and b sit in registers
  auto silu_pass = [&]() {
    const int ch = (threadIdx.x % kVec) * 8;
    float av[8], bv[8];
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      *reinterpret_cast<float4*>(av + j) =
          *reinterpret_cast<const float4*>(a_s + ch + j);
      *reinterpret_cast<float4*>(bv + j) =
          *reinterpret_cast<const float4*>(b_s + ch + j);
    }
    for (int hp = threadIdx.x / kVec; hp < HALO; hp += THREADS / kVec) {
      const int yy = y0 - 1 + hp / kHW;
      const int xx = x0 - 1 + hp % kHW;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const uint4 rv = *reinterpret_cast<const uint4*>(raw + hp * kCH + ch);
        const bf16* xv = reinterpret_cast<const bf16*>(&rv);
        bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pv[j] = affine_silu(__bfloat162float(xv[j]), av[j], bv[j]);
      }
      *reinterpret_cast<uint4*>(act + hp * kLDA + ch) = packed;
    }
  };

  load_halo(0, 0, HALO * kVec);
  load_ab(0);
  load_w(0);
  cp_async_commit();
  load_w(1);
  cp_async_commit();

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  // the lane's ldmatrix row address of its first row block at tap (0, 0);
  // the warp's pixels start on an image row of the tile, so row block i
  // lies a constant offset further (a_step)
  const int px0 = wm * WPIX + (lane & 15);
  const int a_lane = ((px0 / kTW) * kHW + px0 % kTW) * kLDA + (lane >> 4) * 8;

  int s = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // the chunk's halo and a, b have landed; the last tap of the previous
    // chunk is done with the act tile
    cp_async_wait<1>();
    __syncthreads();
    silu_pass();
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap, ++s) {
      if (tap > 0) {
        // weight tile s has landed; step s - 1 is done with stage
        // (s + 2) % 3
        cp_async_wait<1>();
        __syncthreads();
      }
      if (s + 2 < n_steps) load_w(s + 2);
      if (c + 1 < n_chunks) {
        if (tap < kSlices)
          load_halo(c + 1, tap * SLICE, min((tap + 1) * SLICE, HALO * kVec));
        if (tap == 0) load_ab(c + 1);
      }
      cp_async_commit();

      const bf16* wt = wring + (s % kStages) * kCH * LDB;
      const bf16* at = act + ((tap / 3) * kHW + tap % 3) * kLDA;
#pragma unroll
      for (int kk = 0; kk < kCH / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i], at + a_lane + a_step(i) + kk * 16);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(
              bfr, b_frag_addr<LDB>(wt, kk * 16, wn * WCH + nn * 16, lane));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_16816(acc[i][2 * nn], af[i], bfr[0], bfr[1]);
            mma_16816(acc[i][2 * nn + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

  // epilogue from the accumulators: C rows g and g + 8 of each row block,
  // channels 2t and 2t + 1 of each 8-channel tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = wm * WPIX + i * 16 + g + 8 * half;
      const int yy = y0 + px / kTW, xx = x0 + px % kTW;
      if (yy >= H || xx >= W) continue;
      const long long pix = ((long long)bidx * H + yy) * W + xx;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = n0 + wn * WCH + n * 8 + 2 * t;
        if (co >= Cout) continue;
        const bool two = co + 1 < Cout;
        float v0 = acc[i][n][2 * half], v1 = acc[i][n][2 * half + 1];
        if (p.bias != nullptr) {
          v0 += __bfloat162float(p.bias[co]);
          if (two) v1 += __bfloat162float(p.bias[co + 1]);
        }
        if (p.add_bc != nullptr) {
          const float* ab = p.add_bc + (long long)bidx * Cout + co;
          v0 += ab[0];
          if (two) v1 += ab[1];
        }
        const long long off = pix * Cout + co;
        if (p.pairs) {  // two is true
          if (p.residual != nullptr) {
            const float2 r =
                p.residual_f32
                    ? *reinterpret_cast<const float2*>(
                          static_cast<const float*>(p.residual) + off)
                    : __bfloat1622float2(
                          *reinterpret_cast<const __nv_bfloat162*>(
                              static_cast<const bf16*>(p.residual) + off));
            v0 += r.x;
            v1 += r.y;
          }
          if (p.out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + off) =
                pack_bf16(v0, v1);
          continue;
        }
        if (p.residual != nullptr) {
          if (p.residual_f32) {
            const float* r = static_cast<const float*>(p.residual) + off;
            v0 += r[0];
            if (two) v1 += r[1];
          } else {
            const bf16* r = static_cast<const bf16*>(p.residual) + off;
            v0 += __bfloat162float(r[0]);
            if (two) v1 += __bfloat162float(r[1]);
          }
        }
        if (p.out_f32) {
          float* o = static_cast<float*>(p.out) + off;
          o[0] = v0;
          if (two) o[1] = v1;
        } else {
          bf16* o = static_cast<bf16*>(p.out) + off;
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int TH, int BN, int WM, int WN, int MINB>
int launch_conv(const ConvArgs& p, cudaStream_t stream) {
  static std::atomic<bool> smem_done[64];
  auto kernel = fused_conv_kernel<TH, BN, WM, WN, MINB>;
  constexpr size_t smem = conv_smem_bytes<TH, BN>();
  const cudaError_t err = ensure_smem_limit(kernel, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int n_tiles = (p.Cout + BN - 1) / BN;
  const long long blocks =
      (long long)tiles_w * ((p.H + TH - 1) / TH) * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), p.B);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(p, tiles_w, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The input channels of one staged chunk, which the wrapper's callers
// (chip_smoke.py's control) assume.
int fused_conv_cin_chunk() { return kCH; }

// x: (B, H, W, Cin) bf16 contiguous, Cin % 8 == 0, 16-byte aligned; a, b:
// (B, Cin) fp32; w: (3, 3, Cin, Cout) bf16 contiguous; bias: (Cout,) bf16
// or null; add_bc: (B, Cout) fp32 or null; residual: (B, H, W, Cout) bf16
// or fp32 (residual_f32) or null; out: (B, H, W, Cout) bf16 or fp32
// (out_f32). n_tile: the output channels per block, 128 or 16. Launches on
// `stream`; returns the launch's cudaError_t.
int fused_affine_silu_conv3x3_bf16(const void* x, const void* a,
                                   const void* b, const void* w,
                                   const void* bias, const void* add_bc,
                                   const void* residual, int residual_f32,
                                   void* out, int out_f32, int B, int H,
                                   int W, int Cin, int Cout, int n_tile,
                                   void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 8 != 0 ||
      Cout <= 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t res = reinterpret_cast<uintptr_t>(residual);
  const uintptr_t dst = reinterpret_cast<uintptr_t>(out);
  const ConvArgs p{
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const float*>(add_bc),
      residual, out, residual_f32, out_f32, B, H, W, Cin, Cout,
      Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0,
      Cout % 2 == 0 && res % (residual_f32 ? 8 : 4) == 0 &&
          dst % (out_f32 ? 8 : 4) == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tile == 128) return launch_conv<4, 128, 2, 4, 2>(p, s);
  if (n_tile == 16) return launch_conv<8, 16, 8, 1, 2>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
