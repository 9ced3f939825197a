// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel view_neti_tpu/ops/fused_conv.py::_kernel
// (launched by fused_affine_silu_conv3x3 through pl.pallas_call). It
// computes, on NHWC tensors, stride 1, zero padding 1,
//     out = conv3x3(silu(a*x + b)) + bias + add_bc[batch] + residual
// reading the raw activation x once per use, so the normalised and SiLU'd
// tensor never goes to device memory.
//
// What bounds it on an H100: 2*9*Cin*Cout operations per output pixel
// against (Cin + Cout [+ Cout residual]) * 2 bytes, so at the VAE decoder's
// 128..512 channels it sits near the bf16 ridge (about 295 operations per
// byte): the 128-channel levels are close to balanced, the 512-channel
// levels are bound by the tensor cores.
//
// Design: an implicit GEMM, M = output pixels of one image, N = output
// channels, K = 9 taps x Cin, on WMMA 16x16x16 bf16 fragments with fp32
// accumulation.
//   * prologue, on every A-tile load: a*x + b in fp32, rounded to bf16,
//     then y * bf16(sigmoid(f32(y))) rounded to bf16 -- the TPU kernel's
//     rounding order (fused_conv.py:221-232);
//   * halo: taps that fall outside the image load 0 *after* the SiLU
//     (convolution zero padding applies to the post-SiLU tensor);
//   * epilogue: bias, add_bc and residual are added in fp32, then one cast
//     to the output dtype; ragged Cout (e.g. the decoder's conv_out, 3) and
//     ragged Cin (any multiple of 8) are bounds-checked with zero fill.
// The prologue recomputes the SiLU once per tap and per output-channel
// tile; trading that for a staged SiLU'd halo tile is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBC = 32;   // input channels per k-step
constexpr int kThreads = 256;  // 8 warps as 4 (M) x 2 (N), 32x32 each

__device__ __forceinline__ __nv_bfloat16 affine_silu(float x, float a,
                                                     float b) {
  const float y = __bfloat162float(__float2bfloat16(x * a + b));
  const float s = __bfloat162float(__float2bfloat16(1.f / (1.f + expf(-y))));
  return __float2bfloat16(y * s);
}

__global__ void __launch_bounds__(kThreads)
    fused_conv_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      const float* __restrict__ add_bc,
                      const void* __restrict__ residual, int residual_f32,
                      void* __restrict__ out, int out_f32, int H, int W,
                      int Cin, int Cout) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kBC];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBC * kBN];
  __shared__ __align__(128) float Cs[kBM * kBN];

  const int bidx = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int HW = H * W;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16* xb = x + (long long)bidx * HW * Cin;
  const float* ab = a + (long long)bidx * Cin;
  const float* bb = b + (long long)bidx * Cin;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kBC) {
      // A tile: kBM pixels x kBC channels of silu(a*x + b), 8 per load
      for (int i = threadIdx.x; i < kBM * kBC / 8; i += kThreads) {
        const int r = i / (kBC / 8);
        const int cv = (i % (kBC / 8)) * 8;
        const int m = m0 + r;
        const int c = c0 + cv;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (m < HW && c < Cin) {
          const int y = m / W;
          const int yy = y + dy;
          const int xx = m - y * W + dx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                xb + ((long long)yy * W + xx) * Cin + c);
            const __nv_bfloat16* xv =
                reinterpret_cast<const __nv_bfloat16*>(&raw);
            __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              pv[j] = affine_silu(__bfloat162float(xv[j]), ab[c + j],
                                  bb[c + j]);
          }
        }
        *reinterpret_cast<uint4*>(As + r * kBC + cv) = packed;
      }
      // B tile: kBC rows (tap, c) x kBN output channels of the HWIO kernel
      for (int i = threadIdx.x; i < kBC * kBN; i += kThreads) {
        const int kr = i / kBN;
        const int n = i - kr * kBN;
        const int c = c0 + kr;
        const int co = n0 + n;
        Bs[i] = (c < Cin && co < Cout)
                    ? w[((long long)tap * Cin + c) * Cout + co]
                    : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kBC + kk * 16,
                                 kBC);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * 16 * kBN + wn * 32 + j * 16,
                                 kBN);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: fp32 bias / add_bc / residual, one cast at the store
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kBN + wn * 32 + j * 16,
                              acc[i][j], kBN, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int n = i - r * kBN;
    const int m = m0 + r;
    const int co = n0 + n;
    if (m >= HW || co >= Cout) continue;
    float val = Cs[i];
    if (bias != nullptr) val += __bfloat162float(bias[co]);
    if (add_bc != nullptr) val += add_bc[(long long)bidx * Cout + co];
    const long long off = ((long long)bidx * HW + m) * Cout + co;
    if (residual != nullptr)
      val += residual_f32
                 ? static_cast<const float*>(residual)[off]
                 : __bfloat162float(
                       static_cast<const __nv_bfloat16*>(residual)[off]);
    if (out_f32)
      static_cast<float*>(out)[off] = val;
    else
      static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(val);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (B, H, W, Cin) bf16 contiguous, Cin % 8 == 0; a, b: (B, Cin) fp32;
// w: (3, 3, Cin, Cout) bf16 contiguous; bias: (Cout,) bf16 or null;
// add_bc: (B, Cout) fp32 or null; residual: (B, H, W, Cout) bf16 or fp32
// (residual_f32) or null; out: (B, H, W, Cout) bf16 or fp32 (out_f32).
// Launches on `stream`; returns the launch's cudaError_t.
int fused_affine_silu_conv3x3_bf16(const void* x, const void* a,
                                   const void* b, const void* w,
                                   const void* bias, const void* add_bc,
                                   const void* residual, int residual_f32,
                                   void* out, int out_f32, int B, int H,
                                   int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 8 != 0 ||
      Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = (long long)H * W;
  const dim3 grid(static_cast<unsigned>((hw + kBM - 1) / kBM),
                  (Cout + kBN - 1) / kBN, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  fused_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const float*>(add_bc), residual, residual_f32, out, out_f32,
      H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
