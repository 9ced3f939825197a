// K3's split reduction, shared by its two designs
// (flash_attention_bwd_dkv.cu, flash_attention_bwd_dkv_sm90.cu): where the
// wrapper splits the queries across blocks (ops/flash_attention.py::
// dkv_splits), each split writes fp32 partial dK and dV into scratch
// (2, splits, B * H, Lk, d), and this kernel sums them in a fixed order and
// writes bf16 dk and dv through their strides. No atomics: the result is
// the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace dkv_reduce {

using mma_tiles::bf16;
using mma_tiles::pack_bf16;
using mma_tiles::Strides;

// dk = scale * sum_s dK_s, dv = sum_s dV_s over the splits in order 0, 1,
// ...; each thread takes 4 consecutive elements of one key row.
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_reduce_kernel(const float* __restrict__ part,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int splits, int BH, int H, int Lk, int d,
                                Strides dks, Strides dvs, float scale) {
  const int d4 = d / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)BH * Lk * d4;
  if (i >= total) return;
  const long long slice = (long long)BH * Lk * d;
  const long long off = i * 4;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(part + s * slice + off);
    const float4 b = *reinterpret_cast<const float4*>(
        part + (splits + s) * slice + off);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
  }
  const int c = static_cast<int>(i % d4) * 4;
  const long long row = i / d4;
  const int key = static_cast<int>(row % Lk);
  const int bh = static_cast<int>(row / Lk);
  const int bidx = bh / H, h = bh - bidx * H;
  uint2 wk, wv;
  wk.x = pack_bf16(sk.x * scale, sk.y * scale);
  wk.y = pack_bf16(sk.z * scale, sk.w * scale);
  wv.x = pack_bf16(sv.x, sv.y);
  wv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + bidx * dks.b + (long long)key * dks.l +
                            h * dks.h + c) = wk;
  *reinterpret_cast<uint2*>(dv + bidx * dvs.b + (long long)key * dvs.l +
                            h * dvs.h + c) = wv;
}

// The reduction of `splits` partial sums into dk and dv on `stream`.
inline cudaError_t launch_dkv_reduce(const float* part, bf16* dk, bf16* dv,
                                     int splits, int BH, int H, int Lk, int d,
                                     Strides dks, Strides dvs, float scale,
                                     cudaStream_t stream) {
  const long long total = (long long)BH * Lk * (d / 4);
  flash_bwd_dkv_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256),
                                256, 0, stream>>>(part, dk, dv, splits, BH, H,
                                                  Lk, d, dks, dvs, scale);
  return cudaGetLastError();
}

}  // namespace dkv_reduce
