// Hopper (sm_90a) building blocks of the hand-written kernels, in inline
// PTX: TMA tile copies between device and shared memory completed on
// mbarriers, wgmma shared-memory descriptors for the 128-byte swizzle,
// the warpgroup products wgmma.mma_async with bf16 operands and fp32
// accumulators (A from shared memory or from registers; N from 48 to 256),
// their fence,
// commit and wait, setmaxnreg and named barriers; cluster barriers, remote
// mbarrier arrivals and multicast TMA loads; the tiles the attention
// kernels share (64-column chunks of a head dim, 128-byte swizzled) and
// their tensor maps, encoded on the host. K1's Hopper design
// (flash_attention_fwd_sm90.cu), K2's and K3's
// (flash_attention_bwd_dq_sm90.cu, flash_attention_bwd_dkv_sm90.cu) and
// K4's (fused_conv_sm90.cu) are built on them.
//
// Layouts (the PTX ISA's wgmma "canonical" shared-memory layouts):
//   * a TMA box whose rows are 128 bytes (64 bf16), loaded with
//     CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned tile, keeps row r
//     at byte r * 128 with its 16-byte chunk c at chunk c ^ (r % 8): the
//     128-byte swizzle atom of 8 rows (1024 bytes) that sw128_desc
//     describes;
//   * as a K-major operand (the product's depth along the row) the 16
//     columns of k-step kk start 32 * kk bytes into the row: add kk * 2 to
//     the descriptor (its address is in 16-byte units); the 8-row groups
//     are 1024 bytes apart (the stride byte offset);
//   * a head dim wider than 64 columns is kept as several such tiles, one
//     per 64-column chunk (the last one zero-filled past d): as a K-major
//     operand, k-step kk reads chunk kk / 4 at 32 * (kk % 4) bytes;
//   * as an MN-major operand (the depth along the rows, e.g. V in P V) the
//     16 rows of k-step kk start 16 * 128 bytes further: add kk * 128;
//     the 8-row groups along the depth are 1024 bytes apart (the stride
//     byte offset), and the leading byte offset is the step between the
//     64-wide column atoms along N, i.e. between the chunks (N > 64).
//
// Accumulator layout of wgmma.m64nNk16 (fp32): warp w of the warpgroup
// holds rows 16 w .. 16 w + 15 as mma.sync.m16n8k16's C fragments of N / 8
// column tiles: d[4 j + 0..1] row g, columns 8 j + 2 t, + 1; d[4 j + 2..3]
// row g + 8 (lane = 4 g + t). The A operand from registers is
// mma.sync's A fragment of the warp's 16 rows, so two neighbouring column
// tiles of an accumulator, packed to bf16, are the A of one k-step
// (mma_tiles::pack_a's order).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace sm90_tiles {

using mma_tiles::pack_bf16;
using mma_tiles::Strides;

constexpr int kBoxD = 64;  // head-dim columns a box: one 128-byte row
constexpr int kRowBytes = kBoxD * 2;

// ---------------------------------------------------------- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// copy engine; a __syncthreads() follows it.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come (TMA).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival on bar once this thread's cp.async copies issued so far have
// landed; it counts against the arrivals the barrier was initialised with.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase with the given parity has completed. A
// wait that lasts 2^34 cycles (about 9 s) traps: a lost arrival ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// --------------------------------------------------------------- TMA ----

// Brings a tensor map (a kernel parameter) into the cache its TMA copies
// read it from, ahead of the first copy.
__device__ __forceinline__ void prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A 4-d box of the tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst; its bytes complete a transaction on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A 3-d box of the tensor map at coordinates (c0 innermost .. c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared memory at src to the box at (c0 .. c3); the parts of the box
// outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the last N committed groups of stores have read their
// shared memory.
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ clusters ----

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits; it orders
// the shared-memory accesses before it (barrier inits, remote arrivals)
// before those after it, across the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The shared::cluster address of the same location in CTA `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr,
                                                uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// One arrival on a barrier at a shared::cluster address (any CTA's).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// tma_load_3d into the same offset of every CTA in `mask`, completing on
// each one's barrier at bar's offset.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const void* map,
                                                      uint32_t bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

// ------------------------------------------------ barriers, registers ----

// Named barrier `id` (1..15; 0 is __syncthreads') over n threads: sync
// arrives and waits, arrive only arrives.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The warpgroup's registers a thread: all four warps execute it together,
// in branches that never rejoin (else ptxas ignores it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --------------------------------------------------------------- wgmma ----

// The descriptor of a 128-byte swizzled tile at shared address addr
// (1024-byte aligned, or offset from such a tile along a row as above):
// stride byte offset 1024 (8 rows of 128 bytes), leading byte offset lbo
// (the chunk step of an MN-major operand wider than 64; unused otherwise),
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Orders earlier register and shared-memory accesses before the wgmma
// products issued after it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The products write their accumulators (and read A) asynchronously, but
// the compiler sees them only at the asm statement: pinning the registers
// here, after a wait and before an issue, keeps every other access to
// them on its side of the product.
template <int N>
__device__ __forceinline__ void pin_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, fp32) {= or +=} A (64 x 16, shared, K-major) B (16 x 128,
// shared, K-major); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) {= or +=} A (64 x 16, shared, K-major) B (16 x 64,
// shared, K-major).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, fp32) {= or +=} A (64 x 16, shared, K-major) B (16 x 32,
// shared, K-major).
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 80, fp32) {= or +=} A (64 x 16, shared, K-major) B (16 x 80,
// shared, K-major).
__device__ __forceinline__ void wgmma_ss_m64n80k16(float (&d)[40],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 48, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 48,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n48k16_mn(float (&d)[24],
                                                    const uint32_t* a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 64, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 64,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64k16_mn(float (&d)[32],
                                                    const uint32_t* a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 80, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 80,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n80k16_mn(float (&d)[40],
                                                     const uint32_t* a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 160, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 160,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n160k16_mn(float (&d)[80],
                                                     const uint32_t* a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 128, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 128,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128k16_mn(float (&d)[64],
                                                       const uint32_t* a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 256, fp32) {= or +=} A (64 x 16, bf16 in registers) B (16 x 256,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n256k16_mn(float (&d)[128],
                                                       const uint32_t* a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x N) {= or +=} A B, both from shared memory, K-major: the products
// of S = Q K^T over N = 32, 64, 80 or 128 keys.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 128,
                "wgmma_ss: N is 32, 64, 80, 128");
  if constexpr (N == 32)
    wgmma_ss_m64n32k16(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_m64n64k16(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 80)
    wgmma_ss_m64n80k16(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_m64n128k16(d, desc_a, desc_b, scale_d);
}

// D (64 x N) {= or +=} A B with A's 64 x 16 in registers and B MN-major:
// the head-dim buckets N = 48, 64, 80 and 160 of the attention kernels,
// and K4's output-channel tiles N = 128 and 256.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t* a,
                                            uint64_t desc_b, int scale_d) {
  static_assert(N == 48 || N == 64 || N == 80 || N == 128 || N == 160 ||
                    N == 256,
                "wgmma_rs_mn: N is 48, 64, 80, 128, 160 or 256");
  if constexpr (N == 48)
    wgmma_rs_m64n48k16_mn(d, a, desc_b, scale_d);
  else if constexpr (N == 64)
    wgmma_rs_m64n64k16_mn(d, a, desc_b, scale_d);
  else if constexpr (N == 80)
    wgmma_rs_m64n80k16_mn(d, a, desc_b, scale_d);
  else if constexpr (N == 128)
    wgmma_rs_m64n128k16_mn(d, a, desc_b, scale_d);
  else if constexpr (N == 160)
    wgmma_rs_m64n160k16_mn(d, a, desc_b, scale_d);
  else
    wgmma_rs_m64n256k16_mn(d, a, desc_b, scale_d);
}

// ------------------------------------------------ attention tiles ----

// One box a chunk: rows [row, row + box rows) of head h of batch b into
// chunk tiles chunk_bytes apart from dst; their bytes complete on bar.
template <int CHUNKS>
__device__ __forceinline__ void tma_load_chunks(uint32_t dst,
                                                uint32_t chunk_bytes,
                                                const CUtensorMap* map,
                                                uint32_t bar, int row, int h,
                                                int b) {
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch)
    tma_load_4d(dst + ch * chunk_bytes, map, bar, ch * kBoxD, row, h, b);
}

// A consumer's 64 output rows, chunk tiles chunk_bytes apart from src, to
// rows [row, row + 64) of head h of batch b: one committed group of stores
// that clip rows >= Lq and columns >= d.
template <int CHUNKS>
__device__ __forceinline__ void tma_store_chunks(const CUtensorMap* map,
                                                 uint32_t src,
                                                 uint32_t chunk_bytes,
                                                 int row, int h, int b) {
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch)
    tma_store_4d(map, src + ch * chunk_bytes, ch * kBoxD, row, h, b);
  tma_store_commit();
}

// Keys at or past `valid` (Lk less the tile's first key and 2 t) of a
// 64 x N score tile's C fragments get -inf.
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N / 2], int valid) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    s[4 * n] = 8 * n < valid ? s[4 * n] : -INFINITY;
    s[4 * n + 2] = 8 * n < valid ? s[4 * n + 2] : -INFINITY;
    s[4 * n + 1] = 8 * n + 1 < valid ? s[4 * n + 1] : -INFINITY;
    s[4 * n + 3] = 8 * n + 1 < valid ? s[4 * n + 3] : -INFINITY;
  }
}

// P (64 x N, fp32 C fragments) to bf16 pairs: the A operands of N / 16
// k-steps.
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2],
                                       uint32_t (&p)[N / 4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S (+)= Q K^T over bucket DP: k-step kk reads chunk kk / 4 of the
// consumer's Q rows (chunk tiles q_chunk bytes apart) and of the K tile
// (k_chunk apart), 32 (kk % 4) bytes into the row.
template <int DP, int N>
__device__ __forceinline__ void qk_products(float (&s)[N / 2], uint32_t q,
                                            uint32_t q_chunk, uint32_t k,
                                            uint32_t k_chunk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<N>(s, sw128_desc(q + (kk / 4) * q_chunk) + 2 * (kk % 4),
                sw128_desc(k + (kk / 4) * k_chunk) + 2 * (kk % 4), kk > 0);
}

// A warp's rows r and r + 8 of a 64 x DP accumulator (C fragments), times
// inv0 and inv1, as bf16 into a swizzled 64-row tile of chunk tiles
// chunk_bytes apart (o = O / l in the forward, the scaled gradients in the
// backward): column tile n goes to chunk n / 8, its 16 bytes to chunk
// position (n % 8) ^ g (r % 8 = g).
template <int DP>
__device__ __forceinline__ void write_rows(unsigned char* tile,
                                           uint32_t chunk_bytes,
                                           const float (&acc)[DP / 2],
                                           float inv0, float inv1, int r,
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    unsigned char* base = tile + (n / 8) * chunk_bytes;
    const int off = (((n % 8) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(base + r * kRowBytes + off) =
        pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(base + (r + 8) * kRowBytes + off) =
        pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

// ------------------------------------------------- tensor maps ----

// cuTensorMapEncodeTiled, from the driver through the runtime, once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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
// strides: inner extent d, boxes of 64 columns (one chunk) by `rows` rows
// of one (batch, head), 128-byte swizzle, zeros outside the tensor, the
// given L2 promotion of its loads.
inline cudaError_t tensor_map(
    CUtensorMap* map, const void* ptr, int B, int L, int H, int d,
    Strides st, int rows,
    CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
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
      CU_TENSOR_MAP_SWIZZLE_128B, l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90_tiles
