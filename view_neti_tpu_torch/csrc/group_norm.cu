// GroupNorm over NHWC tensors (K5) for Hopper (sm_90a): one-pass fp32
// statistics read from the activation, the normalize with its optional SiLU
// in one pass, and the backward, for bf16 and fp32 activations.
//
// K5 replaces no Pallas kernel of the JAX package. It restores on the card
// the fusion that XLA gives view_neti_tpu/ops/norm.py::FastGroupNorm (one
// bf16 pass for the statistics, one for the normalize, the SiLU fused into
// it): in eager PyTorch and inside a CUDA graph, ops/norm.py's plain chain
// runs every line as a pass of its own over an fp32 copy, about 54 bytes
// an element for a GroupNorm and its SiLU and 22 for a fold that feeds K4.
//
// What bounds it on an H100: bytes. A statistic or a normalize does one or
// two operations an element against 2 to 4 bytes read or written; at 3.35
// TB/s the least time is the activation's bytes over the bandwidth:
//   * forward: read x once for the statistics, read it again and write the
//     output: 3 x sizeof(T) bytes an element (6 for bf16); a fold that
//     feeds K4 reads x once (2);
//   * backward: read the upstream gradient and x for the per-channel sums,
//     read both again and write dx: 5 x sizeof(T) bytes an element (10).
// Everything per (batch, channel) or per (batch, group) is a few kilobytes.
//
// Design, one layout for the four streaming kernels (the wrapper,
// ops/norm.py::norm_plan, chooses it from the shape):
//   * a thread owns a fixed vector column of VEC channels (16-byte loads:
//     8 bf16 or 4 fp32) and walks down the pixel rows of one chunk; a block
//     is tx vector columns x ty row lanes (<= 256 threads), the grid
//     (channel tiles, pixel chunks, batch). The chunk's length is chosen
//     from the shape so that the grid holds about eight blocks an SM at
//     both ends of the paths: the UNet's 6x8 lowest level at batch 9 and
//     the decoder's 576x768 level at batch 3;
//   * the statistics kernel keeps Σx and Σx² per channel in fp32
//     registers (four rows' loads in flight a thread), sums the row lanes
//     by a fixed tree in shared memory and writes one partial per (batch,
//     chunk, channel); a second, small kernel, one block a (group, batch),
//     sums the partials over chunks and the group's channels in double, in
//     a fixed order, and writes the per-(batch, channel) affine (a, b) with
//     ops/norm.py's formula: mean, E[x²], var = max(E[x²] - mean², 0),
//     a = rsqrt(var + eps) * gamma, b = beta - mean * a. No float atomics:
//     the results are the same from run to run;
//   * the apply kernel loads its columns' a and b once and writes
//     cast(x * a + b), the product and the sum each rounded in fp32 as the
//     plain chain rounds them, then, with the SiLU, y / (1 + exp(-y)) on
//     the rounded y in fp32, rounded once (F.silu's arithmetic);
//   * the backward recomputes y from x, a and b where the forward had the
//     SiLU, takes the SiLU's derivative as F.silu's backward does (rounded
//     to the activation's type), sums the gradient and its product with x
//     per channel in one pass (the statistics kernel's layout), folds them
//     per (batch, group) into dx = a * g + c1 * x + c2 and, when the
//     parameters need it, the per-(batch, channel) terms of dgamma and
//     dbeta, and writes dx in a last pass.
// Any C that is a multiple of the group count takes it, with up to 256
// channels a group; a C or a pointer that does not allow 16-byte loads
// takes the one-element instantiation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// the normalize in the plain chain's rounding order: x * a and + b each an
// fp32 operation (no contraction into an FMA), then one cast to T
template <typename T>
__device__ __forceinline__ float normalized(float x, float a, float b) {
  return to_f(from_f<T>(__fadd_rn(__fmul_rn(x, a), b)));
}

// F.silu: y / (1 + exp(-y)) in fp32
__device__ __forceinline__ float silu(float y) {
  return __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
}

// the gradient reaching y = cast(x * a + b): the upstream gradient, or,
// with the SiLU, F.silu's backward g * s * (1 + y * (1 - s)) rounded to T
template <typename T, bool SILU>
__device__ __forceinline__ float grad_y(float g, float x, float a, float b) {
  if (!SILU) return g;
  const float y = normalized<T>(x, a, b);
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
  return to_f(from_f<T>(g * s * (1.0f + y * (1.0f - s))));
}

struct Grid {
  int P, C, rows;  // pixels a batch item, channels, rows of a chunk
};

// this thread's part of the grid: its first row (rows step by the block's
// row lanes), one past its chunk's last row, its first channel and the
// element offset of its column in batch item blockIdx.z; `active` is false
// for a thread past the last column
struct Column {
  int r, r1, ch;
  size_t base;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Column my_column(const Grid& s) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = static_cast<int>(blockIdx.y) * s.rows;
  Column c;
  c.r = r0 + static_cast<int>(threadIdx.y);
  c.r1 = min(s.P, r0 + s.rows);
  c.ch = col * VEC;
  c.base = static_cast<size_t>(blockIdx.z) * s.P * s.C + c.ch;
  c.active = col < s.C / VEC;
  return c;
}

// sums the (2 * VEC) values of every row lane of the block into row lane
// 0, by a fixed tree (the same order on every run)
template <int VEC>
__device__ __forceinline__ void sum_row_lanes(float (&u)[VEC],
                                              float (&w)[VEC]) {
  __shared__ float sh[2 * VEC][kThreads];
  const int TX = blockDim.x, TY = blockDim.y;
  const int me = threadIdx.y * TX + threadIdx.x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh[i][me] = u[i];
    sh[VEC + i][me] = w[i];
  }
  int span = 1;
  while (span < TY) span <<= 1;
  for (int h = span >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (threadIdx.y < h && threadIdx.y + h < TY) {
#pragma unroll
      for (int k = 0; k < 2 * VEC; ++k) sh[k][me] += sh[k][me + h * TX];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    u[i] = sh[i][me];
    w[i] = sh[VEC + i][me];
  }
}

// writes row lane 0's sums as the (batch, chunk) partial of its channels
template <int VEC>
__device__ __forceinline__ void store_partial(const Grid& s, bool active,
                                              int ch, const float (&u)[VEC],
                                              const float (&w)[VEC],
                                              float* p0, float* p1) {
  if (threadIdx.y != 0 || !active) return;
  const size_t o =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * s.C + ch;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    p0[o + i] = u[i];
    p1[o + i] = w[i];
  }
}

// Σx and Σx² per channel of one chunk of pixels
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ p0,
                        float* __restrict__ p1, Grid s) {
  float u[VEC], w[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) u[i] = w[i] = 0.0f;
  const Column c = my_column<VEC>(s);
  if (c.active) {
    const int TY = blockDim.y, r1 = c.r1;
    const T* xp = x + c.base;
    int r = c.r;
    for (; r + 3 * TY < r1; r += 4 * TY) {
      Pack<T, VEC> v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = load_pack<T, VEC>(xp + static_cast<size_t>(r + k * TY) * s.C);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float f = to_f(v[k].v[i]);
          u[i] += f;
          w[i] = fmaf(f, f, w[i]);
        }
    }
    for (; r < r1; r += TY) {
      const Pack<T, VEC> v =
          load_pack<T, VEC>(xp + static_cast<size_t>(r) * s.C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = to_f(v.v[i]);
        u[i] += f;
        w[i] = fmaf(f, f, w[i]);
      }
    }
  }
  sum_row_lanes<VEC>(u, w);
  store_partial<VEC>(s, c.active, c.ch, u, w, p0, p1);
}

// per-channel sums over the chunks of the two partial planes, for the
// `cg` channels from c0 of batch item b, in double and in a fixed order:
// lane l of channel j sums chunks l, l + L, ..., then channel j's L lanes
// in order. Leaves them in out0 and out1 (shared, cg each).
__device__ void channel_sums(const float* __restrict__ p0,
                             const float* __restrict__ p1, int nchunks,
                             int C, int b, int c0, int cg, double* out0,
                             double* out1) {
  __shared__ double lane0[kThreads], lane1[kThreads];
  const int L = kThreads / cg;
  const int t = threadIdx.x, j = t % cg, l = t / cg;
  double s0 = 0.0, s1 = 0.0;
  if (l < L) {
    for (int k = l; k < nchunks; k += L) {
      const size_t o = (static_cast<size_t>(b) * nchunks + k) * C + c0 + j;
      s0 += p0[o];
      s1 += p1[o];
    }
  }
  lane0[t] = s0;
  lane1[t] = s1;
  __syncthreads();
  if (t < cg) {
    double a0 = 0.0, a1 = 0.0;
    for (int k = 0; k < L; ++k) {
      a0 += lane0[k * cg + t];
      a1 += lane1[k * cg + t];
    }
    out0[t] = a0;
    out1[t] = a1;
  }
  __syncthreads();
}

struct Fold {
  int nchunks, C, G, P;
  float eps;
};

// rsqrt(max(var, 0) + eps), NaN kept as torch.clamp keeps it
__device__ __forceinline__ float inv_std(float var, float eps) {
  return rsqrtf(__fadd_rn(var < 0.0f ? 0.0f : var, eps));
}

// one block a (group, batch item): the statistics and the affine
__global__ void __launch_bounds__(kThreads)
group_norm_fold_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ a,
                       float* __restrict__ b, float* __restrict__ stats,
                       Fold f) {
  __shared__ double s0[kThreads], s1[kThreads];
  __shared__ float mean_r[2];
  const int g = blockIdx.x, bi = blockIdx.y, cg = f.C / f.G;
  channel_sums(p0, p1, f.nchunks, f.C, bi, g * cg, cg, s0, s1);
  if (threadIdx.x == 0) {
    double t0 = 0.0, t1 = 0.0;
    for (int j = 0; j < cg; ++j) {
      t0 += s0[j];
      t1 += s1[j];
    }
    const double n = static_cast<double>(f.P) * cg;
    const float mean = static_cast<float>(t0 / n);
    const float mean2 = static_cast<float>(t1 / n);
    const float var = __fsub_rn(mean2, __fmul_rn(mean, mean));
    stats[2 * (bi * f.G + g)] = mean;
    stats[2 * (bi * f.G + g) + 1] = var;
    mean_r[0] = mean;
    mean_r[1] = inv_std(var, f.eps);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cg; j += blockDim.x) {
    const int c = g * cg + j;
    const float ac = __fmul_rn(mean_r[1], gamma[c]);
    a[bi * f.C + c] = ac;
    b[bi * f.C + c] = __fsub_rn(beta[c], __fmul_rn(mean_r[0], ac));
  }
}

// out = cast(x * a + b), with the SiLU after it where SILU
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, T* __restrict__ out,
                        Grid s) {
  const Column c = my_column<VEC>(s);
  if (!c.active) return;
  const int TY = blockDim.y;
  const size_t ab = static_cast<size_t>(blockIdx.z) * s.C + c.ch;
  float av[VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = a[ab + i];
    bv[i] = b[ab + i];
  }
  const T* xp = x + c.base;
  T* op = out + c.base;
  for (int r = c.r; r < c.r1; r += TY) {
    const size_t o = static_cast<size_t>(r) * s.C;
    const Pack<T, VEC> v = load_pack<T, VEC>(xp + o);
    Pack<T, VEC> y;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float f = normalized<T>(to_f(v.v[i]), av[i], bv[i]);
      if (SILU) f = silu(f);
      y.v[i] = from_f<T>(f);
    }
    *reinterpret_cast<Pack<T, VEC>*>(op + o) = y;
  }
}

// the backward's per-channel sums of one chunk: Σ gy and Σ gy * x, gy the
// gradient reaching the normalize's output
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_reduce_kernel(const T* __restrict__ g,
                             const T* __restrict__ x,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ p0, float* __restrict__ p1,
                             Grid s) {
  float u[VEC], w[VEC], av[VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) u[i] = w[i] = av[i] = bv[i] = 0.0f;
  const Column c = my_column<VEC>(s);
  if (c.active) {
    const int TY = blockDim.y, r1 = c.r1;
    if (SILU) {
      const size_t ab = static_cast<size_t>(blockIdx.z) * s.C + c.ch;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        av[i] = a[ab + i];
        bv[i] = b[ab + i];
      }
    }
    const T* gp = g + c.base;
    const T* xp = x + c.base;
    int r = c.r;
    for (; r + TY < r1; r += 2 * TY) {
      Pack<T, VEC> gv[2], xv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const size_t o = static_cast<size_t>(r + k * TY) * s.C;
        gv[k] = load_pack<T, VEC>(gp + o);
        xv[k] = load_pack<T, VEC>(xp + o);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xf = to_f(xv[k].v[i]);
          const float gy =
              grad_y<T, SILU>(to_f(gv[k].v[i]), xf, av[i], bv[i]);
          u[i] += gy;
          w[i] = fmaf(gy, xf, w[i]);
        }
    }
    for (; r < r1; r += TY) {
      const size_t o = static_cast<size_t>(r) * s.C;
      const Pack<T, VEC> gv = load_pack<T, VEC>(gp + o);
      const Pack<T, VEC> xv = load_pack<T, VEC>(xp + o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = to_f(xv.v[i]);
        const float gy = grad_y<T, SILU>(to_f(gv.v[i]), xf, av[i], bv[i]);
        u[i] += gy;
        w[i] = fmaf(gy, xf, w[i]);
      }
    }
  }
  sum_row_lanes<VEC>(u, w);
  store_partial<VEC>(s, c.active, c.ch, u, w, p0, p1);
}

// one block a (group, batch item): dx = a * gy + c1 * x + c2 with
//   dr    = Σ_c gamma_c (S1_c - mean S0_c)           (a_c = r gamma_c)
//   dvar  = dr * (-r³ / 2) where E[x²] - mean² >= 0, else 0 (the clamp)
//   dmean = -Σ_c a_c S0_c - 2 mean dvar               (b_c = beta_c - mean a_c)
//   c1 = 2 dvar / N, c2 = dmean / N
// and, where dgamma is given, dgamma[b, c] = r (S1_c - mean S0_c) and
// dbeta[b, c] = S0_c, summed over the batch by the wrapper
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_fold_kernel(const float* __restrict__ p0,
                           const float* __restrict__ p1,
                           const float* __restrict__ gamma,
                           const float* __restrict__ a,
                           const float* __restrict__ stats,
                           float* __restrict__ c12, float* __restrict__ dgamma,
                           float* __restrict__ dbeta, Fold f) {
  __shared__ double s0[kThreads], s1[kThreads];
  const int g = blockIdx.x, bi = blockIdx.y, cg = f.C / f.G;
  channel_sums(p0, p1, f.nchunks, f.C, bi, g * cg, cg, s0, s1);
  const double mean = stats[2 * (bi * f.G + g)];
  const float var = stats[2 * (bi * f.G + g) + 1];
  const double r = inv_std(var, f.eps);
  if (threadIdx.x == 0) {
    double dr = 0.0, sa = 0.0;
    for (int j = 0; j < cg; ++j) {
      const int c = g * cg + j;
      dr += static_cast<double>(gamma[c]) * (s1[j] - mean * s0[j]);
      sa += static_cast<double>(a[bi * f.C + c]) * s0[j];
    }
    const double dvar = var >= 0.0f ? dr * (-0.5 * r * r * r) : 0.0;
    const double dmean = -sa - 2.0 * mean * dvar;
    const double n = static_cast<double>(f.P) * cg;
    c12[2 * (bi * f.G + g)] = static_cast<float>(2.0 * dvar / n);
    c12[2 * (bi * f.G + g) + 1] = static_cast<float>(dmean / n);
  }
  if (dgamma != nullptr) {
    for (int j = threadIdx.x; j < cg; j += blockDim.x) {
      const int c = g * cg + j;
      dgamma[bi * f.C + c] = static_cast<float>(r * (s1[j] - mean * s0[j]));
      dbeta[bi * f.C + c] = static_cast<float>(s0[j]);
    }
  }
}

// dx = cast(a * gy + c1 * x + c2)
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ c12, T* __restrict__ dx,
                         Grid s, int G) {
  const Column c = my_column<VEC>(s);
  if (!c.active) return;
  const int TY = blockDim.y, cg = s.C / G;
  const size_t ab = static_cast<size_t>(blockIdx.z) * s.C + c.ch;
  float av[VEC], bv[VEC], c1[VEC], c2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = a[ab + i];
    bv[i] = SILU ? b[ab + i] : 0.0f;
    const int grp = blockIdx.z * G + (c.ch + i) / cg;
    c1[i] = c12[2 * grp];
    c2[i] = c12[2 * grp + 1];
  }
  const T* gp = g + c.base;
  const T* xp = x + c.base;
  T* dp = dx + c.base;
  for (int r = c.r; r < c.r1; r += TY) {
    const size_t o = static_cast<size_t>(r) * s.C;
    const Pack<T, VEC> gv = load_pack<T, VEC>(gp + o);
    const Pack<T, VEC> xv = load_pack<T, VEC>(xp + o);
    Pack<T, VEC> d;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = to_f(xv.v[i]);
      const float gy = grad_y<T, SILU>(to_f(gv.v[i]), xf, av[i], bv[i]);
      d.v[i] = from_f<T>(fmaf(c1[i], xf, fmaf(av[i], gy, c2[i])));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dp + o) = d;
  }
}

struct Launch {
  dim3 grid, block;
  Grid s;
  cudaStream_t stream;
};

bool make_launch(int B, int P, int C, int vec, int tx, int ty, int rows,
                 int nchunks, void* stream, Launch* l) {
  if (B <= 0 || B > 65535 || P <= 0 || C <= 0 || vec <= 0 || C % vec != 0 ||
      tx <= 0 || ty <= 0 || tx * ty > kThreads || rows <= 0 ||
      nchunks <= 0 || nchunks > 65535 ||
      static_cast<long long>(rows) * nchunks < P ||
      static_cast<long long>(rows) * (nchunks - 1) >= P)
    return false;
  const int ncols = C / vec;
  l->grid = dim3((ncols + tx - 1) / tx, nchunks, B);
  l->block = dim3(tx, ty);
  l->s = Grid{P, C, rows};
  l->stream = static_cast<cudaStream_t>(stream);
  return true;
}

bool fold_ok(int B, int C, int G, int nchunks) {
  return B > 0 && B <= 65535 && G > 0 && C % G == 0 && C / G <= kThreads &&
         nchunks > 0;
}

template <typename T, int VEC>
void stats_t(const Launch& l, const void* x, float* p0, float* p1) {
  group_norm_stats_kernel<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
      static_cast<const T*>(x), p0, p1, l.s);
}

template <typename T, int VEC, bool SILU>
void apply_t(const Launch& l, const void* x, const float* a, const float* b,
             void* out) {
  group_norm_apply_kernel<T, VEC, SILU><<<l.grid, l.block, 0, l.stream>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(out), l.s);
}

template <typename T, int VEC, bool SILU>
void bwd_reduce_t(const Launch& l, const void* g, const void* x,
                  const float* a, const float* b, float* p0, float* p1) {
  group_norm_bwd_reduce_kernel<T, VEC, SILU>
      <<<l.grid, l.block, 0, l.stream>>>(static_cast<const T*>(g),
                                         static_cast<const T*>(x), a, b, p0,
                                         p1, l.s);
}

template <typename T, int VEC, bool SILU>
void bwd_dx_t(const Launch& l, const void* g, const void* x, const float* a,
              const float* b, const float* c12, void* dx, int G) {
  group_norm_bwd_dx_kernel<T, VEC, SILU><<<l.grid, l.block, 0, l.stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), a, b, c12,
      static_cast<T*>(dx), l.s, G);
}

// calls F<T, VEC> for the activation's type (0 bf16, 1 fp32) and vector
// width (16 bytes or one element); false for any other pair
#define NORM_DISPATCH(dtype, vec, CALL)                 \
  do {                                                  \
    if ((dtype) == 0 && (vec) == 8) {                   \
      CALL(bf16, 8);                                    \
    } else if ((dtype) == 0 && (vec) == 1) {            \
      CALL(bf16, 1);                                    \
    } else if ((dtype) == 1 && (vec) == 4) {            \
      CALL(float, 4);                                   \
    } else if ((dtype) == 1 && (vec) == 1) {            \
      CALL(float, 1);                                   \
    } else {                                            \
      return static_cast<int>(cudaErrorInvalidValue);   \
    }                                                   \
  } while (0)

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward: x (B, P, C) contiguous, bf16 (dtype 0) or fp32 (dtype 1),
// its pointer and C aligned to `vec` elements (8 or 1 for bf16, 4 or 1 for
// fp32); the launch shape (tx, ty, rows, nchunks) from ops/norm.py::
// norm_plan; part: (2, B, nchunks, C) fp32 scratch; gamma, beta (C,) fp32;
// a, b: (B, C) fp32 out; stats: (B, G, 2) fp32 out, the mean and E[x²] -
// mean² of each group; out: (B, P, C) of x's type, or null for the fold
// alone (no apply pass); silu: the SiLU after the normalize. Launches on
// `stream`; returns the first launch's cudaError_t that is not success.
int group_norm_fwd(const void* x, int dtype, int vec, int B, int P, int C,
                   int G, int tx, int ty, int rows, int nchunks, void* part,
                   const void* gamma, const void* beta, float eps, void* a,
                   void* b, void* stats, void* out, int silu, void* stream) {
  Launch l;
  if (!make_launch(B, P, C, vec, tx, ty, rows, nchunks, stream, &l) ||
      !fold_ok(B, C, G, nchunks))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p0 = static_cast<float*>(part);
  float* p1 = p0 + static_cast<size_t>(B) * nchunks * C;
#define STATS(T, V) stats_t<T, V>(l, x, p0, p1)
  NORM_DISPATCH(dtype, vec, STATS);
#undef STATS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_fold_kernel<<<dim3(G, B), kThreads, 0, l.stream>>>(
      p0, p1, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(stats),
      Fold{nchunks, C, G, P, eps});
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
#define APPLY(T, V)                          \
  if (silu)                                  \
    apply_t<T, V, true>(l, x, af, bf, out);  \
  else                                       \
    apply_t<T, V, false>(l, x, af, bf, out)
  NORM_DISPATCH(dtype, vec, APPLY);
#undef APPLY
  return static_cast<int>(cudaGetLastError());
}

// The backward: g and x (B, P, C) of one type and alignment as in the
// forward; a, b, stats the forward's; part: (2, B, nchunks, C) fp32
// scratch; c12: (B, G, 2) fp32 scratch; dgamma, dbeta: (B, C) fp32 out, or
// null when the parameters need no gradient; dx: (B, P, C) of x's type, or
// null when x needs none. Launches on `stream`; returns the first launch's
// cudaError_t that is not success.
int group_norm_bwd(const void* g, const void* x, int dtype, int vec, int B,
                   int P, int C, int G, int tx, int ty, int rows,
                   int nchunks, void* part, const void* gamma, const void* a,
                   const void* b, const void* stats, float eps, void* c12,
                   void* dgamma, void* dbeta, void* dx, int silu,
                   void* stream) {
  Launch l;
  if (!make_launch(B, P, C, vec, tx, ty, rows, nchunks, stream, &l) ||
      !fold_ok(B, C, G, nchunks) || (dgamma == nullptr) != (dbeta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p0 = static_cast<float*>(part);
  float* p1 = p0 + static_cast<size_t>(B) * nchunks * C;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
#define REDUCE(T, V)                                      \
  if (silu)                                               \
    bwd_reduce_t<T, V, true>(l, g, x, af, bf, p0, p1);    \
  else                                                    \
    bwd_reduce_t<T, V, false>(l, g, x, af, bf, p0, p1)
  NORM_DISPATCH(dtype, vec, REDUCE);
#undef REDUCE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_bwd_fold_kernel<<<dim3(G, B), kThreads, 0, l.stream>>>(
      p0, p1, static_cast<const float*>(gamma), af,
      static_cast<const float*>(stats), static_cast<float*>(c12),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      Fold{nchunks, C, G, P, eps});
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  const float* c = static_cast<const float*>(c12);
#define DX(T, V)                                          \
  if (silu)                                               \
    bwd_dx_t<T, V, true>(l, g, x, af, bf, c, dx, G);      \
  else                                                    \
    bwd_dx_t<T, V, false>(l, g, x, af, bf, c, dx, G)
  NORM_DISPATCH(dtype, vec, DX);
#undef DX
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
