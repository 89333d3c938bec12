// rmsnorm: RMSNorm forward and backward over x (rows, d), f32 or bf16.
//
// Replaces the Pallas TPU kernel rmsnorm_2d (src/repro/kernels/rmsnorm.py:28,
// body _rmsnorm_kernel at :21): y = x * rsqrt(mean(x^2) + eps) * scale per
// row, the mean of squares reduced in f32, y in x's dtype, in one pass over
// x.  The TPU side has no backward kernel (JAX differentiates the jnp
// norm); training on the card needs one, so this file has it too:
//   dx     = rstd * (g * s) - x * rstd^3 * mean(g * s * x)
//   dscale = sum over rows of g * x * rstd
//
// What bounds it on an H100.  A few flops a byte, so memory, where there
// are bytes enough: a Qwen3 prefill norm (4096 x 2048 f32, 67 MB) needs
// 20 us at 3.35 TB/s, Mamba2's gated norm (4096 x 3072) 30 us.  At the
// training shape (256 x 960, 1 MB in and out) the bytes need 0.6 us and
// a decode step's norms (4 x 2048, 64 x 128) far less: there the launch
// bounds it, on the device (a few us from launch to the last store) and
// above all on the host (the call's own path from Python to the launch).
//
// Design:
//   * Bytes.  One read of x: each row lives in registers between the sum of
//     squares and the scaling, at most 16 elements a thread.  x, g, y and dx
//     move in 16-byte vectors (4 f32 or 8 bf16) when every row start is
//     16-byte aligned and d fills whole vectors; otherwise element by
//     element (a ragged d, a misaligned view).  The wrapper decides which.
//   * Rows to threads.  A row goes to a group of WPR warps, WPR the least
//     power of two that keeps a thread at 16 elements or fewer: one warp up
//     to 512 elements (d = 128 of q_norm and k_norm), 2 warps for 960, 4
//     for 1536 and 2048, 8 for 3072, 32 for the 16384 limit.  Splitting a
//     large row over more warps, rather than giving a warp more elements,
//     keeps registers low and puts more warps in flight for the few rows of
//     a decode step.  Squares are summed with warp shuffles, then across
//     the row's warps in shared memory, in a fixed order.
//   * Rows to blocks.  A block holds RPB row groups (at most 256 threads
//     when WPR <= 8), RPB cut until there are at least 2 * 132 blocks, so
//     that 4, 64 or 256 rows still spread over as many SMs as they can.
//     When RPB > 1 the block stages scale in shared memory once; otherwise
//     its one row group reads it straight into registers.
//   * Launch latency.  One launch for the forward; nothing is allocated or
//     synchronised here; the host entry is a plain C function bound once
//     with ctypes, so the call's host path is a handful of Python
//     operations and one cudaLaunchKernel.
//   * Rows cut over ranks (tensor parallelism: Mamba's gated norm over a
//     d_inner whose heads the ranks share).  Each pass has a statistics
//     mode and a given-statistics mode.  The forward's statistics mode
//     writes the row's f32 sum of squares over the columns it holds and
//     stops; the caller sums those over the ranks and hands them back
//     with the whole row's width d_norm, and the forward then scales with
//     rsqrt(ss / d_norm + eps).  The backward's writes the row's sum of
//     g * s * x; given the ranks' total, dx uses it over d_norm, and
//     dscale is the columns' own.  Between the two modes only a (rows,)
//     f32 vector a pass crosses the ranks.
//   * Backward.  The same row groups, S of them (at most ceil(rows / 2),
//     and 16 warps an SM in all), each loop over rows slot, slot + S, ...:
//     dx row by row, and g * x * rstd summed in registers for the group's
//     columns.  A block adds its groups' sums in shared memory, in group
//     order, into its row of an f32 scratch (blocks, d) that the wrapper
//     allocates; a second kernel, in the same C call, sums each column's
//     rows in a fixed order.  No float atomics: S depends on rows and d
//     only, so two calls on the same inputs agree bit for bit.  At 256 x
//     960 that is 128 groups of 2 warps, 2 rows each, and 30 column blocks.
//
// C interface, bound with ctypes: rmsnorm_fwd and rmsnorm_bwd return the
// last launch's cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 16384;
constexpr int kMaxElemsPerThread = 16;
constexpr int kMinBlocks = 2 * 132;
constexpr int kColsumWarps = 8;
constexpr int kBwdWarps = 16 * 132;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V consecutive elements at p as f32; V > 1 is one 16-byte access.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread t of a row group owns vectors t, t + TPR, t + 2 TPR, ... of a row:
// element columns (i * TPR + t) * V .. + V - 1 in iteration i.
struct Group {
  int tpr;   // threads a row group
  int slot;  // row group within the block
  int t;     // thread within the row group
  int rpb;   // row groups a block
};

__device__ __forceinline__ Group group_of(int wpr) {
  Group g;
  g.tpr = wpr * 32;
  g.slot = threadIdx.x / g.tpr;
  g.t = threadIdx.x - g.slot * g.tpr;
  g.rpb = blockDim.x / g.tpr;
  return g;
}

// Bytes of scale staged in shared memory, rounded up to 16 so that what
// follows it (the backward's partial sums) is 16-byte aligned.
template <typename T>
__host__ __device__ constexpr size_t staged_bytes(int d) {
  return ((size_t)d * sizeof(T) + 15) / 16 * 16;
}

// Where the block reads scale from: staged in shared memory once when the
// block has more than one row group, else straight from device memory.
template <typename T>
__device__ __forceinline__ const T* stage_scale(const T* scale, int d, int rpb, T* smem) {
  if (rpb == 1) return scale;
  for (int c = threadIdx.x; c < d; c += blockDim.x) smem[c] = scale[c];
  __syncthreads();
  return smem;
}

// Sum v over the row group's warps (shuffles, then shared memory in warp
// order); every thread of the block must call it.
__device__ __forceinline__ float group_sum(float v, int wpr, int slot, float* red) {
  v = warp_sum(v);
  if (wpr == 1) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < wpr; ++w) s += red[slot * wpr + w];
  return s;
}

template <typename T, int V, int ITERS, int MAXT>
__global__ void __launch_bounds__(MAXT)
rmsnorm_fwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd,
                   const float* __restrict__ ss_in, float* __restrict__ ss_out, int rows,
                   int d, float dn, float eps, int wpr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[32];
  const Group g = group_of(wpr);
  const long long row = (long long)blockIdx.x * g.rpb + g.slot;
  const bool live = row < rows;

  float v[ITERS][V];
  float ss = 0.f;
  const T* xr = x + row * sx;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int col = (i * g.tpr + g.t) * V;
    if (live && col < d) {
      load<T, V>(xr + col, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) ss += v[i][k] * v[i][k];
  }
  const T* sp = stage_scale(scale, d, g.rpb, reinterpret_cast<T*>(smem_raw));
  ss = group_sum(ss, wpr, g.slot, red);
  if (!live) return;
  if (ss_out != nullptr) {  // the statistics mode: the sum of squares only
    if (g.t == 0) ss_out[row] = ss;
    return;
  }
  if (ss_in != nullptr) ss = ss_in[row];
  const float r = rsqrtf(ss / dn + eps);
  if (rstd != nullptr && g.t == 0) rstd[row] = r;
  T* yr = y + row * (long long)d;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int col = (i * g.tpr + g.t) * V;
    if (col < d) {
      float s[V], o[V];
      load<T, V>(sp + col, s);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = v[i][k] * r * s[k];
      store<T, V>(yr + col, o);
    }
  }
}

template <typename T, int V, int ITERS, int MAXT>
__global__ void __launch_bounds__(MAXT)
rmsnorm_bwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ scale,
                   const T* __restrict__ gy, long long sg, const float* __restrict__ rstd,
                   const float* __restrict__ dot_in, float* __restrict__ dot_out,
                   T* __restrict__ dx, float* __restrict__ part, int rows, int d, float dn,
                   int wpr, int slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][32];
  const Group g = group_of(wpr);
  const int slot = blockIdx.x * g.rpb + g.slot;   // row slots past `slots` idle
  const int steps = (rows + slots - 1) / slots;

  const T* sp = stage_scale(scale, d, g.rpb, reinterpret_cast<T*>(smem_raw));
  float s[ITERS][V], acc[ITERS][V];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int col = (i * g.tpr + g.t) * V;
    if (slot < slots && col < d) {
      load<T, V>(sp + col, s[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) s[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[i][k] = 0.f;
  }

  // every thread runs every step, so the group sums' barriers line up
  for (int step = 0; step < steps; ++step) {
    const long long row = (long long)step * slots + slot;
    const bool live = slot < slots && row < rows;
    float xv[ITERS][V], gv[ITERS][V];
    float dot = 0.f;
    const T* xr = x + row * sx;
    const T* gr = gy + row * sg;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int col = (i * g.tpr + g.t) * V;
      if (live && col < d) {
        load<T, V>(xr + col, xv[i]);
        load<T, V>(gr + col, gv[i]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) xv[i][k] = gv[i][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) dot += gv[i][k] * s[i][k] * xv[i][k];
    }
    const float r = live ? rstd[row] : 0.f;
    dot = group_sum(dot, wpr, g.slot, red[step & 1]);
    if (!live) continue;
    if (dot_out != nullptr) {  // the statistics mode: the row's dot only
      if (g.t == 0) dot_out[row] = dot;
      continue;
    }
    if (dot_in != nullptr) dot = dot_in[row];
    const float m = dot / dn;
    const float r3 = r * r * r;
    T* dr = dx + row * (long long)d;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int col = (i * g.tpr + g.t) * V;
      if (col < d) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          o[k] = r * (gv[i][k] * s[i][k]) - xv[i][k] * r3 * m;
          acc[i][k] += gv[i][k] * xv[i][k] * r;
        }
        store<T, V>(dr + col, o);
      }
    }
  }

  if (dot_out != nullptr) return;
  // the block's partial dscale: its row groups' sums added in group order
  // (an idle group's sums are 0) into row blockIdx.x of part
  float* pr = part + (long long)blockIdx.x * d;
  float* buf = pr;
  if (g.rpb > 1)
    buf = reinterpret_cast<float*>(smem_raw + staged_bytes<T>(d)) + (long long)g.slot * d;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int col = (i * g.tpr + g.t) * V;
    if (col < d) {
#pragma unroll
      for (int k = 0; k < V; ++k) buf[col + k] = acc[i][k];
    }
  }
  if (g.rpb == 1) return;
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(smem_raw + staged_bytes<T>(d));
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < g.rpb; ++r) t += all[r * d + c];
    pr[c] = t;
  }
}

// dscale[c] = sum over the P partial rows of part[p][c]: a block takes 32
// columns, its warps contiguous ranges of rows, summed in row order and
// then in warp order.
template <typename T>
__global__ void __launch_bounds__(32 * kColsumWarps)
rmsnorm_column_sum_kernel(const float* __restrict__ part, T* __restrict__ dscale, int n_part,
                          int d) {
  __shared__ float sums[kColsumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per_warp = (n_part + kColsumWarps - 1) / kColsumWarps;
  const int lo = warp * per_warp;
  const int hi = min(n_part, lo + per_warp);
  float a = 0.f;
  if (col < d)
    for (int p = lo; p < hi; ++p) a += part[(long long)p * d + col];
  sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kColsumWarps; ++w) t += sums[w][lane];
    dscale[col] = from_f<T>(t);
  }
}

// How rows map to threads (see the note at the top).
struct Plan {
  int wpr;     // warps a row group
  int iters;   // vectors a thread, rounded up to an instantiated count
  int rpb;     // row groups a block
  int blocks;  // blocks of the launch
};

Plan plan(int d, int v, int row_groups) {
  const int max_iters = kMaxElemsPerThread / v;
  const int nvec = (d + v - 1) / v;
  Plan p;
  p.wpr = 1;
  while (p.wpr * 32 * max_iters < nvec) p.wpr *= 2;
  const int need = (nvec + 32 * p.wpr - 1) / (32 * p.wpr);
  p.iters = 1;
  while (p.iters < need) p.iters *= 2;
  p.rpb = p.wpr >= 8 ? 1 : 8 / p.wpr;
  while (p.rpb > 1 && (row_groups + p.rpb - 1) / p.rpb < kMinBlocks) p.rpb /= 2;
  p.blocks = (row_groups + p.rpb - 1) / p.rpb;
  return p;
}

// The backward's row slots: two rows a slot at the least, and no more
// slots than keep kBwdWarps warps busy; a function of (rows, d, vec) only,
// so the partial sums, and dscale, are the same on every call.
int bwd_slots(int rows, int wpr) {
  const int cap = kBwdWarps / wpr > 1 ? kBwdWarps / wpr : 1;
  const int half = (rows + 1) / 2;
  return half < cap ? half : cap;
}

Plan bwd_plan(int rows, int d, int v) {
  const int wpr = plan(d, v, 1).wpr;
  return plan(d, v, bwd_slots(rows, wpr));
}

template <typename T, int V, int ITERS, int MAXT>
void launch_fwd(const Plan& p, const T* x, long long sx, const T* scale, T* y, float* rstd,
                const float* ss_in, float* ss_out, int rows, int d, float dn, float eps,
                cudaStream_t stream) {
  const size_t smem = p.rpb > 1 ? staged_bytes<T>(d) : 0;
  rmsnorm_fwd_kernel<T, V, ITERS, MAXT><<<p.blocks, p.rpb * p.wpr * 32, smem, stream>>>(
      x, sx, scale, y, rstd, ss_in, ss_out, rows, d, dn, eps, p.wpr);
}

template <typename T, int V, int ITERS, int MAXT>
void launch_bwd(const Plan& p, const T* x, long long sx, const T* scale, const T* gy,
                long long sg, const float* rstd, const float* dot_in, float* dot_out, T* dx,
                float* part, int rows, int d, float dn, cudaStream_t stream) {
  const size_t smem = p.rpb > 1 ? staged_bytes<T>(d) + (size_t)p.rpb * d * sizeof(float) : 0;
  rmsnorm_bwd_kernel<T, V, ITERS, MAXT><<<p.blocks, p.rpb * p.wpr * 32, smem, stream>>>(
      x, sx, scale, gy, sg, rstd, dot_in, dot_out, dx, part, rows, d, dn, p.wpr,
      bwd_slots(rows, p.wpr));
}

template <int I>
using Iters = std::integral_constant<int, I>;

// Calls go(Iters<iters>, Iters<max threads a block>) for the instance the
// plan needs: blocks of at most 256 threads (WPR <= 8: d <= 4096) for each
// power-of-two iters up to 16 / V, and one instance at 16 / V iters whose
// blocks take up to 1024 threads, for the widest rows (WPR 16 and 32; at
// 64 registers a thread its backward may spill; no model path comes near).
template <int V, typename F>
int dispatch(const Plan& p, F&& go) {
  constexpr int kMax = kMaxElemsPerThread / V;
  if (p.wpr > 8) {
    go(Iters<kMax>{}, Iters<1024>{});
    return 0;
  }
  switch (p.iters) {
    case 1: go(Iters<1>{}, Iters<256>{}); return 0;
    case 2: if constexpr (2 <= kMax) { go(Iters<2>{}, Iters<256>{}); return 0; } break;
    case 4: if constexpr (4 <= kMax) { go(Iters<4>{}, Iters<256>{}); return 0; } break;
    case 8: if constexpr (8 <= kMax) { go(Iters<8>{}, Iters<256>{}); return 0; } break;
    case 16: if constexpr (16 <= kMax) { go(Iters<16>{}, Iters<256>{}); return 0; } break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
int fwd_v(const void* x, long long sx, const void* scale, void* y, float* rstd,
          const float* ss_in, float* ss_out, int rows, int d, float dn, float eps,
          cudaStream_t stream) {
  const Plan p = plan(d, V, rows);
  const int err = dispatch<V>(p, [&](auto it, auto mt) {
    launch_fwd<T, V, decltype(it)::value, decltype(mt)::value>(
        p, static_cast<const T*>(x), sx, static_cast<const T*>(scale), static_cast<T*>(y), rstd,
        ss_in, ss_out, rows, d, dn, eps, stream);
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

template <typename T, int V>
int bwd_v(const void* x, long long sx, const void* scale, const void* gy, long long sg,
          const float* rstd, const float* dot_in, float* dot_out, void* dx, void* dscale,
          float* part, int rows, int d, float dn, cudaStream_t stream) {
  const Plan p = bwd_plan(rows, d, V);
  int err = dispatch<V>(p, [&](auto it, auto mt) {
    launch_bwd<T, V, decltype(it)::value, decltype(mt)::value>(
        p, static_cast<const T*>(x), sx, static_cast<const T*>(scale),
        static_cast<const T*>(gy), sg, rstd, dot_in, dot_out, static_cast<T*>(dx), part, rows,
        d, dn, stream);
  });
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0 || dot_out != nullptr) return err;
  rmsnorm_column_sum_kernel<T><<<(d + 31) / 32, 32 * kColsumWarps, 0, stream>>>(
      part, static_cast<T*>(dscale), p.blocks, d);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, long long sx, const void* scale, void* y, float* rstd,
        const float* ss_in, float* ss_out, int rows, int d, float dn, float eps, int vec,
        cudaStream_t stream) {
  if (vec)
    return fwd_v<T, 16 / sizeof(T)>(x, sx, scale, y, rstd, ss_in, ss_out, rows, d, dn, eps,
                                    stream);
  return fwd_v<T, 1>(x, sx, scale, y, rstd, ss_in, ss_out, rows, d, dn, eps, stream);
}

template <typename T>
int bwd(const void* x, long long sx, const void* scale, const void* gy, long long sg,
        const float* rstd, const float* dot_in, float* dot_out, void* dx, void* dscale,
        float* part, int rows, int d, float dn, int vec, cudaStream_t stream) {
  if (vec)
    return bwd_v<T, 16 / sizeof(T)>(x, sx, scale, gy, sg, rstd, dot_in, dot_out, dx, dscale,
                                    part, rows, d, dn, stream);
  return bwd_v<T, 1>(x, sx, scale, gy, sg, rstd, dot_in, dot_out, dx, dscale, part, rows, d,
                     dn, stream);
}

int vec_width(int dtype) { return dtype == 0 ? 4 : 8; }


// The whole row's width: d_norm, or the columns held when it is 0.
float row_width(int d, int d_norm) { return (float)(d_norm > 0 ? d_norm : d); }

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, scale and y alike).  rstd (rows,) f32
// may be null.  vec: x's start, its row stride sx (in elements), scale's
// start and d all allow 16-byte vectors.  Rows cut over ranks: with ss_out
// (rows,) f32 the launch writes the rows' sums of squares there and
// nothing else (y and rstd unused); with ss_in it normalises by
// rsqrt(ss_in / d_norm + eps) instead of the rows' own; both null and
// d_norm 0 is the plain norm.
extern "C" int rmsnorm_fwd(const void* x, long long sx, const void* scale, void* y, void* rstd,
                           const void* ss_in, void* ss_out, int d_norm, int rows, int d,
                           float eps, int dtype, int vec, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pr = static_cast<float*>(rstd);
  const float* si = static_cast<const float*>(ss_in);
  float* so = static_cast<float*>(ss_out);
  const float dn = row_width(d, d_norm);
  if (dtype == 0) return fwd<float>(x, sx, scale, y, pr, si, so, rows, d, dn, eps, vec, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, sx, scale, y, pr, si, so, rows, d, dn, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the f32 scratch (rows_of_part, d) that rmsnorm_bwd needs.
extern "C" int rmsnorm_bwd_scratch_rows(int rows, int d, int dtype, int vec) {
  if (rows < 1 || d < 1 || d > kMaxD) return 0;
  return bwd_plan(rows, d, vec ? vec_width(dtype) : 1).blocks;
}

// dx (rows, d) contiguous in x's dtype; dscale (d,) in scale's dtype; part
// the f32 scratch of rmsnorm_bwd_scratch_rows rows.  vec: as for
// rmsnorm_fwd, over x, g (row stride sg) and scale.  Rows cut over ranks:
// with dot_out (rows,) f32 the launch writes the rows' sums of g * s * x
// there and nothing else (dx, dscale and part unused); with dot_in, dx
// takes dot_in / d_norm for the rows' mean of g * s * x.
extern "C" int rmsnorm_bwd(const void* x, long long sx, const void* scale, const void* gy,
                           long long sg, const void* rstd, const void* dot_in, void* dot_out,
                           int d_norm, void* dx, void* dscale, void* part, int rows, int d,
                           int dtype, int vec, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(rstd);
  const float* di = static_cast<const float*>(dot_in);
  float* dout = static_cast<float*>(dot_out);
  float* pp = static_cast<float*>(part);
  const float dn = row_width(d, d_norm);
  if (dtype == 0)
    return bwd<float>(x, sx, scale, gy, sg, pr, di, dout, dx, dscale, pp, rows, d, dn, vec, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, sx, scale, gy, sg, pr, di, dout, dx, dscale, pp, rows, d, dn,
                              vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_max_d() { return kMaxD; }
