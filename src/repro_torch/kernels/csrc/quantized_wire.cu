// quantized_wire: the four kernels of the physical (quantized, delta-coded)
// gossip wire, for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of src/repro/kernels/consensus_mix.py:
//   wire_encode_f32           <- quantized_gossip_encode_2d          (:334)
//                                C(w - r; u): the send side, round 0
//   wire_bucketed_round_f32   <- bucketed_gossip_round_2d            (:440)
//                                r += D(q); acc += A D(q); C(acc - r; u)
//   wire_pipelined_round_f32  <- bucketed_gossip_round_pipelined_2d  (:577)
//                                C(w - r; u); r += own; acc += A D(delayed)
//   wire_leaf_round_f32       <- quantized_gossip_round_2d           (:219)
//                                R += D(q); W = A R; C(W - R; u)
// C(x; u) is the stochastic quantizer of the wire: per (row, chunk) the
// scale s = absmax > 0 ? absmax * f32(1/qmax) : 1, and the codes
// clip(floor(x * (1/s) + u), -qmax, qmax) as int8 (int4 values unpacked).
//
// What bounds them on an H100: memory.  Each element costs a handful of
// flops (M multiply-adds at M servers) against 13 to 26 bytes moved: the
// f32 state rows read and written, the int8 codes, the f32 dither.  At the
// SmolLM-360M wire shape (M = 4, D = 364,904,448 padded elements) the bytes
// per call and their time at 3.35 TB/s are:
//   encode          13 B/elem  19.00 GB   5.67 ms
//   bucketed round  22 B/elem  32.16 GB   9.60 ms
//   pipelined round 26 B/elem  38.00 GB  11.34 ms
//   per-leaf round  18 B/elem  26.10 GB   7.79 ms (summed over the leaves)
//
// Design (a simple one; the point is bit-exactness):
//   * One block owns a slab of whole chunks (about 1024 columns) of EVERY
//     row, so a chunk's absmax is reduced inside one block and every state
//     buffer can be updated in place: the block reads each of its inputs
//     before it overwrites them (the period allocates nothing per round).
//   * Pass 1: each thread walks its columns over all M rows, writes the new
//     f32 state (acc', ref', mixed) and folds |delta| into the slab's
//     per-(row, chunk) absmax in shared memory (a warp-shuffle max, then
//     atomicMax on the bits of a non-negative float: order-free, so
//     exact).  __syncthreads, scales and
//     reciprocals per (row, chunk), __syncthreads.  Pass 2: each thread
//     re-reads its own pass-1 outputs (from L2) and writes the codes.
//   * The pipelined round consumes the DELAYED codes and ships new ones into
//     the same ring slot: its pass 1 only reduces the absmax, and pass 2
//     loads a column's old codes, w, r and acc for every row before it
//     writes anything of that column, so acc may alias w (the iterate IS the
//     accumulator once the first delayed buffer has landed).  Its new scales
//     are written after a last __syncthreads, when no thread reads the old.
//   * Rounding is pinned op by op to the reference's jitted XLA programs:
//     __fmaf_rn where XLA fuses a multiply-add (the encode's x * inv + u,
//     r + q s, acc + (a s) q, the per-leaf mix a0 R0 + a1 R1 + ...),
//     __fmul_rn / __fsub_rn where it does not, 1/s as a true division
//     (__fdiv_rn).  Nothing is left to nvcc's --fmad contraction, and there
//     is no --use_fast_math.  The plain versions in ../ref.py spell out the
//     same operations.
//   * 64-bit offsets: M * D reaches 1.46e9 elements at full size.
//
// C interface, bound with ctypes: each function returns the launch's
// cudaGetLastError() (0 on success).  Tensors are contiguous, row-major
// (M, D) with D a multiple of chunk; scales are (M, D / chunk).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetCols = 1024;  // columns of one slab (whole chunks)
constexpr int kMaxSlots = 2048;    // M * chunks-per-slab (shared memory)
constexpr int kMaxM = 64;

struct Geom {
  int m;
  int chunk;
  long long d;       // columns of a row
  long long nc;      // chunks of a row
  int cpb;           // chunks per slab
  bool warp_chunks;  // chunk % 32 == 0: a warp's 32 columns share a chunk
  float qmax;
  float rq;          // f32(1 / qmax)
};

struct Slab {
  long long chunk0;  // first chunk of this block's slab
  int nch;           // chunks in the slab
  long long col0;    // first column
  int ncols;         // columns in the slab
};

__device__ __forceinline__ Slab slab_of(const Geom& g) {
  Slab s;
  s.chunk0 = (long long)blockIdx.x * g.cpb;
  const long long left = g.nc - s.chunk0;
  s.nch = (int)(left < g.cpb ? left : g.cpb);
  s.col0 = s.chunk0 * g.chunk;
  s.ncols = s.nch * g.chunk;
  return s;
}

// Shared memory: A (M x M), then per (row, local chunk) the absmax bits, the
// scale and its reciprocal.
struct Smem {
  float* a;
  unsigned int* absmax;
  float* scale;
  float* inv;
};

__device__ __forceinline__ Smem smem_layout(float* base, const Geom& g) {
  Smem s;
  s.a = base;
  s.absmax = reinterpret_cast<unsigned int*>(base + g.m * g.m);
  s.scale = base + g.m * g.m + g.m * g.cpb;
  s.inv = base + g.m * g.m + 2 * g.m * g.cpb;
  return s;
}

__device__ __forceinline__ void stage(const Smem& sm, const float* a, const Geom& g,
                                      const Slab& sl) {
  if (a != nullptr) {
    for (int k = threadIdx.x; k < g.m * g.m; k += blockDim.x) sm.a[k] = a[k];
  }
  for (int k = threadIdx.x; k < g.m * g.cpb; k += blockDim.x) sm.absmax[k] = 0u;
  __syncthreads();
}

// Fold |delta| into the (row, chunk) absmax.  When a warp's 32 columns lie
// in one chunk (chunk % 32 == 0; the slab loops then keep whole warps
// converged), the warp reduces first and one lane does the atomic.
__device__ __forceinline__ void fold_absmax(const Smem& sm, const Geom& g, int row, int lc,
                                            float delta) {
  unsigned int v = __float_as_uint(fabsf(delta));
  if (g.warp_chunks) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) != 0) return;
  }
  atomicMax(&sm.absmax[row * g.cpb + lc], v);
}

// Scales and reciprocals of the slab's (row, chunk) cells; the scales are
// also stored to `scales` when it is given.
__device__ __forceinline__ void finish_scales(const Smem& sm, const Geom& g, const Slab& sl,
                                              float* __restrict__ scales) {
  __syncthreads();
  for (int k = threadIdx.x; k < g.m * sl.nch; k += blockDim.x) {
    const int row = k / sl.nch, lc = k % sl.nch;
    const int slot = row * g.cpb + lc;
    const float am = __uint_as_float(sm.absmax[slot]);
    const float s = am > 0.f ? __fmul_rn(am, g.rq) : 1.f;
    sm.scale[slot] = s;
    sm.inv[slot] = __fdiv_rn(1.f, s);
    if (scales != nullptr) scales[(long long)row * g.nc + sl.chunk0 + lc] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ signed char quantize(float delta, float inv, float u, float qmax) {
  float q = floorf(__fmaf_rn(delta, inv, u));
  q = fminf(fmaxf(q, -qmax), qmax);
  return (signed char)(int)q;
}

// ---------------------------------------------------------------------------
// kernel 6: C(w - r; u)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    encode_kernel(const float* __restrict__ w, const float* __restrict__ r,
                  const float* __restrict__ u, signed char* __restrict__ codes,
                  float* __restrict__ scales, Geom g) {
  extern __shared__ float smem_raw[];
  const Slab sl = slab_of(g);
  const Smem sm = smem_layout(smem_raw, g);
  stage(sm, nullptr, g, sl);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    for (int i = 0; i < g.m; ++i) {
      const long long at = (long long)i * g.d + col;
      fold_absmax(sm, g, i, c / g.chunk, __fsub_rn(w[at], r[at]));
    }
  }
  finish_scales(sm, g, sl, scales);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    for (int i = 0; i < g.m; ++i) {
      const long long at = (long long)i * g.d + col;
      codes[at] = quantize(__fsub_rn(w[at], r[at]), sm.inv[i * g.cpb + lc], u[at], g.qmax);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 7: r' = r + q s; acc' = acc + sum_j (a_ij s_j) q_j; C(acc' - r'; u)
// in place on codes, scales, ref and acc.
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreads)
    bucketed_kernel(const float* __restrict__ a, signed char* __restrict__ codes,
                    float* __restrict__ scales, float* __restrict__ ref,
                    float* __restrict__ acc, const float* __restrict__ u, Geom g) {
  extern __shared__ float smem_raw[];
  const Slab sl = slab_of(g);
  const Smem sm = smem_layout(smem_raw, g);
  stage(sm, a, g, sl);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    float q[MT], s[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < g.m) {
        q[j] = (float)codes[(long long)j * g.d + col];
        s[j] = scales[(long long)j * g.nc + sl.chunk0 + lc];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < g.m) {
        const long long at = (long long)i * g.d + col;
        const float r2 = __fmaf_rn(q[i], s[i], ref[at]);
        float acc2 = acc[at];
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j < g.m) acc2 = __fmaf_rn(__fmul_rn(sm.a[i * g.m + j], s[j]), q[j], acc2);
        }
        ref[at] = r2;
        acc[at] = acc2;
        fold_absmax(sm, g, i, lc, __fsub_rn(acc2, r2));
      }
    }
  }
  finish_scales(sm, g, sl, scales);  // every old scale was read in pass 1
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    for (int i = 0; i < g.m; ++i) {
      const long long at = (long long)i * g.d + col;
      codes[at] = quantize(__fsub_rn(acc[at], ref[at]), sm.inv[i * g.cpb + lc], u[at], g.qmax);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 8: q', s' = C(w - r; u); r' = r + q' s'; acc' = acc + sum_j
// (a_ij s_j) q_j over the delayed (q, s); q', s' replace (q, s) in place.
// acc may alias w.
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreads)
    pipelined_kernel(const float* __restrict__ a, signed char* __restrict__ codes,
                     float* __restrict__ scales, const float* w, float* __restrict__ ref,
                     float* acc, const float* __restrict__ u, Geom g) {
  extern __shared__ float smem_raw[];
  const Slab sl = slab_of(g);
  const Smem sm = smem_layout(smem_raw, g);
  stage(sm, a, g, sl);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    for (int i = 0; i < g.m; ++i) {
      const long long at = (long long)i * g.d + col;
      fold_absmax(sm, g, i, c / g.chunk, __fsub_rn(w[at], ref[at]));
    }
  }
  finish_scales(sm, g, sl, nullptr);  // the old scales are still to be read
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    float q[MT], s[MT], wv[MT], rv[MT], av[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < g.m) {
        const long long at = (long long)j * g.d + col;
        q[j] = (float)codes[at];
        s[j] = scales[(long long)j * g.nc + sl.chunk0 + lc];
        wv[j] = w[at];
        rv[j] = ref[at];
        av[j] = acc[at];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < g.m) {
        const long long at = (long long)i * g.d + col;
        const int slot = i * g.cpb + lc;
        const signed char qi = quantize(__fsub_rn(wv[i], rv[i]), sm.inv[slot], u[at], g.qmax);
        float acc2 = av[i];
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j < g.m) acc2 = __fmaf_rn(__fmul_rn(sm.a[i * g.m + j], s[j]), q[j], acc2);
        }
        ref[at] = __fmaf_rn((float)qi, sm.scale[slot], rv[i]);
        acc[at] = acc2;
        codes[at] = qi;
      }
    }
  }
  __syncthreads();  // no thread reads an old scale past this point
  for (int k = threadIdx.x; k < g.m * sl.nch; k += blockDim.x) {
    const int row = k / sl.nch, lc = k % sl.nch;
    scales[(long long)row * g.nc + sl.chunk0 + lc] = sm.scale[row * g.cpb + lc];
  }
}

// ---------------------------------------------------------------------------
// kernel 5: R' = R + q s (every row); W = A R' (a0 R0 + a1 R1 fused, then
// left to right); C(W - R'; u) -- in place on codes, scales and ref.
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreads)
    leaf_kernel(const float* __restrict__ a, signed char* __restrict__ codes,
                float* __restrict__ scales, float* __restrict__ ref, float* __restrict__ mixed,
                const float* __restrict__ u, Geom g) {
  extern __shared__ float smem_raw[];
  const Slab sl = slab_of(g);
  const Smem sm = smem_layout(smem_raw, g);
  stage(sm, a, g, sl);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    float rr[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < g.m) {
        const long long at = (long long)j * g.d + col;
        const float qj = (float)codes[at];
        rr[j] = __fmaf_rn(qj, scales[(long long)j * g.nc + sl.chunk0 + lc], ref[at]);
        ref[at] = rr[j];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < g.m) {
        const float* ai = sm.a + i * g.m;
        constexpr int k1 = MT > 1 ? 1 : 0;  // MT == 1 has one row only
        float mx;
        if (MT == 1 || g.m == 1) {
          mx = __fmul_rn(ai[0], rr[0]);
        } else {
          mx = __fmaf_rn(ai[0], rr[0], __fmul_rn(ai[k1], rr[k1]));
#pragma unroll
          for (int j = 2; j < MT; ++j) {
            if (j < g.m) mx = __fmaf_rn(ai[j], rr[j], mx);
          }
        }
        mixed[(long long)i * g.d + col] = mx;
        fold_absmax(sm, g, i, lc, __fsub_rn(mx, rr[i]));
      }
    }
  }
  finish_scales(sm, g, sl, scales);  // every old scale was read in pass 1
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    for (int i = 0; i < g.m; ++i) {
      const long long at = (long long)i * g.d + col;
      codes[at] = quantize(__fsub_rn(mixed[at], ref[at]), sm.inv[i * g.cpb + lc], u[at], g.qmax);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool make_geom(int m, long long d, int chunk, int bits, Geom* g) {
  if (m < 1 || m > kMaxM || d < 0 || chunk < 1 || d % chunk != 0) return false;
  if (bits != 8 && bits != 4) return false;
  g->m = m;
  g->chunk = chunk;
  g->d = d;
  g->nc = d / chunk;
  int cpb = kTargetCols / chunk;
  if (cpb < 1) cpb = 1;
  if (cpb > kMaxSlots / m) cpb = kMaxSlots / m;
  if (cpb < 1) cpb = 1;
  g->cpb = cpb;
  g->warp_chunks = chunk % 32 == 0;
  const double qmax = bits == 8 ? 127.0 : 7.0;
  g->qmax = (float)qmax;
  g->rq = (float)(1.0 / qmax);
  return true;
}

size_t smem_bytes(const Geom& g) {
  return sizeof(float) * ((size_t)g.m * g.m + 3 * (size_t)g.m * g.cpb);
}

unsigned grid_of(const Geom& g) { return (unsigned)((g.nc + g.cpb - 1) / g.cpb); }

#define WIRE_DISPATCH_MT(KERNEL, G, STREAM, ...)                                        \
  do {                                                                                  \
    const size_t sm_ = smem_bytes(G);                                                   \
    const unsigned gr_ = grid_of(G);                                                    \
    if ((G).m <= 1) KERNEL<1><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);          \
    else if ((G).m <= 2) KERNEL<2><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);     \
    else if ((G).m <= 4) KERNEL<4><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);     \
    else if ((G).m <= 8) KERNEL<8><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);     \
    else if ((G).m <= 16) KERNEL<16><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);   \
    else if ((G).m <= 32) KERNEL<32><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);   \
    else KERNEL<64><<<gr_, kThreads, sm_, STREAM>>>(__VA_ARGS__, G);                    \
  } while (0)

}  // namespace

extern "C" int wire_encode_f32(const void* w, const void* r, const void* u, void* codes,
                               void* scales, int m, long long d, int chunk, int bits,
                               void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  encode_kernel<<<grid_of(g), kThreads, smem_bytes(g), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(r),
      static_cast<const float*>(u), static_cast<signed char*>(codes),
      static_cast<float*>(scales), g);
  return (int)cudaGetLastError();
}

extern "C" int wire_bucketed_round_f32(const void* a, void* codes, void* scales, void* ref,
                                       void* acc, const void* u, int m, long long d, int chunk,
                                       int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WIRE_DISPATCH_MT(bucketed_kernel, g, s, static_cast<const float*>(a),
                   static_cast<signed char*>(codes), static_cast<float*>(scales),
                   static_cast<float*>(ref), static_cast<float*>(acc),
                   static_cast<const float*>(u));
  return (int)cudaGetLastError();
}

extern "C" int wire_pipelined_round_f32(const void* a, void* codes, void* scales, const void* w,
                                        void* ref, void* acc, const void* u, int m, long long d,
                                        int chunk, int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WIRE_DISPATCH_MT(pipelined_kernel, g, s, static_cast<const float*>(a),
                   static_cast<signed char*>(codes), static_cast<float*>(scales),
                   static_cast<const float*>(w), static_cast<float*>(ref),
                   static_cast<float*>(acc), static_cast<const float*>(u));
  return (int)cudaGetLastError();
}

extern "C" int wire_leaf_round_f32(const void* a, void* codes, void* scales, void* ref,
                                   void* mixed, const void* u, int m, long long d, int chunk,
                                   int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WIRE_DISPATCH_MT(leaf_kernel, g, s, static_cast<const float*>(a),
                   static_cast<signed char*>(codes), static_cast<float*>(scales),
                   static_cast<float*>(ref), static_cast<float*>(mixed),
                   static_cast<const float*>(u));
  return (int)cudaGetLastError();
}
