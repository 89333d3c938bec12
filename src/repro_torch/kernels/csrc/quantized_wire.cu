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
// and the pipelined round's row form (one own row of M = 4 gathered ones:
// 4 delayed codes, w, u, ref and acc read, ref, acc and the new code
// written, 29 bytes a column) 10.61 GB, 3.17 ms.
//
// Kernels 5, 6 and 7 (a simple design; the point is bit-exactness):
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
//
// Kernel 8, the pipelined round, consumes the DELAYED codes and ships new
// ones (in the square call into the same ring slot, in place).  What held
// its first, two-pass design at 0.43-0.59 of the bound: w and r read twice
// (once for the absmax, once to quantize), 4-byte and 1-byte accesses, and
// a third of a million small blocks each passing four barriers with no load
// in flight across them.  Its resident body (pipelined_kernel) instead:
//   * A thread owns VEC consecutive columns (VEC = 4: 16-byte loads and
//     stores of w, r, acc, u, r' and acc', one 4-byte load of each gathered
//     row's delayed codes and one 4-byte store of its new ones) in G column
//     groups of a slab of whole chunks, for up to four own rows (two groups
//     at one own row, a 2048-column slab; one at up to four, 1024).
//   * Each operand is read once, into registers: phase 1 forms delta =
//     w - r (kept), acc' (stored at once: w and acc of the column are
//     already loaded, so acc may be w) and folds |delta| into the slab's
//     (row, chunk) absmax: a warp shuffle over the chunk's lanes, then one
//     atomicMax a warp and chunk into shared memory.  One __syncthreads,
//     then phase 2 quantizes from registers and stores r', the codes and
//     the slab's scales.  The absmax slots rotate through three sets, so one
//     barrier a slab suffices.
//   * A persistent grid (as many blocks as fit on the card) walks the
//     slabs, and each block issues the NEXT slab's loads before it waits at
//     the barrier, so they are in flight across it (register double
//     buffering).  The delayed codes and scales of the first four gathered
//     rows ride in that prefetch; phase 1 reads any further rows' itself.
//   * In the square call the delayed codes of a column are read by the
//     thread that later writes that column's new codes, every old scale of
//     a slab is read before its barrier and the new ones stored after it,
//     and the prefetched slab is disjoint from the one being written, so
//     the in-place update is safe.
//   * The C entry point picks the instance: VEC = 4 when chunk and D are
//     multiples of 4 and w, r, acc, u are 16-byte and the codes 4-byte
//     aligned, else VEC = 1 (any chunk the wire accepts); more than four
//     own rows (one process holding more than four servers) or a chunk
//     wider than the slab run the two-pass body (pipelined_twopass_kernel,
//     which re-reads w and r); wire_pipelined_instance() names the last one
//     launched, for the wrapper's per-instance count.
//
// All four:
//   * Rounding is pinned op by op to the reference's jitted XLA programs:
//     __fmaf_rn where XLA fuses a multiply-add (the encode's x * inv + u,
//     r + q s, acc + (a s) q, the per-leaf mix a0 R0 + a1 R1 + ...),
//     __fmul_rn / __fsub_rn where it does not, 1/s as a true division
//     (__fdiv_rn).  Nothing is left to nvcc's --fmad contraction, and there
//     is no --use_fast_math.  The plain versions in ../ref.py spell out the
//     same operations; kernel 8's bodies run them in the same order, so
//     either is bitwise the plain version.
//   * 64-bit offsets: M * D reaches 1.46e9 elements at full size.
//   * Row forms of kernels 7 and 8 (wire_bucketed_round_rows_f32,
//     wire_pipelined_round_rows_f32), for a rank of the multi-process wire
//     that gathers all M rows of codes and scales but owns M_out of them,
//     starting at row0: A is (M_out, M), the gathered codes and scales are
//     a read-only (M, .) input, ref / acc / w / u have M_out rows, and the
//     next codes and scales go to separate (M_out, .) buffers (the gathered
//     buffer is the receive buffer; it cannot be overwritten).  Each element
//     runs the same operations in the same order as in the square call, so
//     row r of a row form is bitwise row r of the square call; the square
//     entry points are the row forms with M_out = M, row0 = 0 and the code
//     and scale outputs equal to the inputs.  The code and scale pointers
//     may therefore alias and carry no __restrict__.
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
  int m;             // rows of the gathered codes and scales (and of A's rows)
  int m_out;         // rows of the state buffers and of the output codes
  int row0;          // the first own row among the m (the row-form offset)
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

// Shared memory: A (M_out x M), then per (own row, local chunk) the absmax
// bits, the scale and its reciprocal.
struct Smem {
  float* a;
  unsigned int* absmax;
  float* scale;
  float* inv;
};

__device__ __forceinline__ Smem smem_layout(float* base, const Geom& g) {
  Smem s;
  s.a = base;
  s.absmax = reinterpret_cast<unsigned int*>(base + g.m_out * g.m);
  s.scale = base + g.m_out * g.m + g.m_out * g.cpb;
  s.inv = base + g.m_out * g.m + 2 * g.m_out * g.cpb;
  return s;
}

__device__ __forceinline__ void stage(const Smem& sm, const float* a, const Geom& g,
                                      const Slab& sl) {
  if (a != nullptr) {
    for (int k = threadIdx.x; k < g.m_out * g.m; k += blockDim.x) sm.a[k] = a[k];
  }
  for (int k = threadIdx.x; k < g.m_out * g.cpb; k += blockDim.x) sm.absmax[k] = 0u;
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
                                              float* scales) {
  __syncthreads();
  for (int k = threadIdx.x; k < g.m_out * sl.nch; k += blockDim.x) {
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
// kernel 7: r' = r + q s; acc' = acc + sum_j (a_ij s_j) q_j; C(acc' - r'; u).
// The square call is in place on codes, scales, ref and acc; the row form
// reads the gathered (codes_in, scales_in) and writes (codes_out,
// scales_out).
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreads)
    bucketed_kernel(const float* __restrict__ a, const signed char* codes_in,
                    const float* scales_in, float* __restrict__ ref, float* __restrict__ acc,
                    const float* __restrict__ u, signed char* codes_out, float* scales_out,
                    Geom g) {
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
        q[j] = (float)codes_in[(long long)j * g.d + col];
        s[j] = scales_in[(long long)j * g.nc + sl.chunk0 + lc];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < g.m_out) {
        // the own row's code and scale: row i itself in the square call
        // (an unrolled index, kept in registers); in a row form, read again
        // (an L1 hit) rather than picked out of the register arrays by a
        // run-time index.  The branch is uniform across the grid.
        float qo, so;
        if (g.m_out == g.m) {
          qo = q[i];
          so = s[i];
        } else {
          const int gi = g.row0 + i;
          qo = (float)codes_in[(long long)gi * g.d + col];
          so = scales_in[(long long)gi * g.nc + sl.chunk0 + lc];
        }
        const long long at = (long long)i * g.d + col;
        const float r2 = __fmaf_rn(qo, so, ref[at]);
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
  finish_scales(sm, g, sl, scales_out);  // every old scale was read in pass 1
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    for (int i = 0; i < g.m_out; ++i) {
      const long long at = (long long)i * g.d + col;
      codes_out[at] = quantize(__fsub_rn(acc[at], ref[at]), sm.inv[i * g.cpb + lc], u[at], g.qmax);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 8: q', s' = C(w - r; u); r' = r + q' s'; acc' = acc + sum_j
// (a_ij s_j) q_j over the delayed (q, s).  The square call writes q', s'
// over (q, s) in place; the row form reads the gathered delayed (codes_in,
// scales_in) and writes (codes_out, scales_out).  acc may alias w.
// ---------------------------------------------------------------------------

constexpr int kPreRows = 4;     // gathered rows whose delayed codes ride in the prefetch
constexpr int kAbsmaxSets = 3;  // absmax slot sets in rotation (one barrier a slab)

// The resident body's geometry: a slab is `cpb` whole chunks of every own
// row, at most one tile of kThreads * VEC * G columns.
struct PGeom {
  int m, m_out, chunk, cpb;
  long long d, nc, nslabs;
  float qmax, rq;
  bool warp_chunks;  // chunk % (32 * VEC) == 0: a warp's columns lie in one chunk
};

// column groups a thread holds: two at one own row, one at up to four
template <int RG>
__host__ __device__ constexpr int col_groups() { return RG == 1 ? 2 : 1; }

template <int VEC>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void ld_vec_stream(const float* p, float* v) {  // read once: evict first
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// VEC codes as one word (code e in byte e)
template <int VEC>
__device__ __forceinline__ unsigned ld_codes(const signed char* p) {
  if constexpr (VEC == 4) return *reinterpret_cast<const unsigned*>(p);
  else return (unsigned)(unsigned char)*p;
}

template <int VEC>
__device__ __forceinline__ void st_codes(signed char* p, unsigned word) {
  if constexpr (VEC == 4) *reinterpret_cast<unsigned*>(p) = word;
  else *p = (signed char)(unsigned char)word;
}

__device__ __forceinline__ float code_at(unsigned word, int e) {
  return (float)(int)(signed char)(unsigned char)(word >> (8 * e));
}

// Fold |delta| of a thread's VEC columns of one row into the slab's
// (row, chunk) absmax: a max over the chunk's lanes of the warp by shuffles
// (a butterfly when the whole warp lies in one chunk, else a segmented max
// down to each chunk's first lane), then one atomicMax on the bits of a
// non-negative float (order-free, so exact) by that lane.  Every lane of the
// warp calls it; `valid` is false past the slab's last column.
template <int VEC>
__device__ __forceinline__ void fold_vec(unsigned* slots, const PGeom& g, int row, int lc,
                                         bool valid, const float* delta) {
  unsigned v = 0u;
  if (valid) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v = max(v, __float_as_uint(fabsf(delta[e])));
  }
  const int lane = threadIdx.x & 31;
  if (g.warp_chunks) {  // validity is uniform across the warp here
    if (!valid) return;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) atomicMax(&slots[row * g.cpb + lc], v);
    return;
  }
  const int seg = valid ? lc : -1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned ov = __shfl_down_sync(0xffffffffu, v, o);
    const int os = __shfl_down_sync(0xffffffffu, seg, o);
    if (lane + o < 32 && os == seg) v = max(v, ov);
  }
  const int prev = __shfl_up_sync(0xffffffffu, seg, 1);
  if (valid && (lane == 0 || prev != seg)) atomicMax(&slots[row * g.cpb + lc], v);
}

__device__ __forceinline__ float scale_of(unsigned bits, float rq) {
  const float am = __uint_as_float(bits);
  return am > 0.f ? __fmul_rn(am, rq) : 1.f;
}

// What a thread loads of one slab: its G column groups of VEC columns for
// RG own rows, and the delayed codes and scales of the first kPreRows
// gathered rows at those columns.
template <int RG, int VEC, int G>
struct Tile {
  float w[G][RG][VEC], r[G][RG][VEC], a[G][RG][VEC], u[G][RG][VEC];
  unsigned q[G][kPreRows];
  float s[G][kPreRows];
};

struct SlabPos {
  long long chunk0, col0;
  int nch, ncols;
};

__device__ __forceinline__ SlabPos slab_pos(const PGeom& g, long long sidx) {
  SlabPos p;
  p.chunk0 = sidx * g.cpb;
  const long long left = g.nc - p.chunk0;
  p.nch = (int)(left < g.cpb ? left : g.cpb);
  p.col0 = p.chunk0 * g.chunk;
  p.ncols = p.nch * g.chunk;
  return p;
}

template <int RG, int VEC, int G>
__device__ __forceinline__ void load_tile(Tile<RG, VEC, G>& t, const PGeom& g,
                                          const SlabPos& p, const signed char* codes_in,
                                          const float* scales_in, const float* w,
                                          const float* ref, const float* acc,
                                          const float* u) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int c = (k * kThreads + threadIdx.x) * VEC;
    if (c < p.ncols) {
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        if (i < g.m_out) {
          const long long at = (long long)i * g.d + p.col0 + c;
          ld_vec<VEC>(w + at, t.w[k][i]);
          ld_vec<VEC>(ref + at, t.r[k][i]);
          ld_vec<VEC>(acc + at, t.a[k][i]);
          ld_vec_stream<VEC>(u + at, t.u[k][i]);
        }
      }
      const long long ch = p.chunk0 + c / g.chunk;
#pragma unroll
      for (int j = 0; j < kPreRows; ++j) {
        if (j < g.m) {
          t.q[k][j] = ld_codes<VEC>(codes_in + (long long)j * g.d + p.col0 + c);
          t.s[k][j] = scales_in[(long long)j * g.nc + ch];
        }
      }
    }
  }
}

// One (a_ij s_j) q_j term of every own row of one column group.
template <int RG, int VEC>
__device__ __forceinline__ void mix_term(float (*a)[VEC], const float* sa, const PGeom& g,
                                         int j, unsigned qw, float sj) {
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    if (i < g.m_out) {
      const float ws = __fmul_rn(sa[i * g.m + j], sj);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[i][e] = __fmaf_rn(ws, code_at(qw, e), a[i][e]);
    }
  }
}

// The resident body, for m_out <= 4 own rows and a chunk no wider than a
// tile.  A persistent grid: block b walks slabs b, b + gridDim.x, ...  A
// thread owns VEC consecutive columns in each of its G column groups and
// loads every operand of a slab once, into registers, one slab ahead:
//   phase 1: delta = w - r (kept), acc' = acc + sum_j (a_ij s_j) q_j
//            (stored: acc and w of these columns are already loaded, so acc
//            may be w), |delta| folded into the slab's absmax set;
//   then the NEXT slab's loads are issued, and one __syncthreads;
//   phase 2: s, 1/s per (row, chunk); q' = C(delta; u), r' = r + q' s'
//            stored, the slab's new scales stored (every old one of the slab
//            was read in phase 1 or in the prefetch, before the barrier);
//            the absmax set of the slab after next is cleared.
// In the square call the delayed codes of a column are read (prefetched) by
// the thread that later writes that column's new codes, so the in-place
// update is safe; the prefetched slab is disjoint from the one written.
template <int RG, int VEC>
__global__ void __launch_bounds__(kThreads)
    pipelined_kernel(const float* __restrict__ a, const signed char* codes_in,
                     const float* scales_in, const float* w, float* ref, float* acc,
                     const float* __restrict__ u, signed char* codes_out, float* scales_out,
                     PGeom g) {
  constexpr int G = col_groups<RG>();
  extern __shared__ float smem_raw[];
  float* sa = smem_raw;
  const int slots = g.m_out * g.cpb;
  unsigned* absmax = reinterpret_cast<unsigned*>(smem_raw + g.m_out * g.m);
  for (int k = threadIdx.x; k < g.m_out * g.m; k += blockDim.x) sa[k] = a[k];
  for (int k = threadIdx.x; k < kAbsmaxSets * slots; k += blockDim.x) absmax[k] = 0u;
  __syncthreads();
  Tile<RG, VEC, G> cur;
  long long sidx = blockIdx.x;
  if (sidx < g.nslabs)
    load_tile(cur, g, slab_pos(g, sidx), codes_in, scales_in, w, ref, acc, u);
  for (int it = 0; sidx < g.nslabs; ++it, sidx += gridDim.x) {
    const SlabPos p = slab_pos(g, sidx);
    unsigned* set = absmax + (it % kAbsmaxSets) * slots;
    // ---- phase 1 ----
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int c = (k * kThreads + threadIdx.x) * VEC;
      const bool valid = c < p.ncols;
      const int lc = valid ? c / g.chunk : 0;
      if (valid) {
#pragma unroll
        for (int j = 0; j < kPreRows; ++j) {
          if (j < g.m) mix_term<RG, VEC>(cur.a[k], sa, g, j, cur.q[k][j], cur.s[k][j]);
        }
        for (int j = kPreRows; j < g.m; ++j) {
          const unsigned qw = ld_codes<VEC>(codes_in + (long long)j * g.d + p.col0 + c);
          const float sj = scales_in[(long long)j * g.nc + p.chunk0 + lc];
          mix_term<RG, VEC>(cur.a[k], sa, g, j, qw, sj);
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          if (i < g.m_out) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) cur.w[k][i][e] = __fsub_rn(cur.w[k][i][e], cur.r[k][i][e]);
            st_vec<VEC>(acc + (long long)i * g.d + p.col0 + c, cur.a[k][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        if (i < g.m_out) fold_vec<VEC>(set, g, i, lc, valid, cur.w[k][i]);
      }
    }
    // ---- the next slab's loads, in flight across the barrier ----
    Tile<RG, VEC, G> nxt;
    const long long nidx = sidx + gridDim.x;
    if (nidx < g.nslabs)
      load_tile(nxt, g, slab_pos(g, nidx), codes_in, scales_in, w, ref, acc, u);
    __syncthreads();
    // ---- phase 2 ----
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int c = (k * kThreads + threadIdx.x) * VEC;
      if (c < p.ncols) {
        const int lc = c / g.chunk;
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          if (i < g.m_out) {
            const float s = scale_of(set[i * g.cpb + lc], g.rq);
            const float inv = __fdiv_rn(1.f, s);
            float rn[VEC];
            unsigned word = 0u;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const signed char q = quantize(cur.w[k][i][e], inv, cur.u[k][i][e], g.qmax);
              rn[e] = __fmaf_rn((float)q, s, cur.r[k][i][e]);
              word |= (unsigned)(unsigned char)q << (8 * e);
            }
            const long long at = (long long)i * g.d + p.col0 + c;
            st_vec<VEC>(ref + at, rn);
            st_codes<VEC>(codes_out + at, word);
          }
        }
      }
    }
    for (int k = threadIdx.x; k < g.m_out * p.nch; k += blockDim.x) {
      const int row = k / p.nch, lc = k - row * p.nch;
      scales_out[(long long)row * g.nc + p.chunk0 + lc] = scale_of(set[row * g.cpb + lc], g.rq);
    }
    // the set of slab it - 1: every thread has read it (it is past this
    // slab's barrier); slab it + 2 folds into it after slab it + 1's barrier
    unsigned* stale = absmax + ((it + 2) % kAbsmaxSets) * slots;
    for (int k = threadIdx.x; k < slots; k += blockDim.x) stale[k] = 0u;
    cur = nxt;
  }
}

// The two-pass body, for more than four own rows (one process holding more
// than four servers) or a chunk wider than a tile: one block a slab of
// whole chunks (about 1024 columns) of every own row.  Pass 1 folds
// |w - r| into the absmax; pass 2 reads w, r (again), acc, u and the
// delayed codes and writes everything.  A column's delayed codes and
// scales of the MT (>= M) gathered rows are loaded once into registers
// through the read-only cache before any of its new codes is written (the
// thread that reads a column's codes is the one that writes them, and the
// new scales are written after a last __syncthreads, so no cached line goes
// stale and the square call may update them in place); a run-time loop
// over the own rows then reads and writes one row's w, r, acc and u at a
// time, so only the 2 MT delayed values live in registers (no spills at
// MT = 64).
template <int MT>
__global__ void __launch_bounds__(kThreads)
    pipelined_twopass_kernel(const float* __restrict__ a, const signed char* codes_in,
                             const float* scales_in, const float* w, float* ref, float* acc,
                             const float* __restrict__ u, signed char* codes_out,
                             float* scales_out, Geom g) {
  extern __shared__ float smem_raw[];
  const Slab sl = slab_of(g);
  const Smem sm = smem_layout(smem_raw, g);
  stage(sm, a, g, sl);
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    for (int i = 0; i < g.m_out; ++i) {
      const long long at = (long long)i * g.d + col;
      fold_absmax(sm, g, i, c / g.chunk, __fsub_rn(w[at], ref[at]));
    }
  }
  finish_scales(sm, g, sl, nullptr);  // the old scales are still to be read
  for (int c = threadIdx.x; c < sl.ncols; c += blockDim.x) {
    const long long col = sl.col0 + c;
    const int lc = c / g.chunk;
    float q[MT], s[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < g.m) {
        q[j] = (float)__ldg(&codes_in[(long long)j * g.d + col]);
        s[j] = __ldg(&scales_in[(long long)j * g.nc + sl.chunk0 + lc]);
      }
    }
    for (int i = 0; i < g.m_out; ++i) {
      const long long at = (long long)i * g.d + col;
      const int slot = i * g.cpb + lc;
      const float wv = w[at], rv = ref[at];
      float acc2 = acc[at];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j < g.m) acc2 = __fmaf_rn(__fmul_rn(sm.a[i * g.m + j], s[j]), q[j], acc2);
      }
      const signed char qi = quantize(__fsub_rn(wv, rv), sm.inv[slot], u[at], g.qmax);
      ref[at] = __fmaf_rn((float)qi, sm.scale[slot], rv);
      acc[at] = acc2;
      codes_out[at] = qi;
    }
  }
  __syncthreads();  // no thread reads an old scale past this point
  for (int k = threadIdx.x; k < g.m_out * sl.nch; k += blockDim.x) {
    const int row = k / sl.nch, lc = k % sl.nch;
    scales_out[(long long)row * g.nc + sl.chunk0 + lc] = sm.scale[row * g.cpb + lc];
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

bool make_geom(int m, long long d, int chunk, int bits, Geom* g, int m_out = -1,
               int row0 = 0) {
  if (m_out < 0) m_out = m;
  if (m < 1 || m > kMaxM || d < 0 || chunk < 1 || d % chunk != 0) return false;
  if (m_out < 1 || m_out > m || row0 < 0 || row0 + m_out > m) return false;
  if (bits != 8 && bits != 4) return false;
  g->m = m;
  g->m_out = m_out;
  g->row0 = row0;
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
  return sizeof(float) * ((size_t)g.m_out * g.m + 3 * (size_t)g.m_out * g.cpb);
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

const char* g_pipelined_instance = "none";

bool aligned(const void* p, unsigned n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

struct PipelinedArgs {
  const float* a;
  const signed char* codes_in;
  const float* scales_in;
  const float* w;
  float* ref;
  float* acc;
  const float* u;
  signed char* codes_out;
  float* scales_out;
  cudaStream_t stream;
};

// Launch the resident body on a persistent grid: as many blocks as fit on
// the card at once (registers bound it), at most one a slab.
template <int RG, int VEC>
int launch_resident(const PipelinedArgs& p, const Geom& geom) {
  constexpr int tile = kThreads * VEC * col_groups<RG>();
  PGeom g;
  g.m = geom.m;
  g.m_out = geom.m_out;
  g.chunk = geom.chunk;
  g.cpb = tile / geom.chunk;
  g.d = geom.d;
  g.nc = geom.nc;
  g.nslabs = (g.nc + g.cpb - 1) / g.cpb;
  g.qmax = geom.qmax;
  g.rq = geom.rq;
  g.warp_chunks = geom.chunk % (32 * VEC) == 0;
  const size_t smem =
      sizeof(float) * ((size_t)g.m_out * g.m + (size_t)kAbsmaxSets * g.m_out * g.cpb);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pipelined_kernel<RG, VEC>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sm_count();
  if (grid > g.nslabs) grid = g.nslabs;
  pipelined_kernel<RG, VEC><<<(unsigned)grid, kThreads, smem, p.stream>>>(
      p.a, p.codes_in, p.scales_in, p.w, p.ref, p.acc, p.u, p.codes_out, p.scales_out, g);
  g_pipelined_instance = VEC == 4 ? (RG == 1 ? "vec4.own1" : "vec4.own4")
                                  : (RG == 1 ? "vec1.own1" : "vec1.own4");
  return (int)cudaGetLastError();
}

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

// Row form of kernel 7: a (m_out, m); codes_in (m, d) int8 and scales_in
// (m, d / chunk) read only; ref, acc, u (m_out, d); codes_out (m_out, d) and
// scales_out (m_out, d / chunk) written; row0 the first own row.
extern "C" int wire_bucketed_round_rows_f32(const void* a, const void* codes_in,
                                            const void* scales_in, void* ref, void* acc,
                                            const void* u, void* codes_out, void* scales_out,
                                            int m_out, int row0, int m, long long d, int chunk,
                                            int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g, m_out, row0)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WIRE_DISPATCH_MT(bucketed_kernel, g, s, static_cast<const float*>(a),
                   static_cast<const signed char*>(codes_in),
                   static_cast<const float*>(scales_in), static_cast<float*>(ref),
                   static_cast<float*>(acc), static_cast<const float*>(u),
                   static_cast<signed char*>(codes_out), static_cast<float*>(scales_out));
  return (int)cudaGetLastError();
}

extern "C" int wire_bucketed_round_f32(const void* a, void* codes, void* scales, void* ref,
                                       void* acc, const void* u, int m, long long d, int chunk,
                                       int bits, void* stream) {
  return wire_bucketed_round_rows_f32(a, codes, scales, ref, acc, u, codes, scales, m, 0, m, d,
                                      chunk, bits, stream);
}

// Row form of kernel 8: a (m_out, m); the delayed codes_in (m, d) and
// scales_in (m, d / chunk) read only; w, ref, acc, u (m_out, d), acc may be
// w; this round's codes_out (m_out, d) and scales_out (m_out, d / chunk).
extern "C" int wire_pipelined_round_rows_f32(const void* a, const void* codes_in,
                                             const void* scales_in, const void* w, void* ref,
                                             void* acc, const void* u, void* codes_out,
                                             void* scales_out, int m_out, int m, long long d,
                                             int chunk, int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g, m_out, 0)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  const PipelinedArgs p{static_cast<const float*>(a), static_cast<const signed char*>(codes_in),
                        static_cast<const float*>(scales_in), static_cast<const float*>(w),
                        static_cast<float*>(ref), static_cast<float*>(acc),
                        static_cast<const float*>(u), static_cast<signed char*>(codes_out),
                        static_cast<float*>(scales_out), static_cast<cudaStream_t>(stream)};
  const bool vec4 = chunk % 4 == 0 && d % 4 == 0 && aligned(w, 16) && aligned(ref, 16) &&
                    aligned(acc, 16) && aligned(u, 16) && aligned(codes_in, 4) &&
                    aligned(codes_out, 4);
  const int tile = kThreads * (vec4 ? 4 : 1) * (m_out == 1 ? 2 : 1);
  if (m_out <= 4 && chunk <= tile) {
    if (m_out == 1) return vec4 ? launch_resident<1, 4>(p, g) : launch_resident<1, 1>(p, g);
    return vec4 ? launch_resident<4, 4>(p, g) : launch_resident<4, 1>(p, g);
  }
  WIRE_DISPATCH_MT(pipelined_twopass_kernel, g, p.stream, p.a, p.codes_in, p.scales_in, p.w,
                   p.ref, p.acc, p.u, p.codes_out, p.scales_out);
  g_pipelined_instance = "twopass";
  return (int)cudaGetLastError();
}

extern "C" int wire_pipelined_round_f32(const void* a, void* codes, void* scales, const void* w,
                                        void* ref, void* acc, const void* u, int m, long long d,
                                        int chunk, int bits, void* stream) {
  return wire_pipelined_round_rows_f32(a, codes, scales, w, ref, acc, u, codes, scales, m, m, d,
                                       chunk, bits, stream);
}

// The instance of kernel 8 that the last wire_pipelined_round*_f32 call
// of this process launched: "vec<VEC>.own<1|4>" for the resident body (VEC
// columns a thread, one or up to four own rows), "twopass" for the
// two-pass body.
extern "C" const char* wire_pipelined_instance() { return g_pipelined_instance; }

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
