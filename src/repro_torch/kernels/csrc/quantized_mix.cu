// quantized_mix: kernel 4, the simulated wire's fused quantize -> dequantize
// -> mix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantized_consensus_mix_2d of
// src/repro/kernels/consensus_mix.py (:124, body :96-121):
//   out = A_eff . D(C(w; u))
// where C is the stochastic quantizer of comm.compressors.StochasticQuantizer:
// per (row, chunk) the scale s = absmax > 0 ? absmax * f32(1/qmax) : 1, the
// codes q = clip(floor(w * (1/s) + u), -qmax, qmax), the decoded values
// q * s, then the M-term contraction over the rows (the servers).  The codes
// and the decoded values never reach memory.
//
// What bounds it on an H100: memory.  Each element costs M multiply-adds
// (M = 4 on the main path) against 12 bytes moved: w and u read, out
// written (4 B each), plus the (M, M) A.  At the SmolLM-360M layout (M = 4,
// 372,179,968 padded columns, summed over the leaves) that is 17.87 GB, or
// 5.33 ms at 3.35 TB/s.
//
// Design (a simple one; the point is bit-exactness against ../ref.py):
//   * One block owns a slab of whole chunks (about 1024 columns) of EVERY
//     row, so a chunk's absmax is reduced inside one block: a warp-shuffle
//     max where a warp's 32 columns share a chunk, then atomicMax on the
//     bits of a non-negative float in shared memory (order-free, so exact).
//   * Pass 1 folds |w| into the slab's per-(row, chunk) absmax; after a
//     __syncthreads the scales and their reciprocals are set per cell.
//     Pass 2: each thread takes one column, loads w and u of every row,
//     quantizes and decodes them in registers, and writes the column's M
//     mixed outputs.  A column is read whole before it is written, and by
//     the thread that writes it, so out may be w or u itself (in place).
//   * Rounding is pinned op by op: the encode's multiply-add is one
//     rounding (__fmaf_rn, as the reference's jitted quantizer and the
//     Pallas body round it), 1/s a true division (__fdiv_rn), s and the
//     decode plain products (__fmul_rn), and the contraction a left-to-right
//     chain acc = __fmaf_rn(a_ij, deq_j, acc) from acc = +0.  Nothing is
//     left to nvcc's --fmad contraction, and there is no --use_fast_math.
//     With A = I the chain is exact, so the output is D(C(w)) itself.
//   * 64-bit offsets: M * D reaches 2e8 elements a leaf at full size.
//
// C interface, bound with ctypes: the function returns the launch's
// cudaGetLastError() (0 on success).  Tensors are contiguous, row-major
// (M, D) float32 with D a multiple of chunk; A is (M, M) float32.

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

// Shared memory: A (M x M), then per (row, local chunk) the absmax bits, the
// scale and its reciprocal.
__device__ __forceinline__ void smem_layout(float* base, const Geom& g, float** a,
                                            unsigned int** absmax, float** scale,
                                            float** inv) {
  *a = base;
  *absmax = reinterpret_cast<unsigned int*>(base + g.m * g.m);
  *scale = base + g.m * g.m + g.m * g.cpb;
  *inv = base + g.m * g.m + 2 * g.m * g.cpb;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    quant_mix_kernel(const float* __restrict__ a_in, const float* w, const float* u,
                     float* out, Geom g) {
  extern __shared__ float smem_raw[];
  float *sa, *sscale, *sinv;
  unsigned int* sabs;
  smem_layout(smem_raw, g, &sa, &sabs, &sscale, &sinv);

  const long long chunk0 = (long long)blockIdx.x * g.cpb;
  const long long left = g.nc - chunk0;
  const int nch = (int)(left < g.cpb ? left : g.cpb);
  const long long col0 = chunk0 * g.chunk;
  const int ncols = nch * g.chunk;

  for (int k = threadIdx.x; k < g.m * g.m; k += blockDim.x) sa[k] = a_in[k];
  for (int k = threadIdx.x; k < g.m * g.cpb; k += blockDim.x) sabs[k] = 0u;
  __syncthreads();

  // pass 1: per-(row, chunk) absmax of w
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const long long col = col0 + c;
    const int lc = c / g.chunk;
    for (int i = 0; i < g.m; ++i) {
      unsigned int v = __float_as_uint(fabsf(w[(long long)i * g.d + col]));
      if (g.warp_chunks) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
        if ((threadIdx.x & 31) != 0) continue;
      }
      atomicMax(&sabs[i * g.cpb + lc], v);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < g.m * nch; k += blockDim.x) {
    const int row = k / nch, lc = k % nch;
    const int slot = row * g.cpb + lc;
    const float am = __uint_as_float(sabs[slot]);
    const float s = am > 0.f ? __fmul_rn(am, g.rq) : 1.f;
    sscale[slot] = s;
    sinv[slot] = __fdiv_rn(1.f, s);
  }
  __syncthreads();

  // pass 2: quantize, decode and mix one column per thread
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const long long col = col0 + c;
    const int lc = c / g.chunk;
    float deq[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < g.m) {
        const long long at = (long long)j * g.d + col;
        const int slot = j * g.cpb + lc;
        float q = floorf(__fmaf_rn(w[at], sinv[slot], u[at]));
        q = fminf(fmaxf(q, -g.qmax), g.qmax);
        deq[j] = __fmul_rn(q, sscale[slot]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < g.m) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j < g.m) acc = __fmaf_rn(sa[i * g.m + j], deq[j], acc);
        }
        out[(long long)i * g.d + col] = acc;
      }
    }
  }
}

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

}  // namespace

extern "C" int quantized_mix_f32(const void* a, const void* w, const void* u, void* out, int m,
                                 long long d, int chunk, int bits, void* stream) {
  Geom g;
  if (!make_geom(m, d, chunk, bits, &g)) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)g.m * g.m + 3 * (size_t)g.m * g.cpb);
  const unsigned grid = (unsigned)((g.nc + g.cpb - 1) / g.cpb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pw = static_cast<const float*>(w);
  const float* pu = static_cast<const float*>(u);
  float* po = static_cast<float*>(out);
  if (m <= 1) quant_mix_kernel<1><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else if (m <= 2) quant_mix_kernel<2><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else if (m <= 4) quant_mix_kernel<4><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else if (m <= 8) quant_mix_kernel<8><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else if (m <= 16) quant_mix_kernel<16><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else if (m <= 32) quant_mix_kernel<32><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  else quant_mix_kernel<64><<<grid, kThreads, smem, s>>>(pa, pw, pu, po, g);
  return (int)cudaGetLastError();
}
