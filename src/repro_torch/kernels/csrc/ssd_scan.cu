// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan in the model layout.
//
// Replaces the Pallas TPU kernel ssd_scan_bhs (src/repro/kernels/ssd_scan.py:92, body
// _ssd_kernel at :32).  Over chunks of q = min(chunk, s) steps, for every (batch, head):
//   cum_t  = sum_{j <= t in chunk} dt_j * A_h          (inclusive; total = cum of the last step)
//   y_t    = sum_{k <= t} (C_t . B_k) exp(cum_t - cum_k) dt_k x_k  +  exp(cum_t) C_t . h
//   h     <- exp(total) h + sum_k (B_k exp(total - cum_k) dt_k) x_k'
// and returns y (b, s, nh, hd) and the final h (b, nh, ds, hd), both f32.  x is read as
// (b, s, nh, hd), B and C as group 0 of (b, s, 1, ds) and dt as (b, s, nh), all through
// their strides: the model's split of the conv output goes in without a copy, and B/C are
// never broadcast to the heads in device memory.  x, B and C are f32 or bf16 (cast on
// load, as the Pallas body's .astype(f32)); dt and A are f32.  Steps past s in the last
// chunk are zero with dt = 0 (decay 1, no input): they are never read from memory.
//
// What bounds it on an H100: operations.  chip_smoke.py's ssd_work counts what the scan
// needs: C.B' over the causal (t, k) pairs once per (batch, chunk), since B and C are one
// group that every head shares, and per (batch, head) the scores times x, C.h and the
// state update.  At the serving path's shape (Mamba2-780M prefill: b=4, s=1024, nh=48,
// hd=64, ds=128, chunk 256) that is 9.81 GFLOP, 0.146 ms at the card's 67 TFLOP/s of f32
// FMA (f32 products stay in full f32: TF32 tensor cores are off); the bytes, ~112 MB, take
// 0.033 ms at 3.35 TB/s.
//
// What held the first design back (one block per (batch, head) walking its chunks in
// order, 1.12 ms): 192 blocks on 132 SMs, one uneven wave; C.B' recomputed for each of the
// 48 heads (39% of the flops it computed); 4 x 2 score patches a thread, 5-11 FMAs per
// 16-byte shared-memory read; synchronous tile loads with three to four barriers a tile;
// the prefix sum on one thread while 255 waited.
//
// This design: the SSD decomposition as chunk-parallel passes, three launches in order on
// the caller's stream from the one C entry ssd_scan_fwd, with workspaces from the caller:
//   (a) cum: the in-chunk inclusive prefix of dt * A for each (batch, head, chunk), one
//       warp each, sequential, each step dt * A rounded and then added (__fmul_rn /
//       __fadd_rn: no fused multiply-add), as the plain version's cumsum: cum reaches the
//       thousands at A = -48, so cum_t - cum_k cancels most of its digits and any other
//       summation order rounds differently.  dt is copied beside it, 0 past s.
//   (b) C.B' once per (batch, chunk), on and below the diagonal in 64 x 64 tiles, stored
//       key-major ([k][t]), and C' ([n][t]) beside it: every head reads them (~6 MB at the
//       main shape, in L2).  Passes (a) and (b) are one launch of two kinds of block.
//   (c) each chunk's state contribution S_c = sum_k (B_k exp(total - cum_k) dt_k) x_k' for
//       every (batch, head, chunk) in parallel (768 blocks at the main shape), held in
//       registers for
//   (d) the state pass over chunks, h_{c+1} = exp(total_c) h_c + S_c, in the same launch: a
//       block waits for a flag from the block of the chunk before (blocks take their chunk
//       from an atomic ticket, in the order they start and chunk by chunk, so that block
//       started a wave or more earlier), adds, and publishes the state entering the next
//       chunk, or writes the final state.  S_c never goes to memory.
//   (e) y for every (batch, head, chunk, 64-query tile) in parallel (3072 blocks), latest
//       tiles first.  One accumulator takes three kinds of 32-row tile in turn: the state
//       term C.h (then scaled by exp(cum_r), r = the step before the tile), the keys before
//       the tile with C.B' times exp(cum_r - cum_k) dt_k (then the rows scaled by
//       exp(cum_t - cum_r): both factors are at most 1 for A < 0 and dt >= 0, so nothing
//       overflows), and the keys of the tile's own diagonal band with exp(cum_t - cum_k)
//       dt_k where k <= t and 0 SELECTED where k > t (exp of the positive exponent above
//       the diagonal is never multiplied by a mask; the band's second key tile skips the
//       rows before it, which see none of its keys).
//   Passes (c) and (e) are one FFMA micro-kernel: each thread owns an 8 x 8 patch of the
//   output and reads two float4 of each operand per step, 16 FMAs per 16-byte read.  Tiles
//   come in with 16-byte cp.async (8-byte for bf16 operands), the next tile's copy in
//   flight while the current one is transformed (decay, dt, the select) and multiplied.
//   Rows past s and columns past hd or ds are zero-filled by the copies.
//
// C interface, bound with ctypes: ssd_scan_fwd returns the first failing launch's CUDA error
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTK = 32;         // rows (keys or state rows) of a pipeline tile
constexpr int kStages = 2;      // tiles in flight: the current one and kStages - 1 copies
constexpr int kTQ = 64;         // query rows of a pass-(e) block
constexpr int kTC = 64;         // edge of a pass-(b) C.B' tile
constexpr int kPrepThreads = 256;
constexpr int kLdC = 4;         // floats of padding per pass-(b) shared row

struct Params {
  const void* x;
  const void* bm;
  const void* cm;
  const float* dt;
  const float* a;
  float* y;
  float* state;
  float* cum;  // (b, nh, nc, qp): inclusive prefix of dt * A in each chunk, carried past s
  float* dtw;  // (b, nh, nc, qp): dt, 0 past s
  float* cbt;  // (b, nc, qp, qp): [k][t] = C_t . B_k, 64-tiles on and below the diagonal
  float* ct;   // (b, nc, dsp, qp): [n][t] = C_t[n]
  float* hst;  // (b, nh, nc, dsp, hdp): the state entering chunk c (c >= 1), from pass (c)
  int* ready;  // (b, nh, nc): 1 once the state entering chunk c + 1 is published; then
               // the ticket counter that hands pass (c) its blocks in order
  int b, s, nh, hd, ds, q, nc, qp, dsp, hdp;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long d_sb, d_ss, d_sh;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---- asynchronous copies: 4 elements (16 bytes of f32, 8 of bf16), or 4 zeros ----
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of `cols` elements (a multiple of 4) into a shared tile of row length
// ld; rows from rows_valid and columns from cols_valid (a multiple of 4) on become 0 and
// are not read.  nthreads is a multiple of cols / 4, so a thread keeps one column.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src, long long src_ld,
                                          int rows, int rows_valid, int cols, int cols_valid,
                                          int nthreads) {
  const int units = cols / 4;
  const int c = (threadIdx.x % units) * 4;
  const int rstep = nthreads / units;
  const bool col_ok = c < cols_valid;
  for (int r = threadIdx.x / units; r < rows; r += rstep) {
    const bool ok = col_ok && r < rows_valid;
    cp_async4<T>(dst + r * ld + c, ok ? src + r * src_ld + c : src, ok);
  }
}

// acc[i][j] += sum_{k < kTK} a[k][row_i] * b[k][col_j]: a thread's 8 rows are r0..r0+3 and
// rh+r0..rh+r0+3, its 8 columns c0..c0+3 and ch+c0..ch+c0+3, so a warp's float4 reads of
// one k row fall on distinct banks.  a is f32, b f32 or bf16.  kHighRows: only the rows
// rh+r0.. (a tile whose rows below rh are all 0).
template <typename TB, bool kHighRows = false>
__device__ __forceinline__ void mma_8x8(float (&acc)[8][8], const float* a, int lda, int r0,
                                        int rh, const TB* b, int ldb, int c0, int ch) {
#pragma unroll 4
  for (int k = 0; k < kTK; ++k) {
    const float4 a0 = kHighRows ? make_float4(0.f, 0.f, 0.f, 0.f)
                                : *reinterpret_cast<const float4*>(a + k * lda + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * lda + rh + r0);
    const float4 b0 = Elem<TB>::load4(b + k * ldb + c0);
    const float4 b1 = Elem<TB>::load4(b + k * ldb + ch + c0);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = kHighRows ? 4 : 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---- shared memory of each pass, in bytes ----
size_t prep_smem(int dsp) { return (size_t)2 * kTC * (dsp + kLdC) * sizeof(float); }

size_t state_smem(int dsp, int hdp, int qp, int elem) {
  // raw B [kStages][kTK][dsp] (as loaded), B * w [kTK][dsp] f32 (bf16 only),
  // x [kStages][kTK][hdp], w [qp], the block's ticket
  return (size_t)kStages * kTK * dsp * elem + (elem == 4 ? 0 : (size_t)kTK * dsp * 4) +
         (size_t)kStages * kTK * hdp * elem + (size_t)qp * 4 + 16;
}

size_t out_smem(int hdp, int qp) {
  // A [kStages][kTK][kTQ] f32, B [kStages][kTK][hdp] (room for f32), cum, dt, colf [qp] each
  return ((size_t)kStages * kTK * kTQ + (size_t)kStages * kTK * hdp + (size_t)3 * qp) *
         sizeof(float);
}

// ---- passes (a) and (b): one launch, the prefix blocks first ----
template <typename T>
__global__ void __launch_bounds__(kPrepThreads) ssd_prep_kernel(const Params p, int n_cum_blocks) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < n_cum_blocks) {
    // (a) one warp per (batch, chunk, head): 32 steps of dt a load, then the 32 sums in
    // order, every lane taking the same chain of roundings and keeping its own step's
    const int i = blockIdx.x * (kPrepThreads / 32) + tid / 32;
    const int lane = tid & 31;
    if (i >= p.b * p.nh * p.nc) return;
    const int h = i % p.nh;
    const int c = (i / p.nh) % p.nc;
    const int bi = i / (p.nh * p.nc);
    const int c0 = c * p.q;
    const int rows = min(p.q, p.s - c0);
    const float a = p.a[h];
    const float* dg = p.dt + bi * p.d_sb + h * p.d_sh + (long long)c0 * p.d_ss;
    const long long off = (((long long)bi * p.nh + h) * p.nc + c) * p.qp;
    if (lane == 0) p.ready[i] = 0;
    if (i == 0 && lane == 0) p.ready[p.b * p.nh * p.nc] = 0;  // the ticket counter
    float run = 0.f;
    for (int t8 = 0; t8 < p.qp; t8 += 8 * 32) {  // 8 loads a lane in flight, then the sums
      float d[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int t = t8 + 32 * g + lane;
        d[g] = t < rows ? dg[(long long)t * p.d_ss] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int t0 = t8 + 32 * g;
        if (t0 >= p.qp) break;
        float mine = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float dj = __shfl_sync(0xffffffffu, d[g], j);
          if (t0 + j < rows) run = __fadd_rn(run, __fmul_rn(dj, a));
          if (j == lane) mine = run;  // dt = 0 past s: cum stays
        }
        p.cum[off + t0 + lane] = mine;
        p.dtw[off + t0 + lane] = d[g];
      }
    }
    return;
  }

  // (b) one 64 x 64 tile of C.B' (keys kt, queries qt, kt <= qt) of one (batch, chunk)
  extern __shared__ float4 smem4[];
  const int ld = p.dsp + kLdC;
  float* bs = reinterpret_cast<float*>(smem4);  // kTC x ld: B rows (keys)
  float* cs = bs + kTC * ld;                    // kTC x ld: C rows (queries)
  const int nt = p.qp / kTC;
  int pair = (blockIdx.x - n_cum_blocks) % (nt * (nt + 1) / 2);
  const int rest = (blockIdx.x - n_cum_blocks) / (nt * (nt + 1) / 2);
  const int c = rest % p.nc;
  const int bi = rest / p.nc;
  int qt = 0;
  while (pair > qt) {
    pair -= qt + 1;
    ++qt;
  }
  const int kt = pair;
  const int c0 = c * p.q;
  const int rows = min(p.q, p.s - c0);
  const int t0 = qt * kTC;
  const int k0 = kt * kTC;
  if (t0 >= rows) return;  // a query tile past s: pass (e) never reads it

  const T* bg = static_cast<const T*>(p.bm) + bi * p.b_sb + (long long)c0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.cm) + bi * p.c_sb + (long long)c0 * p.c_ss;
  const int units = p.dsp / 4;
  for (int idx = tid; idx < kTC * units; idx += kPrepThreads) {
    const int r = idx / units;
    const int n = (idx - r * units) * 4;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cv = bv;
    if (n < p.ds) {
      if (k0 + r < rows) bv = Elem<T>::load4(bg + (long long)(k0 + r) * p.b_ss + n);
      if (t0 + r < rows) cv = Elem<T>::load4(cg + (long long)(t0 + r) * p.c_ss + n);
    }
    *reinterpret_cast<float4*>(bs + r * ld + n) = bv;
    *reinterpret_cast<float4*>(cs + r * ld + n) = cv;
  }
  __syncthreads();

  // keys ty + 16 i, queries tx + 16 j
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < p.dsp; n += 4) {
    float4 bv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bv[i] = *reinterpret_cast<const float4*>(bs + (ty + 16 * i) * ld + n);
      cv[i] = *reinterpret_cast<const float4*>(cs + (tx + 16 * i) * ld + n);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(cv[j].x, bv[i].x, acc[i][j]);
        acc[i][j] = fmaf(cv[j].y, bv[i].y, acc[i][j]);
        acc[i][j] = fmaf(cv[j].z, bv[i].z, acc[i][j]);
        acc[i][j] = fmaf(cv[j].w, bv[i].w, acc[i][j]);
      }
  }
  float* og = p.cbt + (((long long)bi * p.nc + c) * p.qp + k0) * p.qp + t0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) og[(long long)(ty + 16 * i) * p.qp + tx + 16 * j] = acc[i][j];
  if (kt == qt) {  // C' of this query tile, once
    float* tg = p.ct + ((long long)bi * p.nc + c) * p.dsp * p.qp + t0;
    for (int idx = tid; idx < p.dsp * kTC; idx += kPrepThreads) {
      const int n = idx / kTC;
      const int t = idx - n * kTC;
      tg[(long long)n * p.qp + t] = cs[t * ld + n];
    }
  }
}

// ---- pass (c): S_c = sum_k (B_k w_k) x_k', w_k = exp(total - cum_k) dt_k ----
// A block owns one (batch, head, chunk): rows n of dsp, columns p of hdp = 64 NG, as
// (dsp / 8) x (8 NG) threads of 8 x 8.
template <typename T, int NG>
__global__ void __launch_bounds__(256) ssd_chunk_state_kernel(const Params p) {
  constexpr int kHdp = 64 * NG;
  constexpr int kNcg = 8 * NG;
  extern __shared__ float4 smem4[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int dsp = p.dsp;
  T* araw = reinterpret_cast<T*>(smem4);                    // [kStages][kTK][dsp]
  T* bx = araw + kStages * kTK * dsp;                       // [kStages][kTK][kHdp]
  float* afw = reinterpret_cast<float*>(bx + kStages * kTK * kHdp);  // [kTK][dsp], bf16 only
  float* w_s = afw + (sizeof(T) == 4 ? 0 : kTK * dsp);                // [qp]

  // blocks take their (batch, head, chunk) from a ticket, in the order they start, chunk
  // by chunk: the block that pass (d) waits on has always started, a wave or more earlier
  int* ticket = reinterpret_cast<int*>(w_s + p.qp);
  if (tid == 0) *ticket = atomicAdd(p.ready + p.b * p.nh * p.nc, 1);
  __syncthreads();
  const int blk = *ticket;
  const int c = blk / (p.b * p.nh);
  const int h = blk % p.nh;
  const int bi = (blk / p.nh) % p.b;
  const int c0 = c * p.q;
  const int rows = min(p.q, p.s - c0);
  const long long bhc = ((long long)bi * p.nh + h) * p.nc + c;
  const T* bg = static_cast<const T*>(p.bm) + bi * p.b_sb + (long long)c0 * p.b_ss;
  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + (long long)c0 * p.x_ss + h * p.x_sh;
  const int n_tiles = (rows + kTK - 1) / kTK;
  auto fetch = [&](int it) {  // one copy group a tile, empty past the last
    if (it < n_tiles) {
      const int k0 = it * kTK;
      const int st = it % kStages;
      copy_tile<T>(araw + st * kTK * dsp, dsp, bg + (long long)k0 * p.b_ss, p.b_ss, kTK,
                   rows - k0, dsp, p.ds, nthreads);
      copy_tile<T>(bx + st * kTK * kHdp, kHdp, xg + (long long)k0 * p.x_ss, p.x_ss, kTK,
                   rows - k0, kHdp, p.hd, nthreads);
    }
    cp_async_commit();
  };
  for (int it = 0; it < kStages - 1; ++it) fetch(it);

  const float* cum_g = p.cum + bhc * p.qp;
  const float* dt_g = p.dtw + bhc * p.qp;
  const float total = cum_g[p.qp - 1];
  for (int k = tid; k < p.qp; k += nthreads)
    w_s[k] = __fmul_rn(expf(total - cum_g[k]), dt_g[k]);  // read after the loop's barrier

  const int rg = tid / kNcg;
  const int cg = tid - rg * kNcg;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; every thread is done with tile it - 1
    fetch(it + kStages - 1);
    const int st = it % kStages;
    T* ar = araw + st * kTK * dsp;
    float* af = sizeof(T) == 4 ? reinterpret_cast<float*>(ar) : afw;
    {  // B_k * w_k, a float4 of one column a step (nthreads is a multiple of dsp / 4)
      const float* w = w_s + it * kTK;
      const int n = (tid % (dsp / 4)) * 4;
      for (int k = tid / (dsp / 4); k < kTK; k += nthreads / (dsp / 4)) {
        const float4 v = Elem<T>::load4(ar + k * dsp + n);
        const float wk = w[k];
        *reinterpret_cast<float4*>(af + k * dsp + n) = make_float4(
            __fmul_rn(v.x, wk), __fmul_rn(v.y, wk), __fmul_rn(v.z, wk), __fmul_rn(v.w, wk));
      }
    }
    __syncthreads();
    mma_8x8<T>(acc, af, dsp, rg * 4, dsp / 2, bx + st * kTK * kHdp, kHdp, cg * 4, kHdp / 2);
  }

  // (d) the state entering chunk c + 1 = exp(total_c) (state entering c) + S_c: block c
  // waits for block c - 1 (a lower index, so already running or done) to publish the
  // state entering c, then publishes its own, or writes the final state
  if (c > 0) {
    if (tid == 0) {
      volatile int* flag = p.ready + bhc - 1;
      while (*flag == 0) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    const float decay = expf(total);
    const float* hin = p.hst + bhc * dsp * kHdp;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = (i < 4 ? 0 : dsp / 2) + rg * 4 + (i & 3);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 hv =
            __ldcg(reinterpret_cast<const float4*>(hin + n * kHdp + g * (kHdp / 2) + cg * 4));
        acc[i][4 * g] = decay * hv.x + acc[i][4 * g];
        acc[i][4 * g + 1] = decay * hv.y + acc[i][4 * g + 1];
        acc[i][4 * g + 2] = decay * hv.z + acc[i][4 * g + 2];
        acc[i][4 * g + 3] = decay * hv.w + acc[i][4 * g + 3];
      }
    }
  }
  const bool last = c + 1 == p.nc;
  float* hout = last ? p.state + ((long long)bi * p.nh + h) * p.ds * p.hd
                     : p.hst + (bhc + 1) * dsp * kHdp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = (i < 4 ? 0 : dsp / 2) + rg * 4 + (i & 3);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = g * (kHdp / 2) + cg * 4;
      const float4 v =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (!last)
        *reinterpret_cast<float4*>(hout + n * kHdp + col) = v;
      else if (n < p.ds && col < p.hd)
        *reinterpret_cast<float4*>(hout + n * p.hd + col) = v;
    }
  }
  if (!last) {
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(p.ready + bhc, 1);
  }
}

// ---- pass (e): y of one (batch, head, chunk, 64-query tile) ----
// 8 x (8 NG) threads of 8 x 8 (64 query rows, hdp = 64 NG columns).
template <typename T, int NG>
__global__ void __launch_bounds__(64 * NG) ssd_output_kernel(const Params p) {
  constexpr int kHdp = 64 * NG;
  constexpr int kThreads = 64 * NG;
  constexpr int kNcg = 8 * NG;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [kStages][kTK][kTQ]
  float* bsm = as + kStages * kTK * kTQ;        // [kStages][kTK][kHdp]: H (f32) or x (T)
  float* cum_s = bsm + kStages * kTK * kHdp;    // [qp]
  float* dt_s = cum_s + p.qp;                   // [qp]
  float* colf = dt_s + p.qp;                    // [qp]: exp(cum_r - cum_k) dt_k, k < t0

  const int tid = threadIdx.x;
  const int per = p.b * p.nh * p.nc;
  const int qt = p.qp / kTQ - 1 - (int)(blockIdx.x / per);  // latest (most loaded) first
  int rest = blockIdx.x % per;
  const int c = rest % p.nc;
  rest /= p.nc;
  const int h = rest % p.nh;
  const int bi = rest / p.nh;
  const int c0 = c * p.q;
  const int rows = min(p.q, p.s - c0);
  const int t0 = qt * kTQ;
  if (t0 >= rows) return;  // a query tile past s
  const int kend = min(t0 + kTQ, rows);
  const long long bhc = ((long long)bi * p.nh + h) * p.nc + c;

  const int n_state = c > 0 ? p.dsp / kTK : 0;
  const int n_off = t0 / kTK;
  const int n_tiles = n_state + n_off + (kend - t0 + kTK - 1) / kTK;
  const float* ct_g = p.ct + ((long long)bi * p.nc + c) * p.dsp * p.qp + t0;
  const float* cbt_g = p.cbt + ((long long)bi * p.nc + c) * p.qp * p.qp + t0;
  const float* h_g = p.hst + bhc * p.dsp * kHdp;
  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + (long long)c0 * p.x_ss + h * p.x_sh;
  auto fetch = [&](int it) {  // one copy group a tile, empty past the last
    if (it < n_tiles) {
      float* a_dst = as + (it % kStages) * kTK * kTQ;
      float* b_dst = bsm + (it % kStages) * kTK * kHdp;
      if (it < n_state) {
        const int n0 = it * kTK;
        copy_tile<float>(a_dst, kTQ, ct_g + (long long)n0 * p.qp, p.qp, kTK, kTK, kTQ, kTQ,
                         kThreads);
        copy_tile<float>(b_dst, kHdp, h_g + n0 * kHdp, kHdp, kTK, kTK, kHdp, kHdp, kThreads);
      } else {
        const int k0 = (it - n_state) * kTK;
        copy_tile<float>(a_dst, kTQ, cbt_g + (long long)k0 * p.qp, p.qp, kTK, kTK, kTQ, kTQ,
                         kThreads);
        copy_tile<T>(reinterpret_cast<T*>(b_dst), kHdp, xg + (long long)k0 * p.x_ss, p.x_ss,
                     kTK, rows - k0, kHdp, p.hd, kThreads);
      }
    }
    cp_async_commit();
  };
  for (int it = 0; it < kStages - 1; ++it) fetch(it);

  for (int k = tid; k < t0 + kTQ; k += kThreads) {
    cum_s[k] = p.cum[bhc * p.qp + k];
    dt_s[k] = p.dtw[bhc * p.qp + k];
  }
  __syncthreads();
  const float cum_r = t0 > 0 ? cum_s[t0 - 1] : 0.f;
  for (int k = tid; k < t0; k += kThreads)
    colf[k] = __fmul_rn(expf(cum_r - cum_s[k]), dt_s[k]);  // read after the loop's barrier

  const int rg = tid / kNcg;
  const int cg = tid - rg * kNcg;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; every thread is done with tile it - 1
    fetch(it + kStages - 1);
    float* a_cur = as + (it % kStages) * kTK * kTQ;
    const float* b_cur = bsm + (it % kStages) * kTK * kHdp;
    if (it < n_state) {  // C.h
      mma_8x8<float>(acc, a_cur, kTQ, rg * 4, kTQ / 2, b_cur, kHdp, cg * 4, kHdp / 2);
      continue;
    }
    const int k0 = (it - n_state) * kTK;
    // a float4 of 4 queries a step: the thread's queries t4..t4+3 stay, its keys step
    const int t4 = (tid % (kTQ / 4)) * 4;
    const int kstep = kThreads / (kTQ / 4);
    if (k0 < t0) {  // keys before the tile: C.B' exp(cum_r - cum_k) dt_k
      for (int k = tid / (kTQ / 4); k < kTK; k += kstep) {
        float4* ap = reinterpret_cast<float4*>(a_cur + k * kTQ + t4);
        const float4 v = *ap;
        const float f = colf[k0 + k];
        *ap = make_float4(__fmul_rn(v.x, f), __fmul_rn(v.y, f), __fmul_rn(v.z, f),
                          __fmul_rn(v.w, f));
      }
    } else {  // the diagonal band: exp(cum_t - cum_k) dt_k where k <= t, else 0
      float ct[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ct[e] = cum_s[t0 + t4 + e];
      for (int k = tid / (kTQ / 4); k < kTK; k += kstep) {
        float* ap = a_cur + k * kTQ + t4;
        const int kk = k0 + k;
        const float ck = cum_s[kk];
        const float dk = dt_s[kk];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.f;
          if (kk <= t0 + t4 + e) v = __fmul_rn(__fmul_rn(ap[e], expf(ct[e] - ck)), dk);
          ap[e] = v;
        }
      }
    }
    __syncthreads();
    if (it == n_state && n_state > 0) {  // the state term: exp(cum_t) = exp(cum_r) exp(cum_t - cum_r)
      const float e_r = expf(cum_r);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= e_r;
    }
    if (it == n_state + n_off) {  // rows scaled by exp(cum_t - cum_r) before the diagonal band
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + (i < 4 ? 0 : kTQ / 2) + rg * 4 + (i & 3);
        const float f = expf(cum_s[t] - cum_r);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= f;
      }
    }
    if (k0 >= t0 + kTQ / 2)  // keys past the tile's first half: its rows there see none
      mma_8x8<T, true>(acc, a_cur, kTQ, rg * 4, kTQ / 2, reinterpret_cast<const T*>(b_cur),
                       kHdp, cg * 4, kHdp / 2);
    else
      mma_8x8<T>(acc, a_cur, kTQ, rg * 4, kTQ / 2, reinterpret_cast<const T*>(b_cur), kHdp,
                 cg * 4, kHdp / 2);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? 0 : kTQ / 2) + rg * 4 + (i & 3);
    if (t >= rows) continue;
    float* yg = p.y + (((long long)bi * p.s + c0 + t) * p.nh + h) * p.hd;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = g * (kHdp / 2) + cg * 4;
      if (col < p.hd)
        *reinterpret_cast<float4*>(yg + col) = make_float4(
            acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

struct Shape {
  int q, nc, qp, dsp, hdp;
  Shape(int s, int hd, int ds, int chunk) {
    q = chunk < s ? chunk : s;
    nc = (s + q - 1) / q;
    qp = round_up(q, kTQ);
    dsp = round_up(ds, kTK);
    hdp = round_up(hd, 64);
  }
};

// workspace floats: cum, dtw, cbt, ct, hst, then the ready flags (4-byte ints)
void work_floats(int b, int nh, const Shape& sh, long long (&n)[6]) {
  n[0] = (long long)b * nh * sh.nc * sh.qp;
  n[1] = n[0];
  n[2] = (long long)b * sh.nc * sh.qp * sh.qp;
  n[3] = (long long)b * sh.nc * sh.dsp * sh.qp;
  n[4] = (long long)b * nh * sh.nc * sh.dsp * sh.hdp;
  n[5] = (long long)b * nh * sh.nc + 4;  // the flags and the ticket counter
}

// blocks of the three launches
void grid_blocks(int b, int nh, const Shape& sh, long long (&g)[3], int& n_cum_blocks) {
  const int nt = sh.qp / kTC;
  n_cum_blocks = (b * nh * sh.nc + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  g[0] = n_cum_blocks + (long long)b * sh.nc * nt * (nt + 1) / 2;
  g[1] = (long long)b * nh * sh.nc;
  g[2] = (long long)b * nh * sh.nc * (sh.qp / kTQ);
}

size_t smem_bytes(int hd, int ds, int chunk, int elem) {
  const Shape sh(chunk, hd, ds, chunk);
  size_t m = prep_smem(sh.dsp);
  const size_t sc = state_smem(sh.dsp, sh.hdp, sh.qp, elem);
  const size_t so = out_smem(sh.hdp, sh.qp);
  if (sc > m) m = sc;
  if (so > m) m = so;
  return m;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int NG>
int launch(Params& p, cudaStream_t stream) {
  const Shape sh(p.s, p.hd, p.ds, p.q);
  long long g[3];
  int n_cum_blocks;
  grid_blocks(p.b, p.nh, sh, g, n_cum_blocks);
  const int elem = (int)sizeof(T);
  const size_t s0 = prep_smem(p.dsp);
  const size_t s1 = state_smem(p.dsp, p.hdp, p.qp, elem);
  const size_t s3 = out_smem(p.hdp, p.qp);
  int err = set_smem(ssd_prep_kernel<T>, s0);
  if (!err) err = set_smem(ssd_chunk_state_kernel<T, NG>, s1);
  if (!err) err = set_smem(ssd_output_kernel<T, NG>, s3);
  if (err) return err;
  ssd_prep_kernel<T><<<(unsigned)g[0], kPrepThreads, s0, stream>>>(p, n_cum_blocks);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_state_kernel<T, NG><<<(unsigned)g[1], p.dsp * NG, s1, stream>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_output_kernel<T, NG><<<(unsigned)g[2], 64 * NG, s3, stream>>>(p);
  return (int)cudaGetLastError();
}

bool takes(int hd, int ds, int chunk, int dtype) {
  return hd >= 4 && hd <= 128 && hd % 4 == 0 && ds >= 8 && ds <= 128 && ds % 8 == 0 &&
         chunk >= 1 && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C alike; dt, A, y and the state are
// float32).  strides, in elements, 10 values: x's (batch, seq, head), B's and C's (batch,
// seq), dt's (batch, seq, head).  x's head_dim and B/C's state strides are 1 and the
// others multiples of 4, the pointers aligned to 4 elements (the wrapper checks).  y is a
// contiguous (b, s, nh, hd) and state a contiguous (b, nh, ds, hd).  work holds
// ssd_scan_work_bytes bytes, 16-byte aligned.
extern "C" int ssd_scan_fwd(const void* x, const void* bm, const void* cm, const float* dt,
                            const float* a, float* y, float* state, void* work, int dtype,
                            int b, int s, int nh, int hd, int ds, int chunk,
                            const long long* strides, void* stream) {
  if (b < 0 || s < 0 || nh < 1 || !takes(hd, ds, chunk, dtype)) return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return 0;
  const Shape sh(s, hd, ds, chunk);
  long long n[6];
  work_floats(b, nh, sh, n);
  Params p;
  p.x = x;
  p.bm = bm;
  p.cm = cm;
  p.dt = dt;
  p.a = a;
  p.y = y;
  p.state = state;
  p.cum = static_cast<float*>(work);
  p.dtw = p.cum + n[0];
  p.cbt = p.dtw + n[1];
  p.ct = p.cbt + n[2];
  p.hst = p.ct + n[3];
  p.ready = reinterpret_cast<int*>(p.hst + n[4]);
  p.b = b;
  p.s = s;
  p.nh = nh;
  p.hd = hd;
  p.ds = ds;
  p.q = sh.q;
  p.nc = sh.nc;
  p.qp = sh.qp;
  p.dsp = sh.dsp;
  p.hdp = sh.hdp;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.x_sh = strides[2];
  p.b_sb = strides[3];
  p.b_ss = strides[4];
  p.c_sb = strides[5];
  p.c_ss = strides[6];
  p.d_sb = strides[7];
  p.d_ss = strides[8];
  p.d_sh = strides[9];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = sh.hdp > 64;
  if (dtype == 0) return wide ? launch<float, 2>(p, st) : launch<float, 1>(p, st);
  return wide ? launch<__nv_bfloat16, 2>(p, st) : launch<__nv_bfloat16, 1>(p, st);
}

// Bytes of the workspace ssd_scan_fwd takes (0 for arguments it does not take).
extern "C" long long ssd_scan_work_bytes(int b, int s, int nh, int hd, int ds, int chunk) {
  if (b <= 0 || s <= 0 || nh < 1 || !takes(hd, ds, chunk, 0)) return 0;
  long long n[6];
  work_floats(b, nh, Shape(s, hd, ds, chunk), n);
  return (n[0] + n[1] + n[2] + n[3] + n[4] + n[5]) * 4;
}

// The most dynamic shared memory a block of the three launches takes, in bytes, for x/B/C
// of the given dtype (chunk already cut to at most s).
extern "C" long long ssd_scan_smem_bytes(int hd, int ds, int chunk, int dtype) {
  return (long long)smem_bytes(hd, ds, chunk, dtype == 1 ? 2 : 4);
}

// Blocks of each of the three launches, in order: (a)+(b), (c)+(d), (e).
extern "C" void ssd_scan_blocks(int b, int s, int nh, int hd, int ds, int chunk,
                                long long* out) {
  long long g[3] = {0, 0, 0};
  int n_cum_blocks = 0;
  if (b > 0 && s > 0 && nh > 0 && takes(hd, ds, chunk, 0))
    grid_blocks(b, nh, Shape(s, hd, ds, chunk), g, n_cum_blocks);
  for (int i = 0; i < 3; ++i) out[i] = g[i];
}
