// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan in the model layout.
//
// Replaces the Pallas TPU kernel ssd_scan_bhs (src/repro/kernels/ssd_scan.py:92, body
// _ssd_kernel at :32).  For every (batch, head) it runs the chunks of q = min(chunk, s)
// steps in order, carrying the state h (ds x hd, f32) from one chunk to the next:
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
// What bounds it on an H100: operations.  At the serving path's shape (Mamba2-780M
// prefill: b=4, s=1024, nh=48, hd=64, ds=128, chunk 256) the k <= t half of the two
// (q, q) products plus C.h and the state update are ~21.0 M flops a chunk, 16.1 GFLOP
// over 4 x 192 (chunk, batch-head) pairs: 0.241 ms at the card's 67 TFLOP/s of f32 FMA
// (the port keeps f32 products in full f32: TF32 tensor cores are off).  The bytes are
// ~112 MB (x and y 50.3 MB each), 0.033 ms at 3.35 TB/s.
//
// Design (simple and right first; splitting the scan into chunk-parallel passes, wgmma
// and TMA are later steps):
//   * One block owns one (batch, head) -- 192 blocks at the main shape -- and loops over
//     the chunks inside itself, in place of the TPU's sequential chunk grid axis, with h
//     in shared memory across the loop.
//   * A 256-step chunk's B and C are 128 KB each in f32, so the chunk is sub-tiled: 64
//     query rows at a time (C tile, y accumulators in registers), against 32-row key tiles
//     (B, x) up to the diagonal only.  S = C.B' is computed per (query, key) tile, scaled
//     by exp(cum_t - cum_k) dt_k where k <= t and SELECTED to 0 elsewhere (exp of the
//     positive exponent above the diagonal is never multiplied by a mask), staged in
//     shared memory and multiplied into x.  After every query tile of the chunk has read
//     the old h, the state update runs over the key tiles again, B pre-scaled by
//     exp(total - cum_k) dt_k as the Pallas body scales it.
//   * The in-chunk prefix sum is sequential, one thread, each step dt * A rounded and
//     then added (__fmul_rn / __fadd_rn: no fused multiply-add), as the plain version's
//     cumsum of dt * A.  cum reaches the thousands at A = -48, so cum_t - cum_k cancels
//     most of its digits and any other summation order rounds differently.
//   * 256 threads as a 16 x 16 grid; every product is an FFMA loop over shared memory
//     with float4 reads, rows padded by 4 floats so 8 lanes' 16-byte reads hit distinct
//     banks.  About 103 KB of shared memory a block at the main shape: two blocks an SM.
//
// C interface, bound with ctypes: ssd_scan_fwd returns the launch's cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 64;       // query rows of a tile
constexpr int kTK = 32;       // key rows of a tile
constexpr int kThreads = 256;  // a 16 x 16 grid: (ty, tx)
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdS = kTK + kPad;

struct Params {
  const void* x;
  const void* bm;
  const void* cm;
  const float* dt;
  const float* a;
  float* y;
  float* state;
  int nh, s, hd, ds, chunk;
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

// shared-memory floats of each buffer
struct Layout {
  int ldh, ldn, h, c, b, x, s, cum, dtv;
  __host__ __device__ Layout(int hd, int ds, int chunk) {
    ldh = hd + kPad;
    ldn = ds + kPad;
    h = ds * ldh;
    c = kTQ * ldn;
    b = kTK * ldn;
    x = kTK * ldh;
    s = kTQ * kLdS;
    cum = round_up(chunk, kTQ);
    dtv = cum;
  }
  __host__ __device__ int total() const { return h + c + b + x + s + cum + dtv; }
};

size_t smem_bytes(int hd, int ds, int chunk) {
  return (size_t)Layout(hd, ds, chunk).total() * sizeof(float);
}

// Stage `rows_valid` rows of `cols` values as f32 (each times scale[r] if given) into a
// `rows`-row shared tile of row length ld; rows past rows_valid become 0 and are not read.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long row_stride,
                                          int rows, int rows_valid, int cols,
                                          const float* scale) {
  const int chunks = cols / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) {
      val = Elem<T>::load4(src + r * row_stride + c);
      if (scale != nullptr) {
        const float w = scale[r];
        val.x = __fmul_rn(val.x, w);
        val.y = __fmul_rn(val.y, w);
        val.z = __fmul_rn(val.z, w);
        val.w = __fmul_rn(val.w, w);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// NG = ceil(hd / 64): the float4 column groups of hd a thread owns.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int hd = p.hd;
  const int ds = p.ds;
  const Layout L(hd, ds, p.chunk);
  float* hs = reinterpret_cast<float*>(smem4);  // ds x ldh: the carried state
  float* cs = hs + L.h;                         // kTQ x ldn: C of the query tile
  float* bs = cs + L.c;                         // kTK x ldn: B of the key tile
  float* xs = bs + L.b;                         // kTK x ldh: x of the key tile
  float* ss = xs + L.x;                         // kTQ x kLdS: the masked, scaled scores
  float* cum = ss + L.s;                        // chunk: inclusive prefix of dt * A
  float* dts = cum + L.cum;                     // chunk: dt (0 past s); then the update weights

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.nh;
  const int head = blockIdx.x - b * p.nh;
  const float a = p.a[head];

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + head * p.x_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb;
  const float* dg = p.dt + b * p.d_sb + head * p.d_sh;

  for (int idx = threadIdx.x; idx < L.h; idx += kThreads) hs[idx] = 0.f;

  const int n_chunks = (p.s + p.chunk - 1) / p.chunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int c0 = ic * p.chunk;
    const int rows = min(p.chunk, p.s - c0);  // valid steps of this chunk
    __syncthreads();  // the previous chunk is done with dts and cum
    for (int t = threadIdx.x; t < L.cum; t += kThreads)
      dts[t] = t < rows ? dg[(long long)(c0 + t) * p.d_ss] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < rows; ++t) {
        run = __fadd_rn(run, __fmul_rn(dts[t], a));
        cum[t] = run;
      }
      for (int t = rows; t < L.cum; ++t) cum[t] = run;  // dt = 0 past s: cum stays
    }
    __syncthreads();
    const float total = cum[rows - 1];

    // ---- y for each query tile: intra-chunk tiles up to the diagonal, then C.h ----
    for (int q0 = 0; q0 < rows; q0 += kTQ) {
      const int q_rows = min(kTQ, rows - q0);
      __syncthreads();  // the previous query tile is done with cs
      load_tile<T>(cs, L.ldn, cg + (long long)(c0 + q0) * p.c_ss, p.c_ss, kTQ, q_rows, ds,
                   nullptr);
      __syncthreads();

      float acc[4][NG][4];  // intra-chunk term
      float ch[4][NG][4];   // C . h (the state before this chunk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g][e] = ch[i][g][e] = 0.f;

      for (int n = 0; n < ds; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ty * 4 + i) * L.ldn + n);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int col = (tx + 16 * g) * 4;
            if (col < hd) {
              const float4 hv = *reinterpret_cast<const float4*>(hs + (n + cc) * L.ldh + col);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float ci = comp(cv[i], cc);
                ch[i][g][0] = fmaf(ci, hv.x, ch[i][g][0]);
                ch[i][g][1] = fmaf(ci, hv.y, ch[i][g][1]);
                ch[i][g][2] = fmaf(ci, hv.z, ch[i][g][2]);
                ch[i][g][3] = fmaf(ci, hv.w, ch[i][g][3]);
              }
            }
          }
        }
      }

      const int k_end = min(rows, q0 + q_rows);  // keys k <= the tile's last row
      for (int k0 = 0; k0 < k_end; k0 += kTK) {
        const int k_rows = min(kTK, rows - k0);
        __syncthreads();  // the previous key tile is done with bs, xs and ss
        load_tile<T>(bs, L.ldn, bg + (long long)(c0 + k0) * p.b_ss, p.b_ss, kTK, k_rows, ds,
                     nullptr);
        load_tile<T>(xs, L.ldh, xg + (long long)(c0 + k0) * p.x_ss, p.x_ss, kTK, k_rows, hd,
                     nullptr);
        __syncthreads();

        // scores: rows ty*4 + i, keys tx + 16 j
        float sc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
        for (int n = 0; n < ds; n += 4) {
          float4 cv[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(cs + (ty * 4 + i) * L.ldn + n);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * L.ldn + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
              sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
              sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
              sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
            }
        }
        // decay and source dt where k <= t, else 0 (selected, never multiplied)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = q0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + tx + 16 * j;
            float v = 0.f;
            if (k <= t) v = __fmul_rn(__fmul_rn(sc[i][j], expf(cum[t] - cum[k])), dts[k]);
            ss[(ty * 4 + i) * kLdS + tx + 16 * j] = v;
          }
        }
        __syncthreads();

        // acc += S x; keys past s have S = 0 and zero-filled x rows
        for (int kk = 0; kk < kTK; kk += 4) {
          float4 sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sv[i] = *reinterpret_cast<const float4*>(ss + (ty * 4 + i) * kLdS + kk);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const int col = (tx + 16 * g) * 4;
              if (col < hd) {
                const float4 xv = *reinterpret_cast<const float4*>(xs + (kk + cc) * L.ldh + col);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float si = comp(sv[i], cc);
                  acc[i][g][0] = fmaf(si, xv.x, acc[i][g][0]);
                  acc[i][g][1] = fmaf(si, xv.y, acc[i][g][1]);
                  acc[i][g][2] = fmaf(si, xv.z, acc[i][g][2]);
                  acc[i][g][3] = fmaf(si, xv.w, acc[i][g][3]);
                }
              }
            }
          }
        }
      }

      // y = intra + exp(cum_t) * (C . h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= q_rows) continue;
        const float e = expf(cum[q0 + r]);
        float* yg = p.y + b * (long long)p.s * p.nh * hd + (long long)(c0 + q0 + r) * p.nh * hd +
                    (long long)head * hd;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int col = (tx + 16 * g) * 4;
          if (col < hd)
            *reinterpret_cast<float4*>(yg + col) = make_float4(
                acc[i][g][0] + e * ch[i][g][0], acc[i][g][1] + e * ch[i][g][1],
                acc[i][g][2] + e * ch[i][g][2], acc[i][g][3] + e * ch[i][g][3]);
        }
      }
    }

    // ---- state update: h <- exp(total) h + sum_k (B_k w_k) x_k', w_k = exp(total - cum_k) dt_k
    __syncthreads();  // every query tile is done reading h and dts
    for (int t = threadIdx.x; t < rows; t += kThreads)
      dts[t] = __fmul_rn(expf(total - cum[t]), dts[t]);
    float upd[8][NG][4];  // rows ty*8 + i of h (ds is a multiple of 8)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) upd[i][g][e] = 0.f;
    const bool own_rows = ty * 8 < ds;
    for (int k0 = 0; k0 < rows; k0 += kTK) {
      const int k_rows = min(kTK, rows - k0);
      __syncthreads();  // dts holds the weights; the previous key tile is done with bs, xs
      load_tile<T>(bs, L.ldn, bg + (long long)(c0 + k0) * p.b_ss, p.b_ss, kTK, k_rows, ds,
                   dts + k0);
      load_tile<T>(xs, L.ldh, xg + (long long)(c0 + k0) * p.x_ss, p.x_ss, kTK, k_rows, hd,
                   nullptr);
      __syncthreads();
      if (own_rows) {
        for (int k = 0; k < k_rows; ++k) {
          const float4 b_lo = *reinterpret_cast<const float4*>(bs + k * L.ldn + ty * 8);
          const float4 b_hi = *reinterpret_cast<const float4*>(bs + k * L.ldn + ty * 8 + 4);
          const float bw[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int col = (tx + 16 * g) * 4;
            if (col < hd) {
              const float4 xv = *reinterpret_cast<const float4*>(xs + k * L.ldh + col);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                upd[i][g][0] = fmaf(bw[i], xv.x, upd[i][g][0]);
                upd[i][g][1] = fmaf(bw[i], xv.y, upd[i][g][1]);
                upd[i][g][2] = fmaf(bw[i], xv.z, upd[i][g][2]);
                upd[i][g][3] = fmaf(bw[i], xv.w, upd[i][g][3]);
              }
            }
          }
        }
      }
    }
    const float decay = expf(total);
    if (own_rows) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* hrow = hs + (ty * 8 + i) * L.ldh;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int col = (tx + 16 * g) * 4;
          if (col < hd) {
            float4 hv = *reinterpret_cast<const float4*>(hrow + col);
            hv.x = decay * hv.x + upd[i][g][0];
            hv.y = decay * hv.y + upd[i][g][1];
            hv.z = decay * hv.z + upd[i][g][2];
            hv.w = decay * hv.w + upd[i][g][3];
            *reinterpret_cast<float4*>(hrow + col) = hv;
          }
        }
      }
    }
  }

  __syncthreads();
  float* sg = p.state + (long long)blockIdx.x * ds * hd;
  for (int idx = threadIdx.x; idx < ds * hd; idx += kThreads) {
    const int n = idx / hd;
    sg[idx] = hs[n * L.ldh + idx - n * hd];
  }
}

template <typename T, int NG>
int launch(const Params& p, int bsz, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd, p.ds, p.chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, NG><<<(unsigned)(bsz * p.nh), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C alike; dt, A, y and the state are
// float32).  strides, in elements, 10 values: x's (batch, seq, head), B's and C's (batch,
// seq), dt's (batch, seq, head).  x's head_dim and B/C's state strides are 1 and the
// others multiples of 4, the pointers aligned to 4 elements (the wrapper checks).  y is a
// contiguous (b, s, nh, hd) and state a contiguous (b, nh, ds, hd).
extern "C" int ssd_scan_fwd(const void* x, const void* bm, const void* cm, const float* dt,
                            const float* a, float* y, float* state, int dtype, int b, int s,
                            int nh, int hd, int ds, int chunk, const long long* strides,
                            void* stream) {
  if (b < 0 || s < 0 || nh < 1 || hd < 4 || hd > 128 || hd % 4 != 0 || ds < 8 || ds > 128 ||
      ds % 8 != 0 || chunk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return 0;
  Params p;
  p.x = x;
  p.bm = bm;
  p.cm = cm;
  p.dt = dt;
  p.a = a;
  p.y = y;
  p.state = state;
  p.nh = nh;
  p.s = s;
  p.hd = hd;
  p.ds = ds;
  p.chunk = chunk < s ? chunk : s;
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
  const bool wide = hd > 64;
  if (dtype == 0) return wide ? launch<float, 2>(p, b, st) : launch<float, 1>(p, b, st);
  return wide ? launch<__nv_bfloat16, 2>(p, b, st) : launch<__nv_bfloat16, 1>(p, b, st);
}

// Dynamic shared memory a block takes, in bytes (chunk already cut to at most s).
extern "C" long long ssd_scan_smem_bytes(int hd, int ds, int chunk) {
  return (long long)smem_bytes(hd, ds, chunk);
}
