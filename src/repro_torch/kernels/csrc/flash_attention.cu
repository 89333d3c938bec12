// flash_attention: forward of blockwise (flash) attention in the model layout.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:118, body _attn_kernel at :40).
// It computes, for q (b, sq, h, hd) and k/v (b, sk, kvh, hd):
//   out[b, i, h] = softmax_j(cap(scale * q[b, i, h] . k[b, j, h / (h / kvh)])) v[b, j, ...]
// over the keys j visible to query i, with the queries aligned to the END of
// the keys (query i sits at position i + sk - sq): causal (j <= pos_i), an
// optional sliding window (j > pos_i - window) and an optional tanh softcap
// (cap(s) = softcap * tanh(s / softcap)).  Scores, the softmax and the sums
// are f32; the output is in q's dtype (f32 or bf16).  A row that sees no key
// is 0, as the TPU kernel's l == 0 guard makes it.
//
// What bounds it on an H100: operations.  At the serving path's shape
// (Qwen3-1.7B prefill: b=4, sq=sk=1024, h=16, kvh=8, hd=128, causal) the
// visible (q, k) pairs cost 4*hd flops each -- 1.72e10 flops, 0.257 ms at the
// card's 67 TFLOP/s of f32 FMA (the port keeps f32 products in full f32, so
// TF32 tensor cores are off) -- while q, k, v and out are 100.7 MB, 0.030 ms
// at 3.35 TB/s.  So the kernel has to keep the FMA pipes fed and touch each
// byte of device memory about once.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are a
// later step):
//   * One block owns one (batch, head, 64-query tile) and loops over the
//     64-key tiles inside itself -- in place of the TPU's sequential k grid
//     axis -- with the online-softmax state (m, l) and the 64 x hd output
//     accumulator in registers.  The (b*h) x q-tile grid is ordered with the
//     latest (most loaded, under causality) q tiles first.
//   * The loop starts and ends at the live key tiles: tiles wholly outside
//     the causal or window band are never loaded (the TPU kernel's pl.when
//     skip); masks inside a tile handle the diagonal and the ragged edges.
//   * Q (pre-scaled), K and V tiles are staged in dynamic shared memory as
//     f32, rows padded to hd + 4 floats so the 16-byte reads of 8 threads
//     hit distinct banks.  The P tile reuses K's buffer once the scores are
//     taken, which keeps a block under 102 KB at hd = 128: two blocks (16
//     warps) per SM.
//   * 256 threads as a 16 x 16 grid: a thread computes a 4 x 4 patch of the
//     scores with f32 FMA (rows ty*4.., keys tx+16j), reduces each row's max
//     and sum with warp shuffles over its 16 lanes, and accumulates a 4-row
//     by 4*ceil(hd/64)-column patch of P V.
//   * Rows and keys past sq / sk are zero-filled in shared memory and masked,
//     so no v row past sk is read and no padding is needed in the caller.
//   * Tensors are read and written through their (batch, seq, head) strides:
//     the model's (b, s, h, hd) layout goes in without a transpose.
//
// C interface, bound with ctypes: flash_attention_fwd returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid: (ty, tx)
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdP = kBlockK + kPad;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int bh, sq, sk, h, group, hd, n_q_tiles;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
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
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__host__ __device__ __forceinline__ int row_floats(int hd) { return hd + kPad; }

__host__ __device__ __forceinline__ int kbuf_floats(int hd) {
  const int ld = row_floats(hd);
  return kBlockK * (ld > kLdP ? ld : kLdP);
}

size_t smem_bytes(int hd) {
  return (size_t)(kBlockQ * row_floats(hd) + kbuf_floats(hd) + kBlockK * row_floats(hd)) *
         sizeof(float);
}

// Stage `rows_valid` rows of hd values (times `mul`) as f32 into a 64-row
// shared tile of row length ld; rows past rows_valid become 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long row_stride,
                                          int rows_valid, int hd, float mul) {
  const int chunks = hd / 4;
  for (int idx = threadIdx.x; idx < kBlockQ * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) {
      val = Elem<T>::load4(src + r * row_stride + c);
      val.x *= mul;
      val.y *= mul;
      val.z *= mul;
      val.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// NG = ceil(hd / 64): the float4 column groups of the output a thread owns.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = p.hd;
  const int ld = row_floats(hd);
  float* qs = smem;                     // kBlockQ x ld, pre-scaled q
  float* ks = qs + kBlockQ * ld;        // kBlockK x ld; then P, kBlockQ x kLdP
  float* vs = ks + kbuf_floats(hd);     // kBlockK x ld
  float* ps = ks;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q_tile = p.n_q_tiles - 1 - (int)(blockIdx.x / p.bh);
  const int bh = (int)(blockIdx.x % p.bh);
  const int b = bh / p.h;
  const int head = bh - b * p.h;
  const int kv_head = head / p.group;
  const int q0 = q_tile * kBlockQ;
  const int q_off = p.sk - p.sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss + head * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv_head * p.v_sh;
  const int q_rows = min(kBlockQ, p.sq - q0);
  load_tile<T>(qs, ld, qg, p.q_ss, q_rows, hd, p.scale);

  // the live keys of this tile's real rows: [k_begin, k_end)
  const int pos_lo = q0 + q_off;
  const int pos_hi = q0 + q_rows - 1 + q_off;
  int k_begin = 0;
  int k_end = p.sk;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end > k_begin) ? (k_end + kBlockK - 1) / kBlockK : t_begin;

  float acc[4][NG][4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    const int k_rows = min(kBlockK, p.sk - k0);
    __syncthreads();  // the previous tile's P V is done with ps (= ks) and vs
    load_tile<T>(ks, ld, kg + (long long)k0 * p.k_ss, p.k_ss, k_rows, hd, 1.f);
    load_tile<T>(vs, ld, vg + (long long)k0 * p.v_ss, p.v_ss, k_rows, hd, 1.f);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // softcap, mask, online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + ty * 4 + i + q_off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.sk;
        if (p.causal) ok = ok && kpos <= pos;
        if (p.window > 0) ok = ok && kpos > pos - p.window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      // a row with no visible key so far keeps p = 0 and acc = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_use);
        s[i][j] = e;
        rs += e;
      }
      rs = half_warp_sum(rs);
      const float alpha = (m_i[i] == -INFINITY) ? 0.f : expf(m_i[i] - m_use);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }

    __syncthreads();  // every thread is done reading ks: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P V; keys past sk have p = 0 and zero-filled v rows
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int col = (tx + 16 * g) * 4;
          if (col < hd) {
            const float4 vv = *reinterpret_cast<const float4*>(vs + (c + cc) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pi = comp(pv[i], cc);
              acc[i][g][0] = fmaf(pi, vv.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(pi, vv.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(pi, vv.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(pi, vv.w, acc[i][g][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float l = (l_i[i] == 0.f) ? 1.f : l_i[i];
    T* og = static_cast<T*>(p.o) + b * p.o_sb + (long long)(q0 + r) * p.o_ss + head * p.o_sh;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < hd)
        Elem<T>::store4(og + col, make_float4(acc[i][g][0] / l, acc[i][g][1] / l,
                                              acc[i][g][2] / l, acc[i][g][3] / l));
    }
  }
}

template <typename T, int NG>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.n_q_tiles * p.bh;
  flash_fwd_kernel<T, NG><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four tensors alike).  strides: the
// (batch, seq, head) strides of q, k, v and o, in elements, 12 values; the
// head_dim stride is 1 and every stride a multiple of 4, the pointers aligned
// to 4 elements (the wrapper checks).  window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int b, int sq, int sk, int h, int kvh, int hd,
                                   const long long* strides, int causal, int window,
                                   float softcap, float scale, void* stream) {
  if (b < 0 || sq < 0 || sk < 0 || h < 1 || kvh < 1 || h % kvh != 0 || hd < 8 || hd > 128 ||
      hd % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bh = b * h;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / kvh;
  p.hd = hd;
  p.n_q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64;
  if (dtype == 0) return wide ? launch<float, 2>(p, s) : launch<float, 1>(p, s);
  return wide ? launch<__nv_bfloat16, 2>(p, s) : launch<__nv_bfloat16, 1>(p, s);
}

// Dynamic shared memory a block takes at head_dim hd, in bytes.
extern "C" long long flash_attention_smem_bytes(int hd) { return (long long)smem_bytes(hd); }
