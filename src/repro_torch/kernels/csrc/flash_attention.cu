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
// What bounds it on an H100: operations.  chip_smoke.py counts 4*hd flops for
// each visible (q, k) pair: at the serving path's shape (Qwen3-1.7B prefill:
// b=4, sq=sk=1024, h=16, kvh=8, hd=128, causal) 1.72e10 flops, 0.257 ms at
// the card's 67 TFLOP/s of f32 FMA (f32 products stay in full f32: TF32
// tensor cores are off), while q, k, v and out are 100.7 MB, 0.030 ms at
// 3.35 TB/s.  So the kernel has to keep the FMA pipes fed.
//
// What held the first design back (0.79 ms, 0.325 of the bound): a block per
// (batch, QUERY head, 64-query tile), so the two query heads of a Qwen3 KV
// head each loaded the same K and V tiles; 4 x 4 scores a thread, 8 FMAs per
// float4 read from shared memory; synchronous K/V copies, and P in K's buffer,
// four barriers a key tile.
//
// This design:
//   * A block holds 128 query rows: the query tile of tq = 128 / gb queries of
//     gb heads that share one KV head (gb the largest power of two, at most 8,
//     that divides h / kvh: both heads of a Qwen3 KV head, tq = 64; a group of
//     8 in one block, tq = 16; a group of 3 over three blocks, tq = 128).  Each
//     K and V tile is loaded once for all of them.  The grid runs the latest
//     (most loaded, under causality) query tiles first, and the key loop runs
//     over the live 64-key tiles only: tiles wholly outside the causal or
//     window band are never loaded (the TPU kernel's pl.when skip); masks
//     inside a tile handle the diagonal and the ragged edges.
//   * K and V are double-buffered in shared memory and copied with cp.async
//     (16 bytes a copy; 8 for bf16, which stays bf16 in shared memory and is
//     widened on read): the next tile's copy is in flight while the current
//     one computes.  Rows past sk and columns past hd are zero-filled by the
//     copy, so no padding is needed in the caller.  P has its own buffer: two
//     barriers a key tile.
//   * 256 threads.  Scores: a thread owns 8 query rows x 8 keys over one half
//     of head_dim (the halves interleaved by float4), reading one float4 of q
//     and of k per 4 FMAs of each of the other operand's 8 rows: 16 FMAs a
//     float4; the halves are summed with one shuffle a score, after which each
//     thread keeps 4 of its keys.  Exponentials of the probabilities use the
//     MUFU ex2 unit (__expf); a tile whose row maxima did not move skips the
//     rescale of the accumulators.  The online softmax's max and sum reduce
//     over the 16 lanes that share the 8 rows, which are also the lanes that
//     hold those rows' output: (m, l) and the rescale never leave registers.
//     P V: a thread owns the 8 rows x 4 * hdp / 64 columns, 2 float4 of P and
//     hdp / 64 float4 of V per key: 16 FMAs a float4 at hd 128.
//   * Q (pre-scaled, f32), K and V rows are stored unpadded with their float4
//     units XOR-swizzled by row, so the reads of a warp fall on distinct
//     banks; at hd = 128 the block takes 230,400 bytes of shared memory, one
//     block (8 warps) per SM.  head_dim is padded with zeros to 64 or 128.
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

constexpr int kRows = 128;      // query rows a block holds (heads of a group x query tile)
constexpr int kTK = 64;         // keys a tile
constexpr int kThreads = 256;
constexpr int kLdP = kRows + 4;  // P row: 128 query rows + 4 floats of padding
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, sk, kvh, group, gb, tq, n_hg, n_q_tiles, hd;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int head_dim_padded(int hd) { return hd > 64 ? 128 : 64; }

size_t smem_bytes(int hd, int elem) {
  const int hdp = head_dim_padded(hd);
  return (size_t)kRows * hdp * 4 + (size_t)2 * 2 * kTK * hdp * elem +
         (size_t)kTK * kLdP * 4;
}

// NG = hdp / 64: hd padded to 64 (NG 1) or 128 (NG 2).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  constexpr int kHdp = 64 * NG;
  constexpr int kUnits = kHdp / 4;  // float4 units of a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // [kRows][kHdp], unit u at u ^ ((r >> 2) & 7)
  T* ks = reinterpret_cast<T*>(qs + kRows * kHdp);  // [2][kTK][kHdp], unit u at u ^ (r & 7)
  T* vs = ks + 2 * kTK * kHdp;                       // [2][kTK][kHdp], likewise
  float* ps = reinterpret_cast<float*>(vs + 2 * kTK * kHdp);  // [kTK][kLdP]

  const int tid = threadIdx.x;
  const int per = p.b * p.kvh * p.n_hg;
  const int q_tile = p.n_q_tiles - 1 - (int)(blockIdx.x / per);
  int rest = (int)(blockIdx.x % per);
  const int hg = rest % p.n_hg;
  rest /= p.n_hg;
  const int kv_head = rest % p.kvh;
  const int b = rest / p.kvh;
  const int head0 = kv_head * p.group + hg * p.gb;
  const int q0 = q_tile * p.tq;
  const int q_off = p.sk - p.sq;
  const int q_rows = min(p.tq, p.sq - q0);

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv_head * p.v_sh;

  // the live keys of this tile's real rows: [k_begin, k_end)
  const int pos_lo = q0 + q_off;
  const int pos_hi = q0 + q_rows - 1 + q_off;
  int k_begin = 0;
  int k_end = p.sk;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  const int t_begin = k_begin / kTK;
  const int t_end = (k_end > k_begin) ? (k_end + kTK - 1) / kTK : t_begin;

  auto fetch = [&](int t, int st) {
    const int k0 = t * kTK;
    T* kd = ks + st * kTK * kHdp;
    T* vd = vs + st * kTK * kHdp;
    for (int idx = tid; idx < kTK * kUnits; idx += kThreads) {
      const int r = idx / kUnits;
      const int u = idx - r * kUnits;
      const bool ok = k0 + r < p.sk && u * 4 < p.hd;
      const int at = r * kHdp + ((u ^ (r & 7)) << 2);
      cp_async4<T>(kd + at, ok ? kg + (long long)(k0 + r) * p.k_ss + u * 4 : kg, ok);
      cp_async4<T>(vd + at, ok ? vg + (long long)(k0 + r) * p.v_ss + u * 4 : vg, ok);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) fetch(t_begin, 0);

  // Q, pre-scaled, as f32; rows past sq and columns past hd are 0
  {
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
    for (int idx = tid; idx < kRows * kUnits; idx += kThreads) {
      const int r = idx / kUnits;
      const int u = idx - r * kUnits;
      const int qi = r % p.tq;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < q_rows && u * 4 < p.hd) {
        val = Elem<T>::load4(qg + (long long)(q0 + qi) * p.q_ss + (head0 + r / p.tq) * p.q_sh +
                             u * 4);
        val.x *= p.scale;
        val.y *= p.scale;
        val.z *= p.scale;
        val.w *= p.scale;
      }
      *reinterpret_cast<float4*>(qs + r * kHdp + ((u ^ ((r >> 2) & 7)) << 2)) = val;
    }
  }

  // lanes: rg = the 8 rows (rg*8 ..) both roles share; scores: dh = head_dim half,
  // kg8 = keys kg8 + 8 j; P V: cg = columns (cg + 16 g) * 4
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  const int rg = tid >> 4;
  const int dh = (tid >> 3) & 1;
  const int kg8 = tid & 7;
  const int cg = tid & 15;

  float acc[8][4 * NG];
  float m_i[8], l_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t (and Q) landed; every thread is done with tile t - 1 and P
    if (t + 1 < t_end) fetch(t + 1, st ^ 1);
    const T* kc = ks + st * kTK * kHdp;
    const T* vc = vs + st * kTK * kHdp;
    const int k0 = t * kTK;

    // partial scores over this thread's half of head_dim: rows rg*8 + i, keys kg8 + 8 (j ^ 4 dh),
    // so that both halves keep their columns 0-3 (the keys kg8 + 8 (4 dh + jj)) and send 4-7
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const T* k_keep = kc + (kg8 + 32 * dh) * kHdp;
    const T* k_send = kc + (kg8 + 32 - 32 * dh) * kHdp;
#pragma unroll 1
    for (int m = 0; m < kUnits / 2; ++m) {
      const int u = 2 * m + dh;
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
        qv[i] = *reinterpret_cast<const float4*>(qs + r * kHdp + ((u ^ ((r >> 2) & 7)) << 2));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* kr = (j < 4 ? k_keep : k_send) + 8 * (j & 3) * kHdp;
        const float4 kv = Elem<T>::load4(kr + ((u ^ kg8) << 2));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    // sum the two halves: this thread keeps keys kg8 + 8 (4 dh + jj), jj < 4
    float own[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) own[i][jj] = s[i][jj] + __shfl_xor_sync(kFull, s[i][jj + 4], 8);

    // softcap, mask (only on tiles some row does not see whole), online softmax; the 8
    // rows' reductions interleaved, so their shuffles overlap
    const bool whole = k0 + kTK <= p.sk && (!p.causal || k0 + kTK - 1 <= pos_lo) &&
                       (p.window <= 0 || k0 > pos_hi - p.window);
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pos = q0 + (rg * 8 + i) % p.tq + q_off;
      mx[i] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = own[i][jj];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x * inv_cap);
        if (!whole) {
          const int kpos = k0 + kg8 + 8 * (4 * dh + jj);
          bool ok = kpos < p.sk;
          if (p.causal) ok = ok && kpos <= pos;
          if (p.window > 0) ok = ok && kpos > pos - p.window;
          x = ok ? x : -INFINITY;
        }
        own[i][jj] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], off));
    float rs[8];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_new = fmaxf(m_i[i], mx[i]);
      // a row with no visible key so far keeps p = 0 and acc = 0: exp(-inf - 0) = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      rs[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float e = __expf(own[i][jj] - m_use);
        own[i][jj] = e;
        rs[i] += e;
      }
      moved = moved || m_new != m_i[i];
      mx[i] = expf(m_i[i] - m_use);  // now the rescale alpha (0 from m_i = -inf)
      m_i[i] = m_new;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) rs[i] += __shfl_xor_sync(kFull, rs[i], off);
#pragma unroll
    for (int i = 0; i < 8; ++i) l_i[i] = mx[i] * l_i[i] + rs[i];
    if (moved) {  // else every alpha is 1
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= mx[i];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float* pr = ps + (kg8 + 8 * (4 * dh + jj)) * kLdP + rg * 8;
      *reinterpret_cast<float4*>(pr) = make_float4(own[0][jj], own[1][jj], own[2][jj], own[3][jj]);
      *reinterpret_cast<float4*>(pr + 4) =
          make_float4(own[4][jj], own[5][jj], own[6][jj], own[7][jj]);
    }
    __syncthreads();  // P is complete

    // acc += P V; keys past sk have p = 0 and zero-filled v rows
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + k * kLdP + rg * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + k * kLdP + rg * 8 + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = Elem<T>::load4(vc + k * kHdp + (((cg + 16 * g) ^ (k & 7)) << 2));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * g] = fmaf(pv[i], vv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(pv[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    const int qi = r % p.tq;
    if (qi >= q_rows) continue;
    const float inv_l = (l_i[i] == 0.f) ? 1.f : 1.f / l_i[i];
    T* og = static_cast<T*>(p.o) + b * p.o_sb + (long long)(q0 + qi) * p.o_ss +
            (head0 + r / p.tq) * p.o_sh;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (cg + 16 * g) * 4;
      if (col < p.hd)
        Elem<T>::store4(og + col, make_float4(acc[i][4 * g] * inv_l, acc[i][4 * g + 1] * inv_l,
                                              acc[i][4 * g + 2] * inv_l,
                                              acc[i][4 * g + 3] * inv_l));
    }
  }
}

// heads a block takes: the largest power of two, at most 8, that divides the group
int heads_a_block(int group) {
  int gb = 1;
  while (gb < 8 && group % (2 * gb) == 0) gb *= 2;
  return gb;
}

long long grid_blocks(int b, int sq, int h, int kvh) {
  const int group = h / kvh;
  const int gb = heads_a_block(group);
  const int tq = kRows / gb;
  return (long long)((sq + tq - 1) / tq) * b * kvh * (group / gb);
}

template <typename T, int NG>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.n_q_tiles * p.b * p.kvh * p.n_hg;
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
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.kvh = kvh;
  p.group = h / kvh;
  p.gb = heads_a_block(p.group);
  p.tq = kRows / p.gb;
  p.n_hg = p.group / p.gb;
  p.n_q_tiles = (sq + p.tq - 1) / p.tq;
  p.hd = hd;
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
  const bool wide = head_dim_padded(hd) > 64;
  if (dtype == 0) return wide ? launch<float, 2>(p, s) : launch<float, 1>(p, s);
  return wide ? launch<__nv_bfloat16, 2>(p, s) : launch<__nv_bfloat16, 1>(p, s);
}

// Dynamic shared memory a block takes at head_dim hd, in bytes, for f32 (dtype 0)
// or bf16 (dtype 1) operands.
extern "C" long long flash_attention_smem_bytes(int hd, int dtype) {
  return (long long)smem_bytes(hd, dtype == 1 ? 2 : 4);
}

// Blocks of one launch.
extern "C" long long flash_attention_blocks(int b, int sq, int h, int kvh) {
  if (b < 1 || sq < 1 || h < 1 || kvh < 1 || h % kvh) return 0;
  return grid_blocks(b, sq, h, kvh);
}
