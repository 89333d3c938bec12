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
// is 0, as the TPU kernel's l == 0 guard makes it.  Two instances, one per
// dtype, share the grid: a block holds 128 query rows, the query tile of
// tq = 128 / gb queries of gb heads that share one KV head (gb the largest
// power of two, at most 8, that divides h / kvh), so each K and V tile is
// loaded once for all of them; the latest (most loaded, under causality)
// query tiles run first; key tiles wholly outside the causal or window band
// are never loaded (the TPU kernel's pl.when skip), and masks inside a tile
// handle the diagonal and the ragged edges.  Tensors are read and written
// through their (batch, seq, head) strides: the model's (b, s, h, hd) layout
// goes in without a transpose; head_dim is padded with zeros to 64 or 128.
//
// ---- f32 (flash_fwd_kernel) ----
// What bounds it on an H100: operations.  chip_smoke.py counts 4*hd flops for
// each visible (q, k) pair: at the serving path's shape (Qwen3-1.7B prefill:
// b=4, sq=sk=1024, h=16, kvh=8, hd=128, causal) 1.72e10 flops, 0.257 ms at
// the card's 67 TFLOP/s of f32 FMA (f32 products stay in full f32: TF32
// tensor cores are off), while q, k, v and out are 100.7 MB, 0.030 ms at
// 3.35 TB/s.  So the kernel has to keep the FMA pipes fed.
//
// What held its first design back (0.79 ms, 0.325 of the bound): a block per
// (batch, QUERY head, 64-query tile), so the two query heads of a Qwen3 KV
// head each loaded the same K and V tiles; 4 x 4 scores a thread, 8 FMAs per
// float4 read from shared memory; synchronous K/V copies, and P in K's buffer,
// four barriers a key tile.
//
// Its design: 64-key tiles, K and V double-buffered in shared memory and
// copied with cp.async (16 bytes a copy; rows past sk and columns past hd are
// zero-filled): the next tile's copy is in flight while the current one
// computes; P has its own buffer: two barriers a key tile.  256 threads.
// Scores: a thread owns 8 query rows x 8 keys over one half of head_dim (the
// halves interleaved by float4), reading one float4 of q and of k per 4 FMAs
// of each of the other operand's 8 rows: 16 FMAs a float4; the halves are
// summed with one shuffle a score, after which each thread keeps 4 of its
// keys.  Exponentials use the MUFU ex2 unit (__expf); a tile whose row maxima
// did not move skips the rescale of the accumulators.  The online softmax's
// max and sum reduce over the 16 lanes that share the 8 rows, which are also
// the lanes that hold those rows' output.  P V: a thread owns the 8 rows x
// 4 * hdp / 64 columns: 16 FMAs a float4 at hd 128.  Q (pre-scaled, f32), K
// and V rows are stored unpadded with their float4 units XOR-swizzled by row;
// at hd = 128 the block takes 230,400 bytes of shared memory, one block
// (8 warps) per SM.
//
// ---- bf16 (flash_bf16_kernel) ----
// What bounds it: operations on the tensor cores, 4*hd flops a visible pair
// at 989 TFLOP/s of dense bf16 (Gemma-2's 6144-token prefill: 0.55-0.63 ms,
// Command-R's 1024-token one 0.070 ms), then the MUFU unit that takes the
// softmax's exponential (one a score) and, under a softcap, two more (the
// exponential and the reciprocal of tanh): at hd 128 a score is 512 tensor
// flops against 1-3 MUFU operations, which at the SM's 16 a clock caps a
// softcap mode near 0.6 of the tensor bound.  Bytes are far below: Gemma-2's
// q, k, v and out are 302 MB, 0.09 ms at 3.35 TB/s.
//
// What held the earlier bf16 instance back (18.6-26.7 ms on the zoo's modes,
// 0.028-0.031 of the bound): it was the f32 design with its operands widened
// on read, so both products ran on FFMA, capped by the 67 TFLOP/s f32 peak,
// and reached about 30 TFLOP/s.
//
// This design (FlashAttention-3's data path, without its intra-warpgroup
// overlap):
//   * Both products on wgmma, bf16 operands, f32 accumulators.  Consumer
//     warpgroup wc (two of them) owns block rows 64 wc .. 64 wc + 63.
//     S = Q K^T runs as m64n128k16 with Q and K from shared memory (both
//     K-major); O += P V as m64n{hdp}k16 with P from registers (the score
//     accumulator's layout is the A fragment's, so P never touches shared
//     memory) and V from shared memory, MN-major (the transpose bit).  The
//     row sums l come from the tensor cores too: m64n8k16 of the same P
//     against a tile of ones, so l is the exact f32 sum of the bf16 P.
//   * The scale (and log2 e, for ex2) multiplies the f32 scores, not a bf16
//     Q, folded into the exponential's FMA.  The online softmax runs on the
//     accumulator fragments: a thread holds two rows, whose max reduces over
//     the 4 lanes that share them; masks only on tiles the band or the ragged
//     end cuts; a warpgroup skips (but releases) a tile none of its rows
//     sees; O and l are rescaled only when some row of the warp moved its
//     maximum.  P is rounded to bf16 for the product and l sums the ROUNDED
//     P, so the weights stay normalised: each weight is off by at most 2^-8
//     of itself, and the output by that fraction of a weighted spread of v;
//     O is divided by l once and rounded once to bf16.  The softcap's tanh is
//     1 - 2 / (exp(2y) + 1) on ex2 and an approximate reciprocal (absolute
//     error ~1e-7, so cap * 2^-23 in a logit); tanh.approx's 2^-11 would move
//     a weight by 2% at cap 50.
//   * Loads: one thread of the producer warpgroup issues TMA copies (rank-4
//     tensor maps over (hd, heads, seq, batch), 64-column boxes, the 128-byte
//     swizzle wgmma's descriptors read) into a ring of 3 K/V stages under
//     mbarriers (full: bytes landed; empty: the 8 consumer warps are done);
//     reads past sk or hd fill zeros.  Q (128 x hdp) and 3 x (K + V) (128 keys
//     x hdp): 224 KB at hd 128, one block (12 warps) per SM.
//   * What the design leaves for later, as measured on the H100: a third
//     stage was faster than two; leaving the loads out did not move the time,
//     leaving the softmax out nearly halved it, so the softmax, which does
//     not overlap the products, is what costs.  Taking turns on the tensor
//     cores (named barriers) did not help.  Overlapping a tile's softmax with
//     the previous tile's P V needs S, O and P live at once (160 registers),
//     past what ptxas allots a consumer here (it spills and serialises the
//     wgmma), and setmaxnreg did not change that.
//   * TMA asks global strides in multiples of 16 bytes (8 bf16) and a
//     16-byte-aligned start; the wrapper refuses other views.  The maps are
//     encoded on the host at every call through cuTensorMapEncodeTiled,
//     reached with cudaGetDriverEntryPoint (flash_attention_encode_ns).
//
// C interface, bound with ctypes: flash_attention_fwd returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <initializer_list>

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

// ---- asynchronous copies: 4 floats (16 bytes), or 4 zeros ----
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__host__ __device__ __forceinline__ int head_dim_padded(int hd) { return hd > 64 ? 128 : 64; }

size_t smem_bytes(int hd) {
  const int hdp = head_dim_padded(hd);
  return (size_t)kRows * hdp * 4 + (size_t)2 * 2 * kTK * hdp * 4 + (size_t)kTK * kLdP * 4;
}

// NG = hdp / 64: hd padded to 64 (NG 1) or 128 (NG 2).
template <int NG>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  constexpr int kHdp = 64 * NG;
  constexpr int kUnits = kHdp / 4;  // float4 units of a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kHdp], unit u at u ^ ((r >> 2) & 7)
  float* ks = qs + kRows * kHdp;                // [2][kTK][kHdp], unit u at u ^ (r & 7)
  float* vs = ks + 2 * kTK * kHdp;              // [2][kTK][kHdp], likewise
  float* ps = vs + 2 * kTK * kHdp;              // [kTK][kLdP]

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

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kv_head * p.v_sh;

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
    float* kd = ks + st * kTK * kHdp;
    float* vd = vs + st * kTK * kHdp;
    for (int idx = tid; idx < kTK * kUnits; idx += kThreads) {
      const int r = idx / kUnits;
      const int u = idx - r * kUnits;
      const bool ok = k0 + r < p.sk && u * 4 < p.hd;
      const int at = r * kHdp + ((u ^ (r & 7)) << 2);
      cp_async4(kd + at, ok ? kg + (long long)(k0 + r) * p.k_ss + u * 4 : kg, ok);
      cp_async4(vd + at, ok ? vg + (long long)(k0 + r) * p.v_ss + u * 4 : vg, ok);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) fetch(t_begin, 0);

  // Q, pre-scaled, as f32; rows past sq and columns past hd are 0
  {
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb;
    for (int idx = tid; idx < kRows * kUnits; idx += kThreads) {
      const int r = idx / kUnits;
      const int u = idx - r * kUnits;
      const int qi = r % p.tq;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < q_rows && u * 4 < p.hd) {
        val = load4(qg + (long long)(q0 + qi) * p.q_ss + (head0 + r / p.tq) * p.q_sh +
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
    const float* kc = ks + st * kTK * kHdp;
    const float* vc = vs + st * kTK * kHdp;
    const int k0 = t * kTK;

    // partial scores over this thread's half of head_dim: rows rg*8 + i, keys kg8 + 8 (j ^ 4 dh),
    // so that both halves keep their columns 0-3 (the keys kg8 + 8 (4 dh + jj)) and send 4-7
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const float* k_keep = kc + (kg8 + 32 * dh) * kHdp;
    const float* k_send = kc + (kg8 + 32 - 32 * dh) * kHdp;
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
        const float* kr = (j < 4 ? k_keep : k_send) + 8 * (j & 3) * kHdp;
        const float4 kv = load4(kr + ((u ^ kg8) << 2));
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
        const float4 vv = load4(vc + k * kHdp + (((cg + 16 * g) ^ (k & 7)) << 2));
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
    float* og = static_cast<float*>(p.o) + b * p.o_sb + (long long)(q0 + qi) * p.o_ss +
                (head0 + r / p.tq) * p.o_sh;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (cg + 16 * g) * 4;
      if (col < p.hd)
        store4(og + col, make_float4(acc[i][4 * g] * inv_l, acc[i][4 * g + 1] * inv_l,
                                     acc[i][4 * g + 2] * inv_l, acc[i][4 * g + 3] * inv_l));
    }
  }
}

// ===================== the bf16 instance: wgmma, TMA, warp specialisation =====================

constexpr int kBN = 128;           // keys a tile
constexpr int kStages = 3;         // K/V tiles in flight
constexpr int kThreadsB = 384;     // a producer warpgroup and two consumer warpgroups of 64 rows
constexpr int kChunk = 128 * 128;  // bytes of one TMA box: 128 rows x 64 bf16 (128-byte swizzle)
constexpr float kLog2e = 1.4426950408889634f;

size_t smem_bytes_bf16(int hd) {
  const int ng = head_dim_padded(hd) / 64;
  // 1024 bytes to align the tiles to the swizzle's period; Q, K and V tiles;
  // 1024 bytes of bf16 ones (the B operand of the row sums); the mbarriers
  return 1024 + (size_t)(1 + 2 * kStages) * ng * kChunk + 1024 + 8 * (1 + 2 * kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a wait of
// 2^34 clocks (~10 s) traps, so a lost copy ends the launch with an error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// one box of a rank-4 tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory descriptor, 128-byte swizzle; byte offsets: lbo between
// 64-column atoms (MN-major operands only), sbo between 8-row groups
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's accumulators across
// the asynchronous product (the wgmma statements name them, the wait does not)
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B for A 64 x 16 (Q rows) and B 16 x 128 (keys), both from shared memory, K-major;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for A 64 x 16 in registers (P, bf16 pairs) and B 16 x 128 or 16 x 64 (V) from
// shared memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for A 64 x 16 in registers (P) and B 16 x 8 from shared memory, K-major:
// with B all ones, each of a row's columns gets the row's sum of A
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A consumer thread's two rows and its place in the tile.
struct Rows {
  int pos0, pos1;        // the rows' query positions
  int cb;                // the thread's first column of each 8
  int wpos_lo, wpos_hi;  // the warpgroup's real rows' positions
  float sl2;             // scale * log2 e
  float cap2, cap_l2;    // softcap: 2 log2 e * scale / cap, cap * log2 e
};

// The tile's scores, in place, made ready for the exponential: with kCap the
// capped score cap * tanh(y), y = s * scale / cap, in log2 units, where
// tanh(y) = 1 - 2 / (exp(2y) + 1); without, the raw score (the exponential's
// FMA scales it); -inf where the mask hides a key (kMask: only on tiles the
// band or the ragged end cuts).  Adds the two rows' maxima over this
// thread's columns into (mx0, mx1).
template <bool kMask, bool kCap>
__device__ __forceinline__ void mask_scores(float (&s)[64], const Params& p, const Rows& w,
                                            int k0, float& mx0, float& mx1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = s[i];
    if constexpr (kCap) x = w.cap_l2 - __fdividef(2.f * w.cap_l2, ex2(x * w.cap2) + 1.f);
    if constexpr (kMask) {
      const int key = k0 + 8 * (i >> 2) + w.cb + (i & 1);
      const int pos = (i & 2) ? w.pos1 : w.pos0;
      bool ok = key < p.sk;
      if (p.causal) ok = ok && key <= pos;
      if (p.window > 0) ok = ok && key > pos - p.window;
      x = ok ? x : -INFINITY;
    }
    s[i] = x;
    if (i & 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
}

// The online softmax of tile k0's scores: P = 2^(x - m) rounded to bf16, in
// wgmma's A-fragment layout (the score accumulator's columns 16 kk .. 16 kk +
// 15 are A fragment kk), (m0, m1) the new row maxima in log2 units; O and l
// are to be scaled by (al0, al1).
template <bool kCap>
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&pa)[8][4],
                                             const Params& p, const Rows& w, int k0, float& m0,
                                             float& m1, float& al0, float& al1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  const bool whole = k0 + kBN <= p.sk && (!p.causal || k0 + kBN - 1 <= w.wpos_lo) &&
                     (p.window <= 0 || k0 > w.wpos_hi - p.window);
  if (whole)
    mask_scores<false, kCap>(s, p, w, k0, mx0, mx1);
  else
    mask_scores<true, kCap>(s, p, w, k0, mx0, mx1);
  // the row maxima over the 4 lanes that hold a row, in log2 units
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float sc = kCap ? 1.f : w.sl2;
  const float mn0 = fmaxf(m0, mx0 * sc);
  const float mn1 = fmaxf(m1, mx1 * sc);
  // a row with no visible key so far keeps p = 0 and o = 0: ex2(-inf - 0) = 0
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = ex2(m0 - mu0);
  al1 = ex2(m1 - mu1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(ex2(fmaf(s[4 * nb], sc, -mu0)),
                                                    ex2(fmaf(s[4 * nb + 1], sc, -mu0)));
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(ex2(fmaf(s[4 * nb + 2], sc, -mu1)),
                                                    ex2(fmaf(s[4 * nb + 3], sc, -mu1)));
    pa[nb >> 1][2 * (nb & 1)] = *reinterpret_cast<const uint32_t*>(&h0);
    pa[nb >> 1][2 * (nb & 1) + 1] = *reinterpret_cast<const uint32_t*>(&h1);
  }
}

// S = Q K^T for the warpgroup's 64 rows: 4 NG steps of 16 along head_dim;
// q_a: the warpgroup's first Q row, k_a: the stage's K tile
template <int NG>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_a, uint32_t k_a) {
#pragma unroll
  for (int kk = 0; kk < 4 * NG; ++kk) {
    const uint32_t col = (kk >> 2) * kChunk + (kk & 3) * 32;
    wgmma_ss_n128(s, smem_desc(q_a + col, 16, 1024), smem_desc(k_a + col, 16, 1024), kk);
  }
}

// O += P V and l += P 1: 8 steps of 16 keys; v_a: the stage's V tile, ones_a:
// 1024 bytes of bf16 ones
template <int NG>
__device__ __forceinline__ void issue_pv(float (&o)[32 * NG], float (&l)[4],
                                         const uint32_t (&pa)[8][4], uint32_t v_a,
                                         uint32_t ones_a) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_rs(o, pa[kk], smem_desc(v_a + kk * 16 * 128, kChunk, 1024));
    wgmma_rs_n8(l, pa[kk], smem_desc(ones_a, 16, 1024));
  }
}

// NG = hdp / 64: hd padded to 64 (NG 1) or 128 (NG 2); kCap: a softcap.
template <int NG, bool kCap>
__global__ void __launch_bounds__(kThreadsB, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // Q: NG boxes of 128 rows; stage st: K (NG boxes of kBN keys) then V (likewise)
  const uint32_t q_s = base;
  const uint32_t kv_s = base + NG * kChunk;
  const uint32_t ones_a = base + (1 + 2 * kStages) * NG * kChunk;
  const uint32_t q_full = ones_a + 1024;
  const uint32_t full0 = q_full + 8;              // + 8 st: stage st landed
  const uint32_t empty0 = full0 + 8 * kStages;    // + 8 st: both consumers are done with st

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

  // the live key tiles of the block's real rows: [t_begin, t_end)
  const int pos_lo = q0 + q_off;
  const int pos_hi = q0 + q_rows - 1 + q_off;
  int k_begin = 0;
  int k_end = p.sk;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  const int t_begin = k_begin / kBN;
  const int t_end = (k_end > k_begin) ? (k_end + kBN - 1) / kBN : t_begin;

  for (int i = threadIdx.x; i < 256; i += kThreadsB)  // bf16 1.0 = 0x3f80
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ones_a + 4 * i), "r"(0x3f803f80u) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup (0 loads, 1 and 2 compute), warp-uniform as ptxas sees it:
  // the consumers' softcap instance at hd 128 spills without the shuffle
  const int wg = __shfl_sync(kFull, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NG * kChunk);
      for (int c = 0; c < NG; ++c)
        for (int i = 0; i < p.gb; ++i)
          tma_load_4d(q_s + c * kChunk + i * p.tq * 128, &qmap, q_full, 64 * c, head0 + i, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int n = t - t_begin;
        const int st = n % kStages;
        mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t ks = kv_s + st * 2 * NG * kChunk;
        mbar_expect_tx(full, 2 * NG * kChunk);
        for (int c = 0; c < NG; ++c) {
          tma_load_4d(ks + c * kChunk, &kmap, full, 64 * c, kv_head, t * kBN, b);
          tma_load_4d(ks + (NG + c) * kChunk, &vmap, full, 64 * c, kv_head, t * kBN, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wc owns block rows 64 wc .. 64 wc + 63 ----
    const int ct = threadIdx.x - 128;
    const int wc = wg - 1;
    const int lane = ct & 31;
    const int r0 = wc * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const int r1 = r0 + 8;
    Rows w;
    w.pos0 = q0 + r0 % p.tq + q_off;
    w.pos1 = q0 + r1 % p.tq + q_off;
    w.cb = 2 * (lane & 3);
    // the warpgroup's real query rows [qmin, qmax] within the tile
    const int qmin = p.tq >= 64 ? (wc * 64) % p.tq : 0;
    const int qmax = min(p.tq >= 64 ? qmin + 63 : p.tq - 1, q_rows - 1);
    w.wpos_lo = q0 + qmin + q_off;
    w.wpos_hi = q0 + qmax + q_off;
    w.sl2 = p.scale * kLog2e;
    w.cap2 = kCap ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
    w.cap_l2 = kCap ? p.softcap * kLog2e : 0.f;
    // the warpgroup's live key tiles [wt_begin, wt_end), inside the block's
    int wt_begin = t_begin, wt_end = t_begin;
    if (qmin <= qmax) {
      const int wk_begin = p.window > 0 ? max(0, w.wpos_lo - p.window + 1) : 0;
      const int wk_end = p.causal ? min(p.sk, w.wpos_hi + 1) : p.sk;
      if (wk_end > wk_begin) {
        wt_begin = max(t_begin, wk_begin / kBN);
        wt_end = max(wt_begin, min(t_end, (wk_end + kBN - 1) / kBN));
      }
    }
    const uint32_t q_a = q_s + wc * 64 * 128;
    // tile t's stage: its K at kv_a(t), its V NG boxes further
    auto kv_a = [&](int t) { return kv_s + ((t - t_begin) % kStages) * 2 * NG * kChunk; };
    auto wait_tile = [&](int t) {
      mbar_wait(full0 + 8 * ((t - t_begin) % kStages), ((t - t_begin) / kStages) & 1);
    };
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty0 + 8 * ((t - t_begin) % kStages));
    };

    float o[32 * NG];
#pragma unroll
    for (int i = 0; i < 32 * NG; ++i) o[i] = 0.f;
    // l: the rows' sums of the bf16 P that the product uses, from the tensor
    // cores (l[0], l[1]: row r0; l[2], l[3]: row r1)
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    float m0 = -INFINITY, m1 = -INFINITY;
    mbar_wait(q_full, 0);
    for (int t = t_begin; t < wt_begin; ++t) {  // tiles only the other warpgroup sees
      wait_tile(t);
      release(t);
    }
    for (int t = wt_begin; t < wt_end; ++t) {
      float s[64];
      uint32_t pa[8][4];
      float al0, al1;
      wait_tile(t);
      wgmma_fence();
      issue_s<NG>(s, q_a, kv_a(t));
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      softmax_tile<kCap>(s, pa, p, w, t * kBN, m0, m1, al0, al1);
      if (!__all_sync(kFull, al0 == 1.f && al1 == 1.f)) {  // some row's maximum moved
#pragma unroll
        for (int i = 0; i < 32 * NG; ++i) o[i] *= (i & 2) ? al1 : al0;
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] *= (i & 2) ? al1 : al0;
      }
      pin(o);
      pin(l);
      wgmma_fence();
      issue_pv<NG>(o, l, pa, kv_a(t) + NG * kChunk, ones_a);
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(l);
      release(t);
    }
    for (int t = wt_end; t < t_end; ++t) {  // tiles only the other warpgroup sees
      wait_tile(t);
      release(t);
    }

    const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;  // a row that saw no key is 0
    const float inv1 = l[2] > 0.f ? 1.f / l[2] : 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rr ? r1 : r0;
      const int qi = r % p.tq;
      if (qi >= q_rows) continue;
      const float inv = rr ? inv1 : inv0;
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                          (long long)(q0 + qi) * p.o_ss + (head0 + r / p.tq) * p.o_sh;
#pragma unroll
      for (int nb = 0; nb < 8 * NG; ++nb) {
        const int col = 8 * nb + w.cb;
        if (col < p.hd)
          *reinterpret_cast<__nv_bfloat162*>(og + col) = __floats2bfloat162_rn(
              o[4 * nb + 2 * rr] * inv, o[4 * nb + 2 * rr + 1] * inv);
      }
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

template <int NG>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.n_q_tiles * p.b * p.kvh * p.n_hg;
  flash_fwd_kernel<NG><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// host nanoseconds of the last bf16 call's three tensor-map encodings
long long g_encode_ns = 0;

// A rank-4 map of a bf16 tensor in the model layout, dims (hd, heads, seq, batch)
// innermost first, strides in elements; boxes of 64 columns x 1 head x `rows`
// positions, 128-byte swizzle; reads past an edge fill zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads, int seq, int batch,
                long long s_head, long long s_seq, long long s_batch, int rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)max(seq, 1),
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_seq * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NG, bool kCap>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap qmap, kmap, vmap;
  const bool ok =
      encode_map(&qmap, p.q, p.hd, p.kvh * p.group, p.sq, p.b, p.q_sh, p.q_ss, p.q_sb, p.tq) &&
      encode_map(&kmap, p.k, p.hd, p.kvh, p.sk, p.b, p.k_sh, p.k_ss, p.k_sb, kBN) &&
      encode_map(&vmap, p.v, p.hd, p.kvh, p.sk, p.b, p.v_sh, p.v_ss, p.v_sb, kBN);
  g_encode_ns =
      std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0)
          .count();
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes_bf16(p.hd);
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<NG, kCap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.n_q_tiles * p.b * p.kvh * p.n_hg;
  flash_bf16_kernel<NG, kCap><<<(unsigned)blocks, kThreadsB, smem, stream>>>(qmap, kmap, vmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four tensors alike).  strides: the
// (batch, seq, head) strides of q, k, v and o, in elements, 12 values; the
// head_dim stride is 1.  float32: every stride a multiple of 4 and the pointers
// aligned to 16 bytes; bfloat16 (TMA): q/k/v strides multiples of 8 (16 bytes),
// o's even, the pointers aligned to 16 bytes (the wrapper checks).  window <= 0
// and softcap <= 0 mean none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int b, int sq, int sk, int h, int kvh, int hd,
                                   const long long* strides, int causal, int window,
                                   float softcap, float scale, void* stream) {
  if (b < 0 || sq < 0 || sk < 0 || h < 1 || kvh < 1 || h % kvh != 0 || hd < 8 || hd > 128 ||
      hd % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  if (dtype == 1) {
    for (int i = 0; i < 9; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
    for (const void* ptr : {q, k, v})
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
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
  if (dtype == 0) return wide ? launch_f32<2>(p, s) : launch_f32<1>(p, s);
  if (softcap > 0.f) return wide ? launch_bf16<2, true>(p, s) : launch_bf16<1, true>(p, s);
  return wide ? launch_bf16<2, false>(p, s) : launch_bf16<1, false>(p, s);
}

// Dynamic shared memory a block takes at head_dim hd, in bytes, for f32 (dtype 0)
// or bf16 (dtype 1) operands.
extern "C" long long flash_attention_smem_bytes(int hd, int dtype) {
  return (long long)(dtype == 1 ? smem_bytes_bf16(hd) : smem_bytes(hd));
}

// Blocks of one launch.
extern "C" long long flash_attention_blocks(int b, int sq, int h, int kvh) {
  if (b < 1 || sq < 1 || h < 1 || kvh < 1 || h % kvh) return 0;
  return grid_blocks(b, sq, h, kvh);
}

// Host nanoseconds the last bf16 call spent encoding its three TMA descriptors.
extern "C" long long flash_attention_encode_ns() { return g_encode_ns; }
