// consensus_mix: one gossip round W <- A W over the flattened server matrix.
//
// Replaces the Pallas TPU kernel consensus_mix_2d
// (src/repro/kernels/consensus_mix.py:71, body _mix_kernel at :58).
//
// What bounds it on an H100: memory.  A is (M, M) with M <= 64 and W is
// (M, D) with D the whole model (361,821,120 for SmolLM-360M), so a round
// reads M*D*4 bytes and writes M*D*4 bytes while doing 2*M*M*D flops -- at
// M = 4 that is 1 flop per byte, far below the ~20 flop/byte f32 ridge of
// the card (67 TFLOP/s over 3.35 TB/s).  The least time is the bytes over
// the memory rate; nothing but moving each byte once matters.
//
// Design:
//   * A is staged once per block in shared memory (padded to MT x MT, MT the
//     next power of two >= M); every thread reads the same A entry at the
//     same time, a broadcast with no bank conflicts.
//   * Each thread owns VEC consecutive columns: it loads that column group's
//     M values once into registers (16-byte float4 loads when the pointers
//     and leading dimensions allow it), then writes its M outputs.  Each W
//     byte is read once and each output byte written once.
//   * The sum over j runs left to right in f32 (fmaf).
//   * A bf16 instance (consensus_mix_bf16) does what the Pallas _mix_kernel
//     does with bf16 leaves: load bf16, accumulate A*w in f32 (A stays f32),
//     store bf16 rounded to nearest even.  It reads 8 bf16 (16 bytes) a
//     load where the alignment allows, and moves half the bytes of the f32
//     instance, so its bound is half as long.
//   * The ragged tail (D % VEC columns) is done in scalar code by block 0.
//   * Source and destination are distinct buffers (ping-pong across the T_S
//     rounds): the caller owns both, so the kernel allocates nothing.
//   * A grid-stride loop over a grid capped at a few blocks per SM keeps
//     enough loads in flight without launching millions of blocks.
//   * Leading dimensions (row strides) are arguments, so a column block of
//     a larger (M, D) buffer is mixed in place of a copy.
//
// C interface, bound with ctypes: consensus_mix_f32 and consensus_mix_bf16
// return the launch's cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    // a bf16 is the top half of an f32: widening is a shift
    v[0] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Mix VEC consecutive columns starting at col.
template <typename T, int MT, int VEC>
__device__ __forceinline__ void mix_columns(const float* sa, int m, const T* __restrict__ src,
                                            long long ld_src, T* __restrict__ dst,
                                            long long ld_dst, long long col) {
  float v[MT][VEC];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    if (j < m) {
      Vec<T, VEC>::load(src + j * ld_src + col, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < m) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j < m) {
          const float aij = sa[i * MT + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(aij, v[j][e], acc[e]);
        }
      }
      Vec<T, VEC>::store(dst + i * ld_dst + col, acc);
    }
  }
}

template <typename T, int MT, int VEC>
__global__ void __launch_bounds__(kThreads)
    consensus_mix_kernel(const float* __restrict__ a, int m, const T* __restrict__ src,
                         long long ld_src, T* __restrict__ dst, long long ld_dst,
                         long long d) {
  __shared__ float sa[MT * MT];
  for (int k = threadIdx.x; k < MT * MT; k += blockDim.x) {
    const int i = k / MT, j = k % MT;
    sa[k] = (i < m && j < m) ? a[i * m + j] : 0.f;
  }
  __syncthreads();

  const long long groups = d / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    mix_columns<T, MT, VEC>(sa, m, src, ld_src, dst, ld_dst, g * VEC);
  }
  if (VEC > 1 && blockIdx.x == 0) {
    const long long col = groups * VEC + threadIdx.x;
    if (col < d) mix_columns<T, MT, 1>(sa, m, src, ld_src, dst, ld_dst, col);
  }
}

template <typename T, int MT, int VEC>
void launch(const float* a, int m, const T* src, long long ld_src, T* dst, long long ld_dst,
            long long d, cudaStream_t stream) {
  const long long work = (d / VEC > 0) ? d / VEC : 1;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  consensus_mix_kernel<T, MT, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(a, m, src, ld_src,
                                                                             dst, ld_dst, d);
}

// Columns a vector load takes: 16 bytes (4 f32 or 8 bf16) while MT * VEC
// registers of staged values stay small, one otherwise.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T, int MT>
void launch_mt(bool vec, const float* a, int m, const T* src, long long ld_src, T* dst,
               long long ld_dst, long long d, cudaStream_t stream) {
  constexpr bool kWide = MT * kVec<T> <= 64;
  if (kWide && vec) {
    launch<T, MT, (kWide ? kVec<T> : 1)>(a, m, src, ld_src, dst, ld_dst, d, stream);
  } else {
    launch<T, MT, 1>(a, m, src, ld_src, dst, ld_dst, d, stream);
  }
}

template <typename T>
int mix(const void* a, int m, const void* src, long long ld_src, void* dst, long long ld_dst,
        long long d, void* stream) {
  if (m < 1 || m > 64 || d < 0 || ld_src < d || ld_dst < d) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  const float* pa = static_cast<const float*>(a);
  const T* ps = static_cast<const T*>(src);
  T* pd = static_cast<T*>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kV = kVec<T>;
  const bool vec = (reinterpret_cast<uintptr_t>(ps) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(pd) % 16 == 0) && (ld_src % kV == 0) &&
                   (ld_dst % kV == 0);
  if (m <= 1) launch_mt<T, 1>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else if (m <= 2) launch_mt<T, 2>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else if (m <= 4) launch_mt<T, 4>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else if (m <= 8) launch_mt<T, 8>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else if (m <= 16) launch_mt<T, 16>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else if (m <= 32) launch_mt<T, 32>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  else launch_mt<T, 64>(vec, pa, m, ps, ld_src, pd, ld_dst, d, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int consensus_mix_f32(const void* a, int m, const void* src, long long ld_src, void* dst,
                                 long long ld_dst, long long d, void* stream) {
  return mix<float>(a, m, src, ld_src, dst, ld_dst, d, stream);
}

// W and the output in bf16, A in f32; leading dimensions in elements.
extern "C" int consensus_mix_bf16(const void* a, int m, const void* src, long long ld_src,
                                  void* dst, long long ld_dst, long long d, void* stream) {
  return mix<__nv_bfloat16>(a, m, src, ld_src, dst, ld_dst, d, stream);
}
