// Float32-exact tensor-core products for sm_90a, shared by ssd_chunk.cu's
// forward and backward and flash_attention_bwd.cu's float32 path: 3xTF32
// on mma.sync m16n8k8.
//
// TF32 keeps 10 mantissa bits.  A float32 operand v is split into
// big = tf32(v) and small = tf32(v - big) (v - big is exact in float32),
// so v = big + small to about 2^-22 relative, and
//
//   a * b ~= a_small * b_big + a_big * b_small + a_big * b_big
//
// (the small products first, all three into one float32 accumulator; the
// dropped a_small * b_small is below float32's own rounding).  An operand
// that is exact in TF32 already, as every value read from bfloat16 is,
// needs no split: its small part is 0 and its products are skipped, so a
// bf16 x bf16 product is one mma.
//
// Fragment layout (PTX ISA, mma.m16n8k8 .tf32): thread (g = lane / 4,
// tq = lane % 4) holds A rows g and g + 8 at columns tq and tq + 4, B
// column g at rows tq and tq + 4, and accumulator rows g and g + 8 at
// columns 2tq and 2tq + 1.  warp_mma reads its fragments from float32
// tiles in shared memory, either as stored (element [row][k]) or through
// the transpose (element [k][row]), so no tile is ever transposed in
// memory.  An accumulator tile is also the A fragment of one k-step of a
// next product, with no shuffle, if that product orders its k dimension
// as (2tq, 2tq + 1) in place of (tq, tq + 4): its B rows then come in the
// same order (mma3's callers say where).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"   // cp_async16, cp_async_commit, cp_async_wait

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __float2bfloat16(v);
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) a[r][c] = 0.f;
}

// dst [R][LD] <- rows x cols of src (row stride `stride` elements), zero
// past either edge, by THREADS threads.  vec (rows 16-byte aligned, cols a
// whole number of 16-byte pieces) with dst of src's type: cp.async, which
// the caller commits and waits for; otherwise loaded (and converted to
// dst's type) by the threads.
template <int R, int C, int LD, int THREADS, typename Ts, typename T>
__device__ __forceinline__ void load_tile(Ts* dst, const T* src,
                                          long long stride, int rows,
                                          int cols, bool vec, int tid) {
  if constexpr (std::is_same<Ts, T>::value) {
    if (vec) {
      constexpr int kPer = 16 / sizeof(T), kPieces = C / kPer;
      for (int e = tid; e < R * kPieces; e += THREADS) {
        const int r = e / kPieces, c = (e % kPieces) * kPer;
        const bool ok = r < rows && c < cols;
        cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
      }
      return;
    }
  }
  for (int e = tid; e < R * C; e += THREADS) {
    const int r = e / C, c = e % C;
    dst[r * LD + c] = from_f32<Ts>(
        (r < rows && c < cols) ? to_f32(src[r * stride + c]) : 0.f);
  }
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small (kSplit), or v as it is when it is exact in TF32
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  if constexpr (kSplit) {
    big = tf32_bits(v);
    small = tf32_bits(v - __uint_as_float(big));
  } else {
    big = __float_as_uint(v);
    small = 0u;
  }
}

// d += a * b for one m16n8k8 tile: tf32 inputs, f32 accumulators
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared, asynchronously (cp.async's cache-all form, the
// only one for 4 bytes); zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// d += a * b from operands split already: a as big[4] and small[4], b's two
// registers as (big, small) pairs (split_tf32); kSmallA / kSmallB say
// whether each has a small part at all
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint2 b0,
                                     uint2 b1) {
  if constexpr (kSmallA) mma1688(d, as, b0.x, b1.x);
  if constexpr (kSmallB) mma1688(d, ab, b0.y, b1.y);
  mma1688(d, ab, b0.x, b1.x);
}

// acc[nt] += A (16 rows from m0) x B (n-tiles n0 + 8nt), over K = 8 * kSteps
// from k = 0, in 3xTF32 (or fewer products where an operand is exact):
//   A[m][k] = kAT ? a[k * lda + m] : a[m * lda + k]
//   B[k][n] = kBT ? b[k * ldb + n] : b[n * ldb + k]
// (a and b are float32 or bf16 tiles)
template <int kNT, int kSteps, bool kAT, bool kBT, bool kSplitA, bool kSplitB,
          typename TA, typename TB>
__device__ __forceinline__ void warp_mma(float (&acc)[kNT][4], const TA* a,
                                         int lda, const TB* b, int ldb,
                                         int m0, int n0, int g, int tq) {
#pragma unroll 2
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k0 = ks * 8;
    float av[4];
    if constexpr (kAT) {
      const TA* p = a + (k0 + tq) * lda + m0 + g;
      av[0] = to_f32(p[0]);
      av[1] = to_f32(p[8]);
      av[2] = to_f32(p[4 * lda]);
      av[3] = to_f32(p[4 * lda + 8]);
    } else {
      const TA* p = a + (m0 + g) * lda + k0 + tq;
      av[0] = to_f32(p[0]);
      av[1] = to_f32(p[8 * lda]);
      av[2] = to_f32(p[4]);
      av[3] = to_f32(p[8 * lda + 4]);
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32<kSplitA>(av[r], ab[r], as[r]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = n0 + nt * 8 + g;
      float bv0, bv1;
      if constexpr (kBT) {
        bv0 = to_f32(b[(k0 + tq) * ldb + n]);
        bv1 = to_f32(b[(k0 + tq + 4) * ldb + n]);
      } else {
        bv0 = to_f32(b[n * ldb + k0 + tq]);
        bv1 = to_f32(b[n * ldb + k0 + tq + 4]);
      }
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32<kSplitB>(bv0, bb0, bs0);
      split_tf32<kSplitB>(bv1, bb1, bs1);
      if constexpr (kSplitA) mma1688(acc[nt], as, bb0, bb1);
      if constexpr (kSplitB) mma1688(acc[nt], ab, bs0, bs1);
      mma1688(acc[nt], ab, bb0, bb1);
    }
  }
}

// Heads a block of the ssd_chunk kernels takes: kMax, halved while the
// grid (`blocks` per head group times ceil(H / heads) groups) would not
// give every SM two blocks.  A block's scores are shared by its heads, so
// fewer heads cost recomputation and pay only on small grids.
inline int heads_per_block(long long blocks, int H, int kMax) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int hg = kMax;
  while (hg > 1 && blocks * ((H + hg - 1) / hg) < 2LL * sms) hg /= 2;
  return hg;
}

}  // namespace
