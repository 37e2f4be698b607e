// Flash attention forward for Hopper (sm_90a): the port of the Pallas
// kernel repro/kernels/flash_attention/kernel.py::flash_attention (body
// _flash_kernel).
//
// What it computes: for q [B, Sq, H, D] and k, v [B, Sk, KV, D] (query
// head h reads KV head h / (H / KV)), out = softmax(scale * q.K^T) V over
// the keys the mask allows: kpos <= qpos when causal, kpos > qpos - window
// when windowed, kpos < Sk always (the ragged edge).  Scores are f32, the
// optional tanh softcap applies before the mask, the online softmax runs
// with a FINITE NEG_INF (-1e30) so an all-masked tile never makes
// exp(m_prev - m_curr) a NaN, masked probabilities are forced to 0 and the
// denominator is clamped at 1e-20, so a row that sees no key writes 0.
// These are _flash_kernel's expressions.  Beside out (q's dtype) it writes
// lse = m + log(max(l, 1e-20)) [B, H, Sq] in f32 for the backward.
//
// What bounds it on this card: operations.  A causal pass does
// 4 * H * D * Sq(Sq+1)/2 FLOP against 2*(Sq*H + 2*Sk*KV)*D bytes: at the
// training shape (Sq = Sk = 4096, H = 12, KV = 2, D = 128, bf16) that is
// 5.16e10 FLOP (0.052 ms at 989 TFLOP/s) against 29.4 MB (0.009 ms at
// 3.35 TB/s).
//
// What the design does about it:
//  * the TPU grid walked KV blocks in order with (m, l, acc) in VMEM
//    scratch; here one block owns (b, h, a 64-row query tile) and walks
//    the key tiles in a loop, so nothing carries between blocks and the
//    12 x 64 = 768 blocks of the training shape spread over 132 SMs;
//  * only key tiles inside the causal / window band are loaded, as
//    pl.when(run) skipped them (kernel.py:47-53);
//  * K and V are read in place from [B, Sk, KV, D] through the KV head:
//    no repeated K/V in memory;
//  * bf16: Q.K^T and P.V run on the tensor cores as mma.sync m16n8k16
//    (bf16 in, f32 accumulate).  Each of 4 warps owns 16 query rows.  The
//    scores, the probabilities and the output accumulator stay in
//    registers: the C fragment of two adjacent key n-tiles of S is, once
//    packed to bf16, the A fragment of P for P.V, so the online softmax
//    (f32, exp2 with log2(e) folded in) runs in place and only the row
//    max and sum cross lanes, by shuffles.  Q's fragments are loaded once
//    (D <= 128); K's B fragments come through ldmatrix and V's through
//    ldmatrix.trans.  64-key K/V tiles stream into two
//    shared-memory stages with cp.async (16 bytes a thread, zero-filled
//    past Sk and past D, which is padded to 64/128/256), so tile t + 1
//    loads while tile t is computed; Q's tile shares K's second stage, so
//    three blocks (12 warps) fit on an SM.  Causal grids launch the query
//    tiles that see the most keys first.  Tiles wholly inside the band
//    skip the per-element mask;
//  * float32 takes an exact scalar path (no TF32): one warp per query
//    row, lanes over the head dim, 16-key f32 tiles in shared memory;
//  * no atomics: the result does not depend on block scheduling.
// D <= 256.  Not yet: wgmma, TMA, a split over keys for short query
// counts; the backward is plain PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fragments kept in registers)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kTcWarps = kBQ / 16;      // 16 query rows per warp
constexpr int kTcThreads = kTcWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of one block: two stages each of K and V, and
// the Q tile.  When Q's fragments live in registers (DP <= 128) they are
// read once before the key loop, and Q's tile is K's stage 1: four tiles,
// so three blocks fit on an SM.  Rows are DP + 8 bf16 long, so ldmatrix
// rows fall on distinct banks and every row starts on 16 bytes.
template <int DP>
struct TcSmem {
  static constexpr bool q_in_regs = DP <= 128;
  static constexpr int LD = DP + 8;
  static constexpr size_t tile = (size_t)64 * LD * 2;
  static constexpr size_t k_off = 0;             // stages 0, 1
  static constexpr size_t v_off = 2 * tile;      // stages 0, 1
  static constexpr size_t q_off = q_in_regs ? tile : 4 * tile;
  static constexpr size_t bytes = q_in_regs ? 4 * tile : 5 * tile;
};

// rows [row0, row0 + 64) x columns [0, DP) of a [*, stride] bf16 matrix
// into shared memory; rows >= n and columns >= D become 0.  With vec_ok
// the copy is asynchronous (cp.async, 16 bytes a thread).  (This loop, not
// a loader with a row-offset functor like paged_attention.cu's load_rows:
// through that loader the kernel took 11% longer at S=4096 on the H100.)
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, long long stride, int D,
                                          int vec_ok) {
  constexpr int LD = TcSmem<DP>::LD;
  if (vec_ok) {            // D % 8 == 0 and 16-byte aligned rows
    constexpr int vpr = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * vpr; idx += kTcThreads) {
      const int row = idx / vpr;
      const int c = (idx - row * vpr) * 8;
      const bool ok = row0 + row < n && c < D;
      cp_async16(dst + row * LD + c,
                 ok ? src + (long long)(row0 + row) * stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kTcThreads) {
      const int row = idx / DP;
      const int c = idx - row * DP;
      dst[row * LD + c] = (row0 + row < n && c < D)
                              ? src[(long long)(row0 + row) * stride + c]
                              : __float2bfloat16(0.f);
    }
  }
}

// Thread (g = lane / 4, tq = lane % 4) of a warp holds, in every m16n8
// accumulator tile, rows g and g + 8 at columns 2tq and 2tq + 1 (PTX ISA,
// mma.m16n8k16).  So each thread owns two query rows of the warp's 16 and
// their running max m, partial sum l and output columns.  The QK^T tile
// S (16 x 64 keys: 8 n-tiles) is rescaled, masked and exponentiated in
// registers, and two adjacent n-tiles of P are exactly the A fragment of
// one 16-key chunk of PV: P never leaves the registers.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, TcSmem<DP>::q_in_regs ? 3 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Sk, int H, int KV, int D, int causal, int window,
                float scale, float softcap, int vec_ok) {
  using L = TcSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int NT = kBK / 8;       // key n-tiles of S
  constexpr int KC = DP / 16;       // head-dim chunks of QK^T
  constexpr int OT = DP / 8;        // head-dim n-tiles of O
  constexpr bool kQRegs = L::q_in_regs;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  // the last query tiles see the most keys under a causal mask: launch
  // them first, so the short ones fill the last wave
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * D;
  const long long k_stride = (long long)KV * D;
  const __nv_bfloat16* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const long long kv_base = (long long)b * Sk * k_stride + (long long)kvh * D;

  // key tiles of the band [t_lo, t_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int t_hi = (Sk + kBK - 1) / kBK;
  if (causal) t_hi = min(t_hi, q_last / kBK + 1);
  int t_lo = 0;
  if (window >= 0) {
    const int floor_pos = q0 - window + 1;   // lowest key the tile's first row sees
    t_lo = floor_pos > 0 ? floor_pos / kBK : 0;
  }

  load_tile<DP>(Qs, qb, q0, Sq, q_stride, D, vec_ok);
  if (t_lo < t_hi) {
    load_tile<DP>(Ks, k + kv_base, t_lo * kBK, Sk, k_stride, D, vec_ok);
    load_tile<DP>(Vs, v + kv_base, t_lo * kBK, Sk, k_stride, D, vec_ok);
  }
  cp_async_commit();

  const __nv_bfloat16* Qw = Qs + warp * 16 * LD;
  uint32_t qf[kQRegs ? KC : 1][4];
  if constexpr (kQRegs) {           // Q's fragments, then its tile is free
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) load_a<LD>(qf[kc], Qw, kc, g, tq);
    __syncthreads();
  }
  const int r0 = q0 + warp * 16 + g;     // this thread's two query rows
  const int r1 = r0 + 8;
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
    o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int mi = lane >> 3;         // the ldmatrix sub-matrix this lane addresses

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {             // the next tile streams in meanwhile
      const size_t nxt = (size_t)(st ^ 1) * 64 * LD;
      load_tile<DP>(Ks + nxt, k + kv_base, (t + 1) * kBK, Sk, k_stride, D,
                    vec_ok);
      load_tile<DP>(Vs + nxt, v + kv_base, (t + 1) * kBK, Sk, k_stride, D,
                    vec_ok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (size_t)st * 64 * LD;
    const __nv_bfloat16* Vt = Vs + (size_t)st * 64 * LD;
    const int k0 = t * kBK;

    // S = Q K^T: 16 rows x 64 keys; K's B fragments through ldmatrix:
    // matrices (keys n | n + 8) x (dims c | c + 8)
    const __nv_bfloat16* krow =
        Kt + ((lane & 7) + (mi >> 1) * 8) * LD + (mi & 1) * 8;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kc][i];
      } else {
        load_a<LD>(a, Qw, kc, g, tq);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + nt * 8 * LD + kc * 16);
        mma16816(s[nt], a, kb[0], kb[1]);
        mma16816(s[nt + 1], a, kb[2], kb[3]);
      }
    }

    // scale, softcap, mask (only where the tile crosses a mask edge)
    const bool full = (!causal || k0 + kBK - 1 <= q0) && k0 + kBK <= Sk &&
                      (window < 0 || k0 > q0 + kBQ - 1 - window);
    unsigned valid = 0xffffffffu;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!full) {
          const int kpos = k0 + nt * 8 + tq * 2 + (e & 1);
          const int qpos = e < 2 ? r0 : r1;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
          if (!ok) {
            x = kNegInf;
            valid &= ~(1u << (nt * 4 + e));
          }
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the four lanes of a row group share its rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;     // this thread's share of the row sums
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ((valid >> (nt * 4 + e)) & 1u)
                            ? exp2f((s[nt][e] - (e < 2 ? mn0 : mn1)) * kLog2e)
                            : 0.f;
        s[nt][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      o[ot][0] *= alpha0;
      o[ot][1] *= alpha0;
      o[ot][2] *= alpha1;
      o[ot][3] *= alpha1;
    }

    // O += P V, 16 keys at a time; V's B fragments come through
    // ldmatrix.trans: matrices (keys 0-7 | 8-15) x (dims n | n + 8)
    const __nv_bfloat16* vrow =
        Vt + ((lane & 7) + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int ot = 0; ot < OT; ot += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + kc * 16 * LD + ot * 8);
        mma16816(o[ot], a, bv[0], bv[1]);
        mma16816(o[ot + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();                // stage st is consumed before its refill
  }
  cp_async_wait<0>();               // an empty band left Q's copy pending

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Sq) continue;
    const float inv = 1.f / (half ? d1 : d0);
    __nv_bfloat16* orow = out + ((long long)b * Sq + row) * q_stride +
                          (long long)h * D;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      const int c = ot * 8 + tq * 2;
      if (c < D) orow[c] = __float2bfloat16(o[ot][2 * half] * inv);
      if (c + 1 < D) orow[c + 1] = __float2bfloat16(o[ot][2 * half + 1] * inv);
    }
    if (tq == 0)
      lse[((long long)b * H + h) * Sq + row] =
          (half ? m1 : m0) + logf(half ? d1 : d0);
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Sk, int H, int KV, int D,
              int causal, int window, float scale, float softcap,
              cudaStream_t stream) {
  const size_t smem = TcSmem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_ok = D % 8 == 0 &&
                     ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_tc_kernel<DP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, D, causal, window, scale,
      softcap, vec_ok);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: exact scalar path
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;            // query rows per block, one warp each
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kKT = 16;                 // keys per shared-memory tile

template <int NI>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int D, int causal, int window, float scale, float softcap) {
  __shared__ float ks[kKT * NI * 32];
  __shared__ float vs[kKT * NI * 32];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kF32Warps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qpos = q0 + warp;
  const bool active = qpos < Sq;
  const int kvh = h / (H / KV);
  const long long q_off = (((long long)b * Sq + qpos) * H + h) * D;

  float qr[NI], acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    qr[i] = (active && d < D) ? q[q_off + d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // keys of the band [k_lo, k_hi) of the block's rows
  const int q_last = min(q0 + kF32Warps, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKT) {
    const int kt = min(kKT, k_hi - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kt * D; idx += kF32Threads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const long long off = (((long long)b * Sk + k0 + j) * KV + kvh) * D + d;
      ks[j * D + d] = k[off];
      vs[j * D + d] = v[off];
    }
    __syncthreads();
    if (!active) continue;

    float s[kKT];
    unsigned valid = 0u;
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      float part = 0.f;
      if (j < kt) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < D) part += qr[i] * ks[j * D + d];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (softcap > 0.f) part = softcap * tanhf(part / softcap);
      const int kpos = k0 + j;
      const bool ok = j < kt && (!causal || kpos <= qpos) &&
                      (window < 0 || kpos > qpos - window);
      s[j] = ok ? part : kNegInf;
      valid |= ok ? (1u << j) : 0u;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float p = ((valid >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      float a = acc[i] * alpha;
      if (d < D) {
#pragma unroll
        for (int j = 0; j < kKT; ++j)
          if (j < kt) a += s[j] * vs[j * D + d];
      }
      acc[i] = a;
    }
  }

  if (!active) return;
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[q_off + d] = acc[i] / denom;
  }
  if (lane == 0) lse[((long long)b * H + h) * Sq + qpos] = m + logf(denom);
}

template <int NI>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int KV, int D,
               int causal, int window, float scale, float softcap,
               cudaStream_t stream) {
  dim3 grid((Sq + kF32Warps - 1) / kF32Warps, H, B);
  flash_f32_kernel<NI><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, D, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, H, D]; k, v: [B, Sk, KV, D], contiguous; lse: [B, H, Sq]
// float32.  causal != 0 masks kpos > qpos; window < 0 means none; softcap
// <= 0 means none; is_bf16 selects bfloat16 (else float32) for q, k, v and
// out.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int H, int KV,
                                     int D, int causal, int window,
                                     float scale, float softcap, int is_bf16,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal, window, \
                   scale, softcap, s
  if (is_bf16) {
    if (D <= 64) return launch_tc<64>(REPRO_ARGS);
    if (D <= 128) return launch_tc<128>(REPRO_ARGS);
    return launch_tc<256>(REPRO_ARGS);
  }
  if (D <= 32) return launch_f32<1>(REPRO_ARGS);
  if (D <= 64) return launch_f32<2>(REPRO_ARGS);
  if (D <= 128) return launch_f32<4>(REPRO_ARGS);
  return launch_f32<8>(REPRO_ARGS);
#undef REPRO_ARGS
}
