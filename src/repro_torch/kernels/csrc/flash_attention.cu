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
// 3.35 TB/s).  So the tensor cores have to be kept busy, and on Hopper only
// wgmma reaches their full rate: a warp that runs its own chain of
// synchronous mma.sync products, with the softmax between them, leaves
// them idle while it does anything else.
//
// What the design does about it (bf16; FlashAttention-3's structure):
//  * the TPU grid walked KV blocks in order with (m, l, acc) in VMEM
//    scratch; here one block owns (b, h, a 128-row query tile) and walks
//    the key tiles of its causal / window band in a loop (tiles outside it
//    are never loaded, as pl.when(run) skipped them), so nothing carries
//    between blocks.  The query tile is the slowest grid dimension, so the
//    tiles that see the most keys start first across all heads and the
//    short ones fill the last wave;
//  * warp specialisation: warpgroup 0 is the producer, and one of its
//    threads keeps K/V tiles in flight through a ring in shared memory (as
//    many stages as fit beside Q: 4 at D = 64, 3 at 128, 2 at 256);
//    warpgroups 1 and 2 are consumers, 64 query rows each.  Full and empty
//    mbarriers hand the stages over, so no load waits on a whole-block
//    barrier, and while one consumer runs its softmax the other's products
//    keep the tensor cores busy: where the products are the longer part
//    (D >= 128, no softcap) the consumers issue them in turns, ordered by
//    two named barriers; elsewhere the warp schedulers interleave them.
//    Where the ring has only 2 stages, K and V have barriers of their own,
//    so K is refilled as soon as S is in.  setmaxnreg moves registers from
//    the producer (40) to the consumers (232), which hold S and O as f32
//    accumulators;
//  * loads by TMA (cp.async.bulk.tensor over a 4-D map of [B, S, heads,
//    D]): Q once and each K/V tile as 64-column slabs in the 128-byte
//    swizzle that wgmma reads.  S is a dimension of its own, so rows past
//    Sq / Sk read as zeros and never as the next sequence's rows, and so
//    do columns past D (D is padded to 64/128/256 here; the wrapper pads
//    a head dim that is not a multiple of 8, since TMA strides are 16-byte
//    multiples).  GQA reads K/V in place through the KV head coordinate.
//    The maps are encoded on the host at every call (a few microseconds
//    against a launch of ~0.1 ms; encode_map in wgmma_bf16.cuh);
//  * S = Q.K^T is wgmma m64n(BK)k16 with Q and K from shared memory (BK =
//    128 keys, 64 at D = 256, where O alone is 128 registers a thread);
//    O += P.V is wgmma m64n(DP)k16 with P from registers (the S
//    accumulator rescaled, masked, exponentiated and packed to bf16 in
//    place) and V from shared memory through the descriptor's transpose:
//    V is never transposed in memory.  Inside a consumer, tile i's S and
//    tile i-1's P.V are issued together and tile i's softmax runs while
//    P.V is still on the tensor cores;
//  * the online softmax runs in registers in log2 units (scale * log2(e)
//    folded into one multiply before exp2); only the row max and sum cross
//    lanes, by shuffles among the 4 lanes of a row.  Tiles wholly inside
//    the band skip the per-element mask; tiles wholly outside a consumer's
//    64 rows (the far side of the diagonal) skip its products.  The softcap
//    takes tanh(y) = 1 - 2 / (1 + 2^(2y log2 e)): one exp2 and one
//    reciprocal (about 1e-7 off, where tanh.approx's 5e-4 would move lse
//    past its bound), in place of tanhf's longer accurate path.  O leaves
//    through the consumer's rows of the Q tile as 16-byte rows;
//  * float32 runs on the tensor cores too, in 3xTF32 (float32-exact
//    products on mma.sync m16n8k8, mma_tf32.cuh; 165 TFLOP/s at most):
//    flash_f32_tc_kernel, one block per (64 query rows, h) of four warps,
//    16 rows and every key of a 32-key tile a warp, K and V through a
//    two-stage cp.async ring, S and O in registers, the softmax the bf16
//    consumers' (softmax_tile), P from the S accumulator into P.V's A
//    fragment with no trip through shared memory;
//  * no atomics: the result does not depend on block scheduling.
// D <= 256.  Not yet: a persistent tile scheduler, a split over keys for
// short query counts.  The backward is flash_attention_bwd.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma forward
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                // query rows per block
constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kThreads = 3 * kWg;       // producer + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;      // 128 x 40 + 256 x 232 <= 65536
constexpr int kEmptyArrivals = 8;       // one per consumer warp

// Shared memory of one block, from a 1024-byte-aligned base: Q (DP / 64
// slabs of 128 rows), K and V (ST tiles each of DP / 64 slabs of BK
// rows), then the mbarriers full[ST], empty[ST], q, and with split_kv
// V's vfull[ST], vempty[ST].  A slab row is 64 bf16 (128 bytes) in the
// 128-byte swizzle.
template <int DP>
struct WgSmem {
  static constexpr int BK = DP <= 128 ? 128 : 64;   // keys per tile
  // ring depth: as many stages as fit beside Q
  static constexpr int ST = DP == 64 ? 4 : DP == 128 ? 3 : 2;
  static constexpr int slabs = DP / 64;
  static constexpr uint32_t q_slab = kBQ * 128;
  static constexpr uint32_t kv_slab = BK * 128;
  static constexpr uint32_t kv_tile = slabs * kv_slab;   // K or V, one stage
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = slabs * q_slab;
  static constexpr uint32_t v_off = k_off + ST * kv_tile;
  static constexpr uint32_t bar_off = v_off + ST * kv_tile;
  // K and V get barriers of their own where the ring is shallow: K_i is
  // then released as soon as S_i is in, and its refill starts a product
  // earlier
  static constexpr bool split_kv = ST == 2;
  static constexpr size_t bytes = bar_off + (4 * ST + 1) * 8 + 1024;
};

// What a consumer thread needs to turn its S accumulator into P: its two
// query rows, its column quarter, the mask and the score transform.
// Scores go to log2 units: x = s * mul with mul = scale * log2(e), or
// with the softcap x = cap2 * tanh(y) where y = s * scale / softcap,
// cap2 = softcap * log2(e) and mul = 2 * log2(e) * scale / softcap, so
// that s * mul = 2 y log2(e).
struct Rows {
  int r0, r1, tq, Sk, causal, window, capped;
  float mul, cap2;
  __device__ __forceinline__ bool visible(int kpos, int qpos) const {
    return kpos < Sk && (!causal || kpos <= qpos) &&
           (window < 0 || kpos > qpos - window);
  }
  __device__ __forceinline__ float capped_score(float s) const {
    return cap2 * (1.f - 2.f * rcp(1.f + ex2(s * mul)));
  }
  __device__ __forceinline__ float score(float s) const {
    return capped ? capped_score(s) : s * mul;
  }
};

// S = Q K^T for one consumer's 64 rows: DP / 16 steps of 16 head dims
template <int DP, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t q_desc,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const uint32_t step = (kc & 3) * 32;     // inside a 64-column slab
    wgmma_ss<BK>(s,
                 sw128_desc(q_desc + (kc >> 2) * (kBQ * 128) + step, 16,
                            1024),
                 sw128_desc(k_tile + (kc >> 2) * (BK * 128) + step, 16, 1024),
                 kc > 0);
  }
}

// O += P V: BK / 16 steps of 16 keys, V read transposed (MN-major)
template <int DP, int BK>
__device__ __forceinline__ void pv_tile(float (&o)[DP / 2],
                                        const uint32_t (&pa)[BK / 16][4],
                                        uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    wgmma_rs_tb<DP>(o, pa[kc],
                    sw128_desc(v_tile + kc * 16 * 128, BK * 128, 1024));
}

// Scale, softcap and mask S (tile keys [k0, k0 + BK)), update the running
// max m (log2 units) and partial sum l of the thread's two rows, and
// leave P = exp2(x - m) in s; alpha = exp2(m_old - m_new) rescales O.
// Tiles wholly inside the band for rows [row_lo, row_hi] take one FFMA
// and one ex2 an element (with the softcap, its transform first) and no
// mask code; the others mask each element and force masked probabilities
// to exactly 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             const Rows& rw, int k0,
                                             int row_lo, int row_hi,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0,
                                             float& alpha1) {
  const bool full = (!rw.causal || k0 + BK - 1 <= row_lo) &&
                    k0 + BK <= rw.Sk &&
                    (rw.window < 0 || k0 > row_hi - rw.window);
  float mx0 = kNegInf, mx1 = kNegInf;
  if (full && !rw.capped) {              // max of raw scores; mul > 0
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 *= rw.mul;
    mx1 *= rw.mul;
  } else if (full) {                     // softcapped, nothing masked
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = rw.capped_score(s[4 * j + e]);
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = rw.score(s[4 * j + e]);
        if (!full && !rw.visible(k0 + 8 * j + 2 * rw.tq + (e & 1),
                                 e < 2 ? rw.r0 : rw.r1))
          x = kNegInf;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
  }
  // the four lanes of a row group share its rows
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  alpha0 = ex2(m0 - mn0);
  alpha1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;            // this thread's share of the sums
  if (full && !rw.capped) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], rw.mul, -(e < 2 ? mn0 : mn1)));
        s[4 * j + e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
  } else if (full) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] - (e < 2 ? mn0 : mn1));
        s[4 * j + e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[4 * j + e] - (e < 2 ? mn0 : mn1));
        if (!full && !rw.visible(k0 + 8 * j + 2 * rw.tq + (e & 1),
                                 e < 2 ? rw.r0 : rw.r1))
          p = 0.f;                       // masked probabilities are exactly 0
        s[4 * j + e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j + 0] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// P as the register A operand: two adjacent n-tiles of S make one 16-key
// step
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// The S and O accumulators of a consumer thread follow the wgmma layout
// (wgmma_bf16.cuh): rows r0 = row_lo + 16 warp + g and r1 = r0 + 8, so the
// thread owns the running max m, partial sum l and output columns of two
// query rows.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Sk, int H, int KV, int D, int causal,
                   int window, float scale, float softcap) {
  using L = WgSmem<DP>;
  constexpr int BK = L::BK;
  constexpr int kStages = L::ST;
  constexpr bool kSplitKV = L::split_kv;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::bar_off;        // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage
  const uint32_t q_bar = empty_bar + 8 * kStages;
  // with kSplitKV the barriers above are K's and these V's
  const uint32_t vfull_bar = q_bar + 8;
  const uint32_t vempty_bar = vfull_bar + 8 * kStages;

  // blocks are dispatched x fastest: every (head, batch) pair's query
  // tile that sees the most keys comes first, so the short ones fill the
  // last wave
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (H / KV);

  // key tiles of the block's band [t_lo, t_lo + n_tiles)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int t_hi = (Sk + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK + 1);
  int t_lo = 0;
  if (window >= 0) {
    const int floor_pos = q0 - window + 1;   // lowest key row q0 sees
    t_lo = floor_pos > 0 ? floor_pos / BK : 0;
  }
  const int n_tiles = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kEmptyArrivals);
      if constexpr (kSplitKV) {
        mbar_init(vfull_bar + 8 * s, 1);
        mbar_init(vempty_bar + 8 * s, kEmptyArrivals);
      }
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(q_bar, L::slabs * L::q_slab);
    for (int sl = 0; sl < L::slabs; ++sl)
      tma_load_4d(base + L::q_off + sl * L::q_slab, &qmap, q_bar, sl * 64, h,
                  q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages)
        mbar_wait(empty_bar + 8 * st, ((i / kStages) - 1) & 1);
      const uint32_t bar = full_bar + 8 * st;
      const int key0 = (t_lo + i) * BK;
      mbar_arrive_expect_tx(bar, (kSplitKV ? 1 : 2) * L::kv_tile);
      for (int sl = 0; sl < L::slabs; ++sl)
        tma_load_4d(base + L::k_off + st * L::kv_tile + sl * L::kv_slab,
                    &kmap, bar, sl * 64, kvh, key0, b);
      uint32_t vbar = bar;
      if constexpr (kSplitKV) {
        if (i >= kStages)
          mbar_wait(vempty_bar + 8 * st, ((i / kStages) - 1) & 1);
        vbar = vfull_bar + 8 * st;
        mbar_arrive_expect_tx(vbar, L::kv_tile);
      }
      for (int sl = 0; sl < L::slabs; ++sl)
        tma_load_4d(base + L::v_off + st * L::kv_tile + sl * L::kv_slab,
                    &vmap, vbar, sl * 64, kvh, key0, b);
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWg - 1;      // consumer 0 or 1
    const int t = threadIdx.x % kWg;
    const int warp = t / 32;
    const int lane = t % 32;
    const int row_lo = q0 + cw * 64;            // rows [row_lo, row_lo + 64)
    const int row_hi = row_lo + 63;
    Rows rows;
    rows.tq = lane & 3;
    rows.r0 = row_lo + warp * 16 + (lane >> 2);   // this thread's two rows
    rows.r1 = rows.r0 + 8;
    rows.Sk = Sk;
    rows.causal = causal;
    rows.window = window;
    rows.capped = softcap > 0.f;
    rows.mul = rows.capped ? 2.f * kLog2e * scale / softcap : scale * kLog2e;
    rows.cap2 = softcap * kLog2e;
    const uint32_t q_desc = base + L::q_off + cw * 64 * 128;

    // this consumer's live tiles [i_lo, i_hi) of the block's band: the
    // others lie wholly past its last row (causal) or below its first
    // row's window, and are only waited for and released
    int i_hi = n_tiles;
    if (causal) i_hi = min(i_hi, row_hi / BK + 1 - t_lo);
    int i_lo = 0;
    if (window >= 0) {
      const int floor_pos = row_lo - window + 1;
      if (floor_pos > 0) i_lo = max(0, floor_pos / BK - t_lo);
    }
    if (row_lo >= Sq) i_hi = 0;
    i_lo = min(i_lo, max(i_hi, 0));
    i_hi = max(i_hi, i_lo);

    float o[DP / 2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    auto full_wait = [&](int i) {
      mbar_wait(full_bar + 8 * (i % kStages), (i / kStages) & 1);
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * (i % kStages));
    };
    // V's own barriers (kSplitKV); otherwise K's cover both
    auto vfull_wait = [&](int i) {
      if constexpr (kSplitKV)
        mbar_wait(vfull_bar + 8 * (i % kStages), (i / kStages) & 1);
    };
    auto vrelease = [&](int i) {
      if constexpr (kSplitKV) {
        __syncwarp();
        if (lane == 0) mbar_arrive(vempty_bar + 8 * (i % kStages));
      }
    };
    auto k_tile = [&](int i) {
      return base + L::k_off + (i % kStages) * L::kv_tile;
    };
    auto v_tile = [&](int i) {
      return base + L::v_off + (i % kStages) * L::kv_tile;
    };

    // Turns: consumer 0 issues tile i's products, then consumer 1, then
    // consumer 0 tile i + 1, ..., so one consumer's softmax runs while the
    // other's products hold the tensor cores.  Each consumer takes one
    // turn per tile of the band, live or not (named barrier 3 + c is
    // consumer c's, 256 threads: its own 128 wait, the other's 128
    // arrive); consumer 1 opens with an arrival and skips its last one,
    // so every arrival is waited for.  Only where the products outweigh
    // the softmax (D >= 128, no softcap): there turns gained 2%, while at
    // D = 64 and with the softcap, where the softmax is the longer part,
    // they cost 6-7% (PERF.md §6, turns).
    const bool turns = DP >= 128 && !rows.capped;
    auto turn_begin = [&]() {
      if (turns) named_bar_sync(3 + cw, 2 * kWg);
    };
    auto turn_end = [&](int i) {
      if (turns && (cw == 0 || i + 1 < n_tiles))
        named_bar_arrive(4 - cw, 2 * kWg);
    };
    if (turns && cw == 1 && n_tiles > 0) named_bar_arrive(3, 2 * kWg);

    mbar_wait(q_bar, 0);
    for (int i = 0; i < i_lo; ++i) {
      full_wait(i);
      release(i);
      vfull_wait(i);
      vrelease(i);
      turn_begin();
      turn_end(i);
    }
    if (i_lo < i_hi) {
      // the first live tile: S, then its softmax
      full_wait(i_lo);
      turn_begin();
      fence_regs(s);
      wgmma_fence();
      qk_tile<DP, BK>(s, q_desc, k_tile(i_lo));
      wgmma_commit();
      turn_end(i_lo);
      wgmma_wait<0>();
      fence_regs(s);
      if (kSplitKV) release(i_lo);     // K is free once S is in
      float alpha0, alpha1;
      softmax_tile<BK>(s, rows, (t_lo + i_lo) * BK, row_lo, row_hi, m0, m1,
                       l0, l1, alpha0, alpha1);
      pack_p<BK>(pa, s);
      // steady state: S of tile i and P.V of tile i - 1 go to the tensor
      // cores together; tile i's softmax runs while P.V is in flight
      for (int i = i_lo + 1; i < i_hi; ++i) {
        full_wait(i);
        vfull_wait(i - 1);
        turn_begin();
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        qk_tile<DP, BK>(s, q_desc, k_tile(i));
        wgmma_commit();
        pv_tile<DP, BK>(o, pa, v_tile(i - 1));
        wgmma_commit();
        turn_end(i);
        wgmma_wait<1>();               // S is in; P.V may still run
        fence_regs(s);
        if (kSplitKV) release(i);
        softmax_tile<BK>(s, rows, (t_lo + i) * BK, row_lo, row_hi, m0, m1,
                         l0, l1, alpha0, alpha1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (kSplitKV) vrelease(i - 1); else release(i - 1);
        rescale<DP>(o, alpha0, alpha1);
        pack_p<BK>(pa, s);
      }
      vfull_wait(i_hi - 1);
      fence_regs(o);
      wgmma_fence();
      pv_tile<DP, BK>(o, pa, v_tile(i_hi - 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (kSplitKV) vrelease(i_hi - 1); else release(i_hi - 1);
    }
    for (int i = i_hi; i < n_tiles; ++i) {
      full_wait(i);
      release(i);
      vfull_wait(i);
      vrelease(i);
      turn_begin();
      turn_end(i);
    }

    const int tq = rows.tq;
    const int r0 = rows.r0;
    const int r1 = rows.r1;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-20f);
    const float d1 = fmaxf(l1, 1e-20f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      const float m = half ? m1 : m0;          // log2 units
      if (tq == 0 && row < Sq)
        lse[((long long)b * H + h) * Sq + row] =
            (m == kNegInf ? kNegInf : m * kLn2) + logf(half ? d1 : d0);
    }
    // O through this consumer's rows of the Q tile (its last S is done):
    // the swizzled slab layout, then 16-byte rows to global memory
    unsigned char* qs = smem + L::q_off + cw * 64 * 128;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = (half ? r1 : r0) - row_lo;
      const float inv = 1.f / (half ? d1 : d0);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + (j >> 3) * L::q_slab + rl * 128 +
                                     (((j & 7) ^ (rl & 7)) << 4) + tq * 4) =
            pack_bf16(o[4 * j + 2 * half] * inv,
                      o[4 * j + 2 * half + 1] * inv);
    }
    named_bar_sync(1 + cw, kWg);              // this consumer's 128 threads
    const long long q_stride = (long long)H * D;
    for (int idx = t; idx < 64 * (DP / 8); idx += kWg) {
      const int r = idx / (DP / 8);
      const int ch = idx - r * (DP / 8);
      if (row_lo + r >= Sq || ch * 8 >= D) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(
          qs + (ch >> 3) * L::q_slab + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(out +
                                ((long long)b * Sq + row_lo + r) * q_stride +
                                (long long)h * D + ch * 8) = val;
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                 int causal, int window, float scale, float softcap,
                 cudaStream_t stream) {
  using L = WgSmem<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  // with no keys nothing reads K or V: their maps stand on q (a map needs
  // a non-empty tensor)
  const bool keys = Sk > 0;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (!(encode_map(&maps[0], q, B, Sq, H, D, kBQ) &&
        encode_map(&maps[1], keys ? k : q, B, keys ? Sk : 1, KV, D, L::BK) &&
        encode_map(&maps[2], keys ? v : q, B, keys ? Sk : 1, KV, D, L::BK)))
    return (int)cudaErrorInvalidValue;
  // longest query tiles first: blockIdx.z counts down from the last tile
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<DP><<<grid, kThreads, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, D, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;              // 16 query rows each
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32BM = 16 * kF32Warps;    // query rows per block
constexpr int kF32BN = 32;                // keys per tile

// Shared memory of one block, in floats: the Q tile [BM][LD], then two
// stages of K and V tiles [2][2][BN][LD].  Rows hold DP + 4 floats, so the
// fragments of a tile read as stored, and V's rows read in the (2tq,
// 2tq + 1) key order, touch 32 distinct banks.
template <int DP>
struct F32Smem {
  static constexpr int LD = DP + 4;
  static constexpr int kv_off = kF32BM * LD;
  static constexpr int stage = 2 * kF32BN * LD;     // K and V of one tile
  static constexpr size_t bytes = (size_t)(kv_off + 2 * stage) * 4;
};

// One block per (BM query rows, head h, sequence b); warp w owns rows
// 16w .. 16w + 15 of the block and every key of each BN-key tile of the
// block's band, which two cp.async stages stream through shared memory.
// S = Q.K^T and O += P.V run on mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh);
// P goes from the S accumulator straight into the A fragment of P.V in
// the (2tq, 2tq + 1) key order, V's B rows in the same order.  The online
// softmax is the bf16 kernel's softmax_tile, in log2 units, on the same
// register layout.  vec: D a multiple of 4 and q, k, v on 16 bytes, so
// tiles load by cp.async; otherwise the threads load them.
template <int DP>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                    int D, int causal, int window, float scale, float softcap,
                    int vec) {
  using L = F32Smem<DP>;
  constexpr int BM = kF32BM, BN = kF32BN, LD = L::LD;
  constexpr int OT = DP / 8;                   // head-dim n-tiles of O
  extern __shared__ float4 f32_smem[];
  float* const sm = reinterpret_cast<float*>(f32_smem);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest band first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int tq = tid & 3;
  const int m0 = 16 * warp;
  const int row_lo = q0 + m0;                  // this warp's rows
  const int row_hi = row_lo + 15;

  const long long q_stride = (long long)H * D, k_stride = (long long)KV * D;
  const float* q_b = q + ((long long)b * Sq * H + h) * D;
  const float* k_b = k + ((long long)b * Sk * KV + kvh) * D;
  const float* v_b = v + ((long long)b * Sk * KV + kvh) * D;
  // key tiles of the block's band, from a multiple of BN
  const int q_last = min(q0 + BM, Sq) - 1;
  const int lo = window >= 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  auto stage = [&](int i) {
    const int k0 = lo + i * BN;
    float* dst = sm + L::kv_off + (i & 1) * L::stage;
    load_tile<BN, DP, LD, kF32Threads>(dst, k_b + k0 * k_stride, k_stride,
                                       Sk - k0, D, vec, tid);
    load_tile<BN, DP, LD, kF32Threads>(dst + BN * LD, v_b + k0 * k_stride,
                                       k_stride, Sk - k0, D, vec, tid);
    cp_async_commit();
  };

  Rows rw;
  rw.r0 = row_lo + g;
  rw.r1 = rw.r0 + 8;
  rw.tq = tq;
  rw.Sk = Sk;
  rw.causal = causal;
  rw.window = window;
  rw.capped = softcap > 0.f;
  rw.mul = rw.capped ? 2.f * kLog2e * scale / softcap : scale * kLog2e;
  rw.cap2 = softcap * kLog2e;

  float o[OT][4];
  zero(o);
  float m0r = kNegInf, m1r = kNegInf, l0 = 0.f, l1 = 0.f;
  if (n_tiles > 0) {
    load_tile<BM, DP, LD, kF32Threads>(sm, q_b + q0 * q_stride, q_stride,
                                       Sq - q0, D, vec, tid);
    stage(0);                           // one group with the Q tile
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = lo + i * BN;
    // a tile wholly past this warp's rows (causal) or wholly before their
    // window changes nothing: no products
    const bool any = row_lo < Sq && (!causal || k0 <= row_hi) &&
                     (window < 0 || k0 + BN - 1 > row_lo - window);
    if (any) {
      const float* Kt = sm + L::kv_off + (i & 1) * L::stage;
      const float* Vt = Kt + BN * LD;
      float s[BN / 8][4];
      zero(s);
      warp_mma<BN / 8, DP / 8, false, false, true, true>(s, sm, LD, Kt, LD,
                                                         m0, 0, g, tq);
      float alpha0, alpha1;
      softmax_tile<BN>(reinterpret_cast<float(&)[BN / 2]>(s), rw, k0, row_lo,
                       row_hi, m0r, m1r, l0, l1, alpha0, alpha1);
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        o[ot][0] *= alpha0;
        o[ot][1] *= alpha0;
        o[ot][2] *= alpha1;
        o[ot][3] *= alpha1;
      }
      // O += P V: P's A fragment of keys 8kt .. 8kt + 7 is the accumulator
      // tile kt in the k order (2tq, 2tq + 1); V's B rows likewise
#pragma unroll
      for (int kt = 0; kt < BN / 8; ++kt) {
        uint32_t pb[4], ps[4];
        split_tf32<true>(s[kt][0], pb[0], ps[0]);     // row g, key 2tq
        split_tf32<true>(s[kt][2], pb[1], ps[1]);     // row g + 8, key 2tq
        split_tf32<true>(s[kt][1], pb[2], ps[2]);     // row g, key 2tq + 1
        split_tf32<true>(s[kt][3], pb[3], ps[3]);     // row g + 8, 2tq + 1
        const float* vr = Vt + (kt * 8 + 2 * tq) * LD + g;
#pragma unroll
        for (int ot = 0; ot < OT; ++ot) {
          uint2 b0, b1;
          split_tf32<true>(vr[ot * 8], b0.x, b0.y);
          split_tf32<true>(vr[LD + ot * 8], b1.x, b1.y);
          mma3<true, true>(o[ot], pb, ps, b0, b1);
        }
      }
    }
    __syncthreads();    // the stage is free again
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rw.r1 : rw.r0;
    if (row >= Sq) continue;
    const float d = half ? d1 : d0;
    const float m = half ? m1r : m0r;          // log2 units
    if (tq == 0)
      lse[((long long)b * H + h) * Sq + row] =
          (m == kNegInf ? kNegInf : m * kLn2) + logf(d);
    float* dst = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      const int c = ot * 8 + 2 * tq;
      const float x = o[ot][2 * half] / d, y = o[ot][2 * half + 1] / d;
      if (c + 1 < D && D % 2 == 0) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(x, y);
      } else {
        if (c < D) dst[c] = x;
        if (c + 1 < D) dst[c + 1] = y;
      }
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int KV, int D,
               int causal, int window, float scale, float softcap,
               cudaStream_t stream) {
  using L = F32Smem<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid(H, B, (Sq + kF32BM - 1) / kF32BM);
  flash_f32_tc_kernel<DP><<<grid, kF32Threads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, D, causal, window, scale,
      softcap, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, H, D]; k, v: [B, Sk, KV, D], contiguous; lse: [B, H, Sq]
// float32.  causal != 0 masks kpos > qpos; window < 0 means none; softcap
// <= 0 means none; is_bf16 selects bfloat16 (else float32) for q, k, v and
// out.  bf16 needs what TMA addresses: D a multiple of 8 and q, k, v and
// out on 16 bytes (kernels/flash_attention/ops.py pads and copies to
// that); anything else is refused, nothing is chosen in its place.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
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
    if (D % 8 != 0 ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
      return (int)cudaErrorInvalidValue;
    if (D <= 64) return launch_wgmma<64>(REPRO_ARGS);
    if (D <= 128) return launch_wgmma<128>(REPRO_ARGS);
    return launch_wgmma<256>(REPRO_ARGS);
  }
  if (D <= 32) return launch_f32<32>(REPRO_ARGS);
  if (D <= 64) return launch_f32<64>(REPRO_ARGS);
  if (D <= 128) return launch_f32<128>(REPRO_ARGS);
  return launch_f32<256>(REPRO_ARGS);
#undef REPRO_ARGS
}
