// Flash attention backward for Hopper (sm_90a).  The reference has no
// backward kernel: repro/kernels/flash_attention/kernel.py::flash_attention
// is differentiated through jax.vjp of attention_ref
// (repro/kernels/flash_attention/ops.py::_attention_cv_bwd), and its
// blockwise path through _bw_bwd (blockwise.py), whose math this file
// computes; kernels/flash_attention/blockwise.py::blockwise_bwd is its
// plain version and kernels/flash_attention/tiled.py mirrors the schedule
// below on the CPU.
//
// What it computes: for the forward's q [B, Sq, H, D], k, v [B, Sk, KV, D],
// out o and row log-sum-exp lse [B, H, Sq] (f32), and the upstream gradient
// dO (o's shape): delta = rowsum(dO * o); P = exp(s - lse) for the scores
// s = scale q.k^T (softcapped: s = c tanh(s / c)) the mask lets through
// (causal, window, kpos < Sk), else 0; dP = dO.V^T; dS = P (dP - delta),
// times 1 - (s / c)^2 under the softcap; dQ = scale dS.K, dK = scale dS^T.Q,
// dV = P^T.dO, with the H / KV query heads of a group summed onto their KV
// head.  The grads come back in q's dtype.
//
// What bounds it on this card: operations.  The five products (S, dP, dQ,
// dK, dV) do 10 * H * D FLOP per visible (query, key) pair: at the
// training shape (Sq = Sk = 4096, H = 12, KV = 2, D = 128, causal, bf16)
// 1.29e11 FLOP, 0.130 ms at 989 TFLOP/s, against 2 * (3 Sq H + 2 Sk KV) D
// bytes read and written (about 44 MB, 0.013 ms at 3.35 TB/s).  So, as in
// the forward, the tensor cores must be kept busy, and only wgmma reaches
// their full rate.
//
// What the design does about it (bf16; FlashAttention-3's split into a
// key-frame and a query-frame pass, with dQ in a pass of its own):
//  * blocks run in no order, so no block adds into another's output: a
//    small pre-pass (flash_bwd_prep_kernel) writes delta and lse in log2
//    units into a workspace padded to whole 128-row tiles (rows past Sq
//    get lse2 = +1e30, so their P is 0 with no mask);
//  * flash_bwd_kv_kernel owns (b, query head h, a tile of BK keys) and
//    walks the query tiles of its band in 64-row steps: with the key
//    tile's K and V held in shared memory it forms S^T = K.Q^T and
//    dP^T = V.dO^T (wgmma m64n64k16, Q and dO from a TMA ring), turns them
//    in registers into P^T and dS^T, packs those to bf16 (as SDPA does:
//    a deliberate rounding, ROADMAP queue 3) and feeds them as the
//    register A operand of dV += P^T.dO and dK += dS^T.Q, with dO and Q
//    read through the descriptor's transpose as the forward reads V.  At
//    D <= 128 each of the two consumer warpgroups owns 64 keys (BK = 128);
//    at D = 256 dK and dV of 64 keys would need 256 registers a thread, so
//    both own the same 64 keys (BK = 64) and half of the head dim each,
//    both forming S^T and dP^T.  One block per query head fills the card
//    (384 blocks at the training shape, where one per KV head gave 64), so
//    a group's heads write f32 partials.  Key tile 0 sees the most query
//    tiles under the causal mask and launches first;
//  * flash_bwd_q_kernel, launched after it, owns (b, h, 128 query rows)
//    and walks its key band in tiles of BK keys as the forward does,
//    recomputing S and dP (two products more than the five) and adding
//    dQ += dS.K with K read transposed; no atomics, so two runs give the
//    same bits.  The producer's three idle warps meanwhile add the key
//    frame's per-head partials in head order (fold_share), a share per
//    block, under the consumers' products;
//  * both are warp-specialised like the forward: one producer thread
//    keeps TMA loads in flight through mbarrier rings (one set of four
//    maps serves both passes), two consumer warpgroups (setmaxnreg 232)
//    hold the accumulators and take turns at issuing their products, so
//    one's elementwise work runs under the other's products (6-8% faster
//    than without);
//  * the elementwise work, not the products, set the pace of the first
//    version: P and dS take one FFMA and one ex2 an element in tiles wholly
//    inside the mask, and the softcap and mask tests are decided once a
//    tile, outside the unrolled loop (inside it, every element paid for
//    the softcap's three MUFU operations: 0.51 -> 0.34 ms a call);
//  * float32 takes the same two frames on mma.sync in 3xTF32 (float32-
//    exact, mma_tf32.cuh; 165 TFLOP/s at most, so the same FLOP bound it
//    at six times bf16's time): flash_bwd_f32_kernel, one block per (64 or
//    32 rows, head), streams the other frame through a two-stage cp.async
//    ring and stages P and dS in shared memory between the products; its
//    query-frame blocks run the same fold_share after dQ.
// D <= 256; the wrapper pads a head dim that is not a multiple of 8 and
// copies bases off 16 bytes (tma_operands), as for the forward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse2 = 1e30f;       // lse2 of rows past Sq: P = 0
constexpr int kRowPad = 128;            // workspace rows: whole 128-row tiles

constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kThreads = 3 * kWg;       // producer + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;      // 128 x 40 + 256 x 232 <= 65536
constexpr int kEmptyArrivals = 8;       // one per consumer warp

// ---------------------------------------------------------------------------
// pre-pass: delta and lse in log2 units
// ---------------------------------------------------------------------------

constexpr int kPrepWarps = 8;

// delta[b, h, q] = sum_d dO * o and lse2[b, h, q] = lse * log2(e) for
// q < Sq; rows up to Sq_pad get delta 0 and lse2 = kPadLse2.  A row takes
// `lanes` lanes of a warp (32, or 16 where bf16 rows are 16 chunks of 16
// bytes or fewer), so every lane loads.
template <typename T>
__global__ void __launch_bounds__(kPrepWarps * 32)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int BH, int Sq, int Sq_pad,
                      int H, int D, int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                        lanes;
  const bool live = row < (long long)BH * Sq_pad;
  const int q = live ? (int)(row % Sq_pad) : Sq;
  const long long bh = row / Sq_pad;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const long long off = ((b * Sq + q) * H + h) * D;
  float acc = 0.f;
  if (q >= Sq) {
    // a padded row (or none): nothing to load
  } else if constexpr (sizeof(T) == 2) {
    // bf16: D is a multiple of 8, 16 bytes a lane
    for (int c = lane; c < D / 8; c += lanes) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + off + 8 * c);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + off + 8 * c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(a2[i]);
        const float2 gf = __bfloat1622float2(g2[i]);
        acc = fmaf(af.x, gf.x, acc);
        acc = fmaf(af.y, gf.y, acc);
      }
    }
  } else {
    for (int d = lane; d < D; d += lanes)
      acc = fmaf(o[off + d], dout[off + d], acc);
  }
  for (int s = lanes / 2; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (live && lane == 0) {
    delta[row] = q < Sq ? acc : 0.f;
    lse2[row] = q < Sq ? lse[bh * Sq + q] * kLog2e : kPadLse2;
  }
}

// ---------------------------------------------------------------------------
// bf16: what a consumer needs to turn S and dP into P and dS
// ---------------------------------------------------------------------------

// Scores go to log2 units as in the forward: x2 = s * mul with mul =
// scale * log2(e), or under the softcap x2 = cap2 * t, t = tanh(y), y =
// s * scale / c, cap2 = c * log2(e) and mul = 2 * log2(e) * scale / c (so
// that s * mul = 2 y log2(e) and t = 1 - 2 / (1 + 2^(s * mul)));
// P = 2^(x2 - lse2) and the softcap's chain factor is 1 - t^2.
struct Grad {
  int Sk, causal, window, capped;
  float mul, cap2;
  __device__ __forceinline__ bool visible(int kpos, int qpos) const {
    return kpos < Sk && (!causal || kpos <= qpos) &&
           (window < 0 || kpos > qpos - window);
  }
  // dS of one score s with its dP, its row's lse2 and delta; P left in s
  template <bool kCapped>
  __device__ __forceinline__ float ds(float& s, float dp, float l2,
                                      float dl) const {
    if (kCapped) {
      const float t = 1.f - 2.f * rcp(1.f + ex2(s * mul));
      s = ex2(fmaf(cap2, t, -l2));
      return s * (dp - dl) * (1.f - t * t);
    }
    s = ex2(fmaf(s, mul, -l2));
    return s * (dp - dl);
  }
};

// P (in s) and dS (in dp) of a 64 x N accumulator tile, in place.  `at(j,
// e, l2, dl, kpos, qpos)` gives element 4j + e's lse2 and delta and its key
// and query.  The softcap and the mask are decided once a tile, outside the
// unrolled loop: a tile wholly inside the mask takes one FFMA and one ex2
// an element and no test.
template <bool kCapped, bool kMasked, int N, typename At>
__device__ __forceinline__ void tile_ds(float (&s)[N / 2], float (&dp)[N / 2],
                                        const Grad& gr, At at) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float l2, dl;
      int kpos, qpos;
      at(j, e, l2, dl, kpos, qpos);
      float p = s[4 * j + e];
      float d = gr.ds<kCapped>(p, dp[4 * j + e], l2, dl);
      if (kMasked && !gr.visible(kpos, qpos)) {
        p = 0.f;
        d = 0.f;
      }
      s[4 * j + e] = p;
      dp[4 * j + e] = d;
    }
  }
}

template <int N, typename At>
__device__ __forceinline__ void tile_ds(float (&s)[N / 2], float (&dp)[N / 2],
                                        const Grad& gr, bool full, At at) {
  if (gr.capped) {
    if (full) tile_ds<true, false, N>(s, dp, gr, at);
    else tile_ds<true, true, N>(s, dp, gr, at);
  } else {
    if (full) tile_ds<false, false, N>(s, dp, gr, at);
    else tile_ds<false, true, N>(s, dp, gr, at);
  }
}

// acc = A.B^T over DP / 16 steps of 16 head dims: A (64 rows) and B (N
// rows) K-major in 128-byte-swizzled slabs of 64 columns, a_slab and b_slab
// bytes apart
template <int DP, int N>
__device__ __forceinline__ void ss_tile(float (&acc)[N / 2], uint32_t a,
                                        uint32_t a_slab, uint32_t b,
                                        uint32_t b_slab) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const uint32_t step = (kc & 3) * 32;     // inside a 64-column slab
    wgmma_ss<N>(acc, sw128_desc(a + (kc >> 2) * a_slab + step, 16, 1024),
                sw128_desc(b + (kc >> 2) * b_slab + step, 16, 1024), kc > 0);
  }
}

// acc += A.B over KS steps of 16: A from registers, B (16 KS rows of N
// columns in slabs b_slab bytes apart) read transposed (MN-major)
template <int N, int KS>
__device__ __forceinline__ void rs_tile(float (&acc)[N / 2],
                                        const uint32_t (&a)[KS][4],
                                        uint32_t b, uint32_t b_slab) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
    wgmma_rs_tb<N>(acc, a[kc], sw128_desc(b + kc * 16 * 128, b_slab, 1024));
}

// an accumulator of 64 x (8 KS) as the register A operand of KS 16-deep
// steps (two adjacent n-tiles make one step)
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[KS][4],
                                       const float (&s)[8 * KS]) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// Turns: the two consumers of a block wait on the same ring stages and so
// would issue their products, and run their elementwise work, at the same
// moments, leaving the tensor cores idle in between.  Instead they take
// turns at issuing: consumer 0 issues, then consumer 1, then consumer 0
// again, so one consumer's elementwise work runs while the other's products
// hold the tensor cores.  Both take the same number of turns (n_turns),
// live tile or not.  Named barrier 1 + c is consumer c's (256 threads: its
// own 128 wait, the other's 128 arrive); consumer 1 opens with an arrival
// and skips its last one, so every arrival is waited for.
struct Turns {
  int cw, n_turns;
  __device__ __forceinline__ void open() const {
    if (cw == 1 && n_turns > 0) named_bar_arrive(1, 2 * kWg);
  }
  __device__ __forceinline__ void begin() const {
    named_bar_sync(1 + cw, 2 * kWg);
  }
  __device__ __forceinline__ void end(int turn) const {
    if (cw == 0 || turn + 1 < n_turns) named_bar_arrive(2 - cw, 2 * kWg);
  }
};

__device__ __forceinline__ Grad make_grad(int Sk, int causal, int window,
                                          float scale, float softcap) {
  Grad gr;
  gr.Sk = Sk;
  gr.causal = causal;
  gr.window = window;
  gr.capped = softcap > 0.f;
  gr.mul = gr.capped ? 2.f * kLog2e * scale / softcap : scale * kLog2e;
  gr.cap2 = softcap * kLog2e;
  return gr;
}

// ---------------------------------------------------------------------------
// bf16: dK and dV in the key tile's frame
// ---------------------------------------------------------------------------

constexpr int kQT = 64;                 // query rows of a ring stage

// Shared memory of one block, from a 1024-byte-aligned base: K and V of the
// key tile (DP / 64 slabs of BK rows each), the ring of ST stages of Q and
// dO (DP / 64 slabs of 64 rows each) and of lse2 / delta (64 floats each),
// then the mbarriers full[ST], empty[ST], kv.
template <int DP>
struct KvSmem {
  static constexpr int BK = DP <= 128 ? 128 : 64;   // keys per block
  static constexpr int DW = DP <= 128 ? DP : 128;   // columns per consumer
  static constexpr int ST = DP <= 128 ? 4 : 2;      // ring depth
  static constexpr int slabs = DP / 64;
  static constexpr uint32_t kv_slab = BK * 128;
  static constexpr uint32_t q_slab = kQT * 128;
  static constexpr uint32_t kv_tile = slabs * kv_slab;
  static constexpr uint32_t q_tile = slabs * q_slab;
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = kv_tile;
  static constexpr uint32_t q_off = 2 * kv_tile;           // + stage q_tile
  static constexpr uint32_t do_off = q_off + ST * q_tile;  // + stage q_tile
  static constexpr uint32_t ld_off = do_off + ST * q_tile; // + stage 512
  static constexpr uint32_t bar_off = ld_off + ST * 2 * kQT * 4;
  static constexpr size_t bytes = bar_off + (2 * ST + 1) * 8 + 1024;
};

// The accumulators follow the wgmma layout (wgmma_bf16.cuh): a consumer
// thread owns key rows kr0 + 16 warp + g and + 8, and of each 64-query
// tile the columns 8j + 2tq + {0, 1}.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    int Sq, int Sq_pad, int Sk, int H, int KV, int D,
                    int causal, int window, float scale, float softcap) {
  using L = KvSmem<DP>;
  constexpr int BK = L::BK;
  constexpr int DW = L::DW;
  constexpr int kStages = L::ST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::bar_off;        // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage
  const uint32_t kv_bar = empty_bar + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;       // key tile 0 sees the most queries
  const int kvh = h / (H / KV);
  const long long bh = (long long)b * H + h;

  // query tiles of the block's band [t_lo, t_lo + n_tiles)
  const int k_last = min(k0 + BK, Sk) - 1;
  const int t_lo = causal ? k0 / kQT : 0;
  int t_hi = (Sq + kQT - 1) / kQT;
  if (window >= 0) t_hi = min(t_hi, max(k_last + window - 1, 0) / kQT + 1);
  const int n_tiles = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kEmptyArrivals);
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(kv_bar, 2 * L::kv_tile);
    for (int sl = 0; sl < L::slabs; ++sl) {
      tma_load_4d(base + L::k_off + sl * L::kv_slab, &kmap, kv_bar, sl * 64,
                  kvh, k0, b);
      tma_load_4d(base + L::v_off + sl * L::kv_slab, &vmap, kv_bar, sl * 64,
                  kvh, k0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages)
        mbar_wait(empty_bar + 8 * st, ((i / kStages) - 1) & 1);
      const uint32_t bar = full_bar + 8 * st;
      const int q0 = (t_lo + i) * kQT;
      mbar_arrive_expect_tx(bar, 2 * L::q_tile + 2 * kQT * 4);
      for (int sl = 0; sl < L::slabs; ++sl) {
        tma_load_4d(base + L::q_off + st * L::q_tile + sl * L::q_slab, &qmap,
                    bar, sl * 64, h, q0, b);
        tma_load_4d(base + L::do_off + st * L::q_tile + sl * L::q_slab,
                    &domap, bar, sl * 64, h, q0, b);
      }
      const uint32_t ld = base + L::ld_off + st * 2 * kQT * 4;
      bulk_load(ld, lse2 + bh * Sq_pad + q0, kQT * 4, bar);
      bulk_load(ld + kQT * 4, delta + bh * Sq_pad + q0, kQT * 4, bar);
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWg - 1;      // consumer 0 or 1
    const int t = threadIdx.x % kWg;
    const int warp = t / 32;
    const int lane = t % 32;
    const int tq = lane & 3;
    // this consumer's 64 keys and output columns
    const int kr0 = DP <= 128 ? k0 + cw * 64 : k0;
    const int col0 = DP <= 128 ? 0 : cw * DW;
    const int r0 = kr0 + warp * 16 + (lane >> 2);   // this thread's two keys
    const int r1 = r0 + 8;
    const Grad gr = make_grad(Sk, causal, window, scale, softcap);
    const uint32_t krows = (DP <= 128 ? cw * 64 * 128 : 0);
    const uint32_t k_desc = base + L::k_off + krows;
    const uint32_t v_desc = base + L::v_off + krows;

    // this consumer's live tiles [i_lo, i_hi): the others lie wholly
    // before its first key (causal) or past its last key's window
    int i_lo = 0, i_hi = n_tiles;
    if (kr0 >= Sk) {
      i_hi = 0;
    } else {
      const int kr_last = min(kr0 + 63, Sk - 1);
      if (causal) i_lo = max(0, kr0 / kQT - t_lo);
      if (window >= 0)
        i_hi = min(i_hi, max(kr_last + window - 1, 0) / kQT + 1 - t_lo);
    }

    float dkacc[DW / 2], dvacc[DW / 2];
    float s[kQT / 2], dp[kQT / 2];
    uint32_t pa[kQT / 16][4], pds[kQT / 16][4];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) {
      dkacc[i] = 0.f;
      dvacc[i] = 0.f;
    }
    // two turns a tile: S^T and dP^T, then dV and dK
    const Turns turns{cw, 2 * n_tiles};
    turns.open();
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
      if (i < i_lo || i >= i_hi) {
        turns.begin();
        turns.end(2 * i);
        turns.begin();
        turns.end(2 * i + 1);
      } else {
        const int q0 = (t_lo + i) * kQT;
        const uint32_t q_st = base + L::q_off + st * L::q_tile;
        const uint32_t do_st = base + L::do_off + st * L::q_tile;
        turns.begin();
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        ss_tile<DP, kQT>(s, k_desc, L::kv_slab, q_st, L::q_slab);
        wgmma_commit();
        ss_tile<DP, kQT>(dp, v_desc, L::kv_slab, do_st, L::q_slab);
        wgmma_commit();
        turns.end(2 * i);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // P^T and dS^T in place; a tile wholly inside the mask for every
        // key of this consumer tests no element (rows past Sq have P = 0
        // through their padded lse2)
        const bool full = kr0 + 63 < Sk && (!causal || kr0 + 63 <= q0) &&
                          (window < 0 || kr0 > q0 + kQT - 1 - window);
        const float* ls = reinterpret_cast<const float*>(
            smem + L::ld_off + st * 2 * kQT * 4);
        tile_ds<kQT>(s, dp, gr, full,
                     [&](int j, int e, float& l2, float& dl, int& kpos,
                         int& qpos) {
                       const int c = 8 * j + 2 * tq + (e & 1);
                       l2 = ls[c];
                       dl = ls[kQT + c];
                       kpos = e < 2 ? r0 : r1;
                       qpos = q0 + c;
                     });
        pack_a<kQT / 16>(pa, s);
        pack_a<kQT / 16>(pds, dp);
        turns.begin();
        fence_regs(dvacc);
        fence_regs(dkacc);
        wgmma_fence();
        rs_tile<DW, kQT / 16>(dvacc, pa, do_st + (col0 / 64) * L::q_slab,
                              L::q_slab);
        rs_tile<DW, kQT / 16>(dkacc, pds, q_st + (col0 / 64) * L::q_slab,
                              L::q_slab);
        wgmma_commit();
        turns.end(2 * i + 1);
        wgmma_wait<0>();
        fence_regs(dvacc);
        fence_regs(dkacc);
        fence_regs(pa);
        fence_regs(pds);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    }

    // dK = scale dS^T.Q; straight to the grads (one head a group) or to
    // this head's f32 partial, 8 or 4 bytes a store
    const int G = H / KV;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      if (row >= Sk) continue;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        const int col = col0 + 8 * j + 2 * tq;
        if (col >= D) continue;
        const float k_a = dkacc[4 * j + 2 * half] * scale;
        const float k_b = dkacc[4 * j + 2 * half + 1] * scale;
        const float v_a = dvacc[4 * j + 2 * half];
        const float v_b = dvacc[4 * j + 2 * half + 1];
        if (G == 1) {
          const long long off = (((long long)b * Sk + row) * KV + kvh) * D + col;
          *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(k_a, k_b);
          *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(v_a, v_b);
        } else {
          const long long off = (((long long)b * Sk + row) * H + h) * D + col;
          *reinterpret_cast<float2*>(dk_part + off) = make_float2(k_a, k_b);
          *reinterpret_cast<float2*>(dv_part + off) = make_float2(v_a, v_b);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// both dtypes: the fold of the key frame's per-head partials
// ---------------------------------------------------------------------------

template <int kVec>
__device__ __forceinline__ void load_cols(float (&x)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_cols(T* p, const float (&x)[kVec]) {
  if constexpr (kVec == 4 && sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = from_f32<T>(x[0]);
  }
}

// The query frame's blocks fold the key frame's per-head partials (the
// key frame ran before them on the stream): dk[b, s, kvh, :] = the sum
// over g in head order of part[b, s, kvh G + g, :], and the same for dv.
// This block takes its share of the n groups of kVec columns (4 where D
// allows: always in bf16, whose D is a multiple of 8) with threads t of nt.
// In bf16 the producer's three idle warps do it under the consumers'
// products (a kernel of its own made the backward 0.014 ms slower on the
// H100 at the training shape, PERF.md); in float32 every thread, after dQ.
template <typename T, int kVec>
__device__ __forceinline__ void fold_share(const float* __restrict__ dk_part,
                                           const float* __restrict__ dv_part,
                                           T* __restrict__ dk,
                                           T* __restrict__ dv, long long n,
                                           int G, int D, int t, int nt) {
  const long long nb = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long id =
      blockIdx.x + gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  const long long end = (id + 1) * n / nb;
  for (long long i = id * n / nb + t; i < end; i += nt) {
    const long long o = kVec * i;           // [b, s, kvh] row, column
    const long long row = o / D;
    const int col = (int)(o - row * D);
    const float* kp = dk_part + row * G * D + col;
    const float* vp = dv_part + row * G * D + col;
    float ka[kVec], va[kVec];
    load_cols<kVec>(ka, kp);
    load_cols<kVec>(va, vp);
    for (int gi = 1; gi < G; ++gi) {
      float kb[kVec], vb[kVec];
      load_cols<kVec>(kb, kp + gi * D);
      load_cols<kVec>(vb, vp + gi * D);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        ka[c] += kb[c];
        va[c] += vb[c];
      }
    }
    store_cols<T, kVec>(dk + o, ka);
    store_cols<T, kVec>(dv + o, va);
  }
}

// ---------------------------------------------------------------------------
// bf16: dQ in the query tile's frame
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                // query rows per block

// Shared memory: Q and dO of the block (DP / 64 slabs of 128 rows each),
// the ring of ST stages of K and V (DP / 64 slabs of BK rows each), then
// the mbarriers kfull[ST], kempty[ST], vfull[ST], vempty[ST], q.  K is
// released after dQ += dS.K, V as soon as dP is in.  BK = 128 keys a
// stage (S and dP of 64 x 128 and dQ take 192 of a consumer's registers at
// D = 128); at D = 256 dQ alone takes 128 registers, so BK = 64.
template <int DP>
struct QSmem {
  static constexpr int BK = DP <= 128 ? 128 : 64;
  static constexpr int ST = DP == 64 ? 4 : DP == 128 ? 2 : 1;
  static constexpr int slabs = DP / 64;
  static constexpr uint32_t q_slab = kBQ * 128;
  static constexpr uint32_t kv_slab = BK * 128;
  static constexpr uint32_t kv_tile = slabs * kv_slab;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = slabs * q_slab;
  static constexpr uint32_t k_off = 2 * slabs * q_slab;     // + stage tile
  static constexpr uint32_t v_off = k_off + ST * kv_tile;   // + stage tile
  static constexpr uint32_t bar_off = v_off + ST * kv_tile;
  static constexpr size_t bytes = bar_off + (4 * ST + 1) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_q_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq,
                   const float* __restrict__ dk_part,
                   const float* __restrict__ dv_part,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, long long folds, int Sq,
                   int Sq_pad, int Sk, int H, int KV, int D, int causal,
                   int window, float scale, float softcap) {
  using L = QSmem<DP>;
  constexpr int BK = L::BK;
  constexpr int kStages = L::ST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kfull = base + L::bar_off;          // + 8 * stage
  const uint32_t kempty = kfull + 8 * kStages;
  const uint32_t vfull = kempty + 8 * kStages;
  const uint32_t vempty = vfull + 8 * kStages;
  const uint32_t q_bar = vempty + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest first
  const int kvh = h / (H / KV);
  const long long bh = (long long)b * H + h;

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
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, kEmptyArrivals);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, kEmptyArrivals);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) {
      fold_share<__nv_bfloat16, 4>(dk_part, dv_part, dk, dv, folds / 4,
                                   H / KV, D, threadIdx.x - 32, kWg - 32);
      return;
    }
    if (threadIdx.x != 0) return;
    // Q and dO through the key frame's maps: two 64-row boxes a slab
    mbar_arrive_expect_tx(q_bar, 2 * L::slabs * L::q_slab);
    for (int sl = 0; sl < L::slabs; ++sl)
      for (int r = 0; r < kBQ; r += kQT) {
        tma_load_4d(base + L::q_off + sl * L::q_slab + r * 128, &qmap, q_bar,
                    sl * 64, h, q0 + r, b);
        tma_load_4d(base + L::do_off + sl * L::q_slab + r * 128, &domap,
                    q_bar, sl * 64, h, q0 + r, b);
      }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int key0 = (t_lo + i) * BK;
      const uint32_t ph = ((i / kStages) - 1) & 1;
      // V first: it is released early, K only after dQ += dS.K
      if (i >= kStages) mbar_wait(vempty + 8 * st, ph);
      mbar_arrive_expect_tx(vfull + 8 * st, L::kv_tile);
      for (int sl = 0; sl < L::slabs; ++sl)
        tma_load_4d(base + L::v_off + st * L::kv_tile + sl * L::kv_slab,
                    &vmap, vfull + 8 * st, sl * 64, kvh, key0, b);
      if (i >= kStages) mbar_wait(kempty + 8 * st, ph);
      mbar_arrive_expect_tx(kfull + 8 * st, L::kv_tile);
      for (int sl = 0; sl < L::slabs; ++sl)
        tma_load_4d(base + L::k_off + st * L::kv_tile + sl * L::kv_slab,
                    &kmap, kfull + 8 * st, sl * 64, kvh, key0, b);
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWg - 1;
    const int t = threadIdx.x % kWg;
    const int warp = t / 32;
    const int lane = t % 32;
    const int tq = lane & 3;
    const int row_lo = q0 + cw * 64;            // rows [row_lo, row_lo + 64)
    const int row_hi = row_lo + 63;
    const int r0 = row_lo + warp * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    const Grad gr = make_grad(Sk, causal, window, scale, softcap);
    const uint32_t q_desc = base + L::q_off + cw * 64 * 128;
    const uint32_t do_desc = base + L::do_off + cw * 64 * 128;
    // rows up to Sq_pad exist in the workspace
    const float l2_0 = lse2[bh * Sq_pad + r0], l2_1 = lse2[bh * Sq_pad + r1];
    const float dl_0 = delta[bh * Sq_pad + r0];
    const float dl_1 = delta[bh * Sq_pad + r1];

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

    float dqacc[DP / 2];
    float s[BK / 2], dp[BK / 2];
    uint32_t pds[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqacc[i] = 0.f;
    // two turns a tile: S and dP, then dQ
    const Turns turns{cw, 2 * n_tiles};
    turns.open();
    auto release = [&](uint32_t bar, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (i % kStages));
    };
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint32_t k_st = base + L::k_off + st * L::kv_tile;
      const uint32_t v_st = base + L::v_off + st * L::kv_tile;
      mbar_wait(kfull + 8 * st, ph);
      mbar_wait(vfull + 8 * st, ph);
      if (i >= i_lo && i < i_hi) {
        const int key0 = (t_lo + i) * BK;
        turns.begin();
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        ss_tile<DP, BK>(s, q_desc, L::q_slab, k_st, L::kv_slab);
        wgmma_commit();
        ss_tile<DP, BK>(dp, do_desc, L::q_slab, v_st, L::kv_slab);
        wgmma_commit();
        turns.end(2 * i);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        release(vempty, i);         // V is free once dP is in
        const bool full = key0 + BK <= Sk &&
                          (!causal || key0 + BK - 1 <= row_lo) &&
                          (window < 0 || key0 > row_hi - window);
        tile_ds<BK>(s, dp, gr, full,
                    [&](int j, int e, float& l2, float& dl, int& kpos,
                        int& qpos) {
                      l2 = e < 2 ? l2_0 : l2_1;
                      dl = e < 2 ? dl_0 : dl_1;
                      kpos = key0 + 8 * j + 2 * tq + (e & 1);
                      qpos = e < 2 ? r0 : r1;
                    });
        pack_a<BK / 16>(pds, dp);
        turns.begin();
        fence_regs(dqacc);
        wgmma_fence();
        rs_tile<DP, BK / 16>(dqacc, pds, k_st, L::kv_slab);
        wgmma_commit();
        turns.end(2 * i + 1);
        wgmma_wait<0>();
        fence_regs(dqacc);
        fence_regs(pds);
      } else {
        release(vempty, i);
        turns.begin();
        turns.end(2 * i);
        turns.begin();
        turns.end(2 * i + 1);
      }
      release(kempty, i);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      if (row >= Sq) continue;
      __nv_bfloat16* dst = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < D)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(dqacc[4 * j + 2 * half] * scale,
                        dqacc[4 * j + 2 * half + 1] * scale);
      }
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse2, const float* delta,
                 void* dq, void* dk, void* dv, float* dk_part, float* dv_part,
                 int B, int Sq, int Sq_pad, int Sk, int H, int KV, int D,
                 int causal, int window, float scale, float softcap,
                 cudaStream_t stream) {
  using KL = KvSmem<DP>;
  using QL = QSmem<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)QL::bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_kv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KL::bytes);
  if (err != cudaSuccess) return (int)err;
  static_assert(QL::BK == KL::BK, "both frames read K and V by one map");
  // 64-row boxes of Q and dO, BK-row boxes of K and V, for both kernels
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  if (!(encode_map(&maps[0], q, B, Sq, H, D, kQT) &&
        encode_map(&maps[1], k, B, Sk, KV, D, KL::BK) &&
        encode_map(&maps[2], v, B, Sk, KV, D, KL::BK) &&
        encode_map(&maps[3], dout, B, Sq, H, D, kQT)))
    return (int)cudaErrorInvalidValue;
  // the key frame first: the query frame's blocks fold its partials
  flash_bwd_kv_kernel<DP><<<dim3(H, B, (Sk + KL::BK - 1) / KL::BK), kThreads,
                            KL::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      dk_part, dv_part, Sq, Sq_pad, Sk, H, KV, D, causal, window, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_q_kernel<DP><<<dim3(H, B, (Sq + kBQ - 1) / kBQ), kThreads,
                           QL::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta,
      static_cast<__nv_bfloat16*>(dq), dk_part, dv_part,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H == KV ? 0 : (long long)B * Sk * KV * D, Sq, Sq_pad, Sk, H, KV, D,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: both frames on mma.sync in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;        // eight warps

// P and dS of one pair (natural units; expf and tanhf, as the forward's
// float32 path)
__device__ __forceinline__ void f32_pd(float dot, float dpv, float lse,
                                       float dl, float scale, float softcap,
                                       bool ok, float& p, float& ds) {
  float x = dot * scale, fac = 1.f;
  if (softcap > 0.f) {
    const float tt = tanhf(x / softcap);
    x = softcap * tt;
    fac = 1.f - tt * tt;
  }
  p = ok ? expf(x - lse) : 0.f;
  ds = p * (dpv - dl) * fac;
}

// A block owns BM rows of one frame as two tiles (K and V of its KV head in
// the key frame, Q and dO of head h in the query frame) and streams the
// other frame's rows BN at a time.  Warp w owns rows 16 (w % RG) of every
// product and a 1 / CS share of its columns.  Rows hold DP + 4 floats (BN
// + 4 for P and dS), so reading a fragment of a tile as stored touches 32
// banks.  Shared memory, in floats: the own tiles [2][BM][LD], two stages
// of streamed tiles [2][2][BN][LD], P and dS [BM][LP] each, then lse and
// delta of the query rows ([2 stages][2][BN] in the key frame, [2][BM] in
// the query frame).
template <int DP>
struct F32Tiles {
  static constexpr int BM = DP <= 128 ? 64 : 32;
  static constexpr int BN = 32;
  static constexpr int LD = DP + 4;
  static constexpr int LP = BN + 4;
  static constexpr int RG = BM / 16;       // row groups of 16
  static constexpr int CS = 8 / RG;        // column shares
  static constexpr int NS = BN / CS / 8;   // n-tiles of S a warp
  static constexpr int NA = DP / CS / 8;   // n-tiles of a grad a warp
  static constexpr int stream = 2 * BM * LD;
  static constexpr int p = stream + 4 * BN * LD;
  static constexpr int ds = p + BM * LP;
  static constexpr int rows = ds + BM * LP;
  static constexpr size_t bytes =
      (rows + 4 * (BM > BN ? BM : BN)) * sizeof(float);
};

// kKeys: the key frame, one block per (BM keys, query head h): S^T = K.Q^T,
// dP^T = V.dO^T, dV += P^T.dO and dK += dS^T.Q over the query rows of its
// band; g0, g1 are dk, dv (H == KV) or head h's partials [B, Sk, H, D].
// Otherwise the query frame, one block per (BM query rows, h): S = Q.K^T,
// dP = dO.V^T and dQ += dS.K over its key band; g0 is dq.  Every product
// is 3xTF32 (mma_tf32.cuh's warp_mma) into float32 accumulators.  vec: D
// a multiple of 4 and q, k, v, dout on 16 bytes, so tiles load by
// cp.async; otherwise the threads load them.
template <int DP, bool kKeys>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ g0,
                     float* __restrict__ g1, const float* __restrict__ dk_part,
                     const float* __restrict__ dv_part, float* __restrict__ dk,
                     float* __restrict__ dv, long long folds, int Sq,
                     int Sq_pad, int Sk, int H, int KV, int D, int causal,
                     int window, float scale, float softcap, int vec) {
  using L = F32Tiles<DP>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LP = L::LP;
  extern __shared__ float4 f32_smem[];
  float* const sm = reinterpret_cast<float*>(f32_smem);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const long long bh = (long long)b * H + h;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int tq = tid & 3;
  const int m0 = 16 * (warp % L::RG);
  const int n0 = (warp / L::RG) * (BN / L::CS);     // columns of S
  const int c0 = (warp / L::RG) * (DP / L::CS);     // columns of a grad

  const long long q_stride = (long long)H * D, k_stride = (long long)KV * D;
  const float* q_b = q + ((long long)b * Sq * H + h) * D;
  const float* o_b = dout + ((long long)b * Sq * H + h) * D;
  const float* k_b = k + ((long long)b * Sk * KV + kvh) * D;
  const float* v_b = v + ((long long)b * Sk * KV + kvh) * D;
  // the block's rows [r0, r0 + BM) and the streamed rows [lo, hi)
  int r0, lo, hi;
  if constexpr (kKeys) {
    r0 = blockIdx.z * BM;               // key tile 0 sees the most queries
    const int last = min(r0 + BM, Sk) - 1;
    lo = causal ? r0 : 0;
    hi = window >= 0 ? min(Sq, last + window) : Sq;
  } else {
    r0 = (gridDim.z - 1 - blockIdx.z) * BM;     // the longest band first
    const int last = min(r0 + BM, Sq) - 1;
    lo = window >= 0 ? max(0, r0 - window + 1) / BN * BN : 0;
    hi = causal ? min(Sk, last + 1) : Sk;
  }
  const int n_steps = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const float* own0 = kKeys ? k_b : q_b;
  const float* own1 = kKeys ? v_b : o_b;
  const float* src0 = kKeys ? q_b : k_b;
  const float* src1 = kKeys ? o_b : v_b;
  const long long own_stride = kKeys ? k_stride : q_stride;
  const long long src_stride = kKeys ? q_stride : k_stride;
  const int own_n = kKeys ? Sk : Sq;
  const int src_n = kKeys ? Sq : Sk;
  float* const rl = sm + L::rows;       // lse, delta

  // lse and delta of query rows [r, r + n) into dst, dst + n
  auto load_rows = [&](float* dst, int r, int n) {
    for (int i = tid; i < n; i += kF32Threads) {
      const bool ok = r + i < Sq;
      cp_async4(dst + i, ok ? lse + bh * Sq + r + i : lse, ok);
      cp_async4(dst + n + i, ok ? delta + bh * Sq_pad + r + i : delta, ok);
    }
  };
  // streamed rows of step i into stage i % 2, one cp.async group
  auto stage = [&](int i) {
    const int s0 = lo + i * BN;
    float* dst = sm + L::stream + (i & 1) * 2 * BN * LD;
    load_tile<BN, DP, LD, kF32Threads>(dst, src0 + s0 * src_stride,
                                       src_stride, src_n - s0, D, vec, tid);
    load_tile<BN, DP, LD, kF32Threads>(dst + BN * LD,
                                       src1 + s0 * src_stride, src_stride,
                                       src_n - s0, D, vec, tid);
    if constexpr (kKeys) load_rows(rl + (i & 1) * 2 * BN, s0, BN);
    cp_async_commit();
  };

  float acc0[L::NA][4], acc1[L::NA][4];
  zero(acc0);
  zero(acc1);
  if (n_steps > 0) {
    load_tile<BM, DP, LD, kF32Threads>(sm, own0 + r0 * own_stride,
                                       own_stride, own_n - r0, D, vec, tid);
    load_tile<BM, DP, LD, kF32Threads>(sm + BM * LD, own1 + r0 * own_stride,
                                       own_stride, own_n - r0, D, vec, tid);
    if constexpr (!kKeys) load_rows(rl, r0, BM);
    stage(0);                           // one group with the own tiles
  }
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = sm + L::stream + (i & 1) * 2 * BN * LD;
    const float* rs = kKeys ? rl + (i & 1) * 2 * BN : rl;
    const int s0 = lo + i * BN;
    float s[L::NS][4], dp[L::NS][4];
    zero(s);
    zero(dp);
    warp_mma<L::NS, DP / 8, false, false, true, true>(s, sm, LD, st, LD, m0,
                                                      n0, g, tq);
    warp_mma<L::NS, DP / 8, false, false, true, true>(
        dp, sm + BM * LD, LD, st + BN * LD, LD, m0, n0, g, tq);
#pragma unroll
    for (int nt = 0; nt < L::NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mr = m0 + g + 8 * (e >> 1);
        const int nc = n0 + 8 * nt + 2 * tq + (e & 1);
        const int kpos = kKeys ? r0 + mr : s0 + nc;
        const int qpos = kKeys ? s0 + nc : r0 + mr;
        const int qi = kKeys ? nc : mr;           // the query row's lse
        const int qn = kKeys ? BN : BM;
        const bool ok = kpos < Sk && qpos < Sq &&
                        (!causal || kpos <= qpos) &&
                        (window < 0 || kpos > qpos - window);
        float p, dsv;
        f32_pd(s[nt][e], dp[nt][e], rs[qi], rs[qn + qi], scale, softcap, ok,
               p, dsv);
        if constexpr (kKeys) sm[L::p + mr * LP + nc] = p;
        sm[L::ds + mr * LP + nc] = dsv;
      }
    __syncthreads();
    if constexpr (kKeys) {
      // dV += P^T.dO, dK += dS^T.Q
      warp_mma<L::NA, BN / 8, false, true, true, true>(
          acc1, sm + L::p, LP, st + BN * LD, LD, m0, c0, g, tq);
      warp_mma<L::NA, BN / 8, false, true, true, true>(
          acc0, sm + L::ds, LP, st, LD, m0, c0, g, tq);
    } else {
      // dQ += dS.K
      warp_mma<L::NA, BN / 8, false, true, true, true>(
          acc0, sm + L::ds, LP, st, LD, m0, c0, g, tq);
    }
    __syncthreads();    // the stage, P and dS are free again
  }

  const int G = H / KV;
#pragma unroll
  for (int nt = 0; nt < L::NA; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + m0 + g + 8 * (e >> 1);
      const int c = c0 + 8 * nt + 2 * tq + (e & 1);
      if (c >= D || r >= own_n) continue;
      if constexpr (kKeys) {
        const long long off =
            G == 1 ? (((long long)b * Sk + r) * KV + kvh) * D + c
                   : (((long long)b * Sk + r) * H + h) * D + c;
        g0[off] = acc0[nt][e] * scale;
        g1[off] = acc1[nt][e];
      } else {
        g0[(((long long)b * Sq + r) * H + h) * D + c] = acc0[nt][e] * scale;
      }
    }
  if constexpr (!kKeys) {
    if (D % 4 == 0)
      fold_share<float, 4>(dk_part, dv_part, dk, dv, folds / 4, G, D, tid,
                           kF32Threads);
    else
      fold_share<float, 1>(dk_part, dv_part, dk, dv, folds, G, D, tid,
                           kF32Threads);
  }
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, float* dk_part,
               float* dv_part, int B, int Sq, int Sq_pad, int Sk, int H,
               int KV, int D, int causal, int window, float scale,
               float softcap, cudaStream_t stream) {
  using L = F32Tiles<DP>;
  const int vec = D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dout) % 16 == 0;
  const bool fold = H != KV;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_f32_kernel<DP, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_f32_kernel<DP, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_f32_kernel<DP, true>
      <<<dim3(H, B, (Sk + L::BM - 1) / L::BM), kF32Threads, L::bytes,
          stream>>>(q, k, v, dout, lse, delta, fold ? dk_part : dk,
                    fold ? dv_part : dv, nullptr, nullptr, nullptr, nullptr,
                    0, Sq, Sq_pad, Sk, H, KV, D, causal, window, scale,
                    softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_f32_kernel<DP, false>
      <<<dim3(H, B, (Sq + L::BM - 1) / L::BM), kF32Threads, L::bytes,
          stream>>>(q, k, v, dout, lse, delta, dq, nullptr, dk_part,
                    dv_part, dk, dv, fold ? (long long)B * Sk * KV * D : 0,
                    Sq, Sq_pad, Sk, H, KV, D, causal, window, scale, softcap,
                    vec);
  return (int)cudaGetLastError();
}

long long pad_rows(int Sq) {
  return ((long long)Sq + kRowPad - 1) / kRowPad * kRowPad;
}

}  // namespace

// Floats of workspace repro_flash_attention_bwd needs: lse2 and delta for
// [B, H, Sq rounded up to 128], and with H > KV the dK and dV partials of
// every query head, [B, Sk, H, D] each.  -1 for sizes it does not take.
extern "C" long long repro_flash_attention_bwd_workspace(int B, int Sq,
                                                         int Sk, int H,
                                                         int KV, int D,
                                                         int is_bf16) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      D <= 0 || D > 256)
    return -1;
  long long n = 2LL * B * H * pad_rows(Sq);
  if (H != KV) n += 2LL * B * Sk * H * D;
  return n;
}

// q, out, dout, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KV, D], contiguous,
// all of one dtype (is_bf16: bfloat16, else float32); lse: [B, H, Sq] f32
// from the forward; ws: the floats repro_flash_attention_bwd_workspace
// asks for.  causal, window (< 0: none) and softcap (<= 0: none) as the
// forward took them, scale its score scale.  bf16 needs what TMA
// addresses: D a multiple of 8 and q, k, v, dout on 16 bytes
// (kernels/flash_attention/ops.py pads and copies to that); anything else
// is refused.  Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* ws, int B, int Sq, int Sk, int H, int KV, int D, int causal,
    int window, float scale, float softcap, int is_bf16, void* stream) {
  if (repro_flash_attention_bwd_workspace(B, Sq, Sk, H, KV, D, is_bf16) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esz = is_bf16 ? 2 : 4;
  if (Sk == 0)       // no key: P and every grad are 0
    return (int)cudaMemsetAsync(dq, 0, (size_t)B * Sq * H * D * esz, s);
  if (is_bf16 && (D % 8 != 0 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dout) % 16))
    return (int)cudaErrorInvalidValue;
  const int Sq_pad = (int)pad_rows(Sq);
  const long long rows = (long long)B * H * Sq_pad;
  float* lse2 = ws;
  float* delta = ws + rows;
  const int lanes = is_bf16 && D <= 128 ? 16 : 32;
  const unsigned prep_blocks =
      (unsigned)((rows * lanes + kPrepWarps * 32 - 1) / (kPrepWarps * 32));
  if (is_bf16)
    flash_bwd_prep_kernel<__nv_bfloat16>
        <<<prep_blocks, kPrepWarps * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out),
            static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, B * H,
            Sq, Sq_pad, H, D, lanes);
  else
    flash_bwd_prep_kernel<float><<<prep_blocks, kPrepWarps * 32, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), lse,
        lse2, delta, B * H, Sq, Sq_pad, H, D, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* dk_part = ws + 2 * rows;
  float* dv_part = dk_part + (long long)B * Sk * H * D;
  int status;
  if (is_bf16) {
#define REPRO_ARGS q, k, v, dout, lse2, delta, dq, dk, dv, dk_part, dv_part, \
                   B, Sq, Sq_pad, Sk, H, KV, D, causal, window, scale,       \
                   softcap, s
    status = D <= 64    ? launch_wgmma<64>(REPRO_ARGS)
             : D <= 128 ? launch_wgmma<128>(REPRO_ARGS)
                        : launch_wgmma<256>(REPRO_ARGS);
#undef REPRO_ARGS
  } else {
#define REPRO_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
                   static_cast<const float*>(v),                              \
                   static_cast<const float*>(dout), lse, delta,               \
                   static_cast<float*>(dq), static_cast<float*>(dk),          \
                   static_cast<float*>(dv), dk_part, dv_part, B, Sq, Sq_pad,  \
                   Sk, H, KV, D, causal, window, scale, softcap, s
    status = D <= 32    ? launch_f32<32>(REPRO_ARGS)
             : D <= 64  ? launch_f32<64>(REPRO_ARGS)
             : D <= 128 ? launch_f32<128>(REPRO_ARGS)
                        : launch_f32<256>(REPRO_ARGS);
#undef REPRO_ARGS
  }
  return status;
}
