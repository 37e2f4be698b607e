// Chunk-causal paged GQA attention for Hopper (sm_90a): the port of the
// Pallas kernel repro/kernels/paged_attention/kernel.py::
// paged_attention_chunk (body _paged_kernel; paged_attention is its C=1
// decode form with lengths - 1).
//
// What it computes: for each sequence b, KV head k and query row r of the
// C*G rows of that head (row r = token c = r / G of the chunk, query head
// h = k*G + r % G, at position lengths[b] + c), softmax(scale * q.K^T)
// over the keys of pages page_table[b, :] (page indices clamped into
// [0, P)) with key position <= the query position (and > position - window
// when windowed), times V.  Scores are f32, an optional tanh softcap
// applies before the mask, the online softmax runs with a FINITE NEG_INF
// (-1e30) so an all-masked tile never makes exp(m_prev - m_curr) a NaN,
// masked probabilities are forced to 0, and the denominator is clamped at
// 1e-20, so a row that sees no key writes 0.  The output is written in q's
// dtype.  These are the exact expressions of _paged_kernel.
//
// What bounds it on this card: bytes.  The work is the K/V bytes of the
// keys each sequence's chunk can see (about 2*ctx*KV*D*sizeof(dtype) per
// sequence) plus q and out, against 3.35 TB/s; its operations,
// 4*H*C*ctx*D per sequence, sit far below the 989 TFLOP/s bf16 line at the
// serving shapes (G=6 query heads share one KV head; decode has C=1).  At
// those shapes a call moves a few MB, so launch and memory latency, not
// the rate, set its time.
//
// What the design does about it (bf16, the serving dtype):
//  * one block per (context split, KV head, sequence) owns every query
//    row of that KV head, up to 128 rows (more rows take more row groups
//    in the grid): each K/V byte is read from device memory once per
//    split, and no row tile re-reads it.  q is read in place from
//    [B, C, H, D] (row (c, g) of KV head k is head k*G + g);
//  * S = Q.K^T and O += P.V run on the tensor cores (mma.sync m16n8k16,
//    bf16 in, f32 accumulate; Q's and K's fragments through ldmatrix, V's
//    through ldmatrix.trans; building blocks in mma_bf16.cuh, shared with
//    the flash kernel).  S, P and O stay in registers and the online
//    softmax runs on them per row (exp2 with log2 e folded in);
//  * a block has 16 warps (8 at D = 256).  A warp owns one 16-row tile and
//    one key group: the KG warps of a row tile (four for a decode step's
//    one tile, two for a 16-token chunk's six) take a 16- or 32-key slice
//    each of every 64-key tile, and fold their states together in shared
//    memory at the end, in key-group order.  A lone warp per tile issued
//    its ~130 products a tile one after another on one SM sub-partition;
//    spread over warps they overlap;
//  * each block reads lengths[b] and walks only the keys its chunk can
//    see, [max(0, start - window + 1), min(start + C, N*T)), as tiles of
//    64 keys gathered row by row through the page table (16 keys of one
//    KV head are 16 rows of D*2 bytes at a stride of KV*D*2), in bf16
//    through cp.async into a ring of four shared-memory stages (two at
//    D = 256).  The table entries of each tile's keys ride in the copy
//    group of the tile three ahead, into a shared-memory ring of their
//    own: a page read issued next to the copies would wait for them, and
//    cost a round trip a tile.  Keys past the visible range are
//    zero-filled and masked; the per-element mask runs only on tiles that
//    cross a mask edge;
//  * splits follow the live context: the wrapper picks the split count per
//    call from the shape and the SM count (ops.py plan_splits), and split
//    s takes an equal share of THAT sequence's live tiles.  A split with
//    no tiles exits at once.  When at most one split of a sequence holds
//    tiles, split 0 writes its rows itself; otherwise each live split
//    writes its (m, l, unnormalised acc) to an f32 workspace and a second
//    kernel merges them, one warp a row, in split order, reading only the
//    live splits.  (Merging in the last block of a sequence to finish,
//    elected with an arrival counter, was slower at C = 16 on the H100:
//    one block then reads every split's state of 96 rows.)
//  * no atomics: the result does not depend on block scheduling, and two
//    calls on the same inputs are bitwise equal.
// float32 (the card tests' and comparisons' dtype) keeps an exact scalar
// path: one warp per query row, lanes over the head dim, 16-key f32 tiles
// in shared memory (8-key tiles above D = 256), on the same split plan and
// merge.  D <= 576.
//
// The latent head dim (MLA's serve step, deepseek-v2: one KV head whose
// D = kv_lora_rank + qk_rope_dim = 576 rows serve as both K and V, 16
// query heads; bf16, D in (256, 576] with D % 8 == 0; paged_latent_kernel
// below).  The layout above cannot hold it: a 128-row block's float32
// accumulator alone would be 288 KB, over an SM's 256 KB of registers, and
// one 64-key tile of K is 72 KB of shared memory.  So:
//  * a block owns 64 query rows (4 row tiles) and ONE slice of 192 of the
//    576 output columns; the three slices of a row group are three blocks,
//    each recomputing the same scores (Q.K^T over all 576 dims, 36 chunks
//    of 16 through shared memory, the same mma.sync fragments as above),
//    so each thread keeps 24 accumulator n-tiles (96 floats), not 72;
//  * when pool_k and pool_v are the same storage (MLA passes one pool
//    twice), a 64-key tile is copied into shared memory once and serves
//    both products: V's fragments come from the K tile at the slice's
//    column offset.  Two stages of full-width K tiles and the 64 Q rows
//    take 219 KB.  Separate pools take one stage of K and one of the V
//    slice (no copy overlaps a tile's products then);
//  * the split plan, the key walk, the masks, the key-group fold and the
//    merge are those of the bf16 kernel above; the column slice 0 block
//    writes a split's (m, l), every slice its columns of the accumulator.
// The bound at the serving shape is still bytes: each latent row (1152 B)
// is read once per split and row group from device memory, and the three
// slices' reads of it hit L2.  Recomputing the scores triples the QK
// products, which stay far below the tensor cores' rate at these shapes.
//
// The fused append (repro_paged_attention_append_chunk; both kernels take
// it as the compile-time flag kFused, so the plain entry point's
// instantiations are the kernels above as they were).  The serve step
// used to launch kv_append.cu twice (K, V) before this kernel: two
// launches of 128 KB each, whose time was all launch and DRAM latency.
// Fused, the block of split 0 and row group 0 of each (KV head, sequence)
// writes that head's C new K and V rows to pool[page_ids[b, c],
// slot_ids[b, c]] first, pads included, dropping out-of-range targets as
// kv_append.cu does; and every block that loads a key of the chunk's own
// positions [lengths[b], lengths[b] + C) reads it from the new rows, not
// from the pool, so no block waits on another and there is no flag or
// atomic between them.  The new rows hold the bits the append stores (the
// pools' dtype is theirs), so the output is bitwise that of the two
// appends and the unfused kernel.  Other blocks read only keys before
// lengths[b], which the append does not touch: the engine's targets are
// unpublished staging slots of the sequence's own pages or the null
// page 0, which only idle slots read (as before, pads race there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 64;                 // keys per tile: the unit of a split
constexpr int kWarps = 8;               // float32 and merge blocks
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 128;              // query rows per bf16 block
constexpr int kMaxSplits = 16;          // context splits a call may take

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Rows [0, n_rows) x columns [0, DP) of a bf16 tile into shared memory
// (row stride LD), by all NTHREADS threads of the block: row j comes from
// row_ptr(j); a null row, and every column >= D, becomes 0 (`any` is a
// valid address for the zero-filling copies).  With vec_ok (D % 8 == 0
// and 16-byte aligned rows) the copy is asynchronous (cp.async, 16 bytes
// a thread; commit and wait are the caller's); otherwise it is element by
// element.
template <int DP, int LD, int NTHREADS, typename RowPtr>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* any,
                                          int n_rows, int D, int vec_ok,
                                          RowPtr row_ptr) {
  if (vec_ok) {
    constexpr int vpr = DP / 8;
    for (int idx = threadIdx.x; idx < n_rows * vpr; idx += NTHREADS) {
      const int row = idx / vpr;
      const int c = (idx - row * vpr) * 8;
      const __nv_bfloat16* p = row_ptr(row);
      const bool ok = p != nullptr && c < D;
      cp_async16(dst + row * LD + c, ok ? p + c : any, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n_rows * DP; idx += NTHREADS) {
      const int row = idx / DP;
      const int c = idx - row * DP;
      const __nv_bfloat16* p = row_ptr(row);
      dst[row * LD + c] = (p != nullptr && c < D) ? p[c]
                                                  : __float2bfloat16(0.f);
    }
  }
}

// The keys sequence b's chunk can see, [*k_lo, *k_hi), and the number of
// kBK-key tiles they span.  Every kernel here, the merge included, derives
// the split plan from it, so all agree on which splits hold work.
__device__ __forceinline__ int key_tiles(int start, int C, int T, int N,
                                         int window, int* k_lo, int* k_hi) {
  *k_hi = min(start + C, N * T);
  *k_lo = window >= 0 ? max(0, start - window + 1) : 0;
  return *k_hi > *k_lo ? (*k_hi - *k_lo + kBK - 1) / kBK : 0;
}

// tiles [t_lo, t_hi) of split sp
__device__ __forceinline__ void split_range(int n_tiles, int splits, int sp,
                                            int* t_lo, int* t_hi) {
  const int per = (n_tiles + splits - 1) / splits;
  *t_lo = min(n_tiles, sp * per);
  *t_hi = min(n_tiles, *t_lo + per);
}

// splits [0, live) of a sequence with n_tiles tiles hold tiles
__device__ __forceinline__ int live_splits(int n_tiles, int splits) {
  const int per = (n_tiles + splits - 1) / splits;
  return per ? (n_tiles + per - 1) / per : 0;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
struct PageWalk {          // key positions of one sequence and KV head
  const int* row;          // page_table[b, :]
  int T, P;
  long long tok_stride, kv_off;
  // element offset of key kpos's row in the pool, given its table entry
  __device__ __forceinline__ long long at(int page, int kpos) const {
    page = page < 0 ? 0 : (page >= P ? P - 1 : page);   // gather clamps
    return ((long long)page * T + kpos % T) * tok_stride + kv_off;
  }
  __device__ __forceinline__ long long off(int kpos) const {
    return at(row[kpos / T], kpos);
  }
};

// The fused append's operands: the chunk's new K and V rows, [B, C, KV, D]
// in the pools' dtype, the (page, slot) each token lands at, [B, C] int32
// (models/attention.py paged_chunk_ids), and the pools to write.  The
// kernel reads the pools through its own const __restrict__ operands and
// writes them only through these, rows no block reads (see the header),
// so its loads stay read-only ones.  Unused without kFused.
struct Append {
  const void* k_new;
  const void* v_new;
  const int* page_ids;
  const int* slot_ids;
  void* pool_k;
  void* pool_v;
};

// The new rows of one sequence and KV head: key start + c is row c
template <typename E>
struct NewRows {
  const E* k;              // k_new[b, 0, kv, :]
  const E* v;
  int start;               // lengths[b]
  long long stride;        // KV * D
  __device__ __forceinline__ NewRows(const Append& ap, int b, int C, int KV,
                                     int kv, int D, int start_)
      : k(static_cast<const E*>(ap.k_new) + ((long long)b * C * KV + kv) * D),
        v(static_cast<const E*>(ap.v_new) + ((long long)b * C * KV + kv) * D),
        start(start_), stride((long long)KV * D) {}
  __device__ __forceinline__ long long off(int kpos) const {
    return (long long)(kpos - start) * stride;
  }
};

// The fused append of sequence b, KV head kv, by the NTH threads of one
// block: row c of the chunk lands at pool[page_ids[b, c], slot_ids[b, c],
// kv], pads included; an out-of-range target is dropped, as kv_append.cu
// drops it.  16-byte pieces when vec (D * sizeof(E) a multiple of 16 and
// every base on 16 bytes), else element by element.
template <typename E, int NTH>
__device__ __forceinline__ void append_rows(const Append& ap, int b, int kv,
                                            int C, int KV, int D, int P,
                                            int T, bool vec) {
  E* pk = static_cast<E*>(ap.pool_k);
  E* pv = static_cast<E*>(ap.pool_v);
  const E* kn = static_cast<const E*>(ap.k_new);
  const E* vn = static_cast<const E*>(ap.v_new);
  const int per = vec ? D * (int)sizeof(E) / 16 : D;   // pieces a row
  for (int idx = threadIdx.x; idx < C * per; idx += NTH) {
    const int c = idx / per;
    const int e = idx - c * per;
    const int page = ap.page_ids[b * C + c];
    const int slot = ap.slot_ids[b * C + c];
    if (page < 0 || page >= P || slot < 0 || slot >= T) continue;
    const long long src = ((long long)(b * C + c) * KV + kv) * D;
    const long long dst = (((long long)page * T + slot) * KV + kv) * D;
    if (vec) {
      reinterpret_cast<int4*>(pk + dst)[e] =
          reinterpret_cast<const int4*>(kn + src)[e];
      reinterpret_cast<int4*>(pv + dst)[e] =
          reinterpret_cast<const int4*>(vn + src)[e];
    } else {
      pk[dst + e] = kn[src + e];
      pv[dst + e] = vn[src + e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Warps of a bf16 block: 16 (D <= 128) or 8 (D = 256, whose accumulators
// need more registers than a 16-warp block leaves a thread)
template <int DP>
struct PaWarps {
  static constexpr int warps = DP <= 128 ? 16 : 8;
  static constexpr int threads = warps * 32;
};

// Keys [k0, k0 + kBK) of K and V into shared memory (row stride LD) with
// cp.async, 16 bytes a thread, through `pages` (the table entry of each key
// of the tile, in shared memory); keys >= k_hi and columns >= D are
// zero-filled.  kFused: keys from nr.start on come from the new rows.
template <int DP, int LD, bool kFused>
__device__ __forceinline__ void gather_kv(__nv_bfloat16* ks,
                                          __nv_bfloat16* vs,
                                          const __nv_bfloat16* pool_k,
                                          const __nv_bfloat16* pool_v,
                                          const int* pages,
                                          const PageWalk& pw,
                                          const NewRows<__nv_bfloat16>& nr,
                                          int k0, int k_hi, int D) {
  constexpr int kT = PaWarps<DP>::threads;
  constexpr int vpr = DP / 8;                      // 16-byte copies a key
  static_assert(kBK * vpr % kT == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kBK * vpr / kT; ++i) {
    const int idx = threadIdx.x + i * kT;
    const int row = idx / vpr;
    const int c = (idx - row * vpr) * 8;
    const bool ok = k0 + row < k_hi && c < D;
    const __nv_bfloat16 *sk = pool_k, *sv = pool_v;
    if (kFused && ok && k0 + row >= nr.start) {
      const long long off = nr.off(k0 + row) + c;
      sk = nr.k + off;
      sv = nr.v + off;
    } else if (ok) {
      const long long off = pw.at(pages[row], k0 + row) + c;
      sk = pool_k + off;
      sv = pool_v + off;
    }
    cp_async16(ks + row * LD + c, sk, ok);
    cp_async16(vs + row * LD + c, sv, ok);
  }
}

// Dynamic shared memory of one block: a ring of `stages` K and V tiles of
// 64 keys (four for D <= 128, two for D = 256), the block's query rows, and
// a ring of 2 * stages tiles' table entries (one int a key).  Rows are
// DP + 8 bf16 long, so ldmatrix rows fall on distinct banks and every row
// starts on 16 bytes.
template <int DP>
struct PaSmem {
  static constexpr int stages = DP <= 128 ? 4 : 2;
  static constexpr int page_slots = 2 * stages;
  static constexpr int LD = DP + 8;
  static constexpr size_t tile = (size_t)kBK * LD * 2;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = stages * tile;
  static constexpr size_t q_off = 2 * stages * tile;
  static constexpr size_t pg_off = q_off + (size_t)kRows * LD * 2;
  static constexpr size_t bytes = pg_off + (size_t)page_slots * kBK * 4;
};

template <int DP, int KG, bool kFused>
__global__ void __launch_bounds__(PaWarps<DP>::threads, 1)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool_k,
                       const __nv_bfloat16* __restrict__ pool_v,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int C, int H, int KV, int D, int P, int T, int N,
                       int splits, int window, float scale, float softcap,
                       int vec_ok, Append ap) {
  using L = PaSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int KW = kBK / KG;      // keys of a tile per warp
  constexpr int NT = KW / 8;        // key n-tiles of S
  constexpr int KC = DP / 16;       // head-dim chunks of QK^T
  constexpr int OT = DP / 8;        // head-dim n-tiles of O
  constexpr int S = L::stages;
  constexpr int NW = PaWarps<DP>::warps;
  constexpr int NTh = PaWarps<DP>::threads;
  // the key groups' states, [warp][OT * 4 + 4][lane] floats, reuse the
  // K/V ring after the walk
  constexpr int kStateWords = OT * 4 + 4;
  static_assert(NW * kStateWords * 32 * 4 <= 2 * S * L::tile,
                "key-group states fit the K/V ring");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int sp = blockIdx.x;
  const int kv = blockIdx.y % KV;
  const int row0 = (blockIdx.y / KV) * kRows;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = C * G;
  const int m_tiles = (min(kRows, R - row0) + 15) / 16;
  const int start = lengths[b];
  if constexpr (kFused) {
    if (sp == 0 && row0 == 0)
      append_rows<__nv_bfloat16, NTh>(ap, b, kv, C, KV, D, P, T, vec_ok);
  }
  const NewRows<__nv_bfloat16> nr(ap, b, C, KV, kv, D, start);

  int k_lo, k_hi, t_lo, t_hi;
  const int n_tiles = key_tiles(start, C, T, N, window, &k_lo, &k_hi);
  split_range(n_tiles, splits, sp, &t_lo, &t_hi);
  // splits [0, live) hold tiles; split 0 alone runs when none does
  const int live = live_splits(n_tiles, splits);
  if (sp >= max(live, 1)) return;
  const bool direct = live <= 1;    // one block: it writes the output

  // element offset of query row r (of the C*G rows of this KV head)
  auto row_id = [&](int r) -> long long {
    const int c = r / G;
    return ((long long)b * C + c) * H + kv * G + (r - c * G);
  };
  PageWalk pw;
  pw.row = page_table + (long long)b * N;
  pw.T = T;
  pw.P = P;
  pw.tok_stride = (long long)KV * D;
  pw.kv_off = (long long)kv * D;
  // The table entry of every key of tile t sits in page slot
  // (t - t_lo) % PS.  issue(t) copies tile t into K/V stage (t - t_lo) % S
  // through its slot and, in the same copy group, the entries of tile
  // t + S - 1 into theirs: the walk reads the page table S - 1 tiles ahead
  // and never waits on it.  One group per call, empty past t_hi, so the
  // group count stays uniform.
  constexpr int PS = L::page_slots;
  int* pg = reinterpret_cast<int*>(smem + L::pg_off);
  auto page_entry = [&](int kpos) -> const int* {
    return pw.row + kpos / T;
  };
  auto issue = [&](int t) {
    if (t < t_hi) {
      const int k0 = k_lo + t * kBK;
      const size_t at = (size_t)((t - t_lo) % S) * kBK * LD;
      if (vec_ok) {
        gather_kv<DP, LD, kFused>(Ks + at, Vs + at, pool_k, pool_v,
                                  pg + ((t - t_lo) % PS) * kBK, pw, nr, k0,
                                  k_hi, D);
        const int ka = k0 + (S - 1) * kBK + (int)threadIdx.x;
        if (threadIdx.x < kBK)
          cp_async4(pg + ((t + S - 1 - t_lo) % PS) * kBK + threadIdx.x,
                    ka < k_hi ? page_entry(ka) : pw.row, ka < k_hi);
      } else {
        auto key_row = [&](const __nv_bfloat16* pool,
                           const __nv_bfloat16* fresh,
                           int kpos) -> const __nv_bfloat16* {
          if (kpos >= k_hi) return nullptr;
          if (kFused && kpos >= start) return fresh + nr.off(kpos);
          return pool + pw.off(kpos);
        };
        load_rows<DP, LD, NTh>(Ks + at, pool_k, kBK, D, 0, [&](int j) {
          return key_row(pool_k, nr.k, k0 + j);
        });
        load_rows<DP, LD, NTh>(Vs + at, pool_v, kBK, D, 0, [&](int j) {
          return key_row(pool_v, nr.v, k0 + j);
        });
      }
    }
    cp_async_commit();
  };

  // Q in a copy group of its own; the entries of the first S - 1 tiles
  // read directly; then those tiles
  load_rows<DP, LD, NTh>(
      Qs, q, m_tiles * 16, D, vec_ok,
      [&](int j) -> const __nv_bfloat16* {
        return row0 + j < R ? q + row_id(row0 + j) * D : nullptr;
      });
  cp_async_commit();
  if (vec_ok) {
    for (int j = threadIdx.x; j < (S - 1) * kBK; j += NTh) {
      const int kpos = k_lo + t_lo * kBK + j;
      pg[j] = kpos < k_hi ? *page_entry(kpos) : 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(t_lo + i);

  // warp = (16-row tile mt, key group kg): the KG warps of a row tile
  // take one KW-key slice each of every tile
  const int mt = warp / KG;
  const int kg = warp % KG;
  const bool active = mt < m_tiles;
  const int mi = lane >> 3;         // the ldmatrix sub-matrix of this lane
  // Q's A fragments through ldmatrix: matrices (rows 0-7 | 8-15) x (dims
  // c | c + 8), read from shared memory on every tile (registers go to the
  // accumulators)
  const __nv_bfloat16* qrow =
      Qs + (mt * 16 + (lane & 7) + (mi & 1) * 8) * LD + (mi >> 1) * 8;
  const int r0 = row0 + mt * 16 + g;     // this thread's two query rows
  const int r1 = r0 + 8;
  const int qp0 = start + r0 / G;
  const int qp1 = start + r1 / G;
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
    o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait<S - 2>();         // tile t has landed ...
    __syncthreads();                // ... for every thread, and tile t - 1's
    issue(t + S - 1);               // stage is free for tile t + S - 1
    const int st = (t - t_lo) % S;
    if (active) {
      const __nv_bfloat16* Kt = Ks + ((size_t)st * kBK + kg * KW) * LD;
      const __nv_bfloat16* Vt = Vs + ((size_t)st * kBK + kg * KW) * LD;
      const int k0 = k_lo + t * kBK + kg * KW;   // this warp's slice

      // S = Q K^T: 16 rows x KW keys; K's B fragments through ldmatrix:
      // matrices (keys n | n + 8) x (dims c | c + 8)
      const __nv_bfloat16* krow =
          Kt + ((lane & 7) + (mi >> 1) * 8) * LD + (mi & 1) * 8;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, qrow + kc * 16);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, krow + nt * 8 * LD + kc * 16);
          mma16816(s[nt], a, kb[0], kb[1]);
          mma16816(s[nt + 1], a, kb[2], kb[3]);
        }
      }

      // scale, softcap, mask (only where the tile crosses a mask edge:
      // the visible range's end, the first row's causal edge, the last
      // row's window floor)
      const bool full = k0 + KW <= k_hi && k0 + KW - 1 <= start &&
                        (window < 0 || k0 > start + C - 1 - window);
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
            const int qpos = e < 2 ? qp0 : qp1;
            const bool ok = kpos < k_hi && kpos <= qpos &&
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
      float ps0 = 0.f, ps1 = 0.f;   // this thread's share of the row sums
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ((valid >> (nt * 4 + e)) & 1u)
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
      for (int kc = 0; kc < KW / 16; ++kc) {
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
    }
  }
  cp_async_wait<0>();               // an empty walk left copies pending

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  bool writer = active;             // holds its rows' final state
  const bool even = D % 2 == 0;     // column pairs are aligned in memory
  if constexpr (KG > 1) {
    // key group 0 of each row tile folds in groups 1 .. KG-1, in order;
    // every thread holds the same fragment positions in every warp
    float* cw = reinterpret_cast<float*>(smem);
    __syncthreads();                // the walk is over in every warp
    if (active && kg > 0) {
      float* w = cw + (size_t)warp * kStateWords * 32 + lane;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(ot * 4 + e) * 32] = o[ot][e];
      w[(OT * 4) * 32] = m0;
      w[(OT * 4 + 1) * 32] = m1;
      w[(OT * 4 + 2) * 32] = l0;
      w[(OT * 4 + 3) * 32] = l1;
    }
    __syncthreads();
    writer = active && kg == 0;
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      if (!writer) break;
      const float* w = cw + (size_t)(warp + k) * kStateWords * 32 + lane;
      const float mk0 = w[(OT * 4) * 32], mk1 = w[(OT * 4 + 1) * 32];
      const float mn0 = fmaxf(m0, mk0), mn1 = fmaxf(m1, mk1);
      const float a0 = exp2f((m0 - mn0) * kLog2e);
      const float a1 = exp2f((m1 - mn1) * kLog2e);
      const float b0 = exp2f((mk0 - mn0) * kLog2e);
      const float b1 = exp2f((mk1 - mn1) * kLog2e);
      l0 = l0 * a0 + w[(OT * 4 + 2) * 32] * b0;
      l1 = l1 * a1 + w[(OT * 4 + 3) * 32] * b1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        o[ot][0] = o[ot][0] * a0 + w[(ot * 4) * 32] * b0;
        o[ot][1] = o[ot][1] * a0 + w[(ot * 4 + 1) * 32] * b0;
        o[ot][2] = o[ot][2] * a1 + w[(ot * 4 + 2) * 32] * b1;
        o[ot][3] = o[ot][3] * a1 + w[(ot * 4 + 3) * 32] * b1;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (!writer || r >= R) continue;
    const long long rid = row_id(r);
    const float l = half ? l1 : l0;
    if (direct) {
      const float inv = 1.f / fmaxf(l, 1e-20f);
      __nv_bfloat16* orow = out + rid * D;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const int c = ot * 8 + tq * 2;
        const float x = o[ot][2 * half] * inv, y = o[ot][2 * half + 1] * inv;
        if (c + 1 < D && even) {          // both columns, one 4-byte store
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x, y);
        } else {
          if (c < D) orow[c] = __float2bfloat16(x);
          if (c + 1 < D) orow[c + 1] = __float2bfloat16(y);
        }
      }
    } else {
      // this split's state: m, l and the unnormalised accumulator
      const long long slot = rid * splits + sp;
      float* arow = ws_acc + slot * D;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const int c = ot * 8 + tq * 2;
        if (c + 1 < D && even) {
          *reinterpret_cast<float2*>(arow + c) =
              make_float2(o[ot][2 * half], o[ot][2 * half + 1]);
        } else {
          if (c < D) arow[c] = o[ot][2 * half];
          if (c + 1 < D) arow[c + 1] = o[ot][2 * half + 1];
        }
      }
      if (tq == 0) {
        ws_ml[slot * 2] = half ? m1 : m0;
        ws_ml[slot * 2 + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at the latent head dim: D in (256, 576], D % 8 == 0 (see the header)
// ---------------------------------------------------------------------------

constexpr int kLatDP = 576;                  // Q.K^T depth: the head dim, padded
constexpr int kLatDV = 192;                  // output columns of one block
constexpr int kLatSlices = kLatDP / kLatDV;  // column slices of a row group
constexpr int kLatRows = 64;                 // query rows of one block
constexpr int kLatWarps = 8;
constexpr int kLatThreads = kLatWarps * 32;

// Dynamic shared memory of one latent block: `stages` full-width K tiles of
// 64 keys, the V slice's tiles when V is a pool of its own (kAlias: V's
// fragments come from the K tile), and the block's 64 query rows.  K and Q
// rows are kLatDP + 8 bf16 long, V slice rows kLatDV + 8: ldmatrix rows
// fall on distinct banks and every row starts on 16 bytes.
template <bool kAlias>
struct LatSmem {
  static constexpr int stages = kAlias ? 2 : 1;
  static constexpr int LD = kLatDP + 8;
  static constexpr int LDV = kAlias ? LD : kLatDV + 8;
  static constexpr size_t k_tile = (size_t)kBK * LD * 2;
  static constexpr size_t v_tile = kAlias ? 0 : (size_t)kBK * LDV * 2;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = stages * k_tile;
  static constexpr size_t q_off = v_off + stages * v_tile;
  static constexpr size_t bytes = q_off + (size_t)kLatRows * LD * 2;
};

template <bool kAlias, int KG>
__global__ void __launch_bounds__(kLatThreads, 1)
paged_latent_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int C, int H, int KV, int D, int P, int T, int N,
                    int splits, int window, float scale, float softcap) {
  using L = LatSmem<kAlias>;
  constexpr int LD = L::LD;
  constexpr int LDV = L::LDV;
  constexpr int S = L::stages;
  constexpr int KW = kBK / KG;      // keys of a tile per warp
  constexpr int NT = KW / 8;        // key n-tiles of S
  constexpr int KC = kLatDP / 16;   // head-dim chunks of QK^T
  constexpr int OT = kLatDV / 8;    // output-column n-tiles of O
  // the key groups' states, [warp][OT * 4 + 4][lane] floats, reuse the
  // whole block's shared memory after the walk
  constexpr int kStateWords = OT * 4 + 4;
  static_assert(kLatWarps * kStateWords * 32 * 4 <= L::bytes,
                "key-group states fit the shared memory");
  static_assert(KW % 16 == 0, "16 keys a warp at least");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int sp = blockIdx.x;
  const int cs = blockIdx.y % kLatSlices;       // column slice
  const int kv = (blockIdx.y / kLatSlices) % KV;
  const int row0 = blockIdx.y / (kLatSlices * KV) * kLatRows;
  const int c0 = cs * kLatDV;                   // its first column
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = C * G;
  const int m_tiles = (min(kLatRows, R - row0) + 15) / 16;
  const int start = lengths[b];

  int k_lo, k_hi, t_lo, t_hi;
  const int n_tiles = key_tiles(start, C, T, N, window, &k_lo, &k_hi);
  split_range(n_tiles, splits, sp, &t_lo, &t_hi);
  // splits [0, live) hold tiles; split 0 alone runs when none does
  const int live = live_splits(n_tiles, splits);
  if (sp >= max(live, 1)) return;
  const bool direct = live <= 1;    // one block a slice: it writes the output

  // element offset of query row r (of the C*G rows of this KV head)
  auto row_id = [&](int r) -> long long {
    const int c = r / G;
    return ((long long)b * C + c) * H + kv * G + (r - c * G);
  };
  PageWalk pw;
  pw.row = page_table + (long long)b * N;
  pw.T = T;
  pw.P = P;
  pw.tok_stride = (long long)KV * D;
  pw.kv_off = (long long)kv * D;

  // tile t into stage (t - t_lo) % S, 16 bytes a thread: every key's full
  // row of K, and the slice's columns of V when V is a pool of its own;
  // keys >= k_hi and columns >= D are zero-filled.  One copy group a call,
  // empty past t_hi.
  auto issue = [&](int t) {
    if (t < t_hi) {
      const int k0 = k_lo + t * kBK;
      const int st = (t - t_lo) % S;
      __nv_bfloat16* kd = Ks + (size_t)st * kBK * LD;
      constexpr int vpr = kLatDP / 8;
      for (int idx = threadIdx.x; idx < kBK * vpr; idx += kLatThreads) {
        const int row = idx / vpr;
        const int c = (idx - row * vpr) * 8;
        const bool ok = k0 + row < k_hi && c < D;
        cp_async16(kd + row * LD + c, ok ? pool_k + pw.off(k0 + row) + c
                                         : pool_k, ok);
      }
      if constexpr (!kAlias) {
        __nv_bfloat16* vd = Vs + (size_t)st * kBK * LDV;
        constexpr int vv = kLatDV / 8;
        for (int idx = threadIdx.x; idx < kBK * vv; idx += kLatThreads) {
          const int row = idx / vv;
          const int c = (idx - row * vv) * 8;
          const bool ok = k0 + row < k_hi && c0 + c < D;
          cp_async16(vd + row * LDV + c,
                     ok ? pool_v + pw.off(k0 + row) + c0 + c : pool_v, ok);
        }
      }
    }
    cp_async_commit();
  };

  // Q in a copy group of its own, then (two stages) the first tile
  load_rows<kLatDP, LD, kLatThreads>(
      Qs, q, m_tiles * 16, D, 1,
      [&](int j) -> const __nv_bfloat16* {
        return row0 + j < R ? q + row_id(row0 + j) * D : nullptr;
      });
  cp_async_commit();
  if constexpr (S == 2) issue(t_lo);

  // warp = (16-row tile mt, key group kg)
  const int mt = warp / KG;
  const int kg = warp % KG;
  const bool active = mt < m_tiles;
  const int mi = lane >> 3;         // the ldmatrix sub-matrix of this lane
  const __nv_bfloat16* qrow =
      Qs + (mt * 16 + (lane & 7) + (mi & 1) * 8) * LD + (mi >> 1) * 8;
  const int r0 = row0 + mt * 16 + g;     // this thread's two query rows
  const int r1 = r0 + 8;
  const int qp0 = start + r0 / G;
  const int qp1 = start + r1 / G;
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
    o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    if constexpr (S == 1) {
      __syncthreads();              // the one stage is free again ...
      issue(t);                     // ... for tile t
    }
    cp_async_wait<0>();             // tile t has landed ...
    __syncthreads();                // ... for every thread; with two stages,
    if constexpr (S == 2) issue(t + 1);   // tile t - 1's is free for t + 1
    const int st = (t - t_lo) % S;
    if (active) {
      const __nv_bfloat16* Kt = Ks + ((size_t)st * kBK + kg * KW) * LD;
      const __nv_bfloat16* Vt =
          kAlias ? Kt + c0 : Vs + ((size_t)st * kBK + kg * KW) * LDV;
      const int k0 = k_lo + t * kBK + kg * KW;   // this warp's slice

      // S = Q K^T over all kLatDP dims: 16 rows x KW keys
      const __nv_bfloat16* krow =
          Kt + ((lane & 7) + (mi >> 1) * 8) * LD + (mi & 1) * 8;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, qrow + kc * 16);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, krow + nt * 8 * LD + kc * 16);
          mma16816(s[nt], a, kb[0], kb[1]);
          mma16816(s[nt + 1], a, kb[2], kb[3]);
        }
      }

      // scale, softcap, mask (only where the tile crosses a mask edge)
      const bool full = k0 + KW <= k_hi && k0 + KW - 1 <= start &&
                        (window < 0 || k0 > start + C - 1 - window);
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
            const int qpos = e < 2 ? qp0 : qp1;
            const bool ok = kpos < k_hi && kpos <= qpos &&
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
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ((valid >> (nt * 4 + e)) & 1u)
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

      // O += P V over the slice's columns, 16 keys at a time
      const __nv_bfloat16* vrow =
          Vt + ((lane & 7) + (mi & 1) * 8) * LDV + (mi >> 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KW / 16; ++kc) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int ot = 0; ot < OT; ot += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + kc * 16 * LDV + ot * 8);
          mma16816(o[ot], a, bv[0], bv[1]);
          mma16816(o[ot + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();               // an empty walk left copies pending

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // key group 0 of each row tile folds in groups 1 .. KG-1, in order
  float* cw = reinterpret_cast<float*>(smem);
  __syncthreads();                  // the walk is over in every warp
  if (active && kg > 0) {
    float* w = cw + (size_t)warp * kStateWords * 32 + lane;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[(ot * 4 + e) * 32] = o[ot][e];
    w[(OT * 4) * 32] = m0;
    w[(OT * 4 + 1) * 32] = m1;
    w[(OT * 4 + 2) * 32] = l0;
    w[(OT * 4 + 3) * 32] = l1;
  }
  __syncthreads();
  const bool writer = active && kg == 0;
  if (writer) {
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float* w = cw + (size_t)(warp + k) * kStateWords * 32 + lane;
      const float mk0 = w[(OT * 4) * 32], mk1 = w[(OT * 4 + 1) * 32];
      const float mn0 = fmaxf(m0, mk0), mn1 = fmaxf(m1, mk1);
      const float a0 = exp2f((m0 - mn0) * kLog2e);
      const float a1 = exp2f((m1 - mn1) * kLog2e);
      const float b0 = exp2f((mk0 - mn0) * kLog2e);
      const float b1 = exp2f((mk1 - mn1) * kLog2e);
      l0 = l0 * a0 + w[(OT * 4 + 2) * 32] * b0;
      l1 = l1 * a1 + w[(OT * 4 + 3) * 32] * b1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        o[ot][0] = o[ot][0] * a0 + w[(ot * 4) * 32] * b0;
        o[ot][1] = o[ot][1] * a0 + w[(ot * 4 + 1) * 32] * b0;
        o[ot][2] = o[ot][2] * a1 + w[(ot * 4 + 2) * 32] * b1;
        o[ot][3] = o[ot][3] * a1 + w[(ot * 4 + 3) * 32] * b1;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (!writer || r >= R) continue;
    const long long rid = row_id(r);
    const float l = half ? l1 : l0;
    if (direct) {
      const float inv = 1.f / fmaxf(l, 1e-20f);
      __nv_bfloat16* orow = out + rid * D;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const int c = c0 + ot * 8 + tq * 2;   // D is even: pairs fit
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(o[ot][2 * half] * inv, o[ot][2 * half + 1] * inv);
      }
    } else {
      // this split's state: m, l (slice 0) and its columns of the
      // unnormalised accumulator
      const long long slot = rid * splits + sp;
      float* arow = ws_acc + slot * D;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const int c = c0 + ot * 8 + tq * 2;
        if (c < D)
          *reinterpret_cast<float2*>(arow + c) =
              make_float2(o[ot][2 * half], o[ot][2 * half + 1]);
      }
      if (cs == 0 && tq == 0) {
        ws_ml[slot * 2] = half ? m1 : m0;
        ws_ml[slot * 2 + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: exact scalar path
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;            // query rows per block, one warp each

// keys per shared-memory tile: 16, or 8 above D = 256 (two tiles of 16 keys
// of 576 floats would take 72 KB, over the 48 KB of static shared memory)
template <int NI>
struct F32Tile {
  static constexpr int keys = NI <= 8 ? 16 : 8;
};

template <int NI, bool kFused>
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ pool_k,
                           const float* __restrict__ pool_v,
                           const int* __restrict__ page_table,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           float* __restrict__ ws_acc,
                           float* __restrict__ ws_ml, int C, int H, int KV,
                           int D, int P, int T, int N, int splits, int window,
                           float scale, float softcap, int vec, Append ap) {
  constexpr int kKT = F32Tile<NI>::keys;
  __shared__ float ks[kKT * NI * 32];
  __shared__ float vs[kKT * NI * 32];

  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z - b * splits;
  const int kv = blockIdx.y;
  const int G = H / KV;
  const int rows = C * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kF32Warps + warp;
  const bool active = row < rows;
  const int c = active ? row / G : 0;
  const int h = kv * G + (active ? row % G : 0);
  const int start = lengths[b];
  const int qpos = start + c;
  if constexpr (kFused) {
    if (sp == 0 && blockIdx.x == 0)
      append_rows<float, kThreads>(ap, b, kv, C, KV, D, P, T, vec);
  }

  int k_lo, k_hi, t_lo, t_hi;
  const int n_tiles = key_tiles(start, C, T, N, window, &k_lo, &k_hi);
  split_range(n_tiles, splits, sp, &t_lo, &t_hi);
  // splits [0, live) hold tiles; split 0 alone runs when none does
  const int live = live_splits(n_tiles, splits);
  if (sp >= max(live, 1)) return;
  const bool direct = live <= 1;    // one block: it writes the output
  const int key_lo = k_lo + t_lo * kBK;
  const int key_hi = min(k_hi, k_lo + t_hi * kBK);

  float qr[NI], acc[NI];
  const long long row_id = ((long long)b * C + c) * H + h;
  const long long q_off = row_id * D;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    qr[i] = (active && d < D) ? q[q_off + d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  PageWalk pw;
  pw.row = page_table + (long long)b * N;
  pw.T = T;
  pw.P = P;
  pw.tok_stride = (long long)KV * D;
  pw.kv_off = (long long)kv * D;

  for (int k0 = key_lo; k0 < key_hi; k0 += kKT) {
    const int kt = min(kKT, key_hi - k0);
    // kFused: keys from start on (the tile's last kt - kp) are new rows
    const int kp = kFused ? max(0, min(kt, start - k0)) : kt;
    __syncthreads();   // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < kp * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const long long off = pw.off(k0 + j) + d;
      ks[j * D + d] = pool_k[off];
      vs[j * D + d] = pool_v[off];
    }
    if constexpr (kFused) {
      const NewRows<float> nr(ap, b, C, KV, kv, D, start);
      for (int idx = kp * D + threadIdx.x; idx < kt * D; idx += kThreads) {
        const int j = idx / D;
        const int d = idx - j * D;
        const long long off = nr.off(k0 + j) + d;
        ks[j * D + d] = nr.k[off];
        vs[j * D + d] = nr.v[off];
      }
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
      const bool ok = j < kt && kpos <= qpos &&
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

  if (direct) {
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (active && d < D) out[q_off + d] = acc[i] / denom;
    }
    return;
  }
  if (active) {
    const long long slot = row_id * splits + sp;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ws_acc[slot * D + d] = acc[i];
    }
    if (lane == 0) {
      ws_ml[slot * 2] = m;
      ws_ml[slot * 2 + 1] = l;
    }
  }
}

// One warp per output row of a sequence with more than one live split:
// those splits' states, in split order: out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-20).  (A sequence with at most one live
// split had its rows written by split 0.)  The loops over splits run to
// kMaxSplits with a predicate, so a lane's loads are in flight together.
template <typename E>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml,
                             const int* __restrict__ lengths,
                             E* __restrict__ out, long long n_rows, int C,
                             int H, int D, int T, int N, int splits,
                             int window) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  int k_lo, k_hi;
  const int live = live_splits(
      key_tiles(lengths[row / ((long long)C * H)], C, T, N, window, &k_lo,
                &k_hi),
      splits);
  if (live <= 1) return;
  const float* ml = ws_ml + row * splits * 2;
  float m[kMaxSplits], w[kMaxSplits];
  float M = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    m[s] = s < live ? ml[2 * s] : kNegInf;
    w[s] = s < live ? ml[2 * s + 1] : 0.f;     // l_s for now
    M = fmaxf(M, m[s]);
  }
  float L = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    const float e = s < live ? expf(m[s] - M) : 0.f;
    L += w[s] * e;
    w[s] = e;
  }
  const float inv = 1.f / fmaxf(L, 1e-20f);
  const float* acc = ws_acc + row * splits * D;
  E* o = out + row * D;
  if (D % 4 == 0) {                 // 16-byte rows: four columns a lane
    for (int d = lane * 4; d < D; d += 128) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < live) {
          const float4 x =
              *reinterpret_cast<const float4*>(acc + (long long)s * D + d);
          a.x += x.x * w[s];
          a.y += x.y * w[s];
          a.z += x.z * w[s];
          a.w += x.w * w[s];
        }
      }
      store(&o[d], a.x * inv);
      store(&o[d + 1], a.y * inv);
      store(&o[d + 2], a.z * inv);
      store(&o[d + 3], a.w * inv);
    }
    return;
  }
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < live) a += acc[(long long)s * D + d] * w[s];
    store(&o[d], a * inv);
  }
}

template <typename E>
int merge(const void* ws_acc, const void* ws_ml, const void* lengths,
          void* out, int B, int C, int H, int D, int T, int N, int splits,
          int window, cudaStream_t stream) {
  const long long n_rows = (long long)B * C * H;
  paged_attention_merge_kernel<E>
      <<<(unsigned)((n_rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
          static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
          static_cast<const int*>(lengths), static_cast<E*>(out), n_rows, C,
          H, D, T, N, splits, window);
  return (int)cudaGetLastError();
}

// 16-byte copies need D * sizeof(element) % 16 == 0 and every float
// operand (q, the pools and the fused append's new rows) on 16 bytes
inline int vec_copies(int D, int esz, const void* q, const void* pool_k,
                  const void* pool_v, const Append& ap) {
  return (D * esz) % 16 == 0 &&
         ((uintptr_t)q | (uintptr_t)pool_k | (uintptr_t)pool_v |
          (uintptr_t)ap.k_new | (uintptr_t)ap.v_new) % 16 == 0;
}

template <int DP, int KG, bool kFused>
int launch_bf16(const void* q, const void* pool_k, const void* pool_v,
                const void* page_table, const void* lengths, void* out,
                void* ws_acc, void* ws_ml, int B, int C, int H, int KV,
                int D, int P, int T, int N, int splits, int window,
                float scale, float softcap, cudaStream_t stream,
                const Append& ap) {
  const size_t smem = PaSmem<DP>::bytes;
  constexpr int NTh = PaWarps<DP>::threads;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<DP, KG, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_groups = (C * (H / KV) + kRows - 1) / kRows;
  dim3 grid(splits, KV * row_groups, B);
  paged_attention_kernel<DP, KG, kFused><<<grid, NTh, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), C, H, KV, D, P, T, N, splits, window,
      scale, softcap, vec_copies(D, 2, q, pool_k, pool_v, ap), ap);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return merge<__nv_bfloat16>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N,
                              splits, window, stream);
}

#define REPRO_PARAMS                                                        \
  const void *q, const void *pool_k, const void *pool_v,                    \
      const void *page_table, const void *lengths, void *out, void *ws_acc, \
      void *ws_ml, int B, int C, int H, int KV, int D, int P, int T, int N, \
      int splits, int window, float scale, float softcap, cudaStream_t s,  \
      const Append &ap
#define REPRO_ARGS q, pool_k, pool_v, page_table, lengths, out, ws_acc, \
                   ws_ml, B, C, H, KV, D, P, T, N, splits, window,      \
                   scale, softcap, s, ap

// Key groups per 16-row tile: as many as the block's warps allow, at most
// four (16 keys a warp of each 64-key tile)
template <int DP, bool kFused>
int dispatch_kg(REPRO_PARAMS) {
  const int m_tiles = (min(kRows, C * (H / KV)) + 15) / 16;
  const int per_tile = PaWarps<DP>::warps / m_tiles;
  if (per_tile >= 4) return launch_bf16<DP, 4, kFused>(REPRO_ARGS);
  if constexpr (PaWarps<DP>::warps == 16) {   // at most 8 row tiles
    return launch_bf16<DP, 2, kFused>(REPRO_ARGS);
  } else {
    if (per_tile >= 2) return launch_bf16<DP, 2, kFused>(REPRO_ARGS);
    return launch_bf16<DP, 1, kFused>(REPRO_ARGS);
  }
}

template <bool kAlias, int KG>
int launch_latent(const void* q, const void* pool_k, const void* pool_v,
                  const void* page_table, const void* lengths, void* out,
                  void* ws_acc, void* ws_ml, int B, int C, int H, int KV,
                  int D, int P, int T, int N, int splits, int window,
                  float scale, float softcap, cudaStream_t stream) {
  const size_t smem = LatSmem<kAlias>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_latent_kernel<kAlias, KG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_groups = (C * (H / KV) + kLatRows - 1) / kLatRows;
  dim3 grid(splits, row_groups * KV * kLatSlices, B);
  paged_latent_kernel<kAlias, KG><<<grid, kLatThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), C, H, KV, D, P, T, N, splits, window,
      scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return merge<__nv_bfloat16>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N,
                              splits, window, stream);
}

// The latent kernel: one pool or two, and key groups per 16-row tile as
// the 8 warps allow (4 for one or two row tiles, 2 for three or four)
int dispatch_latent(const void* q, const void* pool_k, const void* pool_v,
                    const void* page_table, const void* lengths, void* out,
                    void* ws_acc, void* ws_ml, int B, int C, int H, int KV,
                    int D, int P, int T, int N, int splits, int window,
                    float scale, float softcap, cudaStream_t s) {
  const int m_tiles = (min(kLatRows, C * (H / KV)) + 15) / 16;
  const bool alias = pool_k == pool_v;
#define REPRO_LAT_ARGS q, pool_k, pool_v, page_table, lengths, out, ws_acc, \
                       ws_ml, B, C, H, KV, D, P, T, N, splits, window,      \
                       scale, softcap, s
  if (m_tiles <= 2)
    return alias ? launch_latent<true, 4>(REPRO_LAT_ARGS)
                 : launch_latent<false, 4>(REPRO_LAT_ARGS);
  return alias ? launch_latent<true, 2>(REPRO_LAT_ARGS)
               : launch_latent<false, 2>(REPRO_LAT_ARGS);
#undef REPRO_LAT_ARGS
}

template <int NI, bool kFused>
int launch_f32(REPRO_PARAMS) {
  const int rows = C * (H / KV);
  dim3 grid((rows + kF32Warps - 1) / kF32Warps, KV, B * splits);
  paged_attention_f32_kernel<NI, kFused><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool_k),
      static_cast<const float*>(pool_v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), C, H, KV, D,
      P, T, N, splits, window, scale, softcap,
      vec_copies(D, 4, q, pool_k, pool_v, ap), ap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return merge<float>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N, splits,
                      window, s);
}

template <bool kFused>
int run(REPRO_PARAMS, int is_bf16) {
  // D <= 256 everywhere; up to 576 for the plain entry point (the latent
  // kernel in bf16, where D % 8 == 0 and 16-byte operands are needed too)
  const int max_d = kFused ? 256 : kLatDP;
  if (B <= 0 || C <= 0 || D <= 0 || D > max_d || KV <= 0 || H % KV != 0 ||
      splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D <= 64) return dispatch_kg<64, kFused>(REPRO_ARGS);
    if (D <= 128) return dispatch_kg<128, kFused>(REPRO_ARGS);
    if (D <= 256) return dispatch_kg<256, kFused>(REPRO_ARGS);
    if constexpr (!kFused) {
      if (!vec_copies(D, 2, q, pool_k, pool_v, ap))
        return (int)cudaErrorInvalidValue;
      return dispatch_latent(q, pool_k, pool_v, page_table, lengths, out,
                             ws_acc, ws_ml, B, C, H, KV, D, P, T, N, splits,
                             window, scale, softcap, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (D <= 32) return launch_f32<1, kFused>(REPRO_ARGS);
  if (D <= 64) return launch_f32<2, kFused>(REPRO_ARGS);
  if (D <= 128) return launch_f32<4, kFused>(REPRO_ARGS);
  if (D <= 256) return launch_f32<8, kFused>(REPRO_ARGS);
  if constexpr (!kFused) return launch_f32<18, kFused>(REPRO_ARGS);
  return (int)cudaErrorInvalidValue;
}
#undef REPRO_ARGS
#undef REPRO_PARAMS

}  // namespace

// q, out: [B, C, H, D]; pool_k, pool_v: [P, T, KV, D]; page_table: [B, N]
// int32; lengths: [B] int32 (PRE-chunk length).  1 <= splits <= 16 context
// splits per sequence (ops.py plan_splits); with splits > 1, ws_acc holds
// B*C*H*splits*D and ws_ml B*C*H*splits*2 floats of scratch.  window < 0
// means none, softcap <= 0 means none; is_bf16 selects bfloat16 (else
// float32) for q, pools and out.  D <= 576 (bf16 above 256: D % 8 == 0,
// 16-byte operands; pool_k == pool_v reads each latent tile once) and
// H % KV == 0 are checked by the caller.  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
extern "C" int repro_paged_attention_chunk(
    const void* q, const void* pool_k, const void* pool_v,
    const void* page_table, const void* lengths, void* out, void* ws_acc,
    void* ws_ml, int B, int C, int H, int KV, int D, int P, int T, int N,
    int splits, int window, float scale, float softcap, int is_bf16,
    void* stream) {
  return run<false>(q, pool_k, pool_v, page_table, lengths, out, ws_acc,
                    ws_ml, B, C, H, KV, D, P, T, N, splits, window, scale,
                    softcap, static_cast<cudaStream_t>(stream),
                    Append{nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr},
                    is_bf16);
}

// repro_paged_attention_chunk with the chunk's append fused in: k_new,
// v_new [B, C, KV, D] (the pools' dtype) land at pool[page_ids[b, c],
// slot_ids[b, c]] (page_ids, slot_ids: [B, C] int32), in place, and the
// chunk's keys are read from them.  The output and every pool byte off
// the null page 0 are those of repro_kv_append_chunk on K and on V, then
// repro_paged_attention_chunk.  D <= 256.
extern "C" int repro_paged_attention_append_chunk(
    const void* q, const void* k_new, const void* v_new, void* pool_k,
    void* pool_v, const void* page_table, const void* lengths,
    const void* page_ids, const void* slot_ids, void* out, void* ws_acc,
    void* ws_ml, int B, int C, int H, int KV, int D, int P, int T, int N,
    int splits, int window, float scale, float softcap, int is_bf16,
    void* stream) {
  return run<true>(q, pool_k, pool_v, page_table, lengths, out, ws_acc,
                   ws_ml, B, C, H, KV, D, P, T, N, splits, window, scale,
                   softcap, static_cast<cudaStream_t>(stream),
                   Append{k_new, v_new, static_cast<const int*>(page_ids),
                          static_cast<const int*>(slot_ids), pool_k, pool_v},
                   is_bf16);
}
