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
//    kernel merges them, one warp per row and 128 columns, in split order,
//    reading only the live splits.  (Merging in the last block of a sequence to finish,
//    elected with an arrival counter, was slower at C = 16 on the H100:
//    one block then reads every split's state of 96 rows.)
//  * no atomics: the result does not depend on block scheduling, and two
//    calls on the same inputs are bitwise equal.
// float32 (the card tests', the comparison lanes' and the float32 serving
// lanes' dtype; paged_attention_f32_kernel below, D <= 576) on the same
// split plan, key walk and merge.
// What bounds it on this card: bytes at qwen2's shapes (K and V in
// float32 are twice bf16's), and at MLA's latent C = 16 (256 rows over one
// KV head of 576) the operations, which run at 3xTF32's third of the TF32
// rate (165 TFLOP/s).
// What the design does about it:
//  * one block per (split, row group, KV head, sequence) owns up to 128
//    query rows of its KV head (32 above D = 256), so each K/V tile is
//    read from device memory once per split and row group, and no row of
//    a group re-reads it;
//  * S = Q.K^T and O += P.V run on the tensor cores in 3xTF32 (mma.sync
//    m16n8k8, each float32 operand split into two TF32 parts, three
//    products: float32-exact; mma_tf32.cuh, shared with the flash and
//    ssd_chunk kernels).  The head dim is zero-padded to 32, 64, 128, 256
//    or 576 columns, so any D from 1 to 576 takes the same products;
//  * 8 warps.  Up to D = 256 a warp owns a 16-row tile, every key of a
//    tile's scores and every output column (64 or 128 floats of O).  Above
//    it O would need 288 registers a thread, so the output columns are
//    cut into four slices of 144 and the four warps of a row tile each
//    compute the scores of 8 of a tile's 32 keys (in four independent
//    chains of products over the head dim) and agree on each row's maximum
//    and sum through shared memory; P goes through shared memory at every
//    D, and each warp adds P.V to its own columns: the scores are computed
//    once, never once per slice;
//  * tiles of 32 keys (16 at D = 256) gathered through the page table by
//    cp.async into two stages, the next tile's entries in the copy group
//    of this one.  Above D = 256 one 32-key tile is 74 KB, so the two
//    stages hold K = V of one pool passed twice (MLA), copied once, or K
//    and V of one stage for separate pools (which need not be fast).
//
// The latent head dim (MLA's serve step, deepseek-v2: one KV head whose
// D = kv_lora_rank + qk_rope_dim = 576 rows serve as both K and V, 16
// query heads; bf16, D in (256, 576] with D % 8 == 0; paged_latent_kernel
// below).  The layout above cannot hold it: a 128-row block's float32
// accumulator alone would be 288 KB, over an SM's 256 KB of registers, and
// one 64-key tile of K is 72 KB of shared memory.
// What bounds it on this card: bytes.  A call reads each visible latent
// row (1152 B) once, q, and writes out: at the serving shapes (8
// sequences, C = 16 or 1) a few MB, against ~4.7 MFLOP of products a row
// group and 64-key tile, far below the tensor cores' rate.  So the kernel
// must read each row once, keep the SMs busy, and spend as few products
// as it can.
// What the design does about it (FlashMLA's structure, on wgmma):
//  * one block per (split, row group of 64 query rows, KV head, sequence)
//    owns ALL 576 output columns, so each latent tile is read once per
//    split and row group and its scores are computed once;
//  * four warpgroups, specialised.  Warpgroup 0 runs S = Q.K^T as 36
//    wgmma m64n64k16 steps (Q and the tile in shared memory, 128-byte
//    swizzle, wgmma_bf16.cuh's descriptors), the online softmax on its
//    registers, and writes P (bf16) and each row's rescale to shared
//    memory.  Warpgroups 1-3 each own 192 columns of O (96 floats a
//    thread, setmaxnreg giving them the score warpgroup's spare
//    registers), rescale them and add P.V as four wgmma m64n192k16 steps,
//    V being the same tile read transposed through its descriptor;
//  * warpgroups 1-3 are also the loaders: each copies, by cp.async and
//    swizzled on the way, the three 64-column slabs of every tile that its
//    own P.V reads, so it refills them (two tiles ahead, two stages) as
//    soon as its P.V is done, and the copies never hold up the scores;
//    the page-table entries of a tile ride in the copy group of the tile
//    two before it.  Named barriers hand a tile, P and its release between
//    the roles, so warpgroup 0 computes the scores of tile t + 1 while P.V
//    of tile t runs.  Q (72 KB), two 72 KB stages and P take 226 KB.
//    Separate pools (kept working, not fast) take one stage of K and one
//    of V;
//  * a decode step's 16 rows fill a quarter of the 64-row wgmma: the rows
//    past the chunk are zero and their products wasted, since the bound
//    is bytes and one code path serves both shapes;
//  * the wrapper's split plan fills the SMs with these blocks (ops.py
//    plan_splits); masks and merge are the bf16 kernel's (the merge takes
//    a wide row's columns 128 to a warp).
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
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 64;                 // keys per tile: the unit of a split
constexpr int kWarps = 8;               // merge blocks
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 128;              // query rows per bf16 block
constexpr int kMaxSplits = 16;          // context splits a call may take

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

constexpr int kLatDP = 576;                  // the head dim, padded
constexpr int kLatRows = 64;                 // query rows: one wgmma's
constexpr int kLatPV = 3;                    // P.V warpgroups of 192 columns
constexpr int kLatDV = kLatDP / kLatPV;
constexpr int kLatThreads = (1 + kLatPV) * 128;
constexpr int kLatChunks = kLatDP / 8;       // 16-byte chunks of a row
constexpr int kLatOwn = kLatChunks / kLatPV; // of them, one P.V warpgroup's
// registers a thread: the score warpgroup and the P.V warpgroups
// (128 x 96 + 384 x 136 <= 65536)
constexpr int kLatSRegs = 96;
constexpr int kLatPVRegs = 136;
// named barriers (0 is __syncthreads'), each over the whole block but 4
constexpr int kBarFull = 1;    // tile t is in (P.V warpgroups arrive)
constexpr int kBarReady = 2;   // P(t) and its rescales are in (warpgroup 0)
constexpr int kBarFree = 3;    // P.V of tile t is done (P.V warpgroups)
constexpr int kBarQ = 4;       // Q is in, among warpgroup 0's 128 threads
constexpr int kBarPages = 5;   // the first entries, among the 384 P.V threads

// Shared memory of one latent block, from a 1024-byte-aligned base: Q (64
// rows), two 64-key tiles (two stages of K = V when one pool is passed
// twice; K and V of one stage otherwise), P (64 x 64 bf16), each row's
// rescale for the tile, the final (m, l) of each row, and a ring of three
// tiles' page-table entries.  Q, K, V and P are slabs of 64 rows x 64 bf16
// (128 bytes a row) in the 128-byte swizzle that wgmma's descriptors read:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
struct LatSmem {
  static constexpr uint32_t slab = 64 * 128;
  static constexpr uint32_t tile = (kLatDP / 64) * slab;   // 72 KB
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t buf_off = tile;
  static constexpr uint32_t p_off = 3 * tile;
  static constexpr uint32_t alpha_off = p_off + slab;
  static constexpr uint32_t ml_off = alpha_off + kLatRows * 4;
  static constexpr uint32_t pg_off = ml_off + kLatRows * 8;
  static constexpr size_t bytes = pg_off + 3 * kBK * 4 + 1024;
};
static_assert(kBK == kLatRows, "a key tile and a row group are both one slab");
static_assert(LatSmem::bytes <= 232448, "fits an SM's shared memory");

// byte offset of 16-byte chunk c (of 72) of row r in a swizzled 64-row tile
__device__ __forceinline__ uint32_t lat_chunk(int r, int c) {
  return (c >> 3) * LatSmem::slab + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// One block per (context split, row group of 64 query rows, KV head,
// sequence) owns every output column of its rows; four warpgroups.
// Warpgroup 0 computes S = Q.K^T of each 64-key tile once (wgmma
// m64n64k16 over the head dim, Q and K from shared memory), runs the
// online softmax on it and writes P (bf16) and each row's rescale to
// shared memory; warpgroups 1-3 copy the tiles in and each adds P.V to
// its 192 columns (wgmma m64n192k16, P and V from shared memory, V being
// the K tile read transposed).  Each P.V warpgroup copies the three slabs
// of a tile that its own P.V reads (K's other columns are only Q.K^T's,
// read before), so it refills them as soon as its own P.V is done, with no
// barrier among the three; warpgroup 0 computes the scores of tile t + 1
// while they run P.V of tile t, and waits for that P.V only before it
// overwrites P.  alias: one pool passed as K and V.
__global__ void __launch_bounds__(kLatThreads, 1)
paged_latent_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int C, int H, int KV, int D, int P, int T, int N,
                    int splits, int window, float scale, float softcap,
                    int alias) {
  using L = LatSmem;
  extern __shared__ unsigned char lat_raw[];
  const uint32_t raw = smem_addr(lat_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = lat_raw + (base - raw);
  float* alpha_s = reinterpret_cast<float*>(smem + L::alpha_off);
  float* ml_s = reinterpret_cast<float*>(smem + L::ml_off);
  int* pg = reinterpret_cast<int*>(smem + L::pg_off);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wt = tid % 128;
  const int warp = wt / 32;             // rows 16 warp .. 16 warp + 15
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int sp = blockIdx.x;
  const int kv = blockIdx.y % KV;
  const int row0 = blockIdx.y / KV * kLatRows;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = C * G;
  const int start = lengths[b];

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
  const int rr0 = 16 * warp + g;        // this thread's two rows of the block
  const int rr1 = rr0 + 8;
  // tiles in flight beyond the one in use: one more stage with one pool
  const int ahead = alias ? 2 : 1;

  if (wg == 0) {
    // ------------------------------------------------------------ scores
    setmaxnreg_dec<kLatSRegs>();
    // Q's 64 rows (zero past R: wgmma reads every row)
    for (int idx = wt; idx < kLatRows * kLatChunks; idx += 128) {
      const int r = idx / kLatChunks;
      const int c = idx - r * kLatChunks;
      const bool ok = row0 + r < R && c * 8 < D;
      cp_async16(smem + L::q_off + lat_chunk(r, c),
                 ok ? q + row_id(row0 + r) * D + c * 8 : q, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_bar_sync(kBarQ, 128);
    const int qp0 = start + (row0 + rr0) / G;
    const int qp1 = start + (row0 + rr1) / G;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float s[32];
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const uint32_t kt =
          base + L::buf_off + (alias ? (i & 1) : 0) * L::tile;
      named_bar_sync(kBarFull, kLatThreads);     // tile t is in
      // S = Q K^T, 64 rows x 64 keys, over the head dim
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kLatDP / 16; ++kc) {
        const uint32_t step = (kc >> 2) * L::slab + (kc & 3) * 32;
        wgmma_ss<64>(s, sw128_desc(base + L::q_off + step, 16, 1024),
                     sw128_desc(kt + step, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scale, softcap, mask (only where the tile crosses a mask edge:
      // the visible range's end, the first row's causal edge, the last
      // row's window floor)
      const int k0 = k_lo + t * kBK;
      const bool full = k0 + kBK <= k_hi && k0 + kBK - 1 <= start &&
                        (window < 0 || k0 > start + C - 1 - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale;
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = softcap * tanhf(s[e] / softcap);
      }
      if (!full) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int kpos = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
          const int qpos = (e & 2) ? qp1 : qp0;
          if (!(kpos < k_hi && kpos <= qpos &&
                (window < 0 || kpos > qpos - window)))
            s[e] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
      for (int e = 0; e < 32; ++e) {   // masked scores give exactly 0
        const float x = s[e];
        s[e] = x == kNegInf ? 0.f
                            : exp2f((x - ((e & 2) ? mn1 : mn0)) * kLog2e);
        if (e & 2) ps1 += s[e]; else ps0 += s[e];
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
      // P.V of tile t - 1 is done: P and the rescales are free
      if (t > t_lo) named_bar_sync(kBarFree, kLatThreads);
      // P into its swizzled slab: keys 8j + 2tq, + 1 of rows rr0 and rr1
      // are one 4-byte word each
      unsigned char* prow0 = smem + L::p_off + rr0 * 128 + tq * 4;
      unsigned char* prow1 = smem + L::p_off + rr1 * 128 + tq * 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(prow0 + ((j ^ (rr0 & 7)) << 4)) =
            pack_bf16(s[4 * j], s[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(prow1 + ((j ^ (rr1 & 7)) << 4)) =
            pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      if (tq == 0) {
        alpha_s[rr0] = alpha0;
        alpha_s[rr1] = alpha1;
      }
      fence_proxy_async();          // P is read by wgmma
      named_bar_arrive(kBarReady, kLatThreads);
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (tq == 0) {
      ml_s[2 * rr0 + 1] = l0;
      ml_s[2 * rr1 + 1] = l1;
      if (!direct) {                // this split's (m, l) of its rows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = half ? rr1 : rr0;
          if (row0 + rr >= R) continue;
          const long long slot = row_id(row0 + rr) * splits + sp;
          ws_ml[slot * 2] = half ? m1 : m0;
          ws_ml[slot * 2 + 1] = half ? l1 : l0;
        }
      }
    }
    __syncthreads();                // the row sums are in
    return;
  }

  // -------------------------------------------------------------- P.V
  setmaxnreg_inc<kLatPVRegs>();
  const int lt = tid - 128;         // 0 .. 383
  const int c_lo = (wg - 1) * kLatOwn;   // this warpgroup's chunks of a row
  // Tile t into its stage through the table entries in page slot
  // (t - t_lo) % 3: this warpgroup's 24 chunks of each key's row of K (and
  // of V for separate pools), zero past k_hi and D; in the same copy group
  // the entries of tile t + ahead into their slot, so the walk never waits
  // on a page read.  One group a call, empty past t_hi.
  auto issue = [&](int t) {
    if (t < t_hi) {
      const int i = t - t_lo;
      const int k0 = k_lo + t * kBK;
      unsigned char* kd =
          smem + L::buf_off + (alias ? (i & 1) : 0) * L::tile;
      unsigned char* vd = smem + L::buf_off + L::tile;
      const int* pe = pg + (i % 3) * kBK;
      for (int idx = wt; idx < kBK * kLatOwn; idx += 128) {
        const int r = idx / kLatOwn;
        const int c = c_lo + idx - r * kLatOwn;
        const bool ok = k0 + r < k_hi && c * 8 < D;
        const long long off = ok ? pw.at(pe[r], k0 + r) + c * 8 : 0;
        const uint32_t at = lat_chunk(r, c);
        cp_async16(kd + at, pool_k + off, ok);
        if (!alias) cp_async16(vd + at, pool_v + off, ok);
      }
      const int ka = k0 + ahead * kBK + lt;
      if (lt < kBK)
        cp_async4(pg + ((i + ahead) % 3) * kBK + lt,
                  ka < k_hi ? pw.row + ka / T : pw.row, ka < k_hi);
    }
    cp_async_commit();
  };
  // the entries of the first `ahead` tiles read directly, then those tiles
  for (int j = lt; j < ahead * kBK; j += kLatPV * 128) {
    const int ka = k_lo + t_lo * kBK + j;
    pg[j] = ka < k_hi ? pw.row[ka / T] : 0;
  }
  named_bar_sync(kBarPages, kLatPV * 128);
  // tile t's copies, waited for and handed to warpgroup 0 (kBarFull)
  auto landed = [&]() {
    cp_async_wait<0>();
    fence_proxy_async();            // for wgmma too
    named_bar_arrive(kBarFull, kLatThreads);
  };
  issue(t_lo);
  if (alias) {
    issue(t_lo + 1);
    cp_async_wait<1>();             // tile t_lo, not t_lo + 1
    fence_proxy_async();
    if (t_lo < t_hi) named_bar_arrive(kBarFull, kLatThreads);
  } else if (t_lo < t_hi) {
    landed();
  }

  const uint32_t v_cols = (wg - 1) * (kLatDV / 64) * L::slab;
  float o[kLatDV / 2];
#pragma unroll
  for (int j = 0; j < kLatDV / 2; ++j) o[j] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    named_bar_sync(kBarReady, kLatThreads);      // P(t) is in
    const uint32_t vt = base + L::buf_off +
                        (alias ? (i & 1) : 1) * L::tile + v_cols;
    // O = alpha O + P V over this warpgroup's 192 columns, 16 keys a step
    const float a0 = alpha_s[rr0], a1 = alpha_s[rr1];
#pragma unroll
    for (int j = 0; j < kLatDV / 8; ++j) {
      o[4 * j + 0] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wgmma_ss_tb<kLatDV>(o, sw128_desc(base + L::p_off + kc * 32, 16, 1024),
                          sw128_desc(vt + kc * 16 * 128, L::slab, 1024));
    wgmma_commit();
    // with two stages tile t + 1 is in flight: hand it over while P.V of
    // tile t runs, so the scores of t + 1 overlap it
    if (alias && t + 1 < t_hi) landed();
    wgmma_wait<0>();
    fence_regs(o);
    if (t + 1 < t_hi) named_bar_arrive(kBarFree, kLatThreads);
    issue(t + ahead);               // into the slabs this P.V has read
    if (!alias && t + 1 < t_hi) landed();
  }
  cp_async_wait<0>();               // an empty walk left copies pending
  __syncthreads();                  // the row sums are in
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = half ? rr1 : rr0;
    if (row0 + rr >= R) continue;
    const long long rid = row_id(row0 + rr);
    const int c0 = (wg - 1) * kLatDV + 2 * tq;
    if (direct) {
      const float inv = 1.f / fmaxf(ml_s[2 * rr + 1], 1e-20f);
      __nv_bfloat16* orow = out + rid * D;
#pragma unroll
      for (int j = 0; j < kLatDV / 8; ++j) {
        const int c = c0 + 8 * j;   // D is even: pairs fit
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
              o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      }
    } else {
      // this split's unnormalised accumulator (warpgroup 0 wrote m, l)
      float* arow = ws_acc + (rid * splits + sp) * D;
#pragma unroll
      for (int j = 0; j < kLatDV / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c < D)
          *reinterpret_cast<float2*>(arow + c) =
              make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;

// The float32 block's shape at padded head dim DP (see the header): CS
// warps share a 16-row tile, each with KW keys of every BK-key tile's
// scores and DS output columns; MT row tiles make RB rows.  Shared memory,
// in floats: Q [RB][LD], NB key tiles [BK][LD] (two stages of K and V; at
// DP = 576, two stages of K = V for one pool passed twice, else K and V of
// one stage), P [RB][LDP], the row maxima and sums of the CS warps of a
// row tile [2][RB][CS], and a ring of two tiles' page-table entries.  Rows
// are padded by 4 floats, so every fragment read touches 32 distinct banks.
template <int DP>
struct F32L {
  static constexpr int CS = DP > 256 ? 4 : 1;
  static constexpr int MT = kF32Warps / CS;
  static constexpr int RB = 16 * MT;
  static constexpr int BK = DP == 256 ? 16 : 32;
  static constexpr int KW = BK / CS;
  static constexpr int DS = DP / CS;
  static constexpr int NB = DP > 256 ? 2 : 4;
  static constexpr int LD = DP + 4;
  static constexpr int LDP = BK + 4;
  static constexpr int buf_off = RB * LD;
  static constexpr int p_off = buf_off + NB * BK * LD;
  static constexpr int red_off = p_off + RB * LDP;
  static constexpr int pg_off = red_off + 2 * RB * CS;
  static constexpr size_t bytes = (size_t)(pg_off + 2 * BK) * 4;
  static_assert(bytes <= 232448, "fits an SM's shared memory");
  static_assert(kBK % BK == 0, "tiles never straddle a split");
};

// acc[nt] += A (16 rows) x B^T (n-tiles 8nt), over K = 8 * kSteps, as
// warp_mma<kNT, kSteps, false, false, true, true> computes it but in
// kChains independent chains of products over interleaved k-steps, added
// in a fixed order at the end: with one n-tile, one chain would issue its
// 3 * kSteps products one after another.
template <int kNT, int kSteps, int kChains>
__device__ __forceinline__ void warp_mma_chains(float (&acc)[kNT][4],
                                                const float* a, int lda,
                                                const float* b, int ldb,
                                                int g, int tq) {
  static_assert(kSteps % kChains == 0, "whole rounds of chains");
  float part[kChains][kNT][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c) zero(part[c]);
#pragma unroll 2
  for (int ks = 0; ks < kSteps; ks += kChains) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int k0 = (ks + c) * 8;
      const float* p = a + g * lda + k0 + tq;
      uint32_t ab[4], as[4];
      split_tf32<true>(p[0], ab[0], as[0]);
      split_tf32<true>(p[8 * lda], ab[1], as[1]);
      split_tf32<true>(p[4], ab[2], as[2]);
      split_tf32<true>(p[8 * lda + 4], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* q = b + (nt * 8 + g) * ldb + k0 + tq;
        uint2 b0, b1;
        split_tf32<true>(q[0], b0.x, b0.y);
        split_tf32<true>(q[4], b1.x, b1.y);
        mma3<true, true>(part[c][nt], ab, as, b0, b1);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = part[0][nt][e];
#pragma unroll
      for (int c = 1; c < kChains; ++c) v += part[c][nt][e];
      acc[nt][e] += v;
    }
}

// One block per (context split, row group of RB query rows, KV head,
// sequence), on the split plan, key walk and merge of the bf16 kernel.
// Warp (row tile mt, slice cs) computes the scores of its 16 rows and KW
// keys of each tile (S = Q.K^T on mma.sync m16n8k8 in 3xTF32, Q and K
// from shared memory), the CS warps of a row tile agree on each row's
// maximum and sum through shared memory (in a fixed order, so all hold
// the same bits), P goes to shared memory, and the warp adds P.V to its DS
// output columns (3xTF32 again, P and V from shared memory).  Tiles come
// through the page table by cp.async, 16 bytes a thread (vec: D % 4 == 0
// and 16-byte operands; otherwise element by element), with the next
// tile's entries in the copy group of this one.  alias: one pool passed as
// K and V, each tile copied once.  kFused: the chunk's append, and its own
// keys read from the new rows.
template <int DP, bool kFused>
__global__ void __launch_bounds__(kF32Threads, 1)
paged_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ pool_k,
                           const float* __restrict__ pool_v,
                           const int* __restrict__ page_table,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           float* __restrict__ ws_acc,
                           float* __restrict__ ws_ml, int C, int H, int KV,
                           int D, int P, int T, int N, int splits, int window,
                           float scale, float softcap, int vec, int alias,
                           Append ap) {
  using L = F32L<DP>;
  constexpr int BK = L::BK, LD = L::LD, LDP = L::LDP, CS = L::CS;
  constexpr int KW = L::KW, DS = L::DS, RB = L::RB;
  extern __shared__ float4 f32_smem[];
  float* const sm = reinterpret_cast<float*>(f32_smem);
  float* const Ps = sm + L::p_off;
  float* const red = sm + L::red_off;
  int* const pg = reinterpret_cast<int*>(sm + L::pg_off);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int sp = blockIdx.x;
  const int kv = blockIdx.y % KV;
  const int row0 = blockIdx.y / KV * RB;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = C * G;
  const int start = lengths[b];
  if constexpr (kFused) {
    if (sp == 0 && row0 == 0)
      append_rows<float, kF32Threads>(ap, b, kv, C, KV, D, P, T, vec);
  }
  const NewRows<float> nr(ap, b, C, KV, kv, D, start);

  int k_lo, k_hi, t_lo, t_hi;
  const int n_tiles = key_tiles(start, C, T, N, window, &k_lo, &k_hi);
  split_range(n_tiles, splits, sp, &t_lo, &t_hi);
  // splits [0, live) hold tiles; split 0 alone runs when none does
  const int live = live_splits(n_tiles, splits);
  if (sp >= max(live, 1)) return;
  const bool direct = live <= 1;    // one block: it writes the output
  // this split's keys, walked as tiles of BK
  const int key_lo = k_lo + t_lo * kBK;
  const int key_hi = min(k_hi, k_lo + t_hi * kBK);
  const int n_t = key_hi > key_lo ? (key_hi - key_lo + BK - 1) / BK : 0;

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
  // stages: two, or one for separate pools at DP = 576
  const bool two = L::NB == 4 || alias;
  auto kbuf = [&](int i) -> float* {
    const int s = two ? (i & 1) : 0;
    return sm + L::buf_off +
           (L::NB == 4 ? 2 * s : (alias ? s : 0)) * BK * LD;
  };
  auto vbuf = [&](int i) -> float* {
    if (alias) return kbuf(i);
    const int s = two ? (i & 1) : 0;
    return sm + L::buf_off + (L::NB == 4 ? 2 * s + 1 : 1) * BK * LD;
  };

  // Tile i (keys key_lo + i BK ..) into its stage through the table
  // entries in page slot i % 2, and in the same copy group the entries of
  // tile i + 1 into the other slot.  Keys >= key_hi and columns >= D are
  // zero-filled; kFused: keys from start on come from the new rows.  One
  // group a call, empty past the walk.
  auto issue = [&](int i) {
    if (i < n_t) {
      const int k0 = key_lo + i * BK;
      float* kd = kbuf(i);
      float* vd = vbuf(i);
      const int* pe = pg + (i & 1) * BK;
      const int ka = k0 + BK + tid;   // a key of tile i + 1
      int* pn = pg + ((i + 1) & 1) * BK + tid;
      if (vec) {
        constexpr int vpr = DP / 4;
        for (int idx = tid; idx < BK * vpr; idx += kF32Threads) {
          const int r = idx / vpr;
          const int c = (idx - r * vpr) * 4;
          const int kpos = k0 + r;
          const bool ok = kpos < key_hi && c < D;
          const float *sk = pool_k, *sv = pool_v;
          if (kFused && ok && kpos >= start) {
            const long long off = nr.off(kpos) + c;
            sk = nr.k + off;
            sv = nr.v + off;
          } else if (ok) {
            const long long off = pw.at(pe[r], kpos) + c;
            sk = pool_k + off;
            sv = pool_v + off;
          }
          cp_async16(kd + r * LD + c, sk, ok);
          if (!alias) cp_async16(vd + r * LD + c, sv, ok);
        }
        if (tid < BK)
          cp_async4(pn, ka < key_hi ? pw.row + ka / T : pw.row, ka < key_hi);
      } else {
        for (int idx = tid; idx < BK * DP; idx += kF32Threads) {
          const int r = idx / DP;
          const int c = idx - r * DP;
          const int kpos = k0 + r;
          float xk = 0.f, xv = 0.f;
          if (kpos < key_hi && c < D) {
            if (kFused && kpos >= start) {
              const long long off = nr.off(kpos) + c;
              xk = nr.k[off];
              xv = nr.v[off];
            } else {
              const long long off = pw.at(pe[r], kpos) + c;
              xk = pool_k[off];
              xv = pool_v[off];
            }
          }
          kd[r * LD + c] = xk;
          if (!alias) vd[r * LD + c] = xv;
        }
        if (tid < BK) *pn = ka < key_hi ? pw.row[ka / T] : 0;
      }
    }
    cp_async_commit();
  };

  // Q's RB rows (zero past R and D) in a copy group of its own; the
  // entries of the first tile read directly
  for (int idx = tid; idx < RB * (DP / 4); idx += kF32Threads) {
    const int r = idx / (DP / 4);
    const int c = (idx - r * (DP / 4)) * 4;
    const bool row_ok = row0 + r < R;
    const float* src = row_ok ? q + row_id(row0 + r) * D : q;
    if (vec) {
      cp_async16(sm + r * LD + c, row_ok && c < D ? src + c : q,
                 row_ok && c < D);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm[r * LD + c + e] = row_ok && c + e < D ? src[c + e] : 0.f;
    }
  }
  cp_async_commit();
  if (tid < BK) {
    const int ka = key_lo + tid;
    pg[tid] = ka < key_hi ? pw.row[ka / T] : 0;
  }
  __syncthreads();
  if (two) issue(0);

  const int mt = warp / CS;         // row tile
  const int cs = warp % CS;         // its key slice of S, column slice of O
  const int m0 = 16 * mt;
  const bool active = row0 + m0 < R;
  const int r0 = row0 + m0 + g;     // this thread's two query rows
  const int r1 = r0 + 8;
  const int qp0 = start + r0 / G;
  const int qp1 = start + r1 / G;
  float o[DS / 8][4];
  zero(o);
  float mr0 = kNegInf, mr1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float* const red_max = red;
  float* const red_sum = red + RB * CS;

  for (int i = 0; i < n_t; ++i) {
    if (!two) {
      __syncthreads();              // the one stage is free again ...
      issue(i);                     // ... for tile i
    }
    cp_async_wait<0>();             // tile i has landed ...
    __syncthreads();                // ... for every thread; with two
    if (two) issue(i + 1);          // stages, tile i - 1's is free for i + 1
    const float* Kt = kbuf(i);
    const float* Vt = vbuf(i);
    const int k0 = key_lo + i * BK + cs * KW;   // this warp's keys

    float s[KW / 8][4];
    float mx0 = kNegInf, mx1 = kNegInf;
    if (active) {
      // S = Q K^T: 16 rows x KW keys over the head dim
      zero(s);
      if constexpr (KW / 8 >= 2)
        warp_mma<KW / 8, DP / 8, false, false, true, true>(
            s, sm + m0 * LD, LD, Kt + cs * KW * LD, LD, 0, 0, g, tq);
      else
        warp_mma_chains<KW / 8, DP / 8, 4>(s, sm + m0 * LD, LD,
                                           Kt + cs * KW * LD, LD, g, tq);
      // scale, softcap, mask (only where the keys cross a mask edge)
      const bool full = k0 + KW <= key_hi && k0 + KW - 1 <= start &&
                        (window < 0 || k0 > start + C - 1 - window);
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (!full) {
            const int kpos = k0 + nt * 8 + 2 * tq + (e & 1);
            const int qpos = e < 2 ? qp0 : qp1;
            if (!(kpos < key_hi && kpos <= qpos &&
                  (window < 0 || kpos > qpos - window)))
              x = kNegInf;
          }
          s[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    }
    if constexpr (CS > 1) {         // the row maxima of the CS warps
      if (active && tq == 0) {
        red_max[(m0 + g) * CS + cs] = mx0;
        red_max[(m0 + g + 8) * CS + cs] = mx1;
      }
      __syncthreads();
      if (active) {
        mx0 = red_max[(m0 + g) * CS];
        mx1 = red_max[(m0 + g + 8) * CS];
#pragma unroll
        for (int c = 1; c < CS; ++c) {
          mx0 = fmaxf(mx0, red_max[(m0 + g) * CS + c]);
          mx1 = fmaxf(mx1, red_max[(m0 + g + 8) * CS + c]);
        }
      }
    }
    float alpha0 = 1.f, alpha1 = 1.f, ps0 = 0.f, ps1 = 0.f;
    if (active) {
      const float mn0 = fmaxf(mr0, mx0);
      const float mn1 = fmaxf(mr1, mx1);
      alpha0 = exp2f((mr0 - mn0) * kLog2e);
      alpha1 = exp2f((mr1 - mn1) * kLog2e);
      mr0 = mn0;
      mr1 = mn1;
      // P (masked scores exactly 0) into shared memory
      float* p0 = Ps + (m0 + g) * LDP + cs * KW + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          p[e] = x == kNegInf ? 0.f
                              : exp2f((x - (e < 2 ? mn0 : mn1)) * kLog2e);
        }
        ps0 += p[0] + p[1];
        ps1 += p[2] + p[3];
        *reinterpret_cast<float2*>(p0 + nt * 8) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(p0 + 8 * LDP + nt * 8) =
            make_float2(p[2], p[3]);
      }
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    }
    if constexpr (CS > 1) {         // the row sums of the CS warps
      if (active && tq == 0) {
        red_sum[(m0 + g) * CS + cs] = ps0;
        red_sum[(m0 + g + 8) * CS + cs] = ps1;
      }
      __syncthreads();              // P and the sums are in
      if (active) {
        ps0 = red_sum[(m0 + g) * CS];
        ps1 = red_sum[(m0 + g + 8) * CS];
#pragma unroll
        for (int c = 1; c < CS; ++c) {
          ps0 += red_sum[(m0 + g) * CS + c];
          ps1 += red_sum[(m0 + g + 8) * CS + c];
        }
      }
    } else {
      __syncwarp();                 // P is in for the warp's lanes
    }
    if (active) {
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int ot = 0; ot < DS / 8; ++ot) {
        o[ot][0] *= alpha0;
        o[ot][1] *= alpha0;
        o[ot][2] *= alpha1;
        o[ot][3] *= alpha1;
      }
      // O += P V over the warp's columns, every key of the tile
      warp_mma<DS / 8, BK / 8, false, true, true, true>(
          o, Ps + m0 * LDP, LDP, Vt + cs * DS, LD, 0, 0, g, tq);
    }
  }
  cp_async_wait<0>();               // an empty walk left copies pending
  if (!active) return;

  const bool even = D % 2 == 0;     // column pairs are aligned in memory
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= R) continue;
    const long long rid = row_id(r);
    const float l = half ? l1 : l0;
    float* dst;
    float inv = 1.f;
    if (direct) {
      dst = out + rid * D;
      inv = 1.f / fmaxf(l, 1e-20f);
    } else {
      // this split's state: m, l and the unnormalised accumulator
      const long long slot = rid * splits + sp;
      dst = ws_acc + slot * D;
      if (cs == 0 && tq == 0) {
        ws_ml[slot * 2] = half ? mr1 : mr0;
        ws_ml[slot * 2 + 1] = l;
      }
    }
#pragma unroll
    for (int ot = 0; ot < DS / 8; ++ot) {
      const int c = cs * DS + ot * 8 + 2 * tq;
      const float x = o[ot][2 * half] * inv, y = o[ot][2 * half + 1] * inv;
      if (c + 1 < D && even) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(x, y);
      } else {
        if (c < D) dst[c] = x;
        if (c + 1 < D) dst[c + 1] = y;
      }
    }
  }
}

// One warp per (output row, 128 of its columns) of a sequence with more
// than one live split: those splits' states, in split order: out = sum_s
// acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-20).  (A sequence with
// at most one live split had its rows written by split 0, and its warps
// read nothing more than lengths[b].)  A wide row (MLA's 576) takes
// several warps.  With 16-byte rows a lane loads its four columns of every
// live split's state together with the states' (m, l), so those loads are
// in flight together.  MS >= splits sizes those registers: fewer for fewer
// splits, so more warps, and more loads, fit an SM.
template <typename E, int MS>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml,
                             const int* __restrict__ lengths,
                             E* __restrict__ out, long long n_rows, int C,
                             int H, int D, int T, int N, int splits,
                             int window) {
  const int chunks = (D + 127) / 128;
  const long long wid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long row = wid / chunks;
  const int d0 = (int)(wid - row * chunks) * 128;
  const int d1 = min(D, d0 + 128);
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  int k_lo, k_hi;
  const int live = live_splits(
      key_tiles(lengths[row / ((long long)C * H)], C, T, N, window, &k_lo,
                &k_hi),
      splits);
  if (live <= 1) return;
  const float* ml = ws_ml + row * splits * 2;
  const float* acc = ws_acc + row * splits * D;
  const bool vec = D % 4 == 0;      // 16-byte rows: four columns a lane
  const int d = d0 + lane * 4;
  float m[MS], w[MS];
  float4 x[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    if (s < live) {
      m[s] = ml[2 * s];
      w[s] = ml[2 * s + 1];         // l_s for now
      if (vec && d < d1)
        x[s] = *reinterpret_cast<const float4*>(acc + (long long)s * D + d);
    }
  }
  float M = kNegInf;
#pragma unroll
  for (int s = 0; s < MS; ++s)
    if (s < live) M = fmaxf(M, m[s]);
  float L = 0.f;
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    const float e = s < live ? expf(m[s] - M) : 0.f;
    L += (s < live ? w[s] : 0.f) * e;
    w[s] = e;
  }
  const float inv = 1.f / fmaxf(L, 1e-20f);
  E* o = out + row * D;
  if (vec) {
    if (d >= d1) return;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < live) {
        a.x += x[s].x * w[s];
        a.y += x[s].y * w[s];
        a.z += x[s].z * w[s];
        a.w += x[s].w * w[s];
      }
    }
    store(&o[d], a.x * inv);
    store(&o[d + 1], a.y * inv);
    store(&o[d + 2], a.z * inv);
    store(&o[d + 3], a.w * inv);
    return;
  }
  for (int dd = d0 + lane; dd < d1; dd += 32) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < MS; ++s)
      if (s < live) a += acc[(long long)s * D + dd] * w[s];
    store(&o[dd], a * inv);
  }
}

template <typename E, int MS>
int merge_ms(const void* ws_acc, const void* ws_ml, const void* lengths,
             void* out, int B, int C, int H, int D, int T, int N, int splits,
             int window, cudaStream_t stream) {
  const long long warps = (long long)B * C * H * ((D + 127) / 128);
  paged_attention_merge_kernel<E, MS>
      <<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
          static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
          static_cast<const int*>(lengths), static_cast<E*>(out),
          (long long)B * C * H, C, H, D, T, N, splits, window);
  return (int)cudaGetLastError();
}

template <typename E>
int merge(const void* ws_acc, const void* ws_ml, const void* lengths,
          void* out, int B, int C, int H, int D, int T, int N, int splits,
          int window, cudaStream_t stream) {
  if (splits <= 4)
    return merge_ms<E, 4>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N,
                          splits, window, stream);
  if (splits <= 8)
    return merge_ms<E, 8>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N,
                          splits, window, stream);
  return merge_ms<E, kMaxSplits>(ws_acc, ws_ml, lengths, out, B, C, H, D, T,
                                 N, splits, window, stream);
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

// The latent kernel: one block per (split, row group of 64, KV head,
// sequence); one pool passed twice is read once
int launch_latent(const void* q, const void* pool_k, const void* pool_v,
                  const void* page_table, const void* lengths, void* out,
                  void* ws_acc, void* ws_ml, int B, int C, int H, int KV,
                  int D, int P, int T, int N, int splits, int window,
                  float scale, float softcap, cudaStream_t stream) {
  const size_t smem = LatSmem::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_latent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_groups = (C * (H / KV) + kLatRows - 1) / kLatRows;
  dim3 grid(splits, row_groups * KV, B);
  paged_latent_kernel<<<grid, kLatThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), C, H, KV, D, P, T, N, splits, window,
      scale, softcap, pool_k == pool_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return merge<__nv_bfloat16>(ws_acc, ws_ml, lengths, out, B, C, H, D, T, N,
                              splits, window, stream);
}

template <int DP, bool kFused>
int launch_f32(REPRO_PARAMS) {
  using L = F32L<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_f32_kernel<DP, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  const int row_groups = (C * (H / KV) + L::RB - 1) / L::RB;
  dim3 grid(splits, row_groups * KV, B);
  // one pool passed twice is copied once (the fused append writes K and V
  // rows of their own, so it copies both)
  const int alias = !kFused && pool_k == pool_v;
  paged_attention_f32_kernel<DP, kFused>
      <<<grid, kF32Threads, L::bytes, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(pool_k),
          static_cast<const float*>(pool_v),
          static_cast<const int*>(page_table),
          static_cast<const int*>(lengths), static_cast<float*>(out),
          static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), C, H, KV,
          D, P, T, N, splits, window, scale, softcap,
          vec_copies(D, 4, q, pool_k, pool_v, ap), alias, ap);
  err = cudaGetLastError();
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
      return launch_latent(q, pool_k, pool_v, page_table, lengths, out,
                           ws_acc, ws_ml, B, C, H, KV, D, P, T, N, splits,
                           window, scale, softcap, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (D <= 32) return launch_f32<32, kFused>(REPRO_ARGS);
  if (D <= 64) return launch_f32<64, kFused>(REPRO_ARGS);
  if (D <= 128) return launch_f32<128, kFused>(REPRO_ARGS);
  if (D <= 256) return launch_f32<256, kFused>(REPRO_ARGS);
  if constexpr (!kFused) return launch_f32<kLatDP, kFused>(REPRO_ARGS);
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
