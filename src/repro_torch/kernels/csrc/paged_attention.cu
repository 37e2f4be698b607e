// Chunk-causal paged GQA attention for Hopper (sm_90a): the port of the
// Pallas kernel repro/kernels/paged_attention/kernel.py::
// paged_attention_chunk (body _paged_kernel; paged_attention is its C=1
// decode form with lengths - 1).
//
// What it computes: for each sequence b, KV head k and query row r of the
// C*G rows of that head (row r = token c = r / G of the chunk, query head
// h = k*G + r % G, at position lengths[b] + c), softmax(scale * q.K^T)
// over the keys of pages page_table[b, :] with key position <= the query
// position (and > position - window when windowed), times V.  Scores are
// f32, an optional tanh softcap applies before the mask, the online
// softmax runs with a FINITE NEG_INF (-1e30) so an all-masked tile never
// makes exp(m_prev - m_curr) a NaN, masked probabilities are forced to 0,
// and the denominator is clamped at 1e-20, so a row that sees no key
// writes 0.  The output is written in q's dtype.  These are the exact
// expressions of _paged_kernel.
//
// What bounds it on this card: bytes.  The work is the K/V bytes of the
// pages each sequence needs (about 2*ctx*KV*D*sizeof(dtype) per sequence)
// plus q and out, against 3.35 TB/s; its operations, 4*H*C*ctx*D per
// sequence, sit far below the 989 TFLOP/s bf16 line at the serving shapes
// (G=6 query heads share one KV head; decode has C=1).
//
// What the design does about it:
//  * grid (row tiles of C*G, KV, B x context splits): the Pallas version
//    launched one pallas_call per KV head; here KV heads are a grid
//    dimension and one call serves the layer;
//  * q is read in place from [B, C, H, D] (row (c, g) of KV head k is head
//    k*G + g); no transposed copy as at kernel.py:148;
//  * each block reads lengths[b] and the page-table row itself and walks
//    only the pages n < ceil((start + C) / T) (and, with a window, from the
//    first page not wholly below start - window) — the staging-page
//    analogue: allocated but unpublished pages cost nothing;
//  * the walk is cut into splits of a few key tiles, one block each, so a
//    decode step (16 (b, k) pairs at B=8) still spreads over the SMs; each
//    split writes its online-softmax state (m, l, unnormalised acc) to a
//    float32 workspace and a second kernel merges the splits of every row
//    in a fixed order.  The per-warp arithmetic is a chain of dependent
//    shared-memory reads, shuffles and FMAs, so latency, not bandwidth,
//    limits one block; more blocks in flight is what hides it.  With one
//    split the first kernel writes the output itself;
//  * K and V of the block's KV head are staged in tiles of kKT keys in
//    shared memory (f32), so all query rows of the tile reuse each byte
//    read.  Tiles move as 16-byte vectors and the next tile's vectors are
//    loaded into registers while the current tile is computed; head dims
//    that do not fill 16-byte vectors take a scalar path;
//  * one warp owns one query row, each lane NI slices of the head dim,
//    and dot products reduce with warp shuffles;
//  * no atomics: the result does not depend on block scheduling.
// Head dims up to 256 are supported (NI = 8 slices per lane).  No tensor
// cores and no TMA yet: wgmma over the G query heads of a KV head is the
// next step for prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;   // query rows per block, one warp each
constexpr int kKT = 16;     // keys per shared-memory tile
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of E -> 16 / sizeof(E) floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  const float4 a = *reinterpret_cast<const float4*>(&u);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

struct Walk {             // one sequence's tiles, as a block sees them
  const int* row;         // page_table[b, :]
  int n_lo, tiles_per_page, T, P;
  long long tok_stride, kv_off;
  // element offset of tile `it`'s first key; sets its first slot and size
  __device__ __forceinline__ long long base(int it, int* t0, int* kt) const {
    const int n = n_lo + it / tiles_per_page;
    *t0 = (it % tiles_per_page) * kKT;
    *kt = min(kKT, T - *t0);
    int page = row[n];
    page = page < 0 ? 0 : (page >= P ? P - 1 : page);   // gather clamps
    return ((long long)page * T + *t0) * tok_stride + kv_off;
  }
};

template <typename E, int R>
__device__ __forceinline__ void prefetch(const Walk& w, int it, int vpr,
                                         const E* __restrict__ pool_k,
                                         const E* __restrict__ pool_v,
                                         uint4 (&kreg)[R], uint4 (&vreg)[R]) {
  constexpr int kVec = 16 / (int)sizeof(E);
  int t0, kt;
  const long long base = w.base(it, &t0, &kt);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (idx < kt * vpr) {
      const int j = idx / vpr;
      const long long off = base + j * w.tok_stride + (idx - j * vpr) * kVec;
      kreg[r] = *reinterpret_cast<const uint4*>(pool_k + off);
      vreg[r] = *reinterpret_cast<const uint4*>(pool_v + off);
    }
  }
}

template <typename E, int NI>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const E* __restrict__ q, const E* __restrict__ pool_k,
                       const E* __restrict__ pool_v,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, E* __restrict__ out,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int C, int H, int KV, int D, int P, int T, int N,
                       int splits, int split_tiles, int window, float scale,
                       float softcap, int vec_ok) {
  constexpr int kVec = 16 / (int)sizeof(E);              // E per 16 bytes
  constexpr int kRegs = (kKT * NI * 32 / kVec + kThreads - 1) / kThreads;
  __shared__ __align__(16) float ks[kKT * NI * 32];
  __shared__ __align__(16) float vs[kKT * NI * 32];

  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z - b * splits;
  const int kv = blockIdx.y;
  const int G = H / KV;
  const int rows = C * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < rows;
  const int c = active ? row / G : 0;
  const int h = kv * G + (active ? row % G : 0);
  const int start = lengths[b];
  const int qpos = start + c;

  float qr[NI], acc[NI];
  const long long row_id = ((long long)b * C + c) * H + h;
  const long long q_off = row_id * D;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    qr[i] = (active && d < D) ? to_f32(q[q_off + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // pages the chunk can see: [n_lo, n_hi), walked as tiles of kKT keys;
  // this block takes tiles [it_lo, it_hi) of that walk
  int n_hi = (start + C + T - 1) / T;
  if (n_hi > N) n_hi = N;
  int n_lo = 0;
  if (window >= 0) {
    const int floor_pos = start - window;   // first query's window floor
    n_lo = floor_pos > 0 ? floor_pos / T : 0;
  }
  Walk w;
  w.row = page_table + (long long)b * N;
  w.n_lo = n_lo;
  w.tiles_per_page = (T + kKT - 1) / kKT;
  w.T = T;
  w.P = P;
  w.tok_stride = (long long)KV * D;
  w.kv_off = (long long)kv * D;
  const int n_tiles = n_hi > n_lo ? (n_hi - n_lo) * w.tiles_per_page : 0;
  const int it_lo = sp * split_tiles;
  const int it_hi = min(n_tiles, it_lo + split_tiles);
  const int vpr = D / kVec;                 // 16-byte vectors per key row

  uint4 kreg[kRegs], vreg[kRegs];
  if (vec_ok && it_lo < it_hi)
    prefetch<E, kRegs>(w, it_lo, vpr, pool_k, pool_v, kreg, vreg);

  for (int it = it_lo; it < it_hi; ++it) {
    int t0, kt;
    const long long base = w.base(it, &t0, &kt);
    __syncthreads();   // the previous tile is fully consumed
    if (vec_ok) {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const int idx = threadIdx.x + r * kThreads;
        if (idx < kt * vpr) {
          const int j = idx / vpr;
          const int d0 = (idx - j * vpr) * kVec;
          unpack(kreg[r], &ks[j * D + d0], E());
          unpack(vreg[r], &vs[j * D + d0], E());
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < kt * D; idx += kThreads) {
        const int j = idx / D;
        const int d = idx - j * D;
        ks[j * D + d] = to_f32(pool_k[base + j * w.tok_stride + d]);
        vs[j * D + d] = to_f32(pool_v[base + j * w.tok_stride + d]);
      }
    }
    __syncthreads();
    if (vec_ok && it + 1 < it_hi)   // in flight during the compute below
      prefetch<E, kRegs>(w, it + 1, vpr, pool_k, pool_v, kreg, vreg);
    if (!active) continue;

    const int kbase = (n_lo + it / w.tiles_per_page) * T + t0;
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
      const int kpos = kbase + j;
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

  if (!active) return;
  if (splits == 1) {
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(&out[q_off + d], acc[i] / denom);
    }
    return;
  }
  // this split's state; an empty split leaves m = NEG_INF, l = 0, acc = 0
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

// Merge the splits of every output row (one warp per row, splits in
// order): out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-20).
template <typename E>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml, E* __restrict__ out,
               long long n_rows, int D, int splits) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const float* ml = ws_ml + row * splits * 2;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < splits; ++s) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  const float denom = fmaxf(L, 1e-20f);
  const float* acc = ws_acc + row * splits * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a += acc[(long long)s * D + d] * expf(ml[2 * s] - M);
    store(&out[row * D + d], a / denom);
  }
}

template <typename E, int NI>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* page_table, const void* lengths, void* out,
           void* ws_acc, void* ws_ml, int B, int C, int H, int KV, int D,
           int P, int T, int N, int splits, int window, float scale,
           float softcap, cudaStream_t stream) {
  const int rows = C * (H / KV);
  const int max_tiles = N * ((T + kKT - 1) / kKT);
  const int split_tiles = (max_tiles + splits - 1) / splits;
  dim3 grid((rows + kWarps - 1) / kWarps, KV, B * splits);
  // 16-byte tile loads need 16-byte aligned pools and whole vectors per row
  const int vec_ok = (D * (int)sizeof(E)) % 16 == 0 &&
                     ((uintptr_t)pool_k | (uintptr_t)pool_v) % 16 == 0;
  paged_attention_kernel<E, NI><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(pool_k),
      static_cast<const E*>(pool_v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<E*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), C, H, KV, D,
      P, T, N, splits, split_tiles, window, scale, softcap, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n_rows = (long long)B * C * H;
  combine_kernel<E><<<(unsigned)((n_rows + kWarps - 1) / kWarps), kThreads,
                      0, stream>>>(static_cast<const float*>(ws_acc),
                                   static_cast<const float*>(ws_ml),
                                   static_cast<E*>(out), n_rows, D, splits);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_d(const void* q, const void* pool_k, const void* pool_v,
               const void* page_table, const void* lengths, void* out,
               void* ws_acc, void* ws_ml, int B, int C, int H, int KV, int D,
               int P, int T, int N, int splits, int window, float scale,
               float softcap, cudaStream_t s) {
#define REPRO_LAUNCH(NI)                                                    \
  launch<E, NI>(q, pool_k, pool_v, page_table, lengths, out, ws_acc, ws_ml, \
                B, C, H, KV, D, P, T, N, splits, window, scale, softcap, s)
  if (D <= 32) return REPRO_LAUNCH(1);
  if (D <= 64) return REPRO_LAUNCH(2);
  if (D <= 128) return REPRO_LAUNCH(4);
  return REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

}  // namespace

// q, out: [B, C, H, D]; pool_k, pool_v: [P, T, KV, D]; page_table: [B, N]
// int32; lengths: [B] int32 (PRE-chunk length).  splits >= 1 context
// splits per sequence; with splits > 1, ws_acc holds B*C*H*splits*D and
// ws_ml B*C*H*splits*2 floats of scratch.  window < 0 means none,
// softcap <= 0 means none; is_bf16 selects bfloat16 (else float32) for
// q, pools and out.  D <= 256 and H % KV == 0 are checked by the caller.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int repro_paged_attention_chunk(
    const void* q, const void* pool_k, const void* pool_v,
    const void* page_table, const void* lengths, void* out, void* ws_acc,
    void* ws_ml, int B, int C, int H, int KV, int D, int P, int T, int N,
    int splits, int window, float scale, float softcap, int is_bf16,
    void* stream) {
  if (B <= 0 || C <= 0 || D > 256 || KV <= 0 || H % KV != 0 || splits < 1 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, pool_k, pool_v, page_table, lengths,
                                     out, ws_acc, ws_ml, B, C, H, KV, D, P,
                                     T, N, splits, window, scale, softcap, s);
  return dispatch_d<float>(q, pool_k, pool_v, page_table, lengths, out,
                           ws_acc, ws_ml, B, C, H, KV, D, P, T, N, splits,
                           window, scale, softcap, s);
}
