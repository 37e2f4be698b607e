// KV-append scatter for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/kv_append/kernel.py::kv_append_chunk (body _append_kernel;
// kv_append is its C=1 slice).
//
// What it computes: pool[page_ids[t], slot_ids[t]] = src[t] for every
// token t of a [B, C] chunk, in place.  One token's row is KV*D contiguous
// elements in both src [B, C, KV, D] and pool [P, T, KV, D], so the kernel
// is a dtype-blind row copy.
//
// What bounds it on this card: bytes.  It moves 2*B*C*KV*D*sizeof(dtype)
// (one read of src, one write into the pool) plus the two index arrays.
// At the serving shape (B=8, C=16, KV=2, D=128, bf16) that is 128 KB,
// about 40 ns at 3.35 TB/s, so in practice a launch costs its launch
// latency and nothing more.
//
// What the design does about it: a flat grid over tokens x 16-byte
// vectors (falling back to 8/4/2-byte vectors when a row or a base pointer
// is not 16-byte aligned), neighbouring threads on neighbouring addresses,
// every index read on the device (no host round trip), no shared memory.
// Nothing more is worth doing for 128 KB: the launch itself is the cost.
// The serve step therefore does not launch this kernel: the fused entry
// point of paged_attention.cu (repro_paged_attention_append_chunk, the op
// paged_attention_append_chunk) writes the same rows, with the same
// dropping of out-of-range targets, inside the attention launch.  This
// kernel stays the counterpart of the JAX op, for appends that no
// attention follows.
//
// Races: pad tokens of idle slots and of chunk tails past a slot's valid
// count are routed by the caller to the reserved null page 0 (or to
// allocated-but-unpublished staging slots).  Several such tokens may write
// the same (page 0, slot) row concurrently; the bytes that land there are
// undefined, and nothing ever reads them (page 0 is never published).  The
// Pallas grid ran in order, so there the last writer won; here any writer
// may win.  Valid tokens' (page, slot) targets are unique by construction
// of the controller.  Out-of-range indices are dropped, as JAX's scatter
// drops them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
kv_append_kernel(V* __restrict__ pool, const V* __restrict__ src,
                 const int* __restrict__ page_ids,
                 const int* __restrict__ slot_ids, long long n_vec,
                 int vecs_per_row, int num_pages, int page_tokens) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int tok = (int)(i / vecs_per_row);
  const int v = (int)(i - (long long)tok * vecs_per_row);
  const int page = page_ids[tok];
  const int slot = slot_ids[tok];
  if (page < 0 || page >= num_pages || slot < 0 || slot >= page_tokens) return;
  pool[((long long)page * page_tokens + slot) * vecs_per_row + v] = src[i];
}

template <typename V>
int launch(void* pool, const void* src, const void* page_ids,
           const void* slot_ids, int n_tok, int num_pages, int page_tokens,
           int row_bytes, cudaStream_t stream) {
  const int vecs_per_row = row_bytes / (int)sizeof(V);
  const long long n_vec = (long long)n_tok * vecs_per_row;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  kv_append_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<V*>(pool), static_cast<const V*>(src),
      static_cast<const int*>(page_ids), static_cast<const int*>(slot_ids),
      n_vec, vecs_per_row, num_pages, page_tokens);
  return (int)cudaGetLastError();
}

}  // namespace

// pool: [num_pages, page_tokens, row] (row = KV*D elements, row_bytes bytes)
// src:  [n_tok, row];  page_ids, slot_ids: [n_tok] int32.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_kv_append_chunk(void* pool, const void* src,
                                     const void* page_ids,
                                     const void* slot_ids, int n_tok,
                                     int num_pages, int page_tokens,
                                     int row_bytes, void* stream) {
  if (n_tok <= 0 || row_bytes <= 0) return 0;
  const uintptr_t align =
      (uintptr_t)pool | (uintptr_t)src | (uintptr_t)row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<int4>(pool, src, page_ids, slot_ids, n_tok, num_pages,
                        page_tokens, row_bytes, s);
  if (align % 8 == 0)
    return launch<int2>(pool, src, page_ids, slot_ids, n_tok, num_pages,
                        page_tokens, row_bytes, s);
  if (align % 4 == 0)
    return launch<int>(pool, src, page_ids, slot_ids, n_tok, num_pages,
                       page_tokens, row_bytes, s);
  return launch<short>(pool, src, page_ids, slot_ids, n_tok, num_pages,
                       page_tokens, row_bytes, s);
}
