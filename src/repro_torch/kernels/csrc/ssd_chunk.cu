// Mamba2 SSD intra-chunk block for Hopper (sm_90a): the port of the Pallas
// kernel repro/kernels/ssd_chunk/kernel.py::ssd_chunk (body _ssd_kernel).
//
// What it computes: for x [B', L, H, P], dt and cs [B', L, H] (float32),
// Bm and Cm [B', L, N] (ngroups = 1: shared by every head),
//
//   y[b, i, h, :] = sum_{j <= i} (C[b, i] . B[b, j]) * exp(cs[b, i, h] -
//                   cs[b, j, h]) * dt[b, j, h] * x[b, j, h, :]
//
// in float32, written in x's dtype (float32 or bfloat16; Bm and Cm share
// x's dtype).  The weight is formed as (S * exp(cs_i - cs_j)) * dt_j, the
// reference's order, with S = C_i . B_j summed over N.
//
// What bounds it on this card: bytes, once the products run on the tensor
// cores.  The causal half does B' * L(L+1)/2 * (2N + 2HP) FLOP against
// about 2 * B'LHP words of x in and y out: at the training path's shape
// (B' = 16 chunks of L = 256, H = 64, P = 64, N = 128, float32) that is
// 4.45e9 FLOP (0.027 ms at a third of the 494.7 TFLOP/s TF32 rate: the
// products are float32-exact 3xTF32, mma_tf32.cuh) against 141 MB (0.042
// ms at 3.35 TB/s).  The reference contracts in full float32, so plain
// TF32 (about three decimal digits) is not used.
//
// What the design does about it:
//  * the Pallas grid formed the whole [L, L] score matrix of a (batch, head
//    tile) in VMEM; here one block of 256 threads owns (b', a 64-row query
//    tile i, a group of 8 heads (fewer where the grid would leave SMs
//    idle), 64 columns of P) and walks the 64-key
//    tiles j <= i, so the causal upper half is never formed and nothing
//    carries between blocks;
//  * S = C_i B_j^T is formed first for every key tile j <= i (3xTF32
//    mma.sync, N in steps of 64) and kept in shared memory in the mma
//    accumulator's own layout, so the 8 heads share it and each thread
//    reads back exactly the scores it weighs;
//  * per head and key tile, each thread turns its 16 scores into weights
//    W = S E dt_j in registers and splits them into the A fragments of
//    y_i += W x_j with no trip through shared memory (the product orders
//    its k dimension as the accumulator holds it; x_j's rows are read in
//    the same order), so a warp sums its 32 keys and the two key halves
//    meet once per head;
//  * x_j tiles come by cp.async, double buffered, the next one loading
//    while the current one is used; bf16 tiles stay bf16 in shared memory
//    (exact in TF32, so their products take one or two mma, not three);
//  * query tiles that see the most keys launch first, so the last wave is
//    the light one;
//  * ragged L, H, P and N are masked in the kernel (zero-filled tiles, no
//    store past an edge);
//  * the scores of a query tile against at most 4 key tiles (256
//    positions, a whole chunk at the configurations' 256 and 32) live in
//    shared memory at once; a query tile that sees more keys walks them in
//    such windows, its y partials over the windows summed in a float32
//    workspace in window order (each thread adds only what it wrote), so
//    any chunk length is taken;
//  * 103 KB of dynamic shared memory: two blocks per SM.
// Not yet: TMA or wgmma, S shared across query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kT = 64;            // rows of a query / key tile, P columns
constexpr int kHG = 8;            // heads per block (fewer on small grids)
constexpr int kMaxIT = 4;         // key tiles whose scores a block keeps
constexpr int kWin = kMaxIT * kT; // positions of such a window
constexpr int kThreads = 256;
constexpr int kFrag = kT * kT;    // one 64 x 64 tile in accumulator order
// row strides of a shared tile: float32 68 and bf16 72 elements keep the
// fragment reads conflict-free; every tile slot is sized for float32
template <typename T>
constexpr int kLd = std::is_same<T, float>::value ? 68 : 72;
constexpr int kSlotFloats = kT * 68;
constexpr float kLog2e = 1.4426950408889634f;

// the S cache, two tile slots, cs of the query tile and of the window's
// keys and dt of those keys (two of each: one per head of a pair)
constexpr size_t kSmemBytes =
    (kMaxIT * kFrag + 2 * kSlotFloats + 2 * (kT + 2 * kWin)) * sizeof(float);

// kWindows: L > kWin, so a query tile may see more than one window of keys
// (without it the carry through acc_y compiles away)
template <typename T, bool kWindows>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_tc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cs, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ acc_y, int L, int H, int P, int N,
                    int n_pt, int hg, bool vec_x, bool vec_n) {
  // bf16 operands are exact in TF32: their products need no split
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = kLd<T>;
  extern __shared__ __align__(16) float smem[];
  float* Sc = smem;                                  // [kMaxIT][kFrag]
  auto slot = [&](int s) {                           // [2][kT][LD]
    return reinterpret_cast<T*>(Sc + kMaxIT * kFrag + s * kSlotFloats);
  };
  // [2][kT + kWin]: the query tile's cs, then the window keys'
  float* csv = Sc + kMaxIT * kFrag + 2 * kSlotFloats;
  float* dtv = csv + 2 * (kT + kWin);                  // [2][kWin]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // a warp's share of a 64 x 64 tile of S or W: rows i from m0, keys j
  // from n0
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = wm * 16, n0 = wn * 32;
  const int grp = blockIdx.x / n_pt, pt = blockIdx.x % n_pt;
  const long long b = blockIdx.y;
  const int n_it = (L + kT - 1) / kT;
  const int it = n_it - 1 - blockIdx.z;    // heaviest query tiles first
  const int n_jh = it + 1;                 // key tiles j <= i
  const int h0 = grp * hg, nh = min(hg, H - h0);
  const int i0 = it * kT, p0 = pt * kT;
  const long long xrow = (long long)H * P;

  const int n_win = kWindows ? (n_jh + kMaxIT - 1) / kMaxIT : 1;
  for (int w = 0; w < n_win; ++w) {
    const int jw = w * kMaxIT, n_jw = min(kMaxIT, n_jh - jw);
    const int w0 = jw * kT;                // the window's first key

    // ---- S[i, j] for the window's key tiles (C_i and B_j in the slots)
    float acc[4][4];
    for (int t = 0; t < n_jw; ++t) {
      const int jt = jw + t;
      zero(acc);
      for (int c0 = 0; c0 < N; c0 += kT) {
        load_tile<kT, kT, LD, kThreads>(slot(0), Cm + (b * L + i0) * N + c0,
                                        N, L - i0, N - c0, vec_n, tid);
        load_tile<kT, kT, LD, kThreads>(slot(1),
                                        Bm + (b * L + jt * kT) * N + c0, N,
                                        L - jt * kT, N - c0, vec_n, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        warp_mma<4, 8, false, false, kF32, kF32>(acc, slot(0), LD, slot(1),
                                                 LD, m0, n0, g, tq);
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          Sc[t * kFrag + (nt * 4 + r) * kThreads + tid] = acc[nt][r];
    }

    // ---- per head h of the group, per key tile j of the window
    auto load_item = [&](int k) {          // x_j; cs and dt at t = 0
      const int hh = k / n_jw, jt = jw + k % n_jw, gh = h0 + hh;
      load_tile<kT, kT, LD, kThreads>(
          slot(k & 1), x + ((b * L + jt * kT) * H + gh) * P + p0, xrow,
          L - jt * kT, P - p0, vec_x, tid);
      if (jt == jw) {
        const float* c = cs + b * L * H + gh;
        const float* d = dt + b * L * H + gh;
        float* cv = csv + (hh & 1) * (kT + kWin);
        float* dv = dtv + (hh & 1) * kWin;
        for (int e = tid; e < kT + kWin; e += kThreads) {
          const int gp = e < kT ? i0 + e : w0 + e - kT;
          cp_async4(cv + e, gp < L ? c + gp * H : c, gp < L);
          if (e >= kT)
            cp_async4(dv + e - kT, gp < L ? d + gp * H : d, gp < L);
        }
      }
      cp_async_commit();
    };
    float yp[8][4];                        // y_i over this warp's 32 keys
    zero(yp);
    const int n_items = nh * n_jw;
    load_item(0);
    for (int k = 0; k < n_items; ++k) {
      const int hh = k / n_jw, t = k % n_jw, gh = h0 + hh;
      const int jt = jw + t, j0 = jt * kT;
      if (k + 1 < n_items) {
        load_item(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                     // item k's tiles have landed
      const T* xt = slot(k & 1);
      // cs of the query rows, then of the window's keys (key gj at
      // kT + gj - w0), and dt of those keys (gj at gj - w0)
      const float* c = csv + (hh & 1) * (kT + kWin);
      const float* d = dtv + (hh & 1) * kWin;

      // W = S E dt_j, split into dx-style A fragments: k-step nt holds keys
      // n0 + 8nt + 2tq (slots tq) and + 1 (slots tq + 4)
      uint32_t wb[4][4], ws[4][4];
      float ci[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) ci[h2] = c[m0 + g + 8 * h2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int gj = j0 + n0 + nt * 8 + 2 * tq + cc;
          const float cj = c[kT + gj - w0], dtj = d[gj - w0];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = 2 * h2 + cc, gi = i0 + m0 + g + 8 * h2;
            const float e = (gj <= gi && gi < L)
                                ? exp2f((ci[h2] - cj) * kLog2e) : 0.f;
            const float w =
                Sc[t * kFrag + (nt * 4 + r) * kThreads + tid] * e * dtj;
            split_tf32<true>(w, wb[nt][h2 + 2 * cc], ws[nt][h2 + 2 * cc]);
          }
        }
      // y_i += W x_j: k-step ks reads x rows n0 + 8ks + 2tq and + 1,
      // columns 8pn + g
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          const T* q = xt + (n0 + ks * 8 + 2 * tq) * LD + pn * 8 + g;
          uint2 b0, b1;
          split_tf32<kF32>(to_f32(q[0]), b0.x, b0.y);
          split_tf32<kF32>(to_f32(q[LD]), b1.x, b1.y);
          mma3<true, kF32>(yp[pn], wb[ks], ws[ks], b0, b1);
        }

      if (t == n_jw - 1) {                 // the head's last key tile here
        __syncthreads();                   // every warp is done with xt
        float* other = reinterpret_cast<float*>(slot(k & 1));  // [kT][68]
        if (wn == 1) {
#pragma unroll
          for (int pn = 0; pn < 8; ++pn)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              other[(m0 + g + 8 * (r >> 1)) * 68 + pn * 8 + 2 * tq +
                    (r & 1)] = yp[pn][r];
        }
        __syncthreads();
        if (wn == 0) {
#pragma unroll
          for (int pn = 0; pn < 8; ++pn)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int il = m0 + g + 8 * (r >> 1);
              const int pl = pn * 8 + 2 * tq + (r & 1);
              if (i0 + il < L && p0 + pl < P) {
                const long long o = ((b * L + i0 + il) * H + gh) * P + p0 + pl;
                float v = yp[pn][r] + other[il * 68 + pl];
                // windows before the last leave their partial in acc_y
                if (w > 0) v += acc_y[o];
                if (w + 1 < n_win)
                  acc_y[o] = v;
                else
                  y[o] = from_f32<T>(v);
              }
            }
        }
        zero(yp);
      }
      __syncthreads();                     // the item's slot is free
    }
  }
}

template <typename T, bool kWindows>
int launch(const void* x, const void* dt, const void* cs, const void* Bm,
           const void* Cm, void* y, float* acc_y, int Bp, int L, int H,
           int P, int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc_kernel<T, kWindows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kPer = 16 / sizeof(T);     // elements of a 16-byte copy
  auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec_x = P % kPer == 0 && a16(x);
  const bool vec_n = N % kPer == 0 && a16(Bm) && a16(Cm);
  const int n_pt = (P + kT - 1) / kT, n_it = (L + kT - 1) / kT;
  const int hg = heads_per_block((long long)Bp * n_it * n_pt, H, kHG);
  dim3 grid(((H + hg - 1) / hg) * n_pt, Bp, n_it);
  ssd_chunk_tc_kernel<T, kWindows><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cs), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), acc_y, L, H, P, N,
      n_pt, hg, vec_x, vec_n);
  return (int)cudaGetLastError();
}

bool valid(int Bp, int L, int H, int P, int N) {
  return Bp > 0 && Bp <= 65535 && L > 0 && H > 0 && P > 0 && N > 0 &&
         (L + kT - 1) / kT <= 65535;      // grid.z
}

}  // namespace

// Float32 workspace the forward needs for these sizes: y's partials where
// a query tile sees more than one window of keys (L > 256), else 0; -1 for
// sizes it does not take.
extern "C" long long repro_ssd_chunk_workspace(int Bp, int L, int H, int P,
                                               int N) {
  if (!valid(Bp, L, H, P, N)) return -1;
  return L > kWin ? (long long)Bp * L * H * P : 0;
}

// x, y: [Bp, L, H, P]; dt, cs: [Bp, L, H] float32; Bm, Cm: [Bp, L, N];
// ws: repro_ssd_chunk_workspace floats (null when 0); all contiguous.
// is_bf16 selects bfloat16 (else float32) for x, Bm, Cm and y.  Returns
// the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* cs,
                               const void* Bm, const void* Cm, void* y,
                               void* ws, int Bp, int L, int H, int P, int N,
                               int is_bf16, void* stream) {
  if (!valid(Bp, L, H, P, N) || (L > kWin && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  auto go = [&](auto run) { return run(x, dt, cs, Bm, Cm, y, w, Bp, L, H, P,
                                       N, s); };
  if (is_bf16)
    return L > kWin ? go(launch<__nv_bfloat16, true>)
                    : go(launch<__nv_bfloat16, false>);
  return L > kWin ? go(launch<float, true>) : go(launch<float, false>);
}
