// Backward of the Mamba2 SSD intra-chunk block for Hopper (sm_90a).  The
// reference has no backward kernel (JAX differentiates the einsums of
// repro/kernels/ssd_chunk/ref.py); this is the gradient of the port of
// repro/kernels/ssd_chunk/kernel.py::ssd_chunk (csrc/ssd_chunk.cu).
//
// What it computes: for y = ssd_chunk(x, dt, cs, Bm, Cm) and the upstream
// gradient dy [B', L, H, P], with S = C_i . B_j, E = exp(cs_i - cs_j) for
// j <= i (else 0), W = S E dt_j and G = dy_i . x_j per head,
//
//   dx_j  = sum_{i >= j} W[i, j] dy_i       ddt_j = sum_i G S E
//   dS    = sum_h G E dt_j                  dC = dS B,  dB = dS^T C
//   Q     = G W,   dcs_k = sum_j Q[k, j] - sum_i Q[i, k]
//
// in float32, each grad written in its input's dtype (the plain version is
// kernels/ssd_chunk/ref.py::ssd_chunk_bwd_plain; kernels/ssd_chunk/tiled.py
// follows this file's schedule step for step in plain PyTorch).
//
// What bounds it on this card: bytes, narrowly.  At the training path's
// shape (B' = 16 chunks of L = 256, H = 64, P = 64, N = 128, float32) the
// inputs and grads are 214 MB (0.064 ms at 3.35 TB/s) and the causal half
// needs B' L(L+1)/2 (6N + 4HP) = 9.0e9 FLOP (0.055 ms at a third of the
// 494.7 TFLOP/s TF32 rate: float32-exact 3xTF32 products, mma_tf32.cuh).
// mma.sync reaches about a quarter of that rate here, so the products set
// the time.
//
// What the design does about it:
//  * kernel 1 (ssd_bwd_tile_kernel): one block of 256 threads per (b', a
//    64-key tile j, a group of 8 heads (fewer where the grid would leave
//    SMs idle), 64 columns of P).  It first forms
//    S for every query tile i >= j (N in steps of 64, cp.async double
//    buffered) and keeps it in shared memory in the mma accumulator's own
//    layout, so each thread reads back exactly the scores it will weigh:
//    S is formed once for the 8 heads.  Then, per head and per query tile
//    (dy tiles double buffered by cp.async, the head's x tile fetched with
//    its first query tile): G = dy_i x_j^T on 3xTF32 mma; E, W, ddt's and
//    dcs's column and row sums, and the head's share of dS (accumulated
//    over the group in shared memory) from G in registers; W goes through
//    shared memory once, and dx_j += W^T dy_i on 3xTF32 mma accumulates in
//    registers until the head's last query tile.  Only the causal half of
//    the tile pairs exists: the upper half is never formed;
//  * no atomics: ddt's and dcs's column sums are complete in one block;
//    the row sums of Q (one per query row, head and key tile), the group's
//    dS and, for P > 64, each column tile's share of everything linear in
//    G go to a workspace, and kernel 2 (ssd_bwd_finish_kernel) adds them
//    in a fixed order and forms dC_i = sum_j dS_ij B_j and dB_j = sum_i
//    dS_ij^T C_i on 3xTF32 mma.  The grads are the same bits every call;
//  * key tiles that see the most query tiles launch first, so the last
//    wave is the light one;
//  * ragged L, H, P and N are masked in the kernel (zero-filled tiles, no
//    store past an edge);
//  * the scores of a key tile against at most 4 query tiles (256
//    positions, a whole chunk at the configurations' 256 and 32) live in
//    shared memory at once; a longer chunk takes one launch of kernel 1
//    per such window of query tiles, in order, and what a head sums over
//    query tiles (dx_j, ddt's and Q's column sums) is carried from window
//    to window in float32 workspace, added in window order by the thread
//    that wrote it, so any chunk length is taken (a loop over windows
//    inside the kernel ran slower at one window: its registers grew);
//  * about 220 KB of dynamic shared memory: one block per SM.
// Not yet: TMA or wgmma, a split of the operands done once per tile in
// place of once per fragment, skipping the zero k-steps of diagonal
// tiles, and a double-buffered kernel 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kT = 64;            // rows of a query / key tile, P columns
constexpr int kHG = 8;            // heads per block (fewer on small grids)
constexpr int kMaxIT = 4;         // query tiles whose scores a block keeps
constexpr int kWin = kMaxIT * kT; // rows of such a window
constexpr int kThreads = 256;
constexpr int kLdA = 68;          // tiles read as [row][k]: conflict-free
constexpr int kLdW = 72;          // tiles read as [k][row]: conflict-free
constexpr int kTileA = kT * kLdA;
constexpr int kTileW = kT * kLdW;
constexpr int kFrag = kT * kT;    // one 64 x 64 tile in accumulator order

constexpr float kLog2e = 1.4426950408889634f;

// kernel 1: the S and dS caches, x_j and dy_i (two each), W, cs of the
// key tile and the window (two), dt_j (two) and the reductions' exchange
constexpr size_t kSmemFloats = 2 * kMaxIT * kFrag + 4 * kTileA + kTileW +
                               2 * (kT + kWin) + 2 * kT + 2 * kT +
                               2 * 4 * kT;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
// kernel 2: a dS tile and a 64-column tile of B or C
constexpr size_t kSmemFinish = 2 * kTileW * sizeof(float);

// a 64 x 64 tile of rows x cols of src into float32 dst [64][LD]
template <int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int cols, bool vec, int tid) {
  load_tile<kT, kT, LD, kThreads>(dst, src, stride, rows, cols, vec, tid);
}

// kWindows: L > kWin, so a key tile may be seen by more than one window of
// query tiles, one launch each (without it the carry through the workspace
// compiles away)
template <typename T, bool kWindows>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tile_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cs, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dx_part,
                    float* __restrict__ ddt_part,
                    float* __restrict__ col_part,
                    float* __restrict__ row_part,
                    float* __restrict__ dS_part, int Bp, int L, int H, int P,
                    int N, int n_pt, int hg, int win, bool vec_x,
                    bool vec_n) {
  // bf16 operands are exact in TF32: their products need no split
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* Sc = smem;                        // [kMaxIT][kFrag] scores
  float* dSc = Sc + kMaxIT * kFrag;        // [kMaxIT][kFrag] the group's dS
  float* xs = dSc + kMaxIT * kFrag;        // [2][kTileA] x_j (B_j in S)
  float* dys = xs + 2 * kTileA;            // [2][kTileA] dy_i (C_i in S)
  float* Ws = dys + 2 * kTileA;            // [kT][kLdW] W[i][j]
  // [2][kT + kWin] the head's cs: the key tile's, then the window's rows
  float* csv = Ws + kTileW;
  float* dtv = csv + 2 * (kT + kWin);      // [2][kT] the head's dt_j
  float* redr = dtv + 2 * kT;              // [2][kT] row sums of Q
  float* redc = redr + 2 * kT;             // [2][4][kT] ddt, column sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // a warp's share of a 64 x 64 product: 16 rows from m0, 32 from n0
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = wm * 16, n0 = wn * 32;
  const int grp = blockIdx.x / n_pt, pt = blockIdx.x % n_pt;
  const int n_grp = gridDim.x / n_pt;
  const long long b = blockIdx.y;
  const int jt = blockIdx.z;               // key tile 0 sees the most rows
  const int n_it = (L + kT - 1) / kT;
  const int n_ih = n_it - jt;              // query tiles it >= jt
  const int h0 = grp * hg, nh = min(hg, H - h0);
  const int j0 = jt * kT, p0 = pt * kT, pcols = min(kT, P - p0);
  const int n_nc = (N + kT - 1) / kT;
  const long long xrow = (long long)H * P;

  // launch `win` takes that window of the key tile's query tiles (tiles
  // jt + 4 win on); key tiles with fewer windows are not in its grid
  const int n_win = kWindows ? (n_ih + kMaxIT - 1) / kMaxIT : 1;
  const int tw = win * kMaxIT, n_tw = min(kMaxIT, n_ih - tw);
  const int w0 = (jt + tw) * kT;           // the window's first query row

  // ---- S[i, j] for the window's query tiles, in accumulator order
  auto load_s = [&](int k) {
    const int t = k / n_nc, c0 = (k % n_nc) * kT, i0 = w0 + t * kT;
    load_tile<kLdA>(dys + (k & 1) * kTileA, Cm + (b * L + i0) * N + c0, N,
                    L - i0, N - c0, vec_n, tid);
    load_tile<kLdA>(xs + (k & 1) * kTileA, Bm + (b * L + j0) * N + c0, N,
                    L - j0, N - c0, vec_n, tid);
    cp_async_commit();
  };
  float acc[4][4];
  zero(acc);
  const int n_s = n_tw * n_nc;
  load_s(0);
  for (int k = 0; k < n_s; ++k) {
    if (k + 1 < n_s) {
      load_s(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma<4, 8, false, false, kF32, kF32>(acc, dys + (k & 1) * kTileA,
                                             kLdA, xs + (k & 1) * kTileA,
                                             kLdA, m0, n0, g, tq);
    if (k % n_nc == n_nc - 1) {
      const int t = k / n_nc;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int f = t * kFrag + (nt * 4 + r) * kThreads + tid;
          Sc[f] = acc[nt][r];
          dSc[f] = 0.f;
        }
      zero(acc);
    }
    __syncthreads();
  }

  // ---- per head h of the group, per query tile i of the window
  auto load_item = [&](int k) {
    const int hh = k / n_tw, t = k % n_tw, gh = h0 + hh;
    const int i0 = w0 + t * kT;
    load_tile<kLdA>(dys + (k & 1) * kTileA, dy + ((b * L + i0) * H + gh) *
                    P + p0, xrow, L - i0, pcols, vec_x, tid);
    if (t == 0) {                        // the head's first tile here
      load_tile<kLdA>(xs + (hh & 1) * kTileA, x + ((b * L + j0) * H + gh) *
                      P + p0, xrow, L - j0, pcols, vec_x, tid);
      const float* src = cs + b * L * H + gh;
      for (int e = tid; e < kT + kWin; e += kThreads) {
        const int gp = e < kT ? j0 + e : w0 + e - kT;
        cp_async4(csv + (hh & 1) * (kT + kWin) + e,
                  gp < L ? src + gp * H : src, gp < L);
      }
      src = dt + (b * L + j0) * H + gh;
      for (int e = tid; e < kT; e += kThreads)
        cp_async4(dtv + (hh & 1) * kT + e, j0 + e < L ? src + e * H : src,
                  j0 + e < L);
    }
    cp_async_commit();
  };
  float dxa[4][4], cdd[4][2], cq[4][2];
  zero(dxa);
  zero(cdd);
  zero(cq);
  const int n_items = nh * n_tw;
  load_item(0);
  for (int k = 0; k < n_items; ++k) {
    const int hh = k / n_tw, t = k % n_tw, gh = h0 + hh;
    const int i0 = w0 + t * kT;
    if (k + 1 < n_items) {
      load_item(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* dyt = dys + (k & 1) * kTileA;
    // cs of the key tile's rows, then of the window's (row gi at kT +
    // gi - w0)
    const float* c = csv + (hh & 1) * (kT + kWin);
    const float* d = dtv + (hh & 1) * kT;

    float ga[4][4];                      // G = dy_i x_j^T
    zero(ga);
    warp_mma<4, 8, false, false, kF32, kF32>(ga, dyt, kLdA,
                                             xs + (hh & 1) * kTileA, kLdA,
                                             m0, n0, g, tq);
    float ci[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ci[r] = c[kT + i0 - w0 + m0 + g + 8 * r];
    float rq[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jl = n0 + nt * 8 + 2 * tq + cc, gj = j0 + jl;
        const float cj = c[jl], dtj = d[jl];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = 2 * h2 + cc, il = m0 + g + 8 * h2, gi = i0 + il;
          const int f = t * kFrag + (nt * 4 + r) * kThreads + tid;
          const float e = (gj <= gi && gi < L)
                              ? exp2f((ci[h2] - cj) * kLog2e) : 0.f;
          const float sv = Sc[f], ge = ga[nt][r] * e;
          const float w = sv * e * dtj;
          cdd[nt][cc] += ge * sv;
          dSc[f] += ge * dtj;
          const float q = ga[nt][r] * w;
          rq[h2] += q;
          cq[nt][cc] += q;
          Ws[il * kLdW + jl] = w;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rq[r] += __shfl_xor_sync(0xffffffffu, rq[r], 1);
      rq[r] += __shfl_xor_sync(0xffffffffu, rq[r], 2);
    }
    if (tq == 0) {
      redr[wn * kT + m0 + g] = rq[0];
      redr[wn * kT + m0 + g + 8] = rq[1];
    }
    __syncthreads();                     // W and the row sums are whole
    if (tid < kT && i0 + tid < L)
      row_part[(((pt * Bp + b) * L + i0 + tid) * H + gh) * n_it + jt] =
          redr[tid] + redr[kT + tid];
    // dx_j += W^T dy_i: rows j from m0, columns p from n0
    warp_mma<4, 8, true, true, true, kF32>(dxa, Ws, kLdW, dyt, kLdA, m0,
                                           n0, g, tq);

    if (t == n_tw - 1) {                 // the head's last tile here
      // windows before the last leave their partial in dx_part
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gj = j0 + m0 + g + 8 * (r >> 1);
          const int gp = p0 + n0 + nt * 8 + 2 * tq + (r & 1);
          if (gj < L && gp < P) {
            const long long o = ((b * L + gj) * H + gh) * P + gp;
            const float v = win > 0 ? dxa[nt][r] + dx_part[o] : dxa[nt][r];
            if (win + 1 < n_win)
              dx_part[o] = v;
            else
              dx[o] = from_f32<T>(v);
          }
        }
      zero(dxa);
      // column sums over the warp's 16 rows, then over the 4 row warps
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cdd[nt][cc] += __shfl_xor_sync(0xffffffffu, cdd[nt][cc], off);
            cq[nt][cc] += __shfl_xor_sync(0xffffffffu, cq[nt][cc], off);
          }
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int jl = n0 + nt * 8 + 2 * tq + cc;
            redc[wm * kT + jl] = cdd[nt][cc];
            redc[(4 + wm) * kT + jl] = cq[nt][cc];
          }
      }
      zero(cdd);
      zero(cq);
      __syncthreads();
      if (tid < kT && j0 + tid < L) {
        const long long o = ((pt * Bp + b) * L + j0 + tid) * H + gh;
        float a = redc[tid] + redc[kT + tid] + redc[2 * kT + tid] +
                  redc[3 * kT + tid];
        float csum = redc[4 * kT + tid] + redc[5 * kT + tid] +
                    redc[6 * kT + tid] + redc[7 * kT + tid];
        if (win > 0) {                   // after the earlier windows'
          a += ddt_part[o];
          csum += col_part[o];
        }
        ddt_part[o] = a;
        col_part[o] = csum;
      }
    }
    __syncthreads();                     // the item's buffers are free
  }

  // ---- the group's dS tiles (it, jt) of the window, in accumulator
  // order (each thread writes back only the entries it summed)
  const int q = pt * n_grp + grp;
  for (int t = 0; t < n_tw; ++t) {
    float* dst = dS_part + (((q * Bp + b) * n_it + jt + tw + t) * n_it +
                            jt) * (long long)kFrag;
    for (int e = tid; e < kFrag; e += kThreads)
      dst[e] = dSc[t * kFrag + e];
  }
}

// blockIdx.x = 64-column tile of N, blockIdx.y = role, blockIdx.z = b' *
// n_it + tile.  Role 0: dC over the rows of query tile `tile`; role 1: dB
// over the rows of key tile `tile`; role 2 (column tile 0 only): ddt and
// dcs for the rows of `tile`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ ddt_part,
                      const float* __restrict__ col_part,
                      const float* __restrict__ row_part,
                      const float* __restrict__ dS_part, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ ddt,
                      float* __restrict__ dcs, int Bp, int L, int H, int N,
                      int n_pt, int n_part, bool vec_n) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* ds = smem;                        // [kT][kLdW] dS tile [i][j]
  float* ot = ds + kTileW;                 // [kT][kLdW] B_j or C_i

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const int n_it = (L + kT - 1) / kT;
  const int role = blockIdx.y, c0 = blockIdx.x * kT;
  const int tile = blockIdx.z % n_it, r0 = tile * kT;
  const long long b = blockIdx.z / n_it;

  if (role == 2) {
    if (blockIdx.x != 0) return;
    // 4 (row, head) entries a thread at a time, their loads together
    for (int e0 = tid; e0 < kT * H; e0 += 4 * kThreads) {
      float a[4], rs[4], cc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, gi = r0 + e / H, h = e % H;
        a[u] = rs[u] = cc[u] = 0.f;
        if (e >= kT * H || gi >= L) continue;
        for (int pt = 0; pt < n_pt; ++pt) {
          const long long o = ((pt * Bp + b) * L + gi) * H + h;
          a[u] += ddt_part[o];
          cc[u] += col_part[o];
          for (int jt = 0; jt <= tile; ++jt) rs[u] += row_part[o * n_it + jt];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, gi = r0 + e / H, h = e % H;
        if (e >= kT * H || gi >= L) continue;
        ddt[(b * L + gi) * H + h] = a[u];
        dcs[(b * L + gi) * H + h] = rs[u] - cc[u];
      }
    }
    return;
  }

  const T* op = role == 0 ? Bm : Cm;
  const int ld = role == 0 ? kLdA : kLdW;
  float acc[4][4];
  zero(acc);
  const int k_lo = role == 0 ? 0 : tile, k_hi = role == 0 ? tile : n_it - 1;
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    load_tile<kLdW>(ot, op + (b * L + kt * kT) * N + c0, N, L - kt * kT,
                    N - c0, vec_n, tid);
    cp_async_commit();
    // the dS tile (it, jt): its partials, in kernel 1's accumulator order,
    // added in a fixed order; 16 entries a thread, 4 float4 a partial
    const int it = role == 0 ? tile : kt, jt = role == 0 ? kt : tile;
    float4 v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < n_part; ++q) {
      const float4* part = reinterpret_cast<const float4*>(
          dS_part + (((q * Bp + b) * n_it + it) * n_it + jt) *
                        (long long)kFrag);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 u = part[tid + s * kThreads];
        v[s].x += u.x;
        v[s].y += u.y;
        v[s].z += u.z;
        v[s].w += u.w;
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float vs[4] = {v[s].x, v[s].y, v[s].z, v[s].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // kernel 1's entry f: thread f % 256, accumulator entry f / 256
        const int f = 4 * (tid + s * kThreads) + u, tk = f & 255;
        const int nr = f >> 8, lk = tk & 31, wk = tk >> 5;
        const int i = (wk & 3) * 16 + (lk >> 2) + 8 * ((nr & 3) >> 1);
        const int j = (wk >> 2) * 32 + (nr >> 2) * 8 + 2 * (lk & 3) +
                      (nr & 1);
        ds[i * ld + j] = vs[u];
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (role == 0)       // dC_i += dS_ij B_j
      warp_mma<4, 8, false, true, true, kF32>(acc, ds, kLdA, ot, kLdW, m0,
                                              n0, g, tq);
    else                 // dB_j += dS_ij^T C_i
      warp_mma<4, 8, true, true, true, kF32>(acc, ds, kLdW, ot, kLdW, m0, n0,
                                             g, tq);
    __syncthreads();
  }
  T* out = role == 0 ? dC : dB;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = r0 + m0 + g + 8 * (r >> 1);
      const int gc = c0 + n0 + nt * 8 + 2 * tq + (r & 1);
      if (gr < L && gc < N)
        out[(b * L + gr) * N + gc] = from_f32<T>(acc[nt][r]);
    }
}

struct Plan {
  int n_it, n_pt, hg, n_grp, n_nc;
  long long dS, rows, cols, dx;   // workspace floats of each part
};

Plan plan(int Bp, int L, int H, int P, int N) {
  Plan p;
  p.n_it = (L + kT - 1) / kT;
  p.n_pt = (P + kT - 1) / kT;
  p.hg = heads_per_block((long long)Bp * p.n_it * p.n_pt, H, kHG);
  p.n_grp = (H + p.hg - 1) / p.hg;
  p.n_nc = (N + kT - 1) / kT;
  p.dS = (long long)p.n_pt * p.n_grp * Bp * p.n_it * p.n_it * kFrag;
  p.rows = (long long)p.n_pt * Bp * L * H * p.n_it;
  p.cols = (long long)p.n_pt * Bp * L * H;
  p.dx = L > kWin ? (long long)Bp * L * H * P : 0;
  return p;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kWindows>
int launch(const void* x, const void* dt, const void* cs, const void* Bm,
           const void* Cm, const void* dy, void* dx, void* ddt, void* dcs,
           void* dB, void* dC, float* ws, int Bp, int L, int H, int P, int N,
           cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tile_kernel<T, kWindows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(Bp, L, H, P, N);
  float* dS_part = ws;
  float* row_part = dS_part + p.dS;
  float* col_part = row_part + p.rows;
  float* ddt_part = col_part + p.cols;
  float* dx_part = ddt_part + p.cols;
  const bool vec_x = kF32 && P % 4 == 0 && aligned16(x) && aligned16(dy);
  const bool vec_n = kF32 && N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  err = cudaFuncSetAttribute(ssd_bwd_finish_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemFinish);
  if (err != cudaSuccess) return (int)err;
  // one launch per window of query tiles, in order (a window adds to the
  // partials the one before it left); window w has work for key tiles
  // jt < n_it - 4w
  for (int win = 0; win * kMaxIT < p.n_it; ++win) {
    dim3 grid1(p.n_grp * p.n_pt, Bp, p.n_it - win * kMaxIT);
    ssd_bwd_tile_kernel<T, kWindows><<<grid1, kThreads, kSmemBytes,
                                       stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(cs), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const T*>(dy),
        static_cast<T*>(dx), dx_part, ddt_part, col_part, row_part, dS_part,
        Bp, L, H, P, N, p.n_pt, p.hg, win, vec_x, vec_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid2(p.n_nc, 3, Bp * p.n_it);
  ssd_bwd_finish_kernel<T><<<grid2, kThreads, kSmemFinish, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), ddt_part,
      col_part, row_part, dS_part, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(ddt), static_cast<float*>(dcs), Bp, L, H, N,
      p.n_pt, p.n_pt * p.n_grp, vec_n);
  return (int)cudaGetLastError();
}

bool valid(int Bp, int L, int H, int P, int N) {
  return Bp > 0 && L > 0 && H > 0 && P > 0 && N > 0 &&
         (long long)Bp * ((L + kT - 1) / kT) <= 65535;   // kernel 2's grid.z
}

}  // namespace

// Float32 workspace the backward needs for these sizes (0: sizes it does
// not take).
extern "C" long long repro_ssd_chunk_bwd_workspace(int Bp, int L, int H,
                                                   int P, int N) {
  if (!valid(Bp, L, H, P, N)) return 0;
  const Plan p = plan(Bp, L, H, P, N);
  return p.dS + p.rows + 2 * p.cols + p.dx;
}

// x, dy, dx: [Bp, L, H, P]; dt, cs, ddt, dcs: [Bp, L, H] float32; Bm, Cm,
// dB, dC: [Bp, L, N]; ws: repro_ssd_chunk_bwd_workspace floats; all
// contiguous.  is_bf16 selects bfloat16 (else float32) for x, Bm, Cm, dy
// and their grads.  Returns the first failing cudaError_t of the two
// launches (0 = cudaSuccess).
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* dt,
                                   const void* cs, const void* Bm,
                                   const void* Cm, const void* dy, void* dx,
                                   void* ddt, void* dcs, void* dB, void* dC,
                                   void* ws, int Bp, int L, int H, int P,
                                   int N, int is_bf16, void* stream) {
  if (!valid(Bp, L, H, P, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  auto go = [&](auto run) { return run(x, dt, cs, Bm, Cm, dy, dx, ddt, dcs,
                                       dB, dC, w, Bp, L, H, P, N, s); };
  if (is_bf16)
    return L > kWin ? go(launch<__nv_bfloat16, true>)
                    : go(launch<__nv_bfloat16, false>);
  return L > kWin ? go(launch<float, true>) : go(launch<float, false>);
}
