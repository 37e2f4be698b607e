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
// What bounds it on this card: operations.  The causal half does
// B' * L(L+1)/2 * (2N + 2HP) FLOP against about 2 * B'LHP words of x in and
// y out: at the training path's shape (B' = 16 chunks of L = 256, H = 64,
// P = 64, N = 128, float32) that is 4.45e9 FLOP (0.066 ms at 67 TFLOP/s of
// float32 FMA) against 141 MB (0.042 ms at 3.35 TB/s).  The path is
// float32, so the tensor cores' TF32 (about three decimal digits) is not
// used: the reference contracts in full float32.
//
// What the design does about it:
//  * the Pallas grid formed the whole [L, L] score matrix of a (batch, head
//    tile) in VMEM; here one block of 256 threads owns (b', a 64-row query
//    tile, a group of 4 heads, 64 columns of P) and walks the 64-key tiles
//    j <= i in a loop, so the causal upper half is never computed and
//    nothing carries between blocks;
//  * S = C_i B_j^T is formed once per key tile, in registers (4 x 4 per
//    thread, N in steps of 32 through shared memory), and reused by the
//    four heads: each thread turns its 16 scores into 64 weights (one exp
//    each) written to shared memory;
//  * the per-head contraction w @ x_j keeps an 8 x 8 float32 accumulator
//    per thread (rows and columns in two float4 halves, so shared-memory
//    reads are conflict-free 128-bit loads): 64 FMAs per four loads;
//  * query tiles that see the most keys launch first, so the last wave is
//    the light one;
//  * ragged L, H, P and N are masked in the kernel (zero-filled tiles, no
//    store past an edge), so any shape runs; the Pallas h_tile | H
//    restriction does not carry over;
//  * about 163 KB of dynamic shared memory: one block per SM.
// Not yet: TF32/3xTF32 mma, TMA-fed or double-buffered tiles, sharing S
// across more heads; the backward is plain PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kHG = 4;           // heads per block
constexpr int kPT = 64;          // head-dim columns per block
constexpr int kNC = 32;          // state columns per step of S
constexpr int kThreads = 256;
constexpr int kLdT = kBQ + 1;    // C/B tiles, stored [n][row]: conflict-free
constexpr int kLdW = kBQ + 16;   // weights [h][j][i]: conflict-free stores
constexpr int kLdX = kPT;        // x tile [h][j][p]

constexpr size_t kSmemFloats = 2 * kNC * kLdT + kHG * kBK * (kLdW + kLdX) +
                               3 * kHG * kBQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cs, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y, int L, int H,
                 int P, int N, int n_ptiles) {
  extern __shared__ __align__(16) float smem[];
  float* cT = smem;                          // [kNC][kLdT]
  float* bT = cT + kNC * kLdT;               // [kNC][kLdT]
  float* wT = bT + kNC * kLdT;               // [kHG][kBK][kLdW]
  float* xs = wT + kHG * kBK * kLdW;         // [kHG][kBK][kLdX]
  float* csq = xs + kHG * kBK * kLdX;        // [kHG][kBQ]
  float* csk = csq + kHG * kBQ;              // [kHG][kBK]
  float* dtk = csk + kHG * kBK;              // [kHG][kBK]

  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;   // heaviest query tiles first
  const int h0 = (blockIdx.x / n_ptiles) * kHG;
  const int p0 = (blockIdx.x % n_ptiles) * kPT;
  const long long b = blockIdx.y;
  const int i0 = qt * kBQ;

  // scores and weights: rows si + 16a, keys sj + 16c (a, c < 4)
  const int si = tid & 15, sj = tid >> 4;
  // contraction: head ch; rows ti*4 + a and 32 + ti*4 + a, columns
  // tp*4 + c and 32 + tp*4 + c
  const int ch = tid >> 6, ti = (tid >> 3) & 7, tp = tid & 7;

  for (int e = tid; e < kHG * kBQ; e += kThreads) {
    const int h = e % kHG, r = e / kHG;
    const int gi = i0 + r, gh = h0 + h;
    csq[h * kBQ + r] =
        (gi < L && gh < H) ? cs[(b * L + gi) * H + gh] : 0.f;
  }

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done

    // x_j for the block's heads and columns, and the key-side cs and dt
    for (int e = tid; e < kHG * kBK * kPT; e += kThreads) {
      const int p = e % kPT, h = (e / kPT) % kHG, j = e / (kPT * kHG);
      const int gj = j0 + j, gh = h0 + h, gp = p0 + p;
      float v = 0.f;
      if (gj < L && gh < H && gp < P)
        v = load(x + ((b * L + gj) * H + gh) * P + gp);
      xs[(h * kBK + j) * kLdX + p] = v;
    }
    for (int e = tid; e < kHG * kBK; e += kThreads) {
      const int h = e % kHG, j = e / kHG;
      const int gj = j0 + j, gh = h0 + h;
      const bool ok = gj < L && gh < H;
      const long long o = (b * L + gj) * H + gh;
      csk[h * kBK + j] = ok ? cs[o] : 0.f;
      dtk[h * kBK + j] = ok ? dt[o] : 0.f;
    }

    // S = C_i B_j^T, 4 x 4 per thread, N in steps of kNC
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNC) {
      __syncthreads();
      for (int e = tid; e < kNC * kBQ; e += kThreads) {
        const int n = e % kNC, r = e / kNC;
        const int gn = n0 + n, gi = i0 + r, gj = j0 + r;
        cT[n * kLdT + r] =
            (gn < N && gi < L) ? load(Cm + (b * L + gi) * N + gn) : 0.f;
        bT[n * kLdT + r] =
            (gn < N && gj < L) ? load(Bm + (b * L + gj) * N + gn) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kNC; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cT[n * kLdT + si + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bT[n * kLdT + sj + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = fmaf(cv[a], bv[c], s[a][c]);
      }
    }

    // w[h, i, j] = S[i, j] * exp(cs_i - cs_j) * dt_j where j <= i < L
#pragma unroll
    for (int h = 0; h < kHG; ++h) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = si + 16 * a, gi = i0 + il;
        const float ci = csq[h * kBQ + il];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = sj + 16 * c, gj = j0 + jl;
          float w = 0.f;
          if (gj <= gi && gi < L)
            w = s[a][c] * expf(ci - csk[h * kBK + jl]) * dtk[h * kBK + jl];
          wT[(h * kBK + jl) * kLdW + il] = w;
        }
      }
    }
    __syncthreads();

    // acc += w_h @ x_j,h for this thread's head
    const float* wh = wT + ch * kBK * kLdW;
    const float* xh = xs + ch * kBK * kLdX;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 w0 = *reinterpret_cast<const float4*>(wh + j * kLdW + ti * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(wh + j * kLdW + 32 + ti * 4);
      const float4 x0 = *reinterpret_cast<const float4*>(xh + j * kLdX + tp * 4);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xh + j * kLdX + 32 + tp * 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
    }
  }

  const int gh = h0 + ch;
  if (gh >= H) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = i0 + (r >> 2) * 32 + ti * 4 + (r & 3);
    if (gi >= L) continue;
    T* row = y + ((b * L + gi) * H + gh) * P;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int gp = p0 + (c >> 2) * 32 + tp * 4 + (c & 3);
      if (gp < P) store(row + gp, acc[r][c]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* cs, const void* Bm,
           const void* Cm, void* y, int Bp, int L, int H, int P, int N,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ptiles = (P + kPT - 1) / kPT;
  dim3 grid(((H + kHG - 1) / kHG) * n_ptiles, Bp, (L + kBQ - 1) / kBQ);
  ssd_chunk_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cs), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), L, H, P, N, n_ptiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [Bp, L, H, P]; dt, cs: [Bp, L, H] float32; Bm, Cm: [Bp, L, N];
// all contiguous.  is_bf16 selects bfloat16 (else float32) for x, Bm, Cm
// and y.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* cs,
                               const void* Bm, const void* Cm, void* y,
                               int Bp, int L, int H, int P, int N,
                               int is_bf16, void* stream) {
  if (Bp <= 0 || Bp > 65535 || L <= 0 || H <= 0 || P <= 0 || N <= 0 ||
      (L + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, cs, Bm, Cm, y, Bp, L, H, P, N, s);
  return launch<float>(x, dt, cs, Bm, Cm, y, Bp, L, H, P, N, s);
}
