// K1: the 1-D sweep resampler, forward and backward, for Hopper (sm_90a).
//
// Replaces torchregister_tpu/ops/pallas/sweep.py:_fwd_kernel (the Pallas
// forward) and its XLA backward _sweep_vjp_bwd. Each output element o of a
// row samples the row at a coordinate q, inside the static window [-K, K+1]:
//
//   q0 = floor(q), fr = q - q0, k = q0 - o
//   floor tap src[q0]   counts iff k in [-K,   K+1] and 0 <= q0   < X
//   ceil  tap src[q0+1] counts iff k in [-K-1, K  ] and 0 <= q0+1 < X
//   out  = floor * (1 - fr) + ceil * fr,   diff = ceil - floor
//
// What bounds it on this card: memory bytes. The Pallas kernel sweeps 2K+2
// masked terms per voxel because Mosaic has no per-lane gather; here every
// thread reads its two taps directly, so the cost is O(1) per voxel: a read
// of q and two (mostly cached) reads of src, one write of out (and of diff if
// asked). At the slice's windows (K <= 80) nothing is reused across outputs
// beyond what L1/L2 already catch, so the kernels are plain element-parallel
// loops with no shared-memory staging in the forward.
//
// Layout: the swept axis is viewed in place as [outer, X, inner] (strides of
// a contiguous tensor), so axis 0, 1 and 2 passes of a volume need no
// transpose. Consecutive threads take consecutive inner indices, which keeps
// the loads coalesced for every axis (inner == 1 for the last axis, where
// consecutive threads walk along the row itself).
//
// Backward: dq = g * diff (same masks), and dsrc is the adjoint of the
// two-tap gather: g*(1-fr) is added at q0 and g*fr at q0+1. Several outputs
// of a row hit the same source index, so each block owns a tile of at most
// 32 columns (TO rows x TI inner columns) x X, accumulates it in shared
// memory and writes it once (f32 sums, one rounding to the image dtype).
// No atomics: every sum is taken in one fixed order, so the gradient repeats
// to the bit from run to run. (Atomic adds land in whatever order the
// threads reach them, and the rounding of a float sum depends on its order;
// the U-Net's training amplifies such last-bit differences into different
// plateau stops.) The block walks its rows in chunks of 8 positions: every
// thread loads one element of the chunk (coalesced along inner, or along x
// when inner is 1), writes its dq and stages its two weighted taps in
// shared memory; then one thread per column adds the chunk's taps to its
// column in ascending x, the floor tap before the ceil tap.
//
// diff is recomputed in the backward from src instead of being saved by the
// forward: the backward has to read the tile's taps anyway for the scatter
// positions, re-reading src costs the same bytes as reading a saved diff
// plane, and the forward then writes one plane instead of two and keeps no
// extra full-volume buffer alive per pass between forward and backward.
//
// Images are f32 or bf16 (the matrix stages sweep bf16 images); q, the
// weights and all sums are f32 and the output is rounded once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Tap positions and masks of one output element (shared by both kernels).
struct Taps {
  int xf;     // floor tap index q0 (valid only where mf or mc)
  bool mf;    // floor tap counts
  bool mc;    // ceil tap counts
  float fr;   // fractional weight
};

__device__ __forceinline__ Taps taps_of(float q, int x, int X, int K) {
  Taps t;
  float q0 = floorf(q);
  t.fr = q - q0;
  float k = q0 - (float)x;
  bool in_f = (k >= (float)(-K)) && (k <= (float)(K + 1));
  bool in_c = (k >= (float)(-K - 1)) && (k <= (float)K);
  // k is bounded by the window here, so the int conversion is safe.
  t.xf = (in_f || in_c) ? x + (int)k : -2;
  t.mf = in_f && t.xf >= 0 && t.xf < X;
  t.mc = in_c && t.xf + 1 >= 0 && t.xf + 1 < X;
  return t;
}

template <typename T>
__global__ void sweep_fwd_kernel(const T* __restrict__ src, const float* __restrict__ q,
                                 T* __restrict__ out, float* __restrict__ diff,
                                 long long n, int X, long long inner, int K) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    long long i = e % inner;
    long long ox = e / inner;          // o * X + x
    int x = (int)(ox % X);
    long long row = ox - x;            // o * X
    Taps t = taps_of(q[e], x, X, K);
    float vf = t.mf ? load_f(src, (row + t.xf) * inner + i) : 0.0f;
    float vc = t.mc ? load_f(src, (row + t.xf + 1) * inner + i) : 0.0f;
    // Masked products rather than vf*(1-fr)+vc*fr on zeros: a NaN
    // coordinate gives 0 like the reference sweep, not NaN.
    float o = (t.mf ? vf * (1.0f - t.fr) : 0.0f) + (t.mc ? vc * t.fr : 0.0f);
    store_f(out, e, o);
    if (diff) diff[e] = vc - vf;
  }
}

constexpr int kThreads = 256;
constexpr int kCols = 32;                 // columns of a backward tile
constexpr int kChunk = kThreads / kCols;  // positions of each column per chunk

template <typename T>
__global__ void sweep_bwd_kernel(const T* __restrict__ g, const T* __restrict__ src,
                                 const float* __restrict__ q, T* __restrict__ dsrc,
                                 float* __restrict__ dq, long long outer, int X,
                                 long long inner, int K, int TO, int TI, int XP) {
  extern __shared__ float acc[];  // [TO][XP][TI], rows padded to XP >= X
  __shared__ int s_f[kThreads], s_c[kThreads];      // tap positions, -1: none
  __shared__ float s_wf[kThreads], s_wc[kThreads];  // weighted taps
  const long long n_inner_tiles = (inner + TI - 1) / TI;
  const long long o0 = (long long)(blockIdx.x / n_inner_tiles) * TO;
  const long long i0 = (long long)(blockIdx.x % n_inner_tiles) * TI;
  const int tid = threadIdx.x;
  if (dsrc)
    for (int e = tid; e < TO * XP * TI; e += blockDim.x) acc[e] = 0.0f;
  // this thread's element of each chunk: column (to, ti), position x0 + xl
  const int ti = tid % TI;
  const int xl = (tid / TI) % kChunk;
  const int to = tid / (TI * kChunk);
  const long long o = o0 + to, i = i0 + ti;
  const bool staged = to < TO;  // its slot xl * kCols + col exists
  const bool live = staged && o < outer && i < inner;
  const int col = to * TI + ti;
  // the column this thread adds, if tid < TO * TI
  const bool adder = tid < TO * TI && o0 + tid / TI < outer && i0 + tid % TI < inner;
  float* column = acc + (tid / TI) * XP * TI + tid % TI;
  for (int x0 = 0; x0 < X; x0 += kChunk) {
    const int x = x0 + xl;
    int f = -1, c = -1;
    float wf = 0.0f, wc = 0.0f;
    if (live && x < X) {
      const long long row = o * X;
      const long long idx = (row + x) * inner + i;
      const Taps t = taps_of(q[idx], x, X, K);
      const float gv = load_f(g, idx);
      if (t.mf) { f = t.xf; wf = gv * (1.0f - t.fr); }
      if (t.mc) { c = t.xf + 1; wc = gv * t.fr; }
      if (dq) {
        float vf = t.mf ? load_f(src, (row + t.xf) * inner + i) : 0.0f;
        float vc = t.mc ? load_f(src, (row + t.xf + 1) * inner + i) : 0.0f;
        dq[idx] = gv * (vc - vf);
      }
    }
    if (!dsrc) continue;
    __syncthreads();  // acc zeroed; the previous chunk's stage consumed
    if (staged) {
      const int slot = xl * kCols + col;
      s_f[slot] = f; s_c[slot] = c; s_wf[slot] = wf; s_wc[slot] = wc;
    }
    __syncthreads();
    if (adder) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int slot = k * kCols + tid;
        const int ff = s_f[slot], cc = s_c[slot];
        if (ff >= 0) column[ff * TI] += s_wf[slot];
        if (cc >= 0) column[cc * TI] += s_wc[slot];
      }
    }
  }
  if (!dsrc) return;
  __syncthreads();
  for (int e = tid; e < TO * X * TI; e += blockDim.x) {
    const int ei = e % TI;
    const int ex = (e / TI) % X;
    const int eo = e / (TI * X);
    const long long oo = o0 + eo, ii = i0 + ei;
    if (oo >= outer || ii >= inner) continue;
    store_f(dsrc, (oo * X + ex) * inner + ii, acc[(eo * XP + ex) * TI + ei]);
  }
}

// the backward's dynamic tile: with the 4 KB static stage it stays under the
// 48 KB a block may use without the opt-in attribute
constexpr int kAccBytes = 44 * 1024;

int fwd_grid(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
int launch_fwd(const void* src, const void* q, void* out, void* diff, long long outer,
               int X, long long inner, int K, cudaStream_t stream) {
  long long n = outer * X * inner;
  if (n == 0) return 0;
  sweep_fwd_kernel<T><<<fwd_grid(n), kThreads, 0, stream>>>(
      (const T*)src, (const float*)q, (T*)out, (float*)diff, n, X, inner, K);
  return (int)cudaGetLastError();
}

// Row pitch of the backward's shared tile: odd when a warp's adders span
// several rows (TI < 32), so their columns fall in different banks.
int bwd_pitch(int X, int TI) { return TI >= kCols ? X : (X | 1); }

template <typename T>
int launch_bwd(const void* g, const void* src, const void* q, void* dsrc, void* dq,
               long long outer, int X, long long inner, int K, cudaStream_t stream) {
  if (outer * X * inner == 0) return 0;
  // Tile: up to 32 inner columns (coalesced along inner); rows fill the rest
  // of the 32 columns when inner is narrow (inner == 1 for the last axis).
  int TI = inner < kCols ? (int)inner : kCols;
  int TO = kCols / TI;
  if ((long long)TO > outer) TO = (int)outer;
  auto bytes = [&]() { return (long long)TO * TI * bwd_pitch(X, TI) * 4; };
  while (TO > 1 && bytes() > kAccBytes) TO /= 2;
  while (TI > 1 && bytes() > kAccBytes) TI /= 2;
  if (bytes() > kAccBytes) return (int)cudaErrorInvalidValue;
  long long tiles = ((outer + TO - 1) / TO) * ((inner + TI - 1) / TI);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_bwd_kernel<T><<<(unsigned)tiles, kThreads, dsrc ? (size_t)bytes() : 0, stream>>>(
      (const T*)g, (const T*)src, (const float*)q, (T*)dsrc, (float*)dq, outer, X,
      inner, K, TO, TI, bwd_pitch(X, TI));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16
// for src/out/g/dsrc; q, diff and dq are always float32. diff, dsrc and dq
// may be null to skip that output. Returns cudaGetLastError() after launch.
extern "C" int sweep_fwd(const void* src, const void* q, void* out, void* diff,
                         long long outer, int X, long long inner, int K, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(src, q, out, diff, outer, X, inner, K, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(src, q, out, diff, outer, X, inner, K, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sweep_bwd(const void* g, const void* src, const void* q, void* dsrc,
                         void* dq, long long outer, int X, long long inner, int K,
                         int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd<float>(g, src, q, dsrc, dq, outer, X, inner, K, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, src, q, dsrc, dq, outer, X, inner, K, s);
  return (int)cudaErrorInvalidValue;
}
