// The hat-gather probes' kernels (P1-P5) for Hopper (sm_90a).
//
// Replace the Pallas kernels of benchmarks/probe_hatgather.py, which asked
// whether Mosaic lowers the data-dependent fetches a fused exact-warp kernel
// needs on a TPU (scalar-prefetched block indices, element-granular (z, y)
// starts, bounded slices, an in-kernel slice and restack). Each kernel here
// computes the same function directly; none copies the Pallas blocking.
//
//   block_permute_add  P1 (probe_hatgather.py:34): out row block i = x row
//                      block order[i], plus 1.
//   slab_gather        P2 (:69) and P4 (:222): out[t, z, y, :] =
//                      vol[oz_t + z, oy_t + y, :] for slabs (Bz, By, X).
//   slab_sum           P3 (:131): out[t, r, :] = sum over z < Bz, y < By of
//                      vol[oz_t + z, oy_t + y, :], the same for each r < R.
//   slice_transpose    P5 (:270): out[t, c, r] = slab[dz + r / By,
//                      dy + r % By, ox + c] for r < Bz*By, 0 for r up to L.
//
// Every origin is checked on the host before the launch (the probes' origins
// are host data); the kernels read what they are given.
//
// What bounds them on this card. P1, P2, P4 and P5 move a few MB at most at
// the probes' sizes, so the launch itself (a few microseconds of device time,
// and the host's launch path, see native.Library.launch) is their floor. P3
// is a gather at the exact warp's real size: 13824 slabs of 14 x 16 rows of
// 1 KB from a 240 x 240 x 256 volume (59 MB), which overlap about 54-fold
// (3.17 GB of logical reads). Its bound counts the volume read once and the
// 113 MB output written once; how close it comes shows how much of the
// overlap L2 (50 MB) serves. At a device-bound size the copies are bound by
// their bytes: slab_gather by its output (1728 slabs (14, 16, 256) of a
// 240 x 240 x 256 volume write 396 MB), slice_transpose by its scattered
// 64-byte window reads and its output.
//
// Design. slab_gather: each (slab t, plane z) is one contiguous run of By*X
// floats (a slab spans the whole x extent), so a block row copies one run
// as 16-byte float4 loads and streaming stores whenever X % 4 == 0 and both
// base pointers are 16-byte aligned (then every run starts on a 16-byte
// boundary), float by float otherwise: a choice by shape and address, made
// in the C function. A thread moves four elements when the runs alone give
// the card's 132 SMs a few blocks each, one otherwise (the probes' 84 and 80
// runs), so both sizes fill the card. block_permute_add: one block per row
// block, 1024 threads along the rows, plus 1. slab_sum: one block per slab, one thread per x
// lane, each summing its lane over the slab's rows in a fixed order in f32
// (each z plane's By rows, then the planes), so a run repeats to the bit.
// slice_transpose: the TPU reached the transpose with a one-hot matmul on its
// matrix unit; here a block stages its (Bz*By) x CW window in shared memory
// with scalar reads along x (ox is element-granular, so the reads cannot be
// 16-byte aligned in general), rows padded to CW + 1 floats, then writes each
// output row along r as float4 stores: a warp covers 4 output rows x 32
// consecutive r, each lane gathering 4 consecutive r of one column, so with
// the odd pitch the warp's 32 reads of one step hit 32 distinct banks. The
// zero tail r >= Bz*By goes out as float4 zeros; L % 4 != 0 (or an unaligned
// output) takes scalar stores. A block has 256 threads when the tiles give
// the card kFillBlocks blocks, 1024 when they are fewer (the probe's 4 tiles:
// the window's latency, not the card's rate, holds it), and either is held to
// 2048 threads an SM, 32 registers. Each choice won on the card at its own
// size against the other (PERF.md, Findings; probes/profile_copies.py), as did
// slab_gather's four elements a thread at 1728 slabs and one at the probes'.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 256;        // slab_sum: one thread per x lane (X <= 256 in one pass)
constexpr int kPermuteThreads = 1024;  // block_permute_add: a row block in a few passes
constexpr int kCopyThreads = 256;  // slab_gather's blocks; slice_transpose's on a full card
constexpr int kFewThreads = 1024;  // slice_transpose's blocks when its tiles are few
constexpr int kFillBlocks = 2 * 132;  // two blocks on each of the H100's SMs
// Each choice by size is a macro, so that probes/profile_copies.py can build
// the others and time them against it (PERF.md). slab_gather's elements a
// thread: 0 picks 4 when that still gives kFillBlocks blocks, else 1; 1 or 4
// fixes it. slice_transpose's threads a block: 0 picks kCopyThreads when its
// tiles give kFillBlocks blocks, else kFewThreads; another value fixes it.
// TRANSPOSE_REG_CAP 1 holds slice_transpose to 2048 threads an SM (32
// registers), 0 leaves its registers to the compiler.
#ifndef SLAB_GATHER_V
#define SLAB_GATHER_V 0
#endif
#ifndef TRANSPOSE_THREADS
#define TRANSPOSE_THREADS 0
#endif
#ifndef TRANSPOSE_REG_CAP
#define TRANSPOSE_REG_CAP 1
#endif
constexpr int kMaxGridY = 65535;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__global__ void block_permute_add_kernel(const float* __restrict__ x,
                                         const int* __restrict__ order,
                                         float* __restrict__ out, int rows, int W) {
  const int i = blockIdx.x;
  const float* src = x + (long long)__ldg(order + i) * rows * W;
  float* dst = out + (long long)i * rows * W;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) dst[e] = src[e] + 1.0f;
}

// Block (c, piece): run c = t * Bz + z, elements [piece * V * kCopyThreads, ...)
// of it, V a thread, in units of T (float4 or float).
template <typename T, int V>
__global__ void __launch_bounds__(kCopyThreads)
slab_gather_kernel(const T* __restrict__ vol, const int* __restrict__ orgs,
                   T* __restrict__ out, int Y, int Xv, int Bz, int By) {
  const int c = blockIdx.x;
  const int t = c / Bz, z = c - t * Bz;
  const int oz = __ldg(orgs + 2 * t), oy = __ldg(orgs + 2 * t + 1);
  const long long run = (long long)By * Xv;
  const T* src = vol + ((long long)(oz + z) * Y + oy) * Xv;
  T* dst = out + (long long)c * run;
  const long long e0 = (long long)blockIdx.y * (V * kCopyThreads) + threadIdx.x;
  T v[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (e0 + k * kCopyThreads < run) v[k] = __ldg(src + e0 + k * kCopyThreads);
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (e0 + k * kCopyThreads < run) __stcs(dst + e0 + k * kCopyThreads, v[k]);
}

__global__ void slab_sum_kernel(const float* __restrict__ vol, const int* __restrict__ orgs,
                                float* __restrict__ out, int Y, int X, int Bz, int By,
                                int R) {
  const int t = blockIdx.x;
  const int oz = __ldg(orgs + 2 * t), oy = __ldg(orgs + 2 * t + 1);
  for (int x = threadIdx.x; x < X; x += blockDim.x) {
    const float* p = vol + ((long long)oz * Y + oy) * X + x;
    float acc = 0.0f;
    for (int z = 0; z < Bz; ++z) {
      float plane = 0.0f;
#pragma unroll 4
      for (int y = 0; y < By; ++y) plane += __ldg(p + ((long long)z * Y + y) * X);
      acc += plane;
    }
    float* dst = out + (long long)t * R * X + x;
    for (int r = 0; r < R; ++r) dst[r * X] = acc;
  }
}

template <bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads, TRANSPOSE_REG_CAP ? 2048 / kThreads : 1)
slice_transpose_kernel(const float* __restrict__ slab, const int* __restrict__ starts,
                       float* __restrict__ out, int SY, int X, int Bz, int By, int CW, int L) {
  extern __shared__ float win[];  // [Bz * By][CW + 1]
  const int t = blockIdx.x;
  const int dz = __ldg(starts + 3 * t), dy = __ldg(starts + 3 * t + 1);
  const int ox = __ldg(starts + 3 * t + 2);
  const int rows = Bz * By, pitch = CW + 1;
#pragma unroll 8
  for (int e = threadIdx.x; e < rows * CW; e += kThreads) {
    const int r = e / CW, c = e - r * CW;
    const int z = r / By;
    win[r * pitch + c] =
        __ldg(slab + ((long long)(dz + z) * SY + dy + r - z * By) * X + ox + c);
  }
  __syncthreads();
  float* dst = out + (long long)t * CW * L;
  if (kVec) {
    // tile (cb, rb) of a warp: rows c = 4 cb + lane / 8, float4 r4 = 8 rb + lane % 8
    const int L4 = L / 4, nR = (L4 + 7) / 8, tiles = (CW + 3) / 4 * nR;
    const int lane = threadIdx.x & 31;
    for (int tile = threadIdx.x >> 5; tile < tiles; tile += kThreads / 32) {
      const int cb = tile / nR;
      const int c = 4 * cb + (lane >> 3), r4 = 8 * (tile - cb * nR) + (lane & 7);
      if (c < CW && r4 < L4) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = 4 * r4 + k;
          v[k] = r < rows ? win[r * pitch + c] : 0.0f;
        }
        __stcs(reinterpret_cast<float4*>(dst + (long long)c * L) + r4,
               make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  } else {
    for (int e = threadIdx.x; e < CW * L; e += kThreads) {
      const int c = e / L, r = e - c * L;
      dst[e] = r < rows ? win[r * pitch + c] : 0.0f;
    }
  }
}

__global__ void empty_kernel() {}

int done() { return (int)cudaGetLastError(); }

template <typename T, int V>
int gather_runs(const void* vol, const void* orgs, void* out, long long runs, long long run,
                int Y, int Xv, int Bz, int By, cudaStream_t stream) {
  const long long pieces = (run + V * kCopyThreads - 1) / (V * kCopyThreads);
  if (pieces > kMaxGridY) return (int)cudaErrorInvalidValue;
  slab_gather_kernel<T, V><<<dim3((unsigned)runs, (unsigned)pieces), kCopyThreads, 0, stream>>>(
      (const T*)vol, (const int*)orgs, (T*)out, Y, Xv, Bz, By);
  return done();
}

template <bool kVec, int kThreads>
int transpose(const void* slab, const void* starts, void* out, int T, int SY, int X, int Bz,
              int By, int CW, int L, size_t smem, cudaStream_t stream) {
  slice_transpose_kernel<kVec, kThreads><<<T, kThreads, smem, stream>>>(
      (const float*)slab, (const int*)starts, (float*)out, SY, X, Bz, By, CW, L);
  return done();
}

}  // namespace

// Plain C interface (loaded with ctypes). Every array is contiguous f32, the
// index arrays int32; each function returns cudaGetLastError() after its
// launch, and launches nothing for an empty output.

// x [nb * rows, W], order [nb] -> out [nb * rows, W]
extern "C" int block_permute_add(const void* x, const void* order, void* out, int nb,
                                 int rows, int W, void* stream) {
  if (nb <= 0 || rows * W == 0) return 0;
  block_permute_add_kernel<<<nb, kPermuteThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)order, (float*)out, rows, W);
  return done();
}

// vol [Z, Y, X], orgs [T, 2] -> out [T, Bz, By, X]
extern "C" int slab_gather(const void* vol, const void* orgs, void* out, int T, int Y, int X,
                           int Bz, int By, void* stream) {
  if ((long long)T * Bz * By * X == 0) return 0;
  const long long runs = (long long)T * Bz;
  if (runs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool vec = X % 4 == 0 && aligned16(vol) && aligned16(out);
  const int Xv = vec ? X / 4 : X;
  const long long run = (long long)By * Xv;
  const bool wide = SLAB_GATHER_V ? SLAB_GATHER_V == 4
                                  : runs * ((run + 4 * kCopyThreads - 1) / (4 * kCopyThreads))
                                        >= kFillBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return wide ? gather_runs<float4, 4>(vol, orgs, out, runs, run, Y, Xv, Bz, By, s)
                : gather_runs<float4, 1>(vol, orgs, out, runs, run, Y, Xv, Bz, By, s);
  return wide ? gather_runs<float, 4>(vol, orgs, out, runs, run, Y, Xv, Bz, By, s)
              : gather_runs<float, 1>(vol, orgs, out, runs, run, Y, Xv, Bz, By, s);
}

// vol [Z, Y, X], orgs [T, 2] -> out [T, R, X]
extern "C" int slab_sum(const void* vol, const void* orgs, void* out, int T, int Y, int X,
                        int Bz, int By, int R, void* stream) {
  if ((long long)T * R * X == 0) return 0;
  slab_sum_kernel<<<T, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const int*)orgs, (float*)out, Y, X, Bz, By, R);
  return done();
}

// slab [SZ, SY, X], starts [T, 3] -> out [T, CW, L], L >= Bz * By
extern "C" int slice_transpose(const void* slab, const void* starts, void* out, int T, int SY,
                               int X, int Bz, int By, int CW, int L, void* stream) {
  if ((long long)T * CW * L == 0) return 0;
  const size_t smem = (size_t)Bz * By * (CW + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // a fixed TRANSPOSE_THREADS makes both sides of the choice that count
  constexpr int kMany = TRANSPOSE_THREADS ? TRANSPOSE_THREADS : kCopyThreads;
  constexpr int kFew = TRANSPOSE_THREADS ? TRANSPOSE_THREADS : kFewThreads;
  const bool many = T >= kFillBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (L % 4 == 0 && aligned16(out))
    return many ? transpose<true, kMany>(slab, starts, out, T, SY, X, Bz, By, CW, L, smem, s)
                : transpose<true, kFew>(slab, starts, out, T, SY, X, Bz, By, CW, L, smem, s);
  return many ? transpose<false, kMany>(slab, starts, out, T, SY, X, Bz, By, CW, L, smem, s)
              : transpose<false, kFew>(slab, starts, out, T, SY, X, Bz, By, CW, L, smem, s);
}

// The launch floor: one empty kernel (launch != 0), or the call alone.
extern "C" int empty_launch(int launch, void* stream) {
  if (launch) empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return done();
}
