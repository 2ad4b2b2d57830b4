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
// What bounds them on this card. P1, P2, P4 and P5 move a few MB at most, so
// the launch itself (a few microseconds) is their floor. P3 is a gather at the
// exact warp's real size: 13824 slabs of 14 x 16 rows of 1 KB from a 240 x 240
// x 256 volume (59 MB), which overlap about 54-fold (3.17 GB of logical reads).
// Its bound counts the volume read once and the 113 MB output written once;
// how close it comes shows how much of the overlap L2 (50 MB) serves.
//
// Design. The copies have few blocks (2 to 84 at the probes' sizes), so they
// run 1024 threads a block and each block's few KB go in a few unrolled
// passes. slab_gather: one block per (slab, z plane),
// threads along x, so each row is one coalesced 1 KB read and write.
// slab_sum: one block per slab, one thread per x lane, each summing its
// lane over the slab's rows in a fixed order in f32 (each z plane's By rows,
// then the planes), so a run repeats to the bit. slice_transpose: the TPU
// reached the transpose with a one-hot matmul on its matrix unit; here a
// block stages its (Bz*By) x CW window in shared memory with reads along x,
// rows padded to CW + 1 floats so that the transposed reads of a warp hit
// distinct banks, and writes each output row along r.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;      // slab_sum: one thread per x lane (X <= 256 in one pass)
constexpr int kCopyThreads = 1024;  // the copies: each block's rows in a few passes

__global__ void block_permute_add_kernel(const float* __restrict__ x,
                                         const int* __restrict__ order,
                                         float* __restrict__ out, int rows, int W) {
  const int i = blockIdx.x;
  const float* src = x + (long long)__ldg(order + i) * rows * W;
  float* dst = out + (long long)i * rows * W;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) dst[e] = src[e] + 1.0f;
}

__global__ void slab_gather_kernel(const float* __restrict__ vol, const int* __restrict__ orgs,
                                   float* __restrict__ out, int Y, int X, int Bz, int By) {
  const int t = blockIdx.x / Bz;
  const int z = blockIdx.x % Bz;
  const int oz = __ldg(orgs + 2 * t), oy = __ldg(orgs + 2 * t + 1);
  const float* src = vol + ((long long)(oz + z) * Y + oy) * X;
  float* dst = out + (long long)blockIdx.x * By * X;
#pragma unroll 4
  for (int e = threadIdx.x; e < By * X; e += blockDim.x) dst[e] = __ldg(src + e);
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

__global__ void slice_transpose_kernel(const float* __restrict__ slab,
                                       const int* __restrict__ starts,
                                       float* __restrict__ out, int SY, int X, int Bz,
                                       int By, int CW, int L) {
  extern __shared__ float win[];  // [Bz * By][CW + 1]
  const int t = blockIdx.x;
  const int dz = __ldg(starts + 3 * t), dy = __ldg(starts + 3 * t + 1);
  const int ox = __ldg(starts + 3 * t + 2);
  const int rows = Bz * By, pitch = CW + 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * CW; e += blockDim.x) {
    const int c = e % CW, r = e / CW;
    win[r * pitch + c] =
        __ldg(slab + ((long long)(dz + r / By) * SY + dy + r % By) * X + ox + c);
  }
  __syncthreads();
  float* dst = out + (long long)t * CW * L;
#pragma unroll 4
  for (int e = threadIdx.x; e < CW * L; e += blockDim.x) {
    const int c = e / L, r = e % L;
    dst[e] = r < rows ? win[r * pitch + c] : 0.0f;
  }
}

int done() { return (int)cudaGetLastError(); }

}  // namespace

// Plain C interface (loaded with ctypes). Every array is contiguous f32, the
// index arrays int32; each function returns cudaGetLastError() after its
// launch, and launches nothing for an empty output.

// x [nb * rows, W], order [nb] -> out [nb * rows, W]
extern "C" int block_permute_add(const void* x, const void* order, void* out, int nb,
                                 int rows, int W, void* stream) {
  if (nb <= 0 || rows * W == 0) return 0;
  block_permute_add_kernel<<<nb, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)order, (float*)out, rows, W);
  return done();
}

// vol [Z, Y, X], orgs [T, 2] -> out [T, Bz, By, X]
extern "C" int slab_gather(const void* vol, const void* orgs, void* out, int T, int Y, int X,
                           int Bz, int By, void* stream) {
  if ((long long)T * Bz * By * X == 0) return 0;
  slab_gather_kernel<<<T * Bz, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const int*)orgs, (float*)out, Y, X, Bz, By);
  return done();
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
  slice_transpose_kernel<<<T, kCopyThreads, smem, (cudaStream_t)stream>>>(
      (const float*)slab, (const int*)starts, (float*)out, SY, X, Bz, By, CW, L);
  return done();
}
