// The binned NMI's linear splat for Hopper (sm_90a), summed in a fixed order.
//
// Counterpart of the splat in torchregister_tpu/losses/nmi.py:_binned_histogram,
// which the JAX package writes as two-level one-hot products on the TPU's
// matrix unit (XLA code, no Pallas kernel). For each row n of idx, f [N, L]:
//
//   H[n, idx[n, l]]     += 1 - f[n, l]
//   H[n, idx[n, l] + 1] += f[n, l]
//
// with idx in [0, kBins - 2]. A scatter with float atomics adds each bin's
// terms in the order the warps happen to reach it, so two runs differ in the
// last bits and an optimizer fed by the loss drifts apart. Here every bin's
// terms are added in an order fixed by the samples' positions alone, so a run
// repeats to the bit.
//
// What bounds it on this card: memory bytes. It reads idx and f once (8 bytes
// a sample) and writes H: the default criteria at 240^3 splat 8 patches of
// 100^3 (8 M samples, 64 MB) twice a step, 0.019 ms each at 3.35 TB/s. It adds
// twice a sample.
//
// Design. Stage 1: a block of kWarps warps takes a contiguous chunk of kChunk
// samples of one row; warp w takes its w-th part, 32 samples a step, and keeps
// its own kBins histogram in shared memory. In a step each lane holds one
// sample's two terms; for each term in turn (1 - f into idx, then f into
// idx + 1), __match_any_sync groups the lanes that hit the same bin, and the
// group's lowest lane adds the group's weights to the bin in ascending lane
// order. The block then adds its warps' histograms bin by bin in warp order
// into its partial (scratch from the wrapper). Stage 2: one thread a bin adds
// the row's block partials in block order. No float atomics anywhere. When
// every lane of a step hits one bin (a constant image) one lane makes all 32
// adds of the step; the rest of the warp waits.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 1024;                  // the binned NMI's fine grid
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 64;                   // steps of 32 samples a warp
constexpr int kBatch = 8;                    // steps whose samples load at once
constexpr int kChunk = kWarps * kSteps * 32;  // 16384 samples a block (CHUNK in ops/cuda/splat.py)
static_assert(kSteps % kBatch == 0, "a warp's steps come in whole batches");

__global__ void __launch_bounds__(kThreads)
splat_partial_kernel(const int* __restrict__ idx, const float* __restrict__ f,
                     float* __restrict__ part, long long L, int nblk) {
  __shared__ float hist[kWarps][kBins];
  __shared__ float weight[kWarps][32];
  const int b = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < kWarps * kBins; e += kThreads) (&hist[0][0])[e] = 0.0f;
  __syncthreads();
  float* h = hist[warp];
  float* w = weight[warp];
  const long long row = (long long)n * L;
  const long long s0 = (long long)b * kChunk + (long long)warp * (kSteps * 32);
  for (int s = 0; s < kSteps && s0 + s * 32 < L; s += kBatch) {  // uniform in the warp
    int bin[kBatch];
    float fs[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = s0 + (s + k) * 32 + lane;
      bin[k] = i < L ? __ldg(idx + row + i) : -1;
      fs[k] = i < L ? __ldg(f + row + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        const int bt = bin[k] < 0 ? -1 : bin[k] + term;
        w[lane] = term ? fs[k] : 1.0f - fs[k];
        __syncwarp();
        const unsigned group = __match_any_sync(0xffffffffu, bt);
        if (bt >= 0 && lane == __ffs(group) - 1) {
          float acc = h[bt];
          for (unsigned m = group; m; m &= m - 1) acc += w[__ffs(m) - 1];
          h[bt] = acc;
        }
        __syncwarp();
      }
  }
  __syncthreads();
  float* out = part + ((long long)n * nblk + b) * kBins;
  for (int j = threadIdx.x; j < kBins; j += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) acc += hist[v][j];
    out[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
splat_sum_kernel(const float* __restrict__ part, float* __restrict__ H, int nblk) {
  const int n = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  const float* p = part + (long long)n * nblk * kBins + j;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nblk; ++b) acc += __ldg(p + (long long)b * kBins);
  H[(long long)n * kBins + j] = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes). idx contiguous [N, L] int32 with
// every value in [0, 1022], f contiguous [N, L] f32, part [N, nblk, 1024] f32
// scratch with nblk = ceil(L / 16384), H [N, 1024] f32. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue, launching
// nothing, for an nblk that does not fit L or a grid past the card's limits).
extern "C" int splat(const void* idx, const void* f, void* part, void* H, int N, long long L,
                     int nblk, void* stream) {
  if (N <= 0) return 0;
  if (L < 0 || nblk != (L + kChunk - 1) / kChunk || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nblk > 0)
    splat_partial_kernel<<<dim3(nblk, N), kThreads, 0, s>>>((const int*)idx, (const float*)f,
                                                            (float*)part, L, nblk);
  splat_sum_kernel<<<dim3(kBins / kThreads, N), kThreads, 0, s>>>((const float*)part,
                                                                  (float*)H, nblk);
  return (int)cudaGetLastError();
}
