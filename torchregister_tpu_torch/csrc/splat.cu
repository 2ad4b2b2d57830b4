// The binned NMI's linear splat for Hopper (sm_90a), summed in a fixed order.
//
// Counterpart of the splat in torchregister_tpu/losses/nmi.py:_binned_histogram,
// which the JAX package writes as two-level one-hot products on the TPU's
// matrix unit (XLA code, no Pallas kernel). For each row n of idx, f [N, L]:
//
//   H[n, idx[n, l]]     += 1 - f[n, l]
//   H[n, idx[n, l] + 1] += f[n, l]
//
// with idx in [0, kBins - 2]. The signed mode writes the transpose of the
// splat's backward (dL/df = dL/dH[idx + 1] - dL/dH[idx]), the second
// derivative of the binned NMI:
//
//   H[n, idx[n, l]]     -= f[n, l]
//   H[n, idx[n, l] + 1] += f[n, l]
//
// in the same order. A scatter with float atomics adds each bin's
// terms in the order the warps happen to reach it, so two runs differ in the
// last bits and an optimizer fed by the loss drifts apart. Here every bin's
// terms are added in an order fixed by the samples' positions alone, so a run
// repeats to the bit.
//
// What bounds it on this card: memory bytes. It reads idx and f once (8 bytes
// a sample) and writes H: the default criteria at 240^3 splat 8 patches of
// 100^3 (8 M samples, 64 MB) twice a step, 0.019 ms each at 3.35 TB/s. It adds
// twice a sample. Images are smooth, so the 32 samples of a warp's step mostly
// fall in one or two bins: a design that adds a bin's terms one after another
// on one lane (a chain of dependent adds as long as the group) is bound by
// that chain, not by memory.
//
// Design. Stage 1: a block of kWarps warps takes a contiguous chunk of kChunk
// samples of one row; warp w takes its w-th part, in batches of 128 samples
// (the next batch's loads in flight during this one), and keeps its own
// kBins histogram in shared memory. Step k of a batch is its 32 samples
// 32k + l (l = 0 .. 31), each lane holding one sample's bin and both its
// weights (1 - f and f; signed: -f and f). A step:
//   1. sorts its lanes by the key bin * 32 + lane (unique, so the order is
//      fixed): a bitonic sort over the warp by __shfl_xor_sync, skipped when
//      the bins never fall or never rise along the lanes (a smooth image
//      along x, a constant one): each bin's lanes then form one run in lane
//      order, and a run's scan below depends only on its own lanes in lane
//      order (a lane adds what lies d lanes below it iff that lane is in its
//      run, i.e. iff its place in the run is at least d), so the sums, and
//      the bins the runs add them to, are those of the sorted lanes;
//   2. sums each run of equal bins by a segmented inclusive scan over the
//      sorted lanes (__shfl_up_sync at distances 1, 2, 4, 8, 16, a fixed
//      tree, both weights at once; a lane adds what lies d lanes below it
//      when that lane is still in its run);
//   3. each run's last lane adds its 1 - f sum to h[bin] and then, after a
//      __syncwarp, its f sum to h[bin + 1]. A step's runs have distinct bins,
//      so neither round has two writers to one bin.
// The block then adds its warps' histograms bin by bin in warp order into its
// partial (scratch from the wrapper). Stage 2: one thread a bin adds the
// row's block partials in block order. No float atomics anywhere.
// ops/cuda/splat.py:splat_ordered states the same order in torch ops.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 1024;                  // the binned NMI's fine grid
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;                      // steps of a batch
constexpr int kBatch = 32 * kVec;            // samples of a warp's batch: kVec steps
constexpr int kBatches = 16;                 // batches a warp
constexpr int kChunk = kWarps * kBatches * kBatch;  // 16384 samples a block (CHUNK in ops/cuda/splat.py)
constexpr int kNone = kBins;                 // the bin of a lane past the row's end
constexpr unsigned kAll = 0xffffffffu;

// One step's sums: each run's last lane gets its bin and both weights' sums.
struct Run {
  int bin;   // kNone: this lane writes nothing
  float w0, w1;
};

__device__ __forceinline__ Run step_sums(int bin, float w0, float w1, int lane) {
  int prev = __shfl_up_sync(kAll, bin, 1);
  // bins that never fall (or never rise) along the lanes: each bin's lanes
  // are one run already, which the sort would only move as a whole
  if (!__all_sync(kAll, lane == 0 || prev <= bin) &&
      !__all_sync(kAll, lane == 0 || prev >= bin)) {
    int key = bin * 32 + lane;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int other = __shfl_xor_sync(kAll, key, j);
        const bool up = (lane & k) == 0, low = (lane & j) == 0;
        key = (low == up) ? min(key, other) : max(key, other);
      }
    const int from = key & 31;
    bin = key >> 5;
    w0 = __shfl_sync(kAll, w0, from);
    w1 = __shfl_sync(kAll, w1, from);
    prev = __shfl_up_sync(kAll, bin, 1);
  }
  const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != bin);
  const int start = 31 - __clz(heads & (kAll >> (31 - lane)));  // this lane's run begins here
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float a0 = __shfl_up_sync(kAll, w0, d), a1 = __shfl_up_sync(kAll, w1, d);
    if (lane - d >= start) {
      w0 = __fadd_rn(a0, w0);
      w1 = __fadd_rn(a1, w1);
    }
  }
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  return Run{last ? bin : kNone, w0, w1};
}

__global__ void __launch_bounds__(kThreads)
splat_partial_kernel(const int* __restrict__ idx, const float* __restrict__ f,
                     float* __restrict__ part, long long L, int nblk, bool neg) {
  __shared__ float hist[kWarps][kBins];
  const int b = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < kWarps * kBins; e += kThreads) (&hist[0][0])[e] = 0.0f;
  __syncthreads();
  float* h = hist[warp];
  const int* ir = idx + (long long)n * L;
  const float* fr = f + (long long)n * L;
  const long long s0 = (long long)b * kChunk + (long long)warp * (kBatches * kBatch);
  // a batch's samples into bin[k], fs[k]: the lane's sample of step k
  auto load = [&](long long base, int (&bin)[kVec], float (&fs)[kVec]) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = base + 32 * k + lane;
      bin[k] = i < L ? __ldg(ir + i) : kNone;
      fs[k] = i < L ? __ldg(fr + i) : 0.0f;
    }
  };
  int bin[kVec], nbin[kVec];
  float fs[kVec], nfs[kVec];
  if (s0 < L) load(s0, bin, fs);
  for (int t = 0; t < kBatches && s0 + (long long)t * kBatch < L; ++t) {  // uniform in the warp
    const long long next = s0 + (long long)(t + 1) * kBatch;
    if (t + 1 < kBatches && next < L) load(next, nbin, nfs);  // in flight during this batch
    Run run[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      run[k] = step_sums(bin[k], neg ? -fs[k] : 1.0f - fs[k], fs[k], lane);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (run[k].bin < kNone) h[run[k].bin] = __fadd_rn(h[run[k].bin], run[k].w0);
      __syncwarp();
      if (run[k].bin < kNone) h[run[k].bin + 1] = __fadd_rn(h[run[k].bin + 1], run[k].w1);
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      bin[k] = nbin[k];
      fs[k] = nfs[k];
    }
  }
  __syncthreads();
  float* out = part + ((long long)n * nblk + b) * kBins;
  for (int j = threadIdx.x; j < kBins; j += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) acc = __fadd_rn(acc, hist[v][j]);
    out[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
splat_sum_kernel(const float* __restrict__ part, float* __restrict__ H, int nblk) {
  const int n = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  const float* p = part + (long long)n * nblk * kBins + j;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nblk; ++b) acc = __fadd_rn(acc, __ldg(p + (long long)b * kBins));
  H[(long long)n * kBins + j] = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes). idx contiguous [N, L] int32 with
// every value in [0, 1022], f contiguous [N, L] f32, part [N, nblk, 1024] f32
// scratch with nblk = ceil(L / 16384), H [N, 1024] f32; sign 1: the signed
// mode (-f into idx, f into idx + 1). Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue, launching nothing, for an nblk that does
// not fit L, a sign other than 0 or 1, or a grid past the card's limits).
extern "C" int splat(const void* idx, const void* f, void* part, void* H, int N, long long L,
                     int nblk, int sign, void* stream) {
  if (N <= 0) return 0;
  if (L < 0 || nblk != (L + kChunk - 1) / kChunk || N > 65535 || (sign != 0 && sign != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nblk > 0)
    splat_partial_kernel<<<dim3(nblk, N), kThreads, 0, s>>>((const int*)idx, (const float*)f,
                                                            (float*)part, L, nblk,
                                                            sign == 1);
  splat_sum_kernel<<<dim3(kBins / kThreads, N), kThreads, 0, s>>>((const float*)part,
                                                                  (float*)H, nblk);
  return (int)cudaGetLastError();
}
