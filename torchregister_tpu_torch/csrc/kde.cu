// The NMI loss's exact KDE for Hopper (sm_90a): a reduction over samples
// (kde_sum) and a reduction over points (kde_dot), each of which skips itself
// on the card when the call is on the binned path.
//
// Counterpart of torchregister_tpu/losses/nmi.py:_kde_accumulate and kde_pdf,
// XLA code (a lax.scan over checkpointed chunks of [N, 8192, P] kernel
// tensors), not a Pallas kernel. The JAX package picks the binned or the exact
// density with one lax.cond a call; the port computes both and selects one,
// so that a CUDA graph captures the step whatever the branch. These kernels
// read the branch flag from device memory and, on the binned path, write
// zeros and return, so a replay does only the taken branch's work.
//
// Notation: rows s [N, L], points xi [P], bandwidth h, u = (s_l - xi_k) / h,
// phi(u) = exp(-u^2 / 2) / (2 pi), phi' = -u phi, phi'' = (u^2 - 1) phi.
//
//   kde_sum: out[n, k] = sum_l w[n, l] psi(u_lk), psi in {phi, phi'}, w = 1
//            when absent (the forward; w = the cotangent of ds with phi':
//            the second order's cotangent of g)
//   kde_dot: out[n, l] = sum_k g[n, k] psi(u_lk), psi in {phi', phi''}
//            (the backward ds; with phi'': the second order's cotangent of s)
//
// Each term is computed in the JAX package's order of operations: a true
// division by h, (-0.5 u) u, expf, times 1/(2 pi) in f32, each an explicit
// round-to-nearest operation so that no multiply and add fuse. Sums are
// compensated (Kahan): a thread adds thousands of terms in order, and an
// uncompensated serial f32 sum of that length drifts further from the exact
// sum than PyTorch's tree-shaped reductions of the plain version do.
//
// What bounds it on this card: operations. The default NMI at 240^3 (8
// patches of 100^3: rows of 1 M samples for each marginal and 2 M for the
// joint, P = 256) makes 8 x (1 M + 1 M + 2 M) x 256 = 8.2 G terms in the
// forward, each an exponential (one MUFU.EX2, 16 a clock an SM) and ~20 f32
// operations; it reads 64 MB.
//
// Design (simple first). kde_sum, stage 1: a block takes kChunk samples of one
// row, stages them kTile at a time in shared memory, and each thread owns a
// point k (P > kThreads: a loop over groups of points), adding its terms in
// ascending l into its partial (scratch from the wrapper). Stage 2: one thread
// a (row, point) adds the row's partials in block order. kde_dot: one thread a
// (row, sample), adding its P terms in ascending k, g and xi staged in shared
// memory; at most kDotBlocks blocks a row step over its samples, so that on
// the binned path few blocks write the zeros, 16 bytes a store (with one
// block for every 256 samples the zeros took twice their memory time). No
// atomics: two launches agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // samples staged in shared memory at once
constexpr int kChunk = 4096;  // samples a block of kde_sum's first stage (CHUNK in ops/cuda/kde.py)
constexpr int kDotBlocks = 1024;  // kde_dot's blocks a row at most
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.14159265358979323846));
static_assert(kChunk % kTile == 0, "a chunk is whole tiles");

struct Kahan {
  float sum = 0.0f, c = 0.0f;
  __device__ __forceinline__ void add(float x) {
    const float y = __fsub_rn(x, c);
    const float t = __fadd_rn(sum, y);
    c = __fsub_rn(__fsub_rn(t, sum), y);
    sum = t;
  }
};

// psi(u) for D = 0 (phi), 1 (phi') or 2 (phi'')
template <int D>
__device__ __forceinline__ float kde_term(float s, float xi, float h) {
  const float u = __fdiv_rn(__fsub_rn(s, xi), h);
  const float phi = __fmul_rn(kInv2Pi, expf(__fmul_rn(__fmul_rn(-0.5f, u), u)));
  if (D == 0) return phi;
  if (D == 1) return __fmul_rn(-u, phi);
  return __fmul_rn(__fsub_rn(__fmul_rn(u, u), 1.0f), phi);
}

template <int D, bool W>
__global__ void __launch_bounds__(kThreads)
kde_sum_partial(const float* __restrict__ s, const float* __restrict__ w,
                const float* __restrict__ xi, const int* __restrict__ binned,
                float* __restrict__ part, long long L, int P, int nblk, float h) {
  if (*binned) return;  // stage 2 writes the zeros
  __shared__ float ss[kTile];
  __shared__ float ws[W ? kTile : 1];
  const int b = blockIdx.x, n = blockIdx.y;
  const long long base = (long long)n * L + (long long)b * kChunk;
  const int len = (int)min((long long)kChunk, L - (long long)b * kChunk);
  for (int k0 = 0; k0 < P; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    const float x = k < P ? __ldg(xi + k) : 0.0f;
    Kahan acc;
    for (int t0 = 0; t0 < len; t0 += kTile) {
      const int m = min(kTile, len - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += kThreads) {
        ss[i] = __ldg(s + base + t0 + i);
        if (W) ws[i] = __ldg(w + base + t0 + i);
      }
      __syncthreads();
      if (k < P)
        for (int i = 0; i < m; ++i) {
          const float term = kde_term<D>(ss[i], x, h);
          acc.add(W ? __fmul_rn(ws[i], term) : term);
        }
    }
    if (k < P) part[((long long)n * nblk + b) * P + k] = acc.sum;
  }
}

__global__ void __launch_bounds__(kThreads)
kde_sum_total(const float* __restrict__ part, const int* __restrict__ binned,
              float* __restrict__ out, int P, int nblk) {
  const int n = blockIdx.y, k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= P) return;
  Kahan acc;
  if (!*binned)
    for (int b = 0; b < nblk; ++b) acc.add(__ldg(part + ((long long)n * nblk + b) * P + k));
  out[(long long)n * P + k] = acc.sum;
}

// Zeros into a row of n floats, 16 bytes a store where the row is aligned,
// by thread t of a row's `stride` threads.
__device__ __forceinline__ void zero_row(float* row, long long n, long long t, long long stride) {
  long long head = 0;
  if (((unsigned long long)row & 15) == 0) {
    float4* v = reinterpret_cast<float4*>(row);
    for (long long j = t; j < n / 4; j += stride) v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    head = n / 4 * 4;
  }
  for (long long j = head + t; j < n; j += stride) row[j] = 0.0f;
}

// A row's blocks step over its samples, kThreads at a time (a uniform trip
// count, so the barriers hold); the binned path zeroes the row instead.
template <int D>
__global__ void __launch_bounds__(kThreads)
kde_dot_kernel(const float* __restrict__ s, const float* __restrict__ g,
               const float* __restrict__ xi, const int* __restrict__ binned,
               float* __restrict__ out, long long L, int P, float h) {
  __shared__ float gs[kThreads];
  __shared__ float xs[kThreads];
  const int n = blockIdx.y;
  const long long row = (long long)n * L;
  const long long stride = (long long)gridDim.x * kThreads;
  if (*binned) {
    zero_row(out + row, L, (long long)blockIdx.x * kThreads + threadIdx.x, stride);
    return;
  }
  for (long long l0 = (long long)blockIdx.x * kThreads; l0 < L; l0 += stride) {
    const long long l = l0 + threadIdx.x;
    const float sv = l < L ? __ldg(s + row + l) : 0.0f;
    Kahan acc;
    for (int k0 = 0; k0 < P; k0 += kThreads) {
      const int m = min(kThreads, P - k0);
      __syncthreads();
      if (threadIdx.x < m) {
        gs[threadIdx.x] = __ldg(g + (long long)n * P + k0 + threadIdx.x);
        xs[threadIdx.x] = __ldg(xi + k0 + threadIdx.x);
      }
      __syncthreads();
      for (int k = 0; k < m; ++k) acc.add(__fmul_rn(gs[k], kde_term<D>(sv, xs[k], h)));
    }
    if (l < L) out[row + l] = acc.sum;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). s [N, L] and w [N, L] (or null: w = 1)
// contiguous f32, xi [P] f32, binned one int32 (non-zero: the call is on the
// binned path, and the output is zeros), part [N, nblk, P] f32 scratch with
// nblk = ceil(L / 4096), out [N, P] f32; deriv 0 (phi) or 1 (phi'). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue, launching
// nothing, for arguments it does not take).
extern "C" int kde_sum(const void* s, const void* w, const void* xi, const void* binned,
                       void* part, void* out, int N, long long L, int P, int nblk, float h,
                       int deriv, void* stream) {
  if (N <= 0 || P <= 0) return 0;
  if (L < 0 || nblk != (L + kChunk - 1) / kChunk || N > 65535 || (deriv != 0 && deriv != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sf = (const float*)s;
  const float* wf = (const float*)w;
  const float* xf = (const float*)xi;
  const int* bf = (const int*)binned;
  float* pf = (float*)part;
  if (nblk > 0) {
    const dim3 grid(nblk, N);
    if (deriv == 0 && !w)
      kde_sum_partial<0, false><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h);
    else if (deriv == 0)
      kde_sum_partial<0, true><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h);
    else if (!w)
      kde_sum_partial<1, false><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h);
    else
      kde_sum_partial<1, true><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h);
  }
  kde_sum_total<<<dim3((P + kThreads - 1) / kThreads, N), kThreads, 0, st>>>(pf, bf, (float*)out,
                                                                           P, nblk);
  return (int)cudaGetLastError();
}

// s [N, L] f32, g [N, P] f32, xi [P] f32, binned one int32, out [N, L] f32;
// deriv 1 (phi') or 2 (phi'').
extern "C" int kde_dot(const void* s, const void* g, const void* xi, const void* binned,
                       void* out, int N, long long L, int P, float h, int deriv,
                       void* stream) {
  if (N <= 0 || L <= 0) return 0;
  if (P <= 0 || N > 65535 || (deriv != 1 && deriv != 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nx = (L + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(nx < kDotBlocks ? nx : kDotBlocks), N);
  if (deriv == 1)
    kde_dot_kernel<1><<<grid, kThreads, 0, st>>>((const float*)s, (const float*)g,
                                                 (const float*)xi, (const int*)binned,
                                                 (float*)out, L, P, h);
  else
    kde_dot_kernel<2><<<grid, kThreads, 0, st>>>((const float*)s, (const float*)g,
                                                 (const float*)xi, (const int*)binned,
                                                 (float*)out, L, P, h);
  return (int)cudaGetLastError();
}
