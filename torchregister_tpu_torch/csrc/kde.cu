// The NMI loss's exact KDE for Hopper (sm_90a): a reduction over samples
// (kde_sum) and a reduction over points (kde_dot), each of which skips itself
// on the card when the call is on the binned path, and each of which computes
// only the Gaussian terms that f32 can hold.
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
// compensated (Kahan): a thread adds many terms in order, and an
// uncompensated serial f32 sum of that length drifts further from the exact
// sum than PyTorch's tree-shaped reductions of the plain version do.
//
// The cut. For |u| >= kCut = 14, |psi(u)| < 1e-41 for each of phi, phi' and
// phi'' (each falls past |u| = sqrt(3), so it is largest at 14: phi(14) =
// 4.4e-44, phi''(14) = 8.5e-42): below f32's smallest normal, 1.18e-38
// (tests/test_torch_kde_window.py), so no such term can move a sum that
// holds any term f32 represents as a normal. A term is dropped when its own
// rounded difference d = s - xi (the one the term divides by h) has
// R < |d| <= Dmax, R = 14 h and Dmax = 1e19 h rounded to f32: then the
// term's u = d / h rounds to |u| >= 13.9999, and u^2 stays finite, so the
// term would have been finite and below FLT_MIN. A NaN or an infinite d is
// never dropped (NaN fails both comparisons, inf the second), so a sample or
// a point that is not finite, or a difference that overflows, reaches the
// output as in the plain version; a bandwidth that is not positive and
// finite drops nothing. There is no switch that computes every term: where a
// design cannot show that a term lies past the cut, it computes the term.
//
// What bounds it on this card: the exponentials of the terms within the cut,
// and the bytes. The default NMI at 240^3 (8 patches of 100^3: rows of 1 M
// samples for each marginal and 2 M for the joint, P = 256) has 8 x (1 M +
// 1 M + 2 M) x 256 = 8.2 G terms in the forward; on the exact branch the
// joint's points lie >= 767.25 / 255 = 3.009 >= h apart, so a sample has at
// most ~29 of 256 points within |u| < 14 (11 %): on make_pair's joint rows
// scaled to a range just past that (x 360) 8.0 % of the terms, on a CT-like
// range (x 1000, spacing 8.55) 3.2 %. Each computed term is an exponential
// (one MUFU.EX2, 16 a clock an SM) and ~30 f32 instructions, a chain of
// dependent operations (a true division, expf, a Kahan add); the rows are
// 64 MB a call. The kernels run well above that bound (PERF.md): the chains'
// latency, the terms computed past the cut's exact set (kde_sum's groups),
// and the windows' searches and the lists' votes beside the terms.
//
// Design. The points' contract: any order and any values are right; points
// that are monotone in either direction (nmi's _sample_points and get_pdf
// make them non-increasing) are fast.
//   kde_dot (a thread a sample, g and the points staged in shared memory,
//   kThreads points at a time, once where P <= kThreads): the block checks that the staged points are
//   finite and monotone (__syncthreads_and); if so, each thread finds the
//   window of points with |d| <= R by two binary searches over its d, which
//   is monotone in k then, and adds the window's terms in ascending k; if its
//   end points' |d| exceed Dmax (or are NaN) it takes the whole tile, as does
//   every thread of a tile that is not monotone. For evenly spaced points
//   every lane of a warp makes about the same number of trips. At most
//   kDotBlocks blocks a row step over its samples, so that on the binned path
//   few blocks write the zeros, 16 bytes a store (with one block for every
//   256 samples the zeros took twice their memory time).
//   kde_sum, stage 1: a row's blocks (at most kSumBlocks, so that on the
//   binned path few blocks launch) take its chunks of kChunk samples in
//   turn. A block stages a chunk once in shared memory, and warp v finds the
//   [min, max] of tile v (kTile = kChunk / kWarps samples). The block then
//   takes its points kPoints at a time as groups of kGroup, each group's
//   [min, max] from its points (no order assumed). An item is a (group, tile) pair, one for each thread: the
//   block drops the items whose two ranges lie past the cut (the test in the
//   kernel's own differences: d over them lies between tile min - group max
//   and tile max - group min), lists the rest in order (ballot, popc), and
//   warp v runs items v, v + kWarps, ...: it builds an ordered list of the
//   tile's samples that may lie within the cut of some point of the group
//   (ballot and popc, the same test on each sample; every sample when a
//   point or a sample is not finite), its lanes, kSlots to a point, add the
//   list's terms in ascending l (slot j taking entries j, j + kSlots, ...),
//   and the slots' Kahan partials, added in slot order, give the item's sum
//   for each point. Each point then adds its tiles' sums in tile order (a
//   dropped item's is zero) into the chunk's partial (scratch from the
//   wrapper). Image rows are locally smooth, so most items drop and the
//   work of a chunk falls on few groups: items, not groups, go to the
//   warps, so that one warp does not do most of its block's work while the
//   others wait. Which warp runs an item changes no bit. Stage 2: one thread a (row, point) adds the
//   row's chunk partials in chunk order.
// The loops over terms are unrolled by kUnroll, so that a trip's loads,
// division and exponential overlap the previous trip's Kahan add (the adds
// stay in order): a lane's chain of dependent operations, not the issue
// rate, bounds these loops.
// No atomics: two launches agree to the bit, and a row's result depends on
// its own samples, points and weights alone (not on N or the other rows).

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;  // samples a block of kde_sum's first stage (CHUNK in ops/cuda/kde.py)
constexpr int kTile = kChunk / kWarps;  // kde_sum: samples a list covers (a warp finds its range)
constexpr int kTiles = kChunk / kTile;
constexpr int kSumBlocks = 256;   // kde_sum's first-stage blocks a row at most
constexpr int kDotBlocks = 1024;  // kde_dot's blocks a row at most
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr double kCut = 14.0;   // |u| past which psi is below FLT_MIN (CUT in ops/cuda/kde.py)
constexpr double kUMax = 1e19;  // |u| up to which u^2 is finite in f32
#ifndef KDE_GROUP
#define KDE_GROUP 8
#endif
#ifndef KDE_UNROLL
#define KDE_UNROLL 4
#endif
constexpr int kUnroll = KDE_UNROLL;  // terms a loop trip (their adds stay in order)
constexpr int kGroup = KDE_GROUP;    // kde_sum: points a group
constexpr int kSlots = 32 / kGroup;  // kde_sum: lanes a point
constexpr int kItems = kThreads;     // kde_sum: (group, tile) items a round, one a thread
constexpr int kPoints = kItems / kTiles * kGroup;  // kde_sum: points a round
static_assert(kTiles == kWarps, "a warp finds the range of one tile");
static_assert(kItems % kTiles == 0, "each group meets every tile in a round");
static_assert(kChunk <= 65536 && kItems <= 65536, "list and item entries are 16-bit");
static_assert(32 % kGroup == 0, "a warp is whole groups of lanes");

struct Kahan {
  float sum = 0.0f, c = 0.0f;
  __device__ __forceinline__ void add(float x) {
    const float y = __fsub_rn(x, c);
    const float t = __fadd_rn(sum, y);
    c = __fsub_rn(__fsub_rn(t, sum), y);
    sum = t;
  }
};

// The cut: a term whose rounded difference d has r < |d| <= dmax is dropped.
struct Cut {
  float r, dmax;
};

Cut make_cut(float h) {
  const double r = kCut * h, dmax = kUMax * h;
  if (!(h > 0.0f) || !(r <= FLT_MAX)) return {INFINITY, INFINITY};  // nothing dropped
  return {(float)r, dmax < FLT_MAX ? (float)dmax : FLT_MAX};
}

// psi(u) for D = 0 (phi), 1 (phi') or 2 (phi'')
template <int D>
__device__ __forceinline__ float kde_term(float s, float xi, float h) {
  const float u = __fdiv_rn(__fsub_rn(s, xi), h);
  const float phi = __fmul_rn(kInv2Pi, expf(__fmul_rn(__fmul_rn(-0.5f, u), u)));
  if (D == 0) return phi;
  if (D == 1) return __fmul_rn(-u, phi);
  return __fmul_rn(__fsub_rn(__fmul_rn(u, u), 1.0f), phi);
}

// Whether every sample in [a, b] lies past the cut of every point in
// [lo, hi]: the rounded d = s - xi over them lies in [a - hi, b - lo]
// (rounding is monotone). False for a NaN bound.
__device__ __forceinline__ bool past(float a, float b, float lo, float hi, Cut cut) {
  const float dmin = __fsub_rn(a, hi), dmax = __fsub_rn(b, lo);
  return (dmin > cut.r && dmax <= cut.dmax) || (dmax < -cut.r && dmin >= -cut.dmax);
}

template <int D, bool W>
__global__ void __launch_bounds__(kThreads)
kde_sum_partial(const float* __restrict__ s, const float* __restrict__ w,
                const float* __restrict__ xi, const int* __restrict__ binned,
                float* __restrict__ part, long long L, int P, int nblk, float h, Cut cut) {
  if (*binned) return;  // stage 2 writes the zeros
  __shared__ float ss[kChunk];
  __shared__ unsigned short list[kWarps][kTile];
  __shared__ float tile_lo[kTiles], tile_hi[kTiles];
  __shared__ bool tile_finite[kTiles];
  __shared__ float sums[kTiles][kPoints];
  __shared__ unsigned short items[kItems];
  __shared__ int warp_items[kWarps];
  const int n = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, slot = lane / kGroup, p = lane % kGroup;
  const unsigned before = (1u << lane) - 1u;
  // a row's blocks step over its chunks (a uniform trip count: the barriers
  // hold), so that on the binned path few blocks launch
  for (int b = blockIdx.x; b < nblk; b += gridDim.x) {
    const long long base = (long long)n * L + (long long)b * kChunk;
    const int len = (int)min((long long)kChunk, L - (long long)b * kChunk);
    const int tiles = (len + kTile - 1) / kTile;
    for (int i = t; i < len; i += kThreads) ss[i] = __ldg(s + base + i);
    __syncthreads();
    {  // warp v: tile v's [min, max], and whether its samples are all finite
      const int t0 = warp * kTile, m = min(kTile, len - t0);
      float a = INFINITY, c = -INFINITY;
      bool finite = true;
      for (int i = lane; i < m; i += 32) {
        a = fminf(a, ss[t0 + i]);
        c = fmaxf(c, ss[t0 + i]);
        finite = finite && isfinite(ss[t0 + i]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        a = fminf(a, __shfl_xor_sync(~0u, a, o));
        c = fmaxf(c, __shfl_xor_sync(~0u, c, o));
      }
      finite = __all_sync(~0u, finite);
      if (lane == 0) {
        tile_lo[warp] = a;
        tile_hi[warp] = c;
        tile_finite[warp] = finite;
      }
    }
    for (int k0 = 0; k0 < P; k0 += kPoints) {
      for (int i = t; i < kTiles * kPoints; i += kThreads) (&sums[0][0])[i] = 0.0f;
      __syncthreads();
      // item t: group t / kTiles of the round's points against tile t % kTiles;
      // it is needed unless the cut drops every pair of the two ranges
      {
        const int g = t / kTiles, tt = t % kTiles;
        float lo = INFINITY, hi = -INFINITY;
        bool any = false, every = false;
        for (int q = 0; q < kGroup; ++q) {
          const int k = k0 + g * kGroup + q;
          if (k < P) {
            const float v = __ldg(xi + k);
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
            any = true;
            every = every || !isfinite(v);
          }
        }
        const bool need = any && tt < tiles &&
                          (every || !tile_finite[tt] || !past(tile_lo[tt], tile_hi[tt], lo, hi, cut));
        const unsigned vote = __ballot_sync(~0u, need);
        if (lane == 0) warp_items[warp] = __popc(vote);
        __syncthreads();
        int offset = 0;
        for (int v = 0; v < warp; ++v) offset += warp_items[v];
        if (need) items[offset + __popc(vote & before)] = (unsigned short)t;
      }
      int total = 0;
      for (int v = 0; v < kWarps; ++v) total += warp_items[v];
      __syncthreads();
      // the needed items in order, warp v taking items v, v + kWarps, ...
      for (int it = warp; it < total; it += kWarps) {
        const int g = items[it] / kTiles, tt = items[it] % kTiles;
        const int k = k0 + g * kGroup + p;
        const bool valid = k < P;
        const float x = valid ? __ldg(xi + k) : 0.0f;
        float lo = valid ? x : INFINITY, hi = valid ? x : -INFINITY;
        for (int o = 1; o < kGroup; o <<= 1) {
          lo = fminf(lo, __shfl_xor_sync(~0u, lo, o));
          hi = fmaxf(hi, __shfl_xor_sync(~0u, hi, o));
        }
        const bool every = !__all_sync(~0u, !valid || isfinite(x));  // a point not finite
        // the ordered list of the tile's samples the group may need
        const int t0 = tt * kTile, m = min(kTile, len - t0);
        int count = 0;
        for (int i0 = 0; i0 < m; i0 += 32) {
          const int i = i0 + lane;
          const bool keep = i < m && (every || !past(ss[t0 + i], ss[t0 + i], lo, hi, cut));
          const unsigned vote = __ballot_sync(~0u, keep);
          if (keep) list[warp][count + __popc(vote & before)] = (unsigned short)(t0 + i);
          count += __popc(vote);
        }
        __syncwarp();
        Kahan acc;
        if (valid) {
#pragma unroll (kUnroll)
          for (int e = slot; e < count; e += kSlots) {
            const int i = list[warp][e];
            const float term = kde_term<D>(ss[i], x, h);
            acc.add(W ? __fmul_rn(__ldg(w + base + i), term) : term);
          }
        }
        // the slots' partials (sum - c), in slot order, into slot 0's sum
        const float psum = acc.sum, pc = acc.c;
        for (int j = 1; j < kSlots; ++j) {
          acc.add(__shfl_sync(~0u, psum, lane + j * kGroup));
          acc.add(-__shfl_sync(~0u, pc, lane + j * kGroup));
        }
        if (valid && slot == 0) sums[tt][g * kGroup + p] = acc.sum;
        __syncwarp();  // the warp's next item rebuilds the list
      }
      __syncthreads();
      // each point: its tiles' sums in tile order (a skipped tile's is zero)
      for (int q = t; q < kPoints && k0 + q < P; q += kThreads) {
        Kahan acc;
        for (int tt = 0; tt < tiles; ++tt) acc.add(sums[tt][q]);
        part[((long long)n * nblk + b) * P + k0 + q] = acc.sum;
      }
      __syncthreads();  // the next round zeroes the sums
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kde_sum_total(const float* __restrict__ part, const int* __restrict__ binned,
              float* __restrict__ out, int P, int nblk) {
  const int n = blockIdx.y, k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= P) return;
  Kahan acc;
  if (!*binned)
#pragma unroll 8
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

// The points k in [lo, hi) of a tile of m points whose terms with sample s
// are computed: e(k) = dir (s - xs[k]), rounded, is non-decreasing in k for a
// tile that is non-increasing (dir 1) or non-decreasing (dir -1), so the
// window |e| <= r is found by two binary searches, and |e| is largest at the
// ends. The whole tile when an end's |e| exceeds dmax or is NaN.
__device__ __forceinline__ void window(float s, const float* xs, int m, float dir, Cut cut,
                                       int& lo, int& hi) {
  lo = 0;
  hi = m;
  const float e0 = dir * __fsub_rn(s, xs[0]), e1 = dir * __fsub_rn(s, xs[m - 1]);
  if (!(fabsf(e0) <= cut.dmax && fabsf(e1) <= cut.dmax)) return;
  int a = 0, b = m;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (dir * __fsub_rn(s, xs[mid]) < -cut.r) a = mid + 1; else b = mid;
  }
  lo = a;
  b = m;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (dir * __fsub_rn(s, xs[mid]) <= cut.r) a = mid + 1; else b = mid;
  }
  hi = a;
}

// Stages points k0 .. k0 + m - 1 and their g into shared memory (every
// thread of the block calls it) and returns the tile's direction: 1
// non-increasing, -1 non-decreasing, 0 neither or a point not finite (NaN
// compares false).
__device__ __forceinline__ float stage_points(const float* __restrict__ g,
                                              const float* __restrict__ xi, float* gs, float* xs,
                                              int k0, int m) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t < m) {
    gs[t] = __ldg(g + k0 + t);
    xs[t] = __ldg(xi + k0 + t);
  }
  __syncthreads();
  const float a = t < m ? xs[t] : 0.0f, c = t + 1 < m ? xs[t + 1] : a;
  const bool finite = t >= m || isfinite(a);
  return __syncthreads_and(finite && a >= c) ? 1.0f
         : __syncthreads_and(finite && a <= c) ? -1.0f : 0.0f;
}

// A row's blocks step over its samples, kThreads at a time (a uniform trip
// count, so the barriers hold); the binned path zeroes the row instead. With
// P <= kThreads the points are staged once.
template <int D>
__global__ void __launch_bounds__(kThreads)
kde_dot_kernel(const float* __restrict__ s, const float* __restrict__ g,
               const float* __restrict__ xi, const int* __restrict__ binned,
               float* __restrict__ out, long long L, int P, float h, Cut cut) {
  __shared__ float gs[kThreads];
  __shared__ float xs[kThreads];
  const int n = blockIdx.y, t = threadIdx.x;
  const long long row = (long long)n * L;
  const long long stride = (long long)gridDim.x * kThreads;
  if (*binned) {
    zero_row(out + row, L, (long long)blockIdx.x * kThreads + t, stride);
    return;
  }
  const float* gn = g + (long long)n * P;
  const bool once = P <= kThreads;
  float dir = once ? stage_points(gn, xi, gs, xs, 0, P) : 0.0f;
  for (long long l0 = (long long)blockIdx.x * kThreads; l0 < L; l0 += stride) {
    const long long l = l0 + t;
    const float sv = l < L ? __ldg(s + row + l) : 0.0f;
    Kahan acc;
    for (int k0 = 0; k0 < P; k0 += kThreads) {
      const int m = min(kThreads, P - k0);
      if (!once) dir = stage_points(gn, xi, gs, xs, k0, m);
      int lo = 0, hi = m;
      if (dir != 0.0f) window(sv, xs, m, dir, cut, lo, hi);
#pragma unroll (kUnroll)
      for (int k = lo; k < hi; ++k) acc.add(__fmul_rn(gs[k], kde_term<D>(sv, xs[k], h)));
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
  const Cut cut = make_cut(h);
  if (nblk > 0) {
    const dim3 grid(nblk < kSumBlocks ? nblk : kSumBlocks, N);
    if (deriv == 0 && !w)
      kde_sum_partial<0, false><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h, cut);
    else if (deriv == 0)
      kde_sum_partial<0, true><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h, cut);
    else if (!w)
      kde_sum_partial<1, false><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h, cut);
    else
      kde_sum_partial<1, true><<<grid, kThreads, 0, st>>>(sf, wf, xf, bf, pf, L, P, nblk, h, cut);
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
  const Cut cut = make_cut(h);
  if (deriv == 1)
    kde_dot_kernel<1><<<grid, kThreads, 0, st>>>((const float*)s, (const float*)g,
                                                 (const float*)xi, (const int*)binned,
                                                 (float*)out, L, P, h, cut);
  else
    kde_dot_kernel<2><<<grid, kThreads, 0, st>>>((const float*)s, (const float*)g,
                                                 (const float*)xi, (const int*)binned,
                                                 (float*)out, L, P, h, cut);
  return (int)cudaGetLastError();
}
