// The ROI-stages probe's fetch kernel for Hopper (sm_90a).
//
// Replaces fetch_kernel of benchmarks/probe_roi_stages.py:69, K2b's quantized
// fetch with the restack taken out: for each output tile t, with the block
// origins (zq, yq) of row t of the K2b scalars (zq, yq, zr, yr, ox),
//
//   out[t, 0, l] = sum over i, j < 3, z, y < 8, h < Xp / 128 of
//                  volp[8 * (zq + i) + z, 8 * (yq + j) + y, 128 * h + l]
//
// for l < 128: the nine (8, 8, Xp) blocks a tile's window lies in, summed
// and folded to 128 lanes (the Pallas kernel's reshape(-1, 128).sum(0) over
// each block). The origins are checked on the host before the launch.
//
// What bounds it on this card: memory bytes. At 240^3 (volp 256^3 zero-padded,
// 67.1 MB; T = 13825 tiles; out 7.1 MB) the bound counts the blocks the tiles
// touch read once and the output written once: 0.021 ms at 3.35 TB/s. The
// tiles' windows overlap: 9 * 64 KB of logical reads a tile, 8.15 GB, over
// only 32 x 32 distinct blocks.
//
// Design: two stages, each lane's additions in one fixed order (each block's
// z planes, each plane's y rows and, within a row, its Xp / 128 folds; then
// the nine blocks in the order (i, j)), so a run repeats to the bit. Stage 1
// sums every 8-block of the volume once into a [Zp/8, Yp/8, 128] scratch
// (from the wrapper): a CUDA block a volume block, a warp a z plane, a thread
// four lanes, 16-byte loads where the volume is 16-byte aligned; the planes'
// sums meet in shared memory and one warp adds them in z order. Stage 2 adds
// each tile's nine block sums from the scratch (512 KB, held in L2): a warp a
// tile, a thread four lanes. The volume is read once instead of ~9 times.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQB = 8;      // block edge along z and y
constexpr int kNB = 3;      // blocks along z and y
constexpr int kLanes = 128;
constexpr int kQuads = kLanes / 4;     // a thread's four lanes: a warp covers 128
constexpr int kThreads = kQB * kQuads;  // stage 1: a warp a z plane
constexpr int kTilesABlock = kThreads / 32;  // stage 2: a warp a tile

struct Quad {
  float v[4];
};

template <bool kVec>
__device__ __forceinline__ Quad load4(const float* p) {
  Quad q;
  if (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    q.v[0] = a.x, q.v[1] = a.y, q.v[2] = a.z, q.v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q.v[k] = __ldg(p + k);
  }
  return q;
}

// block (bz, by) = (blockIdx.y, blockIdx.x); thread (z, quad). kFolds is
// Xp / 128 where it is 1, 2 or 3 (every load of a thread is then issued
// before its adds), 0 for any other, read at run time.
template <bool kVec, int kFolds>
__global__ void __launch_bounds__(kThreads)
roi_fetch_blocks_kernel(const float* __restrict__ volp, float* __restrict__ blk, int Yp,
                        int Xp) {
  __shared__ float planes[kQB][kLanes];
  const int by = blockIdx.x, bz = blockIdx.y;
  const int z = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int folds = kFolds ? kFolds : Xp / kLanes;
  const float* row = volp + ((long long)(kQB * bz + z) * Yp + kQB * by) * Xp + 4 * q;
  float plane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int y = 0; y < kQB; ++y)
#pragma unroll
    for (int h = 0; h < folds; ++h) {
      const Quad a = load4<kVec>(row + (long long)y * Xp + h * kLanes);
#pragma unroll
      for (int k = 0; k < 4; ++k) plane[k] += a.v[k];
    }
#pragma unroll
  for (int k = 0; k < 4; ++k) planes[z][4 * q + k] = plane[k];
  __syncthreads();
  if (threadIdx.x < kLanes) {
    const int l = threadIdx.x;
    float b = 0.0f;
#pragma unroll
    for (int zz = 0; zz < kQB; ++zz) b += planes[zz][l];
    blk[((long long)bz * gridDim.x + by) * kLanes + l] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
roi_fetch_tiles_kernel(const float* __restrict__ blk, const int* __restrict__ scal,
                       float* __restrict__ out, int T, int nby) {
  const int t = blockIdx.x * kTilesABlock + threadIdx.x / 32;
  const int q = threadIdx.x % 32;
  if (t >= T) return;
  const int zq = __ldg(scal + 5 * t), yq = __ldg(scal + 5 * t + 1);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kNB; ++i)
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(
                                 blk + ((long long)(zq + i) * nby + yq + j) * kLanes) + q);
      acc[0] += b.x, acc[1] += b.y, acc[2] += b.z, acc[3] += b.w;
    }
  reinterpret_cast<float4*>(out + (long long)t * kLanes)[q] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kVec>
void sum_blocks(const void* volp, void* blk, int nby, int nbz, int Yp, int Xp, cudaStream_t s) {
  const dim3 grid(nby, nbz);
  const float* v = (const float*)volp;
  float* b = (float*)blk;
  switch (Xp / kLanes) {
    case 1: roi_fetch_blocks_kernel<kVec, 1><<<grid, kThreads, 0, s>>>(v, b, Yp, Xp); break;
    case 2: roi_fetch_blocks_kernel<kVec, 2><<<grid, kThreads, 0, s>>>(v, b, Yp, Xp); break;
    case 3: roi_fetch_blocks_kernel<kVec, 3><<<grid, kThreads, 0, s>>>(v, b, Yp, Xp); break;
    default: roi_fetch_blocks_kernel<kVec, 0><<<grid, kThreads, 0, s>>>(v, b, Yp, Xp);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). volp contiguous [Zp, Yp, Xp] f32
// with Xp a multiple of 128, scal contiguous [T, 5] int32 with every (zq, yq)
// in [0, Zp/8 - 3] x [0, Yp/8 - 3], blk a 16-byte aligned f32 scratch of
// (Zp/8) * (Yp/8) * 128 floats, out contiguous 16-byte aligned [T, 1, 128]
// f32. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue, launching nothing, for scratch or output that is
// not 16-byte aligned or a block grid past the card's limits).
extern "C" int roi_fetch(const void* volp, const void* scal, void* blk, void* out, int T, int Zp,
                         int Yp, int Xp, void* stream) {
  if (T <= 0) return 0;
  const int nbz = Zp / kQB, nby = Yp / kQB;
  if (!aligned16(blk) || !aligned16(out) || nbz > 65535 || Xp % kLanes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(volp))
    sum_blocks<true>(volp, blk, nby, nbz, Yp, Xp, s);
  else
    sum_blocks<false>(volp, blk, nby, nbz, Yp, Xp, s);
  roi_fetch_tiles_kernel<<<(T + kTilesABlock - 1) / kTilesABlock, kThreads, 0, s>>>(
      (const float*)blk, (const int*)scal, (float*)out, T, nby);
  return (int)cudaGetLastError();
}
