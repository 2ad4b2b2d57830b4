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
// 67.1 MB; T = 13824 tiles; out 7.1 MB) the bound counts the volume read once:
// (67.1 + 7.1) MB / 3.35 TB/s = 0.022 ms. The tiles' windows overlap, so the
// logical reads are 9 * 64 KB per tile, 8.15 GB; the kernel keeps no shared-
// memory copy of a block, so its time shows how much of that reuse L2 (50 MB)
// gives by itself.
//
// Design: one block per tile, one thread per output lane (128 threads, 512 B
// rows coalesced per warp), each thread summing its lane over the 9 blocks x
// 64 rows x Xp/128 folds in a fixed order in f32 (each row's folds and 8 y
// rows, then the 8 z rows, then the 9 blocks), so a run repeats to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kQB = 8;      // block edge along z and y
constexpr int kNB = 3;      // blocks along z and y
constexpr int kLanes = 128;

__global__ void roi_fetch_kernel(const float* __restrict__ volp, const int* __restrict__ scal,
                                 float* __restrict__ out, int Yp, int Xp) {
  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int zq = __ldg(scal + 5 * t), yq = __ldg(scal + 5 * t + 1);
  const int folds = Xp / kLanes;
  float acc = 0.0f;
  for (int i = 0; i < kNB; ++i)
    for (int j = 0; j < kNB; ++j) {
      float blk = 0.0f;
      for (int z = 0; z < kQB; ++z) {
        const float* row = volp + ((long long)(kQB * (zq + i) + z) * Yp + kQB * (yq + j)) * Xp + l;
        float plane = 0.0f;
#pragma unroll
        for (int y = 0; y < kQB; ++y)
          for (int h = 0; h < folds; ++h) plane += __ldg(row + (long long)y * Xp + h * kLanes);
        blk += plane;
      }
      acc += blk;
    }
  out[(long long)t * kLanes + l] = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes). volp contiguous [Zp, Yp, Xp] f32
// with Xp a multiple of 128, scal contiguous [T, 5] int32, out contiguous
// [T, 1, 128] f32. Returns cudaGetLastError() after the launch.
extern "C" int roi_fetch(const void* volp, const void* scal, void* out, int T, int Yp, int Xp,
                         void* stream) {
  if (T <= 0) return 0;
  roi_fetch_kernel<<<T, kLanes, 0, (cudaStream_t)stream>>>((const float*)volp,
                                                           (const int*)scal, (float*)out, Yp,
                                                           Xp);
  return (int)cudaGetLastError();
}
