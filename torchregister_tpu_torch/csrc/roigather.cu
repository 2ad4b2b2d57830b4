// K2b: the compact ROI gather of the exact affine warp's compact-block route,
// for Hopper (sm_90a).
//
// Replaces torchregister_tpu/ops/pallas/roigather.py:_kernel. For each output
// tile t, with the five int32 scalars (zq, yq, zr, yr, ox) of row t,
//
//   out[t, c, a*16 + b] = vol[8*zq + zr + a, 8*yq + yr + b, ox + c]
//
// for a, b, c in [0, 16): the tile's 16^3 source window, restacked so that x
// (c) is the slow axis of the output row and (z, y) the fast one, which is
// the layout the hat contraction (ops/blocked.py:_roi_hat_contract) consumes.
// The route's host code (_roi_supports) clamps every window into the volume,
// so the kernel reads the unpadded volume; an index outside it reads 0 (the
// plain version in ops/cuda/roigather.py does the same), so a caller's bad
// scalars never read out of bounds.
//
// What the Pallas kernel works around and this one does not need: a TPU
// fetches blocks by DMA at 8-voxel granularity, so it fetched nine 8x8xXp
// blocks around each window and selected the window out of them with two
// one-hot matmuls on the MXU. Here a block reads its window directly.
//
// What bounds it on this card: memory bytes. It writes 16 KB per tile (at
// 240^3, T = 13824 tiles: 226.5 MB) and reads each tile's 16 KB window,
// which overlaps its neighbours' (tile edge 10, window 16), so the volume
// (55.3 MB) comes from device memory about once and the rest from L2. The
// trouble is the transpose: x is contiguous in the volume, while the output
// is c-major. The design: one block of 256 threads per tile stages the
// window in shared memory with reads along x (16 consecutive floats per
// row, two rows per warp), then each thread writes one ab column for every
// c, so consecutive threads write consecutive addresses. The shared tile's
// rows are padded to 17 floats, so the transposed reads of a warp (stride
// 17 words) hit 32 different banks.
//
// Forward only and f32 only, as the JAX kernel is; a pure copy, so it equals
// its plain version to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 16;         // window edge: AW = BW = CW = 16
constexpr int kQB = 8;         // quantization block of the (zq, yq) scalars
constexpr int kRow = kW + 1;   // padded shared row (bank-conflict free)
constexpr int kThreads = kW * kW;  // 256: one thread per output column ab

__global__ void roigather_kernel(const float* __restrict__ vol, const int* __restrict__ scal,
                                 float* __restrict__ out, int Z, int Y, int X) {
  __shared__ float tile[kW * kW * kRow];
  const int t = blockIdx.x;
  const int* s = scal + 5 * (long long)t;
  const int z0 = kQB * __ldg(s + 0) + __ldg(s + 2);
  const int y0 = kQB * __ldg(s + 1) + __ldg(s + 3);
  const int x0 = __ldg(s + 4);
  const int tid = threadIdx.x;
  // stage: element e = (a*16 + b)*16 + c, consecutive threads on consecutive x
#pragma unroll 4
  for (int e = tid; e < kW * kW * kW; e += kThreads) {
    const int c = e % kW;
    const int ab = e / kW;
    const int z = z0 + ab / kW, y = y0 + ab % kW, x = x0 + c;
    float v = 0.0f;
    if (z >= 0 && z < Z && y >= 0 && y < Y && x >= 0 && x < X)
      v = __ldg(vol + ((long long)z * Y + y) * X + x);
    tile[ab * kRow + c] = v;
  }
  __syncthreads();
  // write: row c of the output tile, column ab = tid
  float* dst = out + (long long)t * (kW * kW * kW) + tid;
#pragma unroll
  for (int c = 0; c < kW; ++c) dst[c * (kW * kW)] = tile[tid * kRow + c];
}

}  // namespace

// Plain C interface (loaded with ctypes). vol is contiguous [Z, Y, X] f32,
// scal contiguous [T, 5] int32, out contiguous [T, 16, 256] f32. Returns
// cudaGetLastError() after the launch.
extern "C" int roigather(const void* vol, const void* scal, void* out, int T, int Z, int Y,
                         int X, void* stream) {
  if (T <= 0) return 0;
  roigather_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const int*)scal, (float*)out, Z, Y, X);
  return (int)cudaGetLastError();
}
