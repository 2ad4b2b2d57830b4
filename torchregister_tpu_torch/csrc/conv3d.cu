// K3: the valid 3x3x3 convolution of the U-Net, for Hopper (sm_90a).
//
// Replaces torchregister_tpu/ops/pallas/conv3d.py:_conv_kernel (variant A)
// and _conv_kernel_c (variant C, the same convolution with H cut in strips):
//
//   out[n, co, z, y, x] = sum over ci, dz, dy, dx of
//                         x[n, ci, z+dz, y+dy, x+dx] * w[dz, dy, dx, ci, co]
//
// with x [N, Ci, Z, H, W] (f32 or bf16), w [3, 3, 3, Ci, Co] given here as f32
// [27, Ci, Co], out [N, Co, Z-2, H-2, W-2] in x's type, no bias, valid
// padding, every sum in f32 and a bf16 output rounded once on the store. The
// input gradient runs the same kernel on the cotangent zero-padded by 2, with
// the weights flipped in space and Ci, Co swapped (ops/cuda/conv3d.py).
//
// What the Pallas kernel works around and this one does not need: Mosaic's
// matmul compiles only on 128-lane-aligned slices, so the TPU kernel pads W to
// a multiple of 128, folds the z taps into a K = 3*Ci contraction and picks
// between a whole-plane (A) and an H-strip (C) layout by a VMEM sizing model.
// Here one layout serves every shape: blocks are small and independent.
//
// What bounds it on this card: FP32 FMAs, not bytes. The U-Net's channels are
// narrow (1 to 32 on the recipe) but every output takes 27 * Ci FMAs per
// channel; at 8->8 and 116^3 outputs that is 2.7e9 FMAs against 50 MB in and
// out. The design: a block owns a 16 y x 32 x tile of one output z plane for
// a chunk of CO_T output channels (2, 4 or 8, the smallest that covers Co;
// larger Co is looped in chunks of 8 over the grid). For CI_T input channels
// at a time it stages the 3 x 18 x 34 input halo (converted to f32) and the
// 27 x CO_T weights in shared memory. Each thread owns one x and two
// consecutive y of the tile and keeps 2 * CO_T accumulators in registers: per
// (ci, dz, dx) it reads 4 input rows once and reuses them over the three dy
// taps, and each weight it reads feeds two FMAs. Threads of a warp read
// consecutive x (no bank conflicts); the weights are broadcast. Global
// offsets are 64-bit. No tensor cores and no TF32: every product is an f32
// FMA.
//
// Grid: (tiles of the plane, Z-2, N * ceil(Co / CO_T)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;          // output x per tile (one warp)
constexpr int kRows = 8;         // thread rows per block
constexpr int kTY = 2 * kRows;   // output y per tile (two per thread)
constexpr int kThreads = kTX * kRows;
constexpr int kCiT = 4;          // input channels staged per pass
constexpr int kSX = kTX + 2;     // staged halo width
constexpr int kSY = kTY + 2;     // staged halo height

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int CO_T>
__global__ void __launch_bounds__(kThreads)
conv3x3x3_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                 int Ci, int Co, int Z, int H, int W, int tiles_x, int co_chunks) {
  __shared__ float s_in[kCiT][3][kSY][kSX];
  __shared__ __align__(16) float s_w[kCiT][27][CO_T];

  const int Ho = H - 2, Wo = W - 2, Zo = Z - 2;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int z = blockIdx.y;
  const int n = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z % co_chunks) * CO_T;
  const int lx = threadIdx.x % kTX;
  const int ly = threadIdx.x / kTX;

  const long long plane = (long long)H * W;
  const long long vol = (long long)Z * plane;
  const T* xn = x + (long long)n * Ci * vol + (long long)z * plane;

  float acc[2][CO_T];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[r][o] = 0.0f;

  constexpr int kPerC = 3 * kSY * kSX;
  for (int c0 = 0; c0 < Ci; c0 += kCiT) {
    const int nc = min(kCiT, Ci - c0);
    __syncthreads();  // the previous pass is done with shared memory
    for (int i = threadIdx.x; i < nc * kPerC; i += kThreads) {
      const int c = i / kPerC;
      const int r = i - c * kPerC;
      const int dz = r / (kSY * kSX);
      const int r2 = r - dz * (kSY * kSX);
      const int yy = r2 / kSX;
      const int xx = r2 - yy * kSX;
      const int gy = ty0 + yy, gx = tx0 + xx;
      float v = 0.0f;
      if (gy < H && gx < W)
        v = to_f(xn[(long long)(c0 + c) * vol + (long long)dz * plane + (long long)gy * W + gx]);
      s_in[c][dz][yy][xx] = v;
    }
    for (int i = threadIdx.x; i < nc * 27 * CO_T; i += kThreads) {
      const int c = i / (27 * CO_T);
      const int r = i - c * (27 * CO_T);
      const int tap = r / CO_T;
      const int o = r - tap * CO_T;
      const int co = co0 + o;
      s_w[c][tap][o] = co < Co ? w[((long long)tap * Ci + c0 + c) * Co + co] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) v[r] = s_in[c][dz][2 * ly + r][lx + dx];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float* wp = s_w[c][dz * 9 + dy * 3 + dx];
#pragma unroll
            for (int o = 0; o < CO_T; ++o) {
              const float wv = wp[o];
              acc[0][o] = fmaf(v[dy], wv, acc[0][o]);
              acc[1][o] = fmaf(v[dy + 1], wv, acc[1][o]);
            }
          }
        }
      }
    }
  }

  const int ox = tx0 + lx;
  if (ox >= Wo) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oy = ty0 + 2 * ly + r;
    if (oy >= Ho) continue;
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      const int co = co0 + o;
      if (co < Co)
        store(out + (((long long)n * Co + co) * Zo + z) * ((long long)Ho * Wo) +
                  (long long)oy * Wo + ox,
              acc[r][o]);
    }
  }
}

template <typename T, int CO_T>
int launch(const void* x, const void* w, void* out, int N, int Ci, int Co, int Z, int H,
           int W, cudaStream_t stream) {
  const int tiles_x = (W - 2 + kTX - 1) / kTX;
  const int tiles_y = (H - 2 + kTY - 1) / kTY;
  const int co_chunks = (Co + CO_T - 1) / CO_T;
  const long long gz = (long long)N * co_chunks;
  if (Z - 2 > 65535 || gz > 65535 || (long long)tiles_x * tiles_y > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid(tiles_x * tiles_y, Z - 2, (unsigned)gz);
  conv3x3x3_kernel<T, CO_T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)w, (T*)out, Ci, Co, Z, H, W, tiles_x, co_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int N, int Ci, int Co, int Z, int H,
             int W, cudaStream_t stream) {
  if (Co <= 2) return launch<T, 2>(x, w, out, N, Ci, Co, Z, H, W, stream);
  if (Co <= 4) return launch<T, 4>(x, w, out, N, Ci, Co, Z, H, W, stream);
  return launch<T, 8>(x, w, out, N, Ci, Co, Z, H, W, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). x is contiguous [N, Ci, Z, H, W]
// of dtype 0 (f32) or 1 (bf16); w is contiguous f32 [27, Ci, Co] (tap index
// dz*9 + dy*3 + dx); out is contiguous [N, Co, Z-2, H-2, W-2] of x's dtype.
// Returns cudaGetLastError() after the launch, or an error code for a shape
// the grid cannot hold.
extern "C" int conv3x3x3(const void* x, const void* w, void* out, int N, int Ci, int Co,
                         int Z, int H, int W, int dtype, void* stream) {
  if (N <= 0 || Ci <= 0 || Co <= 0 || Z < 3 || H < 3 || W < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(x, w, out, N, Ci, Co, Z, H, W, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, N, Ci, Co, Z, H, W, s);
  return (int)cudaErrorInvalidValue;
}
