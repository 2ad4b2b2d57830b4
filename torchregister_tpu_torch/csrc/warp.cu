// K2: the exact trilinear warp (grid_sample parity, zeros padding), for Hopper
// (sm_90a).
//
// Replaces torchregister_tpu/ops/pallas/roigather.py:_warp_kernel. Each output
// voxel o = (z, y, x) samples the source at a coordinate q in index space:
//
//   affine mode:  q_s = ((M[s,0]*z + M[s,1]*y) + M[s,2]*x) + t[s]
//   flow mode:    q_s = o_s + flow[s, z, y, x]
//
//   f = floor(q), fr = q - f, per axis the weights (1 - fr, fr)
//   out[c, o] = sum over the corners (i, j, k) in {0,1}^3, k fastest, of
//               src[c, fz+i, fy+j, fx+k] * ((wz_i * wy_j) * wx_k)
//
// and a corner outside the volume contributes 0, as in
// ops/resample.py:multilinear_sample of the JAX package. The coordinates are
// computed here from (M, t) or from the field, so no coordinate grid is ever
// materialized; (M, t) arrive as 12 floats in device memory, so a caller
// computes them on the card and never reads them back.
//
// What the Pallas kernel works around and this one does not need: a TPU has
// no per-lane gather, so K2 fetched each 10^3 output tile's 16^3 support with
// 9 quantized block DMAs, restacked it with one-hot MXU products and
// contracted it with hat matrices, and declined any transform whose support
// outgrew its static windows. On Hopper a thread reads its 8 corners
// directly, so there are no tiles, no windows and no decline: every
// transform and size takes the same path.
//
// What bounds it on this card: memory bytes. Per voxel and channel it reads
// the 8 corners (neighbouring threads read neighbouring x, so for a smooth
// map the corners of a warp are shared through L1/L2 and each source byte
// comes from device memory about once) and writes one value; the flow mode
// reads 12 more bytes of field per voxel. The design: one thread per output
// voxel, consecutive threads on consecutive x (coalesced writes and mostly
// coalesced reads), all channels looped inside the thread so the 8 weights
// and offsets are computed once, source and field read through the
// read-only cache, 64-bit offsets (a batch folded into channels passes 2^31
// elements at 240^3 once C >= 156).
//
// Rounding: every product and sum is an explicit round-to-nearest f32
// operation (__fmul_rn / __fadd_rn, never contracted into an FMA), in the
// order written above, so the plain PyTorch version in ops/cuda/warp.py,
// which runs the same elementwise operations, gives the same bits.
//
// Images and fields are f32. A 2D image is a volume with Z == 1 and
// q_z == 0: the z = 0 corner has weight 1 and the z = 1 corner is outside.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <bool kFlow>
__global__ void warp_kernel(const float* __restrict__ src, float* __restrict__ out,
                            const float* __restrict__ mt, const float* __restrict__ flow,
                            long long C, int Z, int Y, int X) {
  const long long nvox = (long long)Z * Y * X;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int size[3] = {Z, Y, X};
  float m[12];
  if (!kFlow) {
    for (int i = 0; i < 12; ++i) m[i] = __ldg(mt + i);
  }
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvox;
       v += stride) {
    const int x = (int)(v % X);
    const long long zy = v / X;
    const int y = (int)(zy % Y);
    const int z = (int)(zy / Y);
    const float p[3] = {(float)z, (float)y, (float)x};
    float w[3][2];
    long long idx[3][2];
    bool ok[3][2];
    for (int s = 0; s < 3; ++s) {
      float q;
      if (kFlow) {
        q = add(p[s], __ldg(flow + s * nvox + v));
      } else {
        q = add(add(add(mul(m[4 * s], p[0]), mul(m[4 * s + 1], p[1])),
                    mul(m[4 * s + 2], p[2])),
                m[4 * s + 3]);
      }
      const float f = floorf(q);
      const float fr = __fsub_rn(q, f);
      w[s][0] = __fsub_rn(1.0f, fr);
      w[s][1] = fr;
      // Range tests in float (false for NaN); the index is formed only for
      // an in-range corner, so a far-out coordinate never overflows an int.
      for (int i = 0; i < 2; ++i) {
        const float c = add(f, (float)i);
        ok[s][i] = c >= 0.0f && c <= (float)(size[s] - 1);
        idx[s][i] = ok[s][i] ? (long long)c : 0;
      }
    }
    float wc[8];
    long long off[8];
    bool in[8];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 2; ++k) {
          const int n = 4 * i + 2 * j + k;
          wc[n] = mul(mul(w[0][i], w[1][j]), w[2][k]);
          in[n] = ok[0][i] && ok[1][j] && ok[2][k];
          off[n] = (idx[0][i] * Y + idx[1][j]) * X + idx[2][k];
        }
    for (long long c = 0; c < C; ++c) {
      const float* plane = src + c * nvox;
      float acc = 0.0f;
      for (int n = 0; n < 8; ++n) {
        const float val = in[n] ? __ldg(plane + off[n]) : 0.0f;
        acc = add(acc, mul(val, wc[n]));
      }
      out[c * nvox + v] = acc;
    }
  }
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <bool kFlow>
int launch(const void* src, void* out, const void* mt, const void* flow, long long C,
           int Z, int Y, int X, cudaStream_t stream) {
  long long nvox = (long long)Z * Y * X;
  if (nvox == 0 || C == 0) return 0;
  warp_kernel<kFlow><<<grid_for(nvox), kThreads, 0, stream>>>(
      (const float*)src, (float*)out, (const float*)mt, (const float*)flow, C, Z, Y, X);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). src and out are contiguous
// [C, Z, Y, X] f32; mt is 12 f32 (M row-major with t[s] after row s);
// flow is contiguous [3, Z, Y, X] f32. Returns cudaGetLastError() after the
// launch.
extern "C" int warp_affine(const void* src, void* out, const void* mt, long long C, int Z,
                           int Y, int X, void* stream) {
  return launch<false>(src, out, mt, nullptr, C, Z, Y, X, (cudaStream_t)stream);
}

extern "C" int warp_flow(const void* src, void* out, const void* flow, long long C, int Z,
                         int Y, int X, void* stream) {
  return launch<true>(src, out, nullptr, flow, C, Z, Y, X, (cudaStream_t)stream);
}
