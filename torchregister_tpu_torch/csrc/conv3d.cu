// K3: the 3x3x3 convolution of the U-Net and the Sobel edge filter, and its
// weight gradient, for Hopper (sm_90a), on the tensor cores.
//
// conv3x3x3 replaces torchregister_tpu/ops/pallas/conv3d.py:_conv_kernel
// (variant A) and _conv_kernel_c (variant C, the same convolution with H cut
// in strips):
//
//   out[n, co, z, y, x] = sum over ci, dz, dy, dx of
//                         x[n, ci, z+dz-p, y+dy-p, x+dx-p] * w[dz, dy, dx, ci, co]
//
// with x [N, Ci, Z, H, W] (f32 or bf16), w [27, Ci, Co] in x's type (tap
// dz*9 + dy*3 + dx), out [N, Co, Z-2+2p, H-2+2p, W-2+2p] in x's type, no bias,
// every sum in f32 and a bf16 output rounded once on the store. Reads outside
// x are zero. p = 0 is the forward's valid convolution; p = 2 is the input
// gradient, run on the cotangent itself with the weights flipped in space and
// Ci, Co swapped (ops/cuda/conv3d.py), so no padded copy of it is made.
//
// conv3x3x3_wgrad replaces the JAX package's XLA weight gradient
// (conv3d.py:_wgrad_xla, 27 einsums at Precision.HIGHEST; not a Pallas
// kernel):
//
//   dw[dz, dy, dx, ci, co] = sum over n, z, y, x of
//                            x[n, ci, z+dz, y+dy, x+dx] * g[n, co, z, y, x]
//
// in f32, with g [N, Co, Z-2, H-2, W-2] in x's type and dw f32 [27, Ci, Co].
//
// What bounds them on this card: operations. The U-Net's channels are narrow
// (1 to 32) but every output takes 27 * Ci products per channel; at 8->8 and
// 116^3 outputs that is 5.4 GFLOP against 100 MB in and out. Both are implicit
// GEMMs on mma.sync. f32 runs as 3xTF32: each operand is split into big (a
// rounded to TF32) and small (the rest, cut to TF32), and small*big +
// big*small + big*big is summed in f32 accumulators, ~2^-20 from the f32
// product (a single TF32 pass keeps ~3 decimal digits). bf16 operands are
// exact in TF32 and their products exact in f32, so bf16 takes one pass:
// conv3x3x3 on bf16 MMAs (m16n8k16), the weight gradient on one TF32 MMA of
// the widened values. The tensor cores add into an accumulator cutting toward
// zero, so a long chain of MMAs drifts by up to an ulp a step: each chunk of
// K (conv3x3x3) or tile of voxels (the weight gradient) sums into fresh
// accumulators, and those sums are added in f32.
//
// conv3x3x3: M = output voxels, N = Co (all of it in one block, up to 32;
// more is a grid axis), K = 27 * Ci. A block owns a 32 x by 32 y tile of one
// output z plane where N = 8 (32 x by 16 y where N > 8, for the registers);
// each of its 8 warps owns 16 x by 8 (or 4) rows and all of N. K is folded as
// in the TPU kernel: j = 3 * ci + dz, in chunks of 8 MMA k-words (8 values of
// j in f32, 8 pairs of j in bf16), then the 9 (dy, dx) taps. A chunk stages,
// per word, the input halo (34 x 34 or 34 x 18) of plane z + dz - p of
// channel ci, and the chunk's weights, in shared memory; zeros past the input
// and past K. The f32 path stages with cp.async (4-byte, zero-fill for reads
// outside x: TMA's 16-byte global strides do not hold for rows of 118 or 59
// floats) into a double buffer, so chunk k+1 loads while chunk k multiplies.
// The bf16 path packs two values of j into one 32-bit word, which cp.async
// cannot interleave: it loads through registers into the same double buffer.
// Per (chunk, dx) a warp loads each of its halo rows once and uses it for the
// 3 dy taps of the rows it covers. Word strides of 8 mod 32 (halo) and 8, 24
// or 40 (weights) keep every fragment load free of bank conflicts. What holds
// it back is not the tensor cores but the staging (each input plane is staged
// by 3 output planes, 4 bytes a copy) and the operand splits and
// shared-memory loads around each MMA.
//
// conv3x3x3_wgrad: M = 27 * (8 input channels), N = Co (up to 32), K = the
// voxels, split over blocks. A block walks a fixed range of 4 x 32 output
// tiles, z fastest, for one chunk of 8 input channels. Per tile it stages the
// g tile (double buffer) and one new input plane of the 8-channel 34 x 6 halo
// into a ring of 4 planes (all 3 where a run along z starts), cp.async as
// above, and forms all 27 taps from the 3 staged planes; its 8 warps own the
// M tiles. Each block writes its partial [27, 8, Co] into a workspace and a
// second pass sums the partials in ascending block order. No float atomics
// anywhere: two launches on the same inputs give the same bits.
//
// A weight set per item (the U-Net cohort: each pair trains its own net,
// JAX's vmap of the Pallas kernel over a batched weight operand). conv3x3x3
// takes w [N, 27, Ci, Co] and a block of item n reads set n; the weight
// gradient's grid.x holds N x splits blocks, each pair's split as for that
// pair alone, and writes dw [N, 27, Ci, Co], each pair's splits summed in
// ascending order. So each item's output, input gradient and dw equal a
// launch on that item alone to the bit.
//
// Global offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWords = 8;      // MMA k-words per chunk
constexpr int kStages = 2;     // shared-memory buffers the staging cycles through

// ---- tensor-core and copy primitives --------------------------------------

// An MMA operand register of the f32 path as its big and small TF32 halves:
// big is the value rounded to TF32's 10 fraction bits (half up in magnitude),
// small the exact rest cut to 10 bits; |a - big - small| <= 2^-21 |a|; integer
// ops and one FADD. A bf16 word (or a bf16 value widened to f32, exact in
// TF32) passes as is.
template <int P>
__device__ __forceinline__ void operand(uint32_t word, uint32_t (&out)[P]) {
  if constexpr (P == 2) {
    out[0] = (word + 0x1000u) & 0xffffe000u;
    out[1] = __float_as_uint(__uint_as_float(word) - __uint_as_float(out[0])) & 0xffffe000u;
  } else {
    out[0] = word;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b on one 16 x 8 tile. a[r][p], b[r][p]: register r of the
// fragment, part p (P = 2: big, small; 3xTF32, small terms first).
template <int P, bool kBF16>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4][P],
                                    const uint32_t (&b)[2][P]) {
  if constexpr (kBF16) {
    mma_bf16(d, a[0][0], a[1][0], a[2][0], a[3][0], b[0][0], b[1][0]);
  } else {
    if constexpr (P == 2) {
      mma_tf32(d, a[0][1], a[1][1], a[2][1], a[3][1], b[0][0], b[1][0]);
      mma_tf32(d, a[0][0], a[1][0], a[2][0], a[3][0], b[0][1], b[1][1]);
    }
    mma_tf32(d, a[0][0], a[1][0], a[2][0], a[3][0], b[0][0], b[1][0]);
  }
}

// 4 bytes global -> shared, asynchronous; zeros where !ok (src-size 0)
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t widened(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The dynamic shared memory of kernel K (its bytes are fixed for each
// instantiation), allowed once a device, so that a launch inside a CUDA graph
// capture makes no other CUDA call than the launch itself.
template <auto K>
int allow_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && ready[dev]) return 0;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

// ---- conv3x3x3 --------------------------------------------------------------

// resident blocks of 8 warps an SM holds of each kernel: two, or one where
// N = 24 or 32 takes more than 128 registers a thread
template <int NT>
constexpr int kBlocksPerSM = NT >= 3 ? 1 : 2;

// conv3x3x3's tiling for N = 8 * NT output channels: a warp covers 16 x by
// WY rows (8 where N = 8, else 4, for the registers), a block 2 x 4 warps
template <int NT>
struct ConvTile {
  static constexpr int kWX = 16, kWY = NT == 1 ? 8 : 4;
  static constexpr int kTX = 2 * kWX, kTY = 4 * kWY;  // output tile of one z plane
  static constexpr int kHX = kTX + 2, kHY = kTY + 2;  // its staged input halo
  static constexpr int kHalo = kHX * kHY;
  static constexpr int kCS = kHalo + (40 - kHalo % 32) % 32;  // words a k-word: 8 mod 32
  static constexpr int kSlots = (kHalo + kThreads - 1) / kThreads;
  static constexpr int kCos = NT == 1 ? 8 : NT <= 3 ? 24 : 40;  // words a weight k-word
  static constexpr int kStage = kWords * kCS + 9 * kWords * kCos;
  static_assert(kCS % 32 == 8 && (kCos % 32 == 8 || kCos % 32 == 24), "strides");
};

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<NT>)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int Ci,
            int Co, int Zi, int Hi, int Wi, int pad, int tiles_x, int co_chunks,
            long long w_stride) {
  using L = ConvTile<NT>;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int P = kBF16 ? 1 : 2;
  constexpr int kFold = kBF16 ? 2 : 1;  // values of j in one k-word
  constexpr int kWY = L::kWY, kHX = L::kHX, kCS = L::kCS, kCos = L::kCos;
  extern __shared__ __align__(16) uint32_t smem[];

  const int Zo = Zi - 2 + 2 * pad, Ho = Hi - 2 + 2 * pad, Wo = Wi - 2 + 2 * pad;
  const int tx0 = (blockIdx.x % tiles_x) * L::kTX;
  const int ty0 = (blockIdx.x / tiles_x) * L::kTY;
  const int z = blockIdx.y;
  const int n = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z % co_chunks) * (8 * NT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wx = (warp & 1) * L::kWX, wy = (warp >> 1) * kWY;

  const long long plane = (long long)Hi * Wi;
  const T* xn = x + (long long)n * Ci * Zi * plane;
  const T* wn = w + n * w_stride;  // item n's weights (one set for all: stride 0)
  const int J = 3 * Ci;  // the folded contraction j = 3 * ci + dz
  const int nchunks = (J + kWords * kFold - 1) / (kWords * kFold);

  // this thread's halo positions: offset in the plane, or -1 outside it
  int sp[L::kSlots];
#pragma unroll
  for (int k = 0; k < L::kSlots; ++k) {
    const int p = tid + k * kThreads;
    const int gy = ty0 - pad + p / kHX, gx = tx0 - pad + p % kHX;
    sp[k] = (p < L::kHalo && gy >= 0 && gy < Hi && gx >= 0 && gx < Wi) ? gy * Wi + gx : -1;
  }

  // plane (ci, z + dz - p) of folded index j, or null past K or outside x
  auto plane_of = [&](int j) -> const T* {
    const int ci = j / 3, zz = z + j - 3 * ci - pad;
    return (j < J && zz >= 0 && zz < Zi) ? xn + ((long long)ci * Zi + zz) * plane : nullptr;
  };
  auto weight_of = [&](int j, int tap, int co) -> const T* {
    const int ci = j / 3, dz = j - 3 * ci;
    return (j < J && co < Co) ? wn + ((long long)(dz * 9 + tap) * Ci + ci) * Co + co : nullptr;
  };

  auto stage = [&](int c, int buf) {
    uint32_t* sh = smem + buf * L::kStage;
    uint32_t* sw = sh + kWords * kCS;
    const int j0 = c * kWords * kFold;
#pragma unroll
    for (int word = 0; word < kWords; ++word) {
      if constexpr (kBF16) {
        const T* lo = plane_of(j0 + 2 * word);
        const T* hi = plane_of(j0 + 2 * word + 1);
#pragma unroll
        for (int k = 0; k < L::kSlots; ++k) {
          const int p = tid + k * kThreads;
          if (p < L::kHalo) {
            const bool in = sp[k] >= 0;
            const uint32_t l = (lo && in) ? bits(lo[sp[k]]) : 0u;
            const uint32_t h = (hi && in) ? bits(hi[sp[k]]) : 0u;
            sh[word * kCS + p] = l | (h << 16);
          }
        }
      } else {
        const T* src = plane_of(j0 + word);
#pragma unroll
        for (int k = 0; k < L::kSlots; ++k) {
          const int p = tid + k * kThreads;
          if (p < L::kHalo) {
            const bool ok = src && sp[k] >= 0;
            cp_async4(sh + word * kCS + p, ok ? src + sp[k] : x, ok);
          }
        }
      }
    }
    // weights: [9 taps (dy, dx)][k-word][co]
    for (int e = tid; e < 9 * kWords * 8 * NT; e += kThreads) {
      const int co = e % (8 * NT), r = e / (8 * NT);
      const int word = r % kWords, tap = r / kWords;
      uint32_t* dst = sw + (tap * kWords + word) * kCos + co;
      if constexpr (kBF16) {
        const T* lo = weight_of(j0 + 2 * word, tap, co0 + co);
        const T* hi = weight_of(j0 + 2 * word + 1, tap, co0 + co);
        *dst = (lo ? bits(*lo) : 0u) | ((hi ? bits(*hi) : 0u) << 16);
      } else {
        const T* src = weight_of(j0 + word, tap, co0 + co);
        cp_async4(dst, src ? src : w, src != nullptr);
      }
    }
  };

  float acc[kWY][NT][4];
#pragma unroll
  for (int i = 0; i < kWY; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.0f;

  for (int c = 0; c < kStages - 1 && c < nchunks; ++c) {
    stage(c, c);
    cp_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    const int next = c + kStages - 1;
    if (next < nchunks) stage(next, next % kStages);
    cp_commit();  // an empty group past the end keeps the count below uniform
    cp_wait<kStages - 1>();
    __syncthreads();
    const uint32_t* sh = smem + (c % kStages) * L::kStage;
    const uint32_t* sw = sh + kWords * kCS;
    float part[kWY][NT][4];
#pragma unroll
    for (int i = 0; i < kWY; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][nt][r] = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      // B fragments of the 3 taps (dy, dx): co g, k-words t and t + 4
      uint32_t b[3][NT][2][P];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* q = sw + ((dy * 3 + dx) * kWords + t) * kCos + nt * 8 + g;
          operand<P>(q[0], b[dy][nt][0]);
          operand<P>(q[4 * kCos], b[dy][nt][1]);
        }
      // A fragment of halo row wy + r at x offset dx (x g and g + 8 of the
      // warp's 16, k-words t and t + 4), for output rows r - dy
#pragma unroll
      for (int r = 0; r < kWY + 2; ++r) {
        const uint32_t* q = sh + t * kCS + (wy + r) * kHX + wx + dx + g;
        uint32_t a[4][P];
        operand<P>(q[0], a[0]);
        operand<P>(q[8], a[1]);
        operand<P>(q[4 * kCS], a[2]);
        operand<P>(q[4 * kCS + 8], a[3]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          if (r - dy >= 0 && r - dy < kWY)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma<P, kBF16>(part[r - dy][nt], a, b[dy][nt]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
#pragma unroll
    for (int i = 0; i < kWY; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] += part[i][nt][r];
  }

  // accumulator r of a tile: x g + 8 * (r / 2), co 2t + r % 2
  const long long out_plane = (long long)Ho * Wo;
#pragma unroll
  for (int i = 0; i < kWY; ++i) {
    const int oy = ty0 + wy + i;
    if (oy >= Ho) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ox = tx0 + wx + g + 8 * (r >> 1);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (ox < Wo && co < Co)
          store(out + (((long long)n * Co + co) * Zo + z) * out_plane + (long long)oy * Wo + ox,
                acc[i][nt][r]);
      }
  }
}

template <typename T, int NT>
int conv_launch(const void* x, const void* w, void* out, int N, int Ci, int Co, int Z, int H,
                int W, int pad, long long w_stride, cudaStream_t stream) {
  using L = ConvTile<NT>;
  const int Zo = Z - 2 + 2 * pad, Ho = H - 2 + 2 * pad, Wo = W - 2 + 2 * pad;
  const int tiles_x = (Wo + L::kTX - 1) / L::kTX, tiles_y = (Ho + L::kTY - 1) / L::kTY;
  const int co_chunks = (Co + 8 * NT - 1) / (8 * NT);
  const long long gz = (long long)N * co_chunks;
  if (Zo > 65535 || gz > 65535 || (long long)tiles_x * tiles_y > 2147483647LL ||
      (long long)H * W > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int bytes = kStages * L::kStage * 4;
  const int rc = allow_smem<conv_kernel<T, NT>>(bytes);
  if (rc != 0) return rc;
  dim3 grid(tiles_x * tiles_y, Zo, (unsigned)gz);
  conv_kernel<T, NT><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, (const T*)w, (T*)out, Ci, Co, Z, H, W, pad, tiles_x, co_chunks, w_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_dispatch(const void* x, const void* w, void* out, int N, int Ci, int Co, int Z, int H,
                  int W, int pad, long long ws, cudaStream_t s) {
  switch (Co <= 8 ? 1 : Co <= 16 ? 2 : Co <= 24 ? 3 : 4) {
    case 1: return conv_launch<T, 1>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
    case 2: return conv_launch<T, 2>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
    case 3: return conv_launch<T, 3>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
    default: return conv_launch<T, 4>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
  }
}

// ---- conv3x3x3_wgrad ---------------------------------------------------------

constexpr int kGY = 4, kGX = 32;               // an output tile of one z plane
constexpr int kGHX = kGX + 2, kGHY = kGY + 2;  // its input halo, 34 x 6 a plane
constexpr int kGPlane = kGHX * kGHY;
constexpr int kRing = 4;                       // input planes a channel keeps staged
constexpr int kXS = kRing * kGPlane + 4;       // words a channel's ring: 4 mod 8
constexpr int kGS = kGY * kGX + 4;             // words a g channel's tile: 4 mod 32
constexpr int kCiC = 8;                        // input channels a block
static_assert(kXS % 8 == 4 && kGS % 32 == 4, "wgrad word strides");

template <int NT>
__host__ __device__ constexpr int wgrad_smem_words() { return kCiC * kXS + 2 * 8 * NT * kGS; }

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<NT>)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gr, float* __restrict__ ws,
             int N, int Ci, int Co, int Z, int H, int W, int splits) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  constexpr int kGTile = 8 * NT * kGS;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sx = smem;  // [ci][ring slot z % 4][row][x]
  uint32_t* sg = smem + kCiC * kXS;  // [2][co][voxel]

  const int Zo = Z - 2, Ho = H - 2, Wo = W - 2;
  const int tiles_x = (Wo + kGX - 1) / kGX, tiles_y = (Ho + kGY - 1) / kGY;
  const long long units = (long long)N * tiles_y * tiles_x * Zo;  // z fastest
  // a weight set per pair: grid.x holds pairs x splits and each pair's
  // blocks see its N = 1 items alone (one shared set: pair 0 only)
  const int pair = blockIdx.x / splits, s = blockIdx.x - pair * splits;
  const long long u0 = units * s / splits, u1 = units * (s + 1) / splits;
  const int ci0 = blockIdx.y * kCiC, cic = min(kCiC, Ci - ci0);
  const int co0 = blockIdx.z * 8 * NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows = 27 * cic;  // M: row m is tap m / cic, channel m % cic

  const long long vol = (long long)Z * H * W, ovol = (long long)Zo * Ho * Wo;
  x += (long long)pair * N * Ci * vol;
  gr += (long long)pair * N * Co * ovol;
  ws += (long long)pair * splits * 27 * Ci * Co;

  // this warp's M tiles (warp, warp + 8): each lane's rows g and g + 8 in them
  // as a halo offset without the plane and the plane's dz
  int roff[2][2], rdz[2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp + 8 * q) * 16 + g + 8 * h;
      const int tap = m < rows ? m / cic : 0, ci = m < rows ? m - tap * cic : 0;
      roff[q][h] = ci * kXS + (tap / 3 % 3) * kGHX + tap % 3;
      rdz[q][h] = tap / 9;
    }
  const bool busy[2] = {warp * 16 < rows, (warp + 8) * 16 < rows};

  struct Unit { int n, z, y0, x0; };
  auto unit = [&](long long u) {
    const int z = (int)(u % Zo);
    long long r = u / Zo;
    const int tx = (int)(r % tiles_x);
    r /= tiles_x;
    return Unit{(int)(r / tiles_y), z, (int)(r % tiles_y) * kGY, tx * kGX};
  };

  // unit u's g tile into buffer (u - u0) % 2, and its input planes z + 2 (a
  // run goes on) or z .. z + 2 (a run starts) into ring slots plane % 4
  auto stage = [&](long long u, bool run_starts) {
    const Unit un = unit(u);
    const T* xb = x + ((long long)un.n * Ci + ci0) * vol;
    const int dz0 = run_starts ? 0 : 2;
    for (int p = tid; p < (3 - dz0) * kGPlane; p += kThreads) {
      const int zz = un.z + dz0 + p / kGPlane, rem = p % kGPlane;
      const int gy = un.y0 + rem / kGHX, gx = un.x0 + rem % kGHX;
      const bool in = gy < H && gx < W;
      const long long off = in ? ((long long)zz * H + gy) * W + gx : 0;
      uint32_t* dst = sx + (zz % kRing) * kGPlane + rem;
#pragma unroll
      for (int c = 0; c < kCiC; ++c) {
        const bool ok = in && c < cic;
        if constexpr (P == 2) {
          cp_async4(dst + c * kXS, ok ? xb + c * vol + off : x, ok);
        } else {
          dst[c * kXS] = ok ? widened(xb[c * vol + off]) : 0u;
        }
      }
    }
    const T* gb = gr + ((long long)un.n * Co + co0) * ovol + (long long)un.z * Ho * Wo;
    uint32_t* gdst = sg + (int)((u - u0) & 1) * kGTile;
    for (int e = tid; e < 8 * NT * kGY * kGX; e += kThreads) {
      const int co = e / (kGY * kGX), v = e % (kGY * kGX);
      const int oy = un.y0 + v / kGX, ox = un.x0 + v % kGX;
      const bool ok = co0 + co < Co && oy < Ho && ox < Wo;
      const long long off = ok ? co * ovol + (long long)oy * Wo + ox : 0;
      if constexpr (P == 2) {
        cp_async4(gdst + co * kGS + v, ok ? gb + off : gr, ok);
      } else {
        gdst[co * kGS + v] = ok ? widened(gb[off]) : 0u;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][nt][r] = 0.0f;

  // Units run along z, so each stages one new input plane; the ring's fourth
  // slot takes it while the unit before reads the other three. A new run
  // (z = 0, another tile) stages all three planes once the unit before is done.
  if (u0 < u1) {
    stage(u0, true);
    cp_commit();
  }
  for (long long u = u0; u < u1; ++u) {
    const int z = (int)(u % Zo);
    const bool run_goes_on = u + 1 < u1 && z + 1 < Zo;
    if (run_goes_on) stage(u + 1, false);
    cp_commit();  // an empty group where nothing was staged keeps the count uniform
    cp_wait<1>();
    __syncthreads();
    const uint32_t* gt = sg + (int)((u - u0) & 1) * kGTile;
    int off[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) off[q][h] = roff[q][h] + ((z + rdz[q][h]) % kRing) * kGPlane;
    float part[2][NT][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[q][nt][r] = 0.0f;
    // k-steps of 8 voxels along x: voxel t and t + 4 of the step
#pragma unroll 4
    for (int kq = 0; kq < kGY * kGX / 8; ++kq) {
      const int vy = kq / (kGX / 8), vx = (kq % (kGX / 8)) * 8;
      uint32_t b[NT][2][P];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* q = gt + (nt * 8 + g) * kGS + vy * kGX + vx + t;
        operand<P>(q[0], b[nt][0]);
        operand<P>(q[4], b[nt][1]);
      }
      const int hv = vy * kGHX + vx + t;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!busy[q]) continue;
        uint32_t a[4][P];
        operand<P>(sx[off[q][0] + hv], a[0]);
        operand<P>(sx[off[q][1] + hv], a[1]);
        operand<P>(sx[off[q][0] + hv + 4], a[2]);
        operand<P>(sx[off[q][1] + hv + 4], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma<P, false>(part[q][nt], a, b[nt]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][nt][r] += part[q][nt][r];
    if (u + 1 < u1 && !run_goes_on) {
      stage(u + 1, true);
      cp_commit();
    }
  }

  // the block's partial: ws[s][tap][ci0 + ci][co0 + co]
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = (warp + 8 * q) * 16 + g + 8 * (r >> 1);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (m < rows && co < Co) {
          const int tap = m / cic, ci = m - tap * cic;
          ws[(((long long)s * 27 + tap) * Ci + ci0 + ci) * Co + co] = acc[q][nt][r];
        }
      }
}

// dw[p][e] = sum over s of ws[p][s][e], in ascending s (p < pairs)
__global__ void wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                 int splits, long long E, int pairs) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= pairs * E) return;
  const long long p = i / E, e = i - p * E;
  const float* wp = ws + p * splits * E;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += wp[s * E + e];
  dw[i] = acc;
}

// pairs > 1: N items a pair, each pair's dw its own
template <typename T, int NT>
int wgrad_launch(const void* x, const void* g, void* ws, void* dw, int N, int Ci, int Co,
                 int Z, int H, int W, int splits, int pairs, cudaStream_t stream) {
  const int ci_chunks = (Ci + kCiC - 1) / kCiC, co_chunks = (Co + 8 * NT - 1) / (8 * NT);
  if (ci_chunks > 65535 || co_chunks > 65535 || (long long)pairs * splits > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int bytes = wgrad_smem_words<NT>() * 4;
  int rc = allow_smem<wgrad_kernel<T, NT>>(bytes);
  if (rc != 0) return rc;
  wgrad_kernel<T, NT><<<dim3(pairs * splits, ci_chunks, co_chunks), kThreads, bytes, stream>>>(
      (const T*)x, (const T*)g, (float*)ws, N, Ci, Co, Z, H, W, splits);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long E = 27LL * Ci * Co;
  wgrad_sum_kernel<<<(unsigned)((pairs * E + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      (const float*)ws, (float*)dw, splits, E, pairs);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad_dispatch(const void* x, const void* g, void* ws, void* dw, int N, int Ci, int Co,
                   int Z, int H, int W, int splits, int pairs, cudaStream_t s) {
  switch (Co <= 8 ? 1 : Co <= 16 ? 2 : Co <= 24 ? 3 : 4) {
    case 1: return wgrad_launch<T, 1>(x, g, ws, dw, N, Ci, Co, Z, H, W, splits, pairs, s);
    case 2: return wgrad_launch<T, 2>(x, g, ws, dw, N, Ci, Co, Z, H, W, splits, pairs, s);
    case 3: return wgrad_launch<T, 3>(x, g, ws, dw, N, Ci, Co, Z, H, W, splits, pairs, s);
    default: return wgrad_launch<T, 4>(x, g, ws, dw, N, Ci, Co, Z, H, W, splits, pairs, s);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Tensors are contiguous; dtype 0 is
// f32, 1 bf16. Each returns cudaGetLastError() after its launches, or an
// error code for a shape the grid cannot hold.
//
// x [N, Ci, Z, H, W] and w [27, Ci, Co] (per_pair 0) or [N, 27, Ci, Co]
// (per_pair 1: item n convolved with its own set) of dtype; out [N, Co,
// Z-2+2*pad, H-2+2*pad, W-2+2*pad] of dtype; pad 0 or 2.
extern "C" int conv3x3x3(const void* x, const void* w, void* out, int N, int Ci, int Co,
                         int Z, int H, int W, int pad, int per_pair, int dtype, void* stream) {
  const int least = pad == 0 ? 3 : 1;
  if (N <= 0 || Ci <= 0 || Co <= 0 || (pad != 0 && pad != 2) || Z < least || H < least ||
      W < least || (per_pair != 0 && per_pair != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long ws = per_pair ? 27LL * Ci * Co : 0;
  if (dtype == 0) return conv_dispatch<float>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
  if (dtype == 1)
    return conv_dispatch<__nv_bfloat16>(x, w, out, N, Ci, Co, Z, H, W, pad, ws, s);
  return (int)cudaErrorInvalidValue;
}

// x [N, Ci, Z, H, W] and g [N, Co, Z-2, H-2, W-2] of dtype. per_pair 0: ws
// f32 [splits, 27, Ci, Co] (scratch, no initial value needed), dw f32 [27,
// Ci, Co] summed over the N items; per_pair 1: ws [N, splits, 27, Ci, Co]
// and dw [N, 27, Ci, Co], item n's own, each equal to a launch on item n
// alone with the same splits.
extern "C" int conv3x3x3_wgrad(const void* x, const void* g, void* ws, void* dw, int N,
                               int Ci, int Co, int Z, int H, int W, int splits, int per_pair,
                               int dtype, void* stream) {
  if (N <= 0 || Ci <= 0 || Co <= 0 || Z < 3 || H < 3 || W < 3 || splits <= 0 ||
      (per_pair != 0 && per_pair != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int items = per_pair ? 1 : N, pairs = per_pair ? N : 1;
  if (dtype == 0)
    return wgrad_dispatch<float>(x, g, ws, dw, items, Ci, Co, Z, H, W, splits, pairs, s);
  if (dtype == 1)
    return wgrad_dispatch<__nv_bfloat16>(x, g, ws, dw, items, Ci, Co, Z, H, W, splits, pairs,
                                         s);
  return (int)cudaErrorInvalidValue;
}
