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
// What bounds it on this card: memory bytes. At 240^3 f32 the affine mode
// must read the source and write the output once, 110.6 MB (0.033 ms at 3.35
// TB/s); the flow mode reads the 3-channel field too, 276.5 MB (0.083 ms).
// A thread per voxel that reads its 8 corners from global memory is far from
// that: the corners of a warp's outputs spread over several source rows and
// planes under a rotation, and the index arithmetic (64-bit divisions and
// offsets, float-integer conversions on the card's slow conversion unit)
// costs more issue slots than the arithmetic of the sample.
//
// The design. A block of 256 threads owns one output tile, its origin taken
// from blockIdx with no division; each thread walks a column of the tile (x
// fastest across threads, so loads of the field and stores of the output
// coalesce), its z and y as exact floats stepped by 1 and its offset stepped
// by a plane: no division or conversion per voxel. Offsets are 32-bit when
// every tensor a launch indexes holds fewer than 2^31 elements: C*Z*Y*X for
// the image and the output, and 3*Z*Y*X for the flow mode's field (a
// template; 64-bit otherwise).
//   Affine mode, 3-D tiles of 16^3, the staged route. The box: each q_s is a
//   chain of round-to-nearest products and sums of z, y and x, each monotone
//   in its operands, so over a tile it is monotone in each of z, y and x and
//   takes its least and greatest values at the tile's corners; the floors at
//   the 8 corners give exactly the box [min, max + 1] that holds every
//   corner of every voxel. When the box fits 24 x 24 x 24 floats (x with 3
//   to spare for the shift to a 16-byte boundary) and lies within +-2^13,
//   where the box offsets below are exact in f32, the block counts itself in
//   `staged` (one atomicAdd), copies the box into shared memory with cp.async
//   (16-byte copies where X % 4 == 0 and src is 16-byte aligned, 4-byte
//   otherwise) and writes zeros where the box leaves the volume, so that a
//   corner outside the volume reads the 0 its range test would give. Each
//   thread then reads its 8 corners at fixed offsets from one base in shared
//   memory, (fz*24 + fy)*24 + fx - base computed in exact f32 and turned
//   into an int without a conversion: no range test and no 64-bit offset a
//   corner. C > 1 stages and gathers channel by channel.
//   The direct route, for an affine tile whose box does not fit (a zoom out,
//   a large rotation, a coordinate far out; a NaN map), for the flow mode
//   (8 x 8 x 32 tiles) and for 2-D images (1 x 8 x 32): the 8 corners from
//   global memory through the read-only cache, each behind its range test.
//   Staging did not pay there: a field's box is known only after the field
//   is read, and that round trip and the lower occupancy under a box cost
//   more than the gathers save (PERF.md §6, K2).
// Both routes run the same f32 operations in the same order on the same
// values, so they give the same bits.
//
// Rounding: every product and sum of the sample is an explicit
// round-to-nearest f32 operation (__fmul_rn / __fadd_rn, never contracted
// into an FMA), in the order written above, so the plain PyTorch version in
// ops/cuda/warp.py, which runs the same elementwise operations, gives the
// same bits. q is computed per voxel as written, never stepped.
//
// The slab mode (warp_affine_slab, warp_flow_slab; the template's kSlab): a
// volume split into slabs over a mesh's space axis, each slab's outputs
// computed on its own device. The output is a block of the volume's outputs
// from an origin o, and the source a buffer of the volume's voxels from b
// (the slab's rows and those of its neighbours that its outputs reach). Each
// thread's z, y and x are the volume's, exact floats stepped by 1 from the
// origin, so q, the weights and the corner order are the unsharded launch's.
// A corner is read where it lies in the volume and in the buffer (else 0):
// where the buffer holds every in-volume corner the block reaches, each
// output equals the unsharded launch's to the bit. The staged route stages
// the buffer's rows of its box and zeros elsewhere. Offsets are 32-bit when
// the buffer, the output block and (flow) the block's field each hold fewer
// than 2^31 elements.
//
// Images and fields are f32. A 2D image is a volume with Z == 1 and
// q_z == 0: the z = 0 corner has weight 1 and the z = 1 corner is outside.
//
// The tiles, the box and the route are the constants kTile, kBox, kFlowTile
// and kStageAffine below; ops/cuda/warp.py:tile_boxes mirrors them, and
// profile_warp.py builds variants of those lines for its ablations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// (z, y, x): the affine mode's 3-D tile and the most of its box that shared
// memory holds, the flow mode's 3-D tile; whether the affine tiles stage
// their box (false: every block takes the direct route)
constexpr int kTile[3] = {16, 16, 16}, kBox[3] = {24, 24, 24};
constexpr int kFlowTile[3] = {8, 8, 32};
constexpr bool kStageAffine = true;
// blocks an SM (__launch_bounds__): a staged block's box (54 KB at 24^3)
// leaves room for 4, which 64 registers a thread allow; a direct block has
// no box, and 6 blocks (40 registers) read the field fastest (PERF.md §6, K2)
constexpr int kStagedBlocks = 4, kDirectBlocks = 6;
constexpr float kFar = 8192.0f;      // 2^13: a staged box lies within +-kFar
constexpr float kInt = 8388608.0f;   // 2^23: v + kInt holds v in its low bits
constexpr float kExact = 16777216.0f;  // 2^24: integers below it are exact in f32
constexpr int kIntBits = 0x4B000000; // the bits of kInt
constexpr int kMaxSize = 1 << 22;    // sizes beyond it are refused

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// An integer-valued float v in [0, 2^23) as an int, without the conversion
// unit.
__device__ __forceinline__ int small_int(float v) {
  return __float_as_int(__fadd_rn(v, kInt)) - kIntBits;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// fn(pz, py, v) for each voxel of the tile that this thread owns and that
// lies in the output: column x, rows y0 + threadIdx.x / TX + j * kThreads/TX,
// every plane. The coordinates pz, py (the volume's: the output's origin oz,
// oy added) are stepped as floats (exact integers), v as an offset into the
// output: no conversion or division per voxel.
template <int TZ, int TY, int TX, typename Idx, typename Fn>
__device__ __forceinline__ void for_voxels(int z0, int y0, int x, int Z, int Y, int X, int oz,
                                           int oy, Fn fn) {
  constexpr int kRows = kThreads / TX;
  static_assert(kThreads % TX == 0 && TY % kRows == 0, "tile");
  if (x >= X) return;
  const int zn = min(TZ, Z - z0);
  const Idx plane = (Idx)Y * X;
#pragma unroll
  for (int j = 0; j < TY / kRows; ++j) {
    const int y = y0 + threadIdx.x / TX + j * kRows;
    if (y >= Y) return;
    const float py = (float)(y + oy);
    float pz = (float)(z0 + oz);
    Idx v = ((Idx)z0 * Y + y) * X + x;
#pragma unroll 2
    for (int k = 0; k < zn; ++k, pz = add(pz, 1.0f), v += plane) fn(pz, py, v);
  }
}

// The source a launch reads: in the slab mode a buffer of the volume's voxels
// from b (extent n along each axis), and a corner is read where it lies in
// [lo, hi] (inclusive, the volume and the buffer); else the volume itself
// (b = 0, [lo, hi] = [0, size - 1]).
struct Src {
  int lo[3], hi[3], b[3], Y, X;  // Y, X: the source's row and plane extents
};

// The box (ez planes from lz, ey rows from ly, BX columns from xa, the
// volume's coordinates) of one channel's plane of the source into box
// ([BZ][BY][BX]) with cp.async; zeros where a voxel is not read (outside the
// volume or the buffer). A warp takes a plane, each lane one 16-byte piece of
// every kRowsPerPass-th row.
template <int BY, int BX, typename Idx>
__device__ __forceinline__ void stage(float* box, const float* plane, const Src& sr, int lz,
                                      int ly, int xa, int ez, int ey, bool vec) {
  constexpr int kPieces = BX / 4, kRowsPerPass = 32 / kPieces;
  static_assert(kRowsPerPass > 0, "a box row of at most 32 pieces");
  const int lane = threadIdx.x % 32;
  if (lane >= kRowsPerPass * kPieces) return;
  const int r0 = lane / kPieces, i = 4 * (lane % kPieces);
  const int gx = xa + i;
  const bool whole = vec && gx >= sr.lo[2] && gx + 4 <= sr.hi[2] + 1;  // one 16-byte copy
  for (int bz = threadIdx.x / 32; bz < ez; bz += kThreads / 32) {
    const int gz = lz + bz;
    const bool zin = gz >= sr.lo[0] && gz <= sr.hi[0];
    for (int by = r0; by < ey; by += kRowsPerPass) {
      const int gy = ly + by;
      float* dst = box + (bz * BY + by) * BX + i;
      if (zin && gy >= sr.lo[1] && gy <= sr.hi[1]) {
        const float* g =
            plane + ((Idx)(gz - sr.b[0]) * sr.Y + (gy - sr.b[1])) * sr.X + (gx - sr.b[2]);
        if (whole) {
          cp_async16(dst, g);
        } else {
          for (int j = 0; j < 4; ++j) {
            if (gx + j >= sr.lo[2] && gx + j <= sr.hi[2])
              cp_async4(dst + j, g + j);
            else
              dst[j] = 0.0f;
          }
        }
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  cp_async_wait_all();
}

// The slab mode's geometry: the output's first voxel in the volume (o), the
// source buffer's first voxel in the volume (b) and its extent (n), and the
// volume's extent (g); each (z, y, x).
struct Geo {
  int o[3], b[3], n[3], g[3];
};

// kStage: affine 3-D tiles, which stage their box; every other launch (the
// flow mode, 2-D images) takes the direct route everywhere and has no box.
// kSlab: the slab mode (geo); otherwise the output and the source are the
// volume and geo is not read.
template <bool kFlow, bool kSlab, typename Idx, int TZ, int TY, int TX, bool kStage, int BZ,
          int BY, int BX, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_kernel(const float* __restrict__ src, float* __restrict__ out,
                const float* __restrict__ mt, const float* __restrict__ flow, int C, int Z,
                int Y, int X, Geo geo, bool vec, int* __restrict__ staged) {
  static_assert(!(kStage && kFlow), "the flow mode never stages");
  constexpr int PZ = BY * BX;
  // |fz*PZ + fy*BX + fx| and the base (x shifted down by at most 3), plus kInt
  static_assert(BX % 4 == 0 && (PZ + BX + 1) * (kFar + 4) + kInt < kExact,
                "exact box offsets");
  extern __shared__ float4 smem[];
  float* box = reinterpret_cast<float*>(smem);
  const Idx nvox = (Idx)Z * Y * X;  // the output's (and the field's) voxels
  Src sr;
  const int size[3] = {Z, Y, X};
  for (int s = 0; s < 3; ++s) {
    sr.b[s] = kSlab ? geo.b[s] : 0;
    sr.lo[s] = kSlab ? max(0, geo.b[s]) : 0;
    sr.hi[s] = kSlab ? min(geo.g[s], geo.b[s] + geo.n[s]) - 1 : size[s] - 1;
  }
  sr.Y = kSlab ? geo.n[1] : Y;
  sr.X = kSlab ? geo.n[2] : X;
  const Idx nsrc = kSlab ? (Idx)geo.n[0] * sr.Y * sr.X : nvox;
  const int oz = kSlab ? geo.o[0] : 0, oy = kSlab ? geo.o[1] : 0, ox = kSlab ? geo.o[2] : 0;
  const int z0 = blockIdx.z * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int x = x0 + threadIdx.x % TX;
  const float px = (float)(x + ox);
  float m[12], ax[3];
  if (!kFlow) {
    for (int i = 0; i < 12; ++i) m[i] = __ldg(mt + i);
    for (int s = 0; s < 3; ++s) ax[s] = mul(m[4 * s + 2], px);  // the same product
  }
  // q_s of the voxel (pz, py, x) at offset v, as the note above writes it
  auto coords = [&](float q[3], float pz, float py, Idx v) {
    if (kFlow) {
      const float p[3] = {pz, py, px};
      for (int s = 0; s < 3; ++s) q[s] = add(p[s], __ldg(flow + s * nvox + v));
    } else {
      for (int s = 0; s < 3; ++s)
        q[s] = add(add(add(mul(m[4 * s], pz), mul(m[4 * s + 1], py)), ax[s]), m[4 * s + 3]);
    }
  };

  if constexpr (kStage) {
    // The box from the floors at the tile's 8 corners (the note above); a
    // NaN corner (a NaN map) sends the block to the direct route.
    __shared__ float red[6];
    if (threadIdx.x < 32) {
      const int t = threadIdx.x & 7;
      const float c[3] = {(float)(((t & 4) ? min(z0 + TZ, Z) - 1 : z0) + oz),
                          (float)(((t & 2) ? min(y0 + TY, Y) - 1 : y0) + oy),
                          (float)(((t & 1) ? min(x0 + TX, X) - 1 : x0) + ox)};
      for (int s = 0; s < 3; ++s) {
        float fmax = floorf(add(add(add(mul(m[4 * s], c[0]), mul(m[4 * s + 1], c[1])),
                                    mul(m[4 * s + 2], c[2])),
                                m[4 * s + 3]));
        float fmin = isnan(fmax) ? -INFINITY : fmax;
        for (int o = 4; o > 0; o >>= 1) {
          fmin = fminf(fmin, __shfl_xor_sync(0xffffffffu, fmin, o));
          fmax = fmaxf(fmax, __shfl_xor_sync(0xffffffffu, fmax, o));
        }
        if (threadIdx.x == 0) red[s] = fmin, red[3 + s] = fmax;
      }
    }
    __syncthreads();
    bool fits = true;
    int lo[3], ext[3];
    for (int s = 0; s < 3; ++s) {
      // false for a NaN and past +-kFar
      fits = fits && red[s] >= -kFar && red[3 + s] < kFar;
      lo[s] = fits ? (int)red[s] : 0;
      ext[s] = fits ? (int)red[3 + s] - lo[s] + 2 : 0;
    }
    // x: room for the shift to a 16-byte boundary
    if (fits && ext[0] <= BZ && ext[1] <= BY && ext[2] + 3 <= BX) {
      if (threadIdx.x == 0) atomicAdd(staged, 1);
      // the box's x, 16-byte aligned in the source
      const int xa = lo[2] - (vec ? ((lo[2] - sr.b[2]) & 3) : 0);
      // the corner f at box + (fz*BY + fy)*BX + fx - base, exact in f32,
      // with kInt folded in as small_int adds it
      const float boff = __fadd_rn((float)-(lo[0] * PZ + lo[1] * BX + xa), kInt);
      for (int c = 0; c < C; ++c) {
        if (c > 0) __syncthreads();  // the previous channel's gathers are done
        stage<BY, BX, Idx>(box, src + c * nsrc, sr, lo[0], lo[1], xa, ext[0], ext[1], vec);
        __syncthreads();
        for_voxels<TZ, TY, TX, Idx>(z0, y0, x, Z, Y, X, oz, oy, [&](float pz, float py, Idx v) {
          float q[3], f[3], w[3][2];
          coords(q, pz, py, v);
          for (int s = 0; s < 3; ++s) {
            f[s] = floorf(q[s]);
            const float fr = __fsub_rn(q[s], f[s]);
            w[s][0] = __fsub_rn(1.0f, fr);
            w[s][1] = fr;
          }
          // (the clamp only guards the read: a staged tile's q are finite)
          const float o = fmaxf(__fadd_rn(fmaf(f[0], (float)PZ, fmaf(f[1], (float)BX, f[2])),
                                          boff),
                                kInt);
          const float* b = box + (__float_as_int(o) - kIntBits);
          float acc = 0.0f;
          for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 2; ++j)
              for (int k = 0; k < 2; ++k) {
                const float wc = mul(mul(w[0][i], w[1][j]), w[2][k]);
                acc = add(acc, mul(b[i * PZ + j * BX + k], wc));
              }
          out[c * nvox + v] = acc;
        });
      }
      return;
    }
  }

  const float lo_f[3] = {(float)sr.lo[0], (float)sr.lo[1], (float)sr.lo[2]};
  const float hi_f[3] = {(float)sr.hi[0], (float)sr.hi[1], (float)sr.hi[2]};
  for_voxels<TZ, TY, TX, Idx>(z0, y0, x, Z, Y, X, oz, oy, [&](float pz, float py, Idx v) {
    float q[3], w[3][2];
    Idx idx[3][2];
    bool ok[3][2];
    coords(q, pz, py, v);
    for (int s = 0; s < 3; ++s) {
      const float f = floorf(q[s]);
      const float fr = __fsub_rn(q[s], f);
      w[s][0] = __fsub_rn(1.0f, fr);
      w[s][1] = fr;
      // Range tests in float (false for NaN); the index (into the source,
      // exact: both terms are integers below 2^22) is taken only for an
      // in-range corner, so a far-out coordinate never reaches it.
      for (int i = 0; i < 2; ++i) {
        const float cs = add(f, (float)i);
        ok[s][i] = cs >= lo_f[s] && cs <= hi_f[s];
        idx[s][i] = ok[s][i] ? (Idx)small_int(kSlab ? __fsub_rn(cs, (float)sr.b[s]) : cs) : 0;
      }
    }
    float wc[8];
    Idx off[8];
    bool in[8];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 2; ++k) {
          const int n = 4 * i + 2 * j + k;
          wc[n] = mul(mul(w[0][i], w[1][j]), w[2][k]);
          in[n] = ok[0][i] && ok[1][j] && ok[2][k];
          off[n] = (idx[0][i] * sr.Y + idx[1][j]) * sr.X + idx[2][k];
        }
    for (int c = 0; c < C; ++c) {
      const float* plane = src + c * nsrc;
      float acc = 0.0f;
      for (int n = 0; n < 8; ++n) {
        const float val = in[n] ? __ldg(plane + off[n]) : 0.0f;
        acc = add(acc, mul(val, wc[n]));
      }
      out[c * nvox + v] = acc;
    }
  });
}

template <bool kFlow, bool kSlab, typename Idx, int TZ, int TY, int TX, bool kStage, int BZ,
          int BY, int BX, int kMinBlocks>
int launch_tiles(const float* src, float* out, const float* mt, const float* flow, int C,
                 int Z, int Y, int X, const Geo& geo, int* staged, cudaStream_t stream) {
  auto kernel = warp_kernel<kFlow, kSlab, Idx, TZ, TY, TX, kStage, BZ, BY, BX, kMinBlocks>;
  constexpr int kBytes = kStage ? (int)sizeof(float) * BZ * BY * BX : 0;
  if (kBytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool ready[kMaxDevices];  // the shared-memory attribute, once per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !ready[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) ready[dev] = true;
    }
  }
  const bool vec = (kSlab ? geo.n[2] : X) % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + TZ - 1) / TZ);
  kernel<<<grid, kThreads, kBytes, stream>>>(src, out, mt, flow, C, Z, Y, X, geo, vec, staged);
  return (int)cudaGetLastError();
}

// The affine mode's 3-D tiles stage a box of up to kBox; the flow mode's
// 3-D tiles and every 2-D (Z == 1) tile, 1 x 8 x 32, take the direct route
// (PERF.md §6, K2: staging lost there).
template <bool kFlow, bool kSlab, typename Idx>
int launch_mode(const float* s, float* o, const float* m, const float* f, int c, int Z, int Y,
                int X, const Geo& g, int* st, cudaStream_t stream) {
  constexpr int BZ = kBox[0], BY = kBox[1], BX = kBox[2];
  if (Z == 1)
    return launch_tiles<kFlow, kSlab, Idx, 1, 8, 32, false, BZ, BY, BX, kDirectBlocks>(
        s, o, m, f, c, Z, Y, X, g, st, stream);
  if constexpr (kFlow)
    return launch_tiles<kFlow, kSlab, Idx, kFlowTile[0], kFlowTile[1], kFlowTile[2], false, BZ,
                        BY, BX, kDirectBlocks>(s, o, m, f, c, Z, Y, X, g, st, stream);
  else
    return launch_tiles<kFlow, kSlab, Idx, kTile[0], kTile[1], kTile[2], kStageAffine, BZ, BY,
                        BX, kStageAffine ? kStagedBlocks : kDirectBlocks>(s, o, m, f, c, Z, Y, X,
                                                                          g, st, stream);
}

bool bad_size(long long n) { return n < 0 || n > kMaxSize; }

// kSlab: geo is the slab mode's (Geo); else the output is the volume, whose
// extent (Z, Y, X) the source shares.
template <bool kFlow, bool kSlab>
int launch(const void* src, void* out, const void* mt, const void* flow, long long C, int Z,
           int Y, int X, const Geo& geo, void* staged, cudaStream_t stream) {
  const long long nvox = (long long)Z * Y * X;
  if (C < 0 || C > 0x7fffffffLL || bad_size(Z) || bad_size(Y) || bad_size(X))
    return (int)cudaErrorInvalidValue;
  long long nsrc = nvox;
  if (kSlab) {
    nsrc = 1;
    for (int s = 0; s < 3; ++s) {
      if (bad_size(geo.n[s]) || bad_size(geo.g[s]) || geo.o[s] < 0 ||
          geo.o[s] + (long long)(s == 0 ? Z : s == 1 ? Y : X) > geo.g[s] ||
          geo.b[s] < -kMaxSize || geo.b[s] > kMaxSize)
        return (int)cudaErrorInvalidValue;
      nsrc *= geo.n[s];
    }
  }
  if (nvox == 0 || C == 0) return 0;
  const float *s = (const float*)src, *m = (const float*)mt, *f = (const float*)flow;
  // the largest tensor the launch indexes: the source and the output (C
  // channels; in the slab mode the buffer and the slab, each counted) or the
  // flow mode's field (3, the output's shape)
  const long long planes = kFlow && C < 3 ? 3 : C;
  if (planes * nvox < (1LL << 31) && C * nsrc < (1LL << 31))
    return launch_mode<kFlow, kSlab, int>(s, (float*)out, m, f, (int)C, Z, Y, X, geo,
                                          (int*)staged, stream);
  return launch_mode<kFlow, kSlab, long long>(s, (float*)out, m, f, (int)C, Z, Y, X, geo,
                                              (int*)staged, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). src and out are contiguous
// [C, Z, Y, X] f32, each size at most 2^22; mt is 12 f32 (M row-major with
// t[s] after row s); flow is contiguous [3, Z, Y, X] f32; staged is one int32
// on the device, to which each block that stages its box adds 1. Returns
// cudaGetLastError() after the launch.
extern "C" int warp_affine(const void* src, void* out, const void* mt, long long C, int Z,
                           int Y, int X, void* staged, void* stream) {
  return launch<false, false>(src, out, mt, nullptr, C, Z, Y, X, Geo{}, staged,
                              (cudaStream_t)stream);
}

extern "C" int warp_flow(const void* src, void* out, const void* flow, long long C, int Z,
                         int Y, int X, void* staged, void* stream) {
  return launch<true, false>(src, out, nullptr, flow, C, Z, Y, X, Geo{}, staged,
                             (cudaStream_t)stream);
}

// The slab mode: out is a block [C, Z, Y, X] of the volume's outputs whose
// first voxel in the volume is (oz, oy, ox) (flow, [3, Z, Y, X], is the
// block's field); src is a contiguous buffer [C, nz, ny, nx] of the volume's
// voxels from (bz, by, bx); the volume is (gz, gy, gx). Each output is the
// unsharded launch's to the bit when the buffer holds every corner within the
// volume that the block's outputs reach (a corner outside the volume reads 0,
// one outside the buffer too).
extern "C" int warp_affine_slab(const void* src, void* out, const void* mt, long long C, int Z,
                                int Y, int X, int oz, int oy, int ox, int bz, int by, int bx,
                                int nz, int ny, int nx, int gz, int gy, int gx, void* staged,
                                void* stream) {
  const Geo geo{{oz, oy, ox}, {bz, by, bx}, {nz, ny, nx}, {gz, gy, gx}};
  return launch<false, true>(src, out, mt, nullptr, C, Z, Y, X, geo, staged,
                             (cudaStream_t)stream);
}

extern "C" int warp_flow_slab(const void* src, void* out, const void* flow, long long C, int Z,
                              int Y, int X, int oz, int oy, int ox, int bz, int by, int bx, int nz,
                              int ny, int nx, int gz, int gy, int gx, void* staged,
                              void* stream) {
  const Geo geo{{oz, oy, ox}, {bz, by, bx}, {nz, ny, nx}, {gz, gy, gx}};
  return launch<true, true>(src, out, nullptr, flow, C, Z, Y, X, geo, staged,
                            (cudaStream_t)stream);
}
