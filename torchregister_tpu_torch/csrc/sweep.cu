// K1: the 1-D sweep resampler, forward and backward, for Hopper (sm_90a).
//
// Replaces torchregister_tpu/ops/pallas/sweep.py:_fwd_kernel (the Pallas
// forward) and its XLA backward _sweep_vjp_bwd. Each output element o of a
// row samples the row at a coordinate q, inside the static window [-K, K+1]:
//
//   q0 = floor(q), fr = q - q0, k = q0 - o
//   floor tap src[q0]   counts iff k in [-K,   K+1] and 0 <= q0   < X
//   ceil  tap src[q0+1] counts iff k in [-K-1, K  ] and 0 <= q0+1 < X
//   out  = floor * (1 - fr) + ceil * fr,   diff = ceil - floor
//
// Where q comes from. One kernel of each kind takes q from a small functor,
// in one of three modes:
//   dense   q[e], a float32 tensor of src's shape (sweep(), the tests, and
//           the yardstick of the other two);
//   affine  q = ((t + c0*z) + c1*y) + c2*x (2-D: (t + c0*y) + c1*x), from one
//           row (coef[d], offset) of a float32 device table: one pass of a
//           separable affine warp, no dense grid and no host read. The
//           table is one for the whole tensor, or one per batch item (a
//           cohort of pairs: row p of table n, at a batch stride);
//   flow    q = u_a(o) + o_a, u_a channel a of a float32 [N, d, *S] field,
//           read by its strides and broadcast over src's channels.
// The affine and flow coordinates are evaluated with __fmul_rn/__fadd_rn in
// the order the plain composition (_axis_coord_grid; flow[:, a] + ident)
// takes, so nvcc cannot contract a*b+c into an FMA: a coordinate, and so
// every tap, is equal to the bit to the dense launch's on the grid built
// that way. The weights and products are written the same way, so the three
// modes give the same bits on the same coordinates.
//
// What bounds it on this card: memory bytes. The Pallas kernel sweeps 2K+2
// masked terms per voxel because Mosaic has no per-lane gather; here every
// thread reads its two taps directly, so the forward is O(1) per voxel: src
// in, out back (plus u in flow mode, q in dense mode). Every kernel sees a
// tensor as rows [outer, L, inner] along the swept axis. The forward's
// threads take 32 consecutive inner indices (or, for the last axis, 32
// consecutive positions) and several rows each, with their loads in flight
// together; a block of the first kind covers 32 positions of one row, so
// neighbouring outputs share their taps in L1. Indices come from the block
// index, with no 64-bit division per element; the affine form finds an
// element's voxel with 32-bit divisions by multiply and shift.
//
// Backward, dense and flow modes: dq (du) = g * diff, and dsrc is the
// adjoint of the two-tap gather. Several outputs of a row hit the same
// source index, and the gradient must repeat to the bit (the U-Net's
// training amplifies last-bit differences into other plateau stops), so
// there are no atomics: each dsrc[j] adds its terms in ascending x, the
// floor tap before the ceil tap of one x (only one of the two can hit j),
// the order of the scatter this kernel replaced, so dsrc is the same to the
// bit. The block owns 32 columns (rows of the view) and a chunk of 64
// positions. In one pass over global memory it stages, for the chunk and
// the window around it (x in [j0-K-1, j0+L+K]), each position's floor index
// and masks (one int), fr, src and g in shared memory. It then finds, per
// column, whether the floor index never decreases along x (a field without
// folds: the x that reach j then form one run). Every thread takes
// positions of the chunk: dq from the staged taps; on a column without
// folds, dsrc by walking to the run of x that reach j. A column with folds
// (any x may reach j; every engine's coordinates are fold-free, a rough
// field is not) is summed by one thread that adds each staged x's two taps
// into the chunk's outputs in ascending x: O(1) a tap, where a search over
// the window would cost O(K) an output.
//
// Backward, affine mode: the same staged kernel, with q computed from the
// row. dq never reaches memory: each position's g * diff, times each of
// its coordinates and alone, is summed per thread, then per block in a
// fixed tree, into a workspace of per-block partials; the last block to
// finish (an integer counter tells it) sums them in a fixed order: the
// gradient of the pass's table row (coef[d], offset). No float atomics
// anywhere. With a table per batch item the grid's y index is the item:
// its blocks tile its rows as a launch on that item alone would, and it
// has its own counter and range of partials, so each item's row gradient
// (and its dsrc and output) is that launch's to the bit.
//
// Second order, affine mode (sweep_bwd2: the LM engines' Hessian). The
// backward of one pass maps (g, s, row) to ds = A(q)^T g and the row gradient
// dr = sum_e g_e (D(q)s)_e [n_e, 1], where D(q)s = s[floor + 1] - s[floor]
// over the taps that count is constant in q between taps. Given cotangents
// ubar (of ds) and rbar (of dr), with v_e = rbar . [n_e, 1]:
//
//   gbar = A(q) ubar + v * D(q)s
//   sbar = D(q)^T (v * g)
//   the row's gradient  sum_e g_e (D(q) ubar)_e [n_e, 1]
//
// It reads g, src and ubar and writes gbar and sbar: five volumes, each
// moved once. Its tile stages src, ubar and g in the image dtype and each
// position's tap code (16 bits) with the window around a chunk of up to 256
// positions; rows up to 256 (every shape the LM paths run) are staged whole,
// with no halo. gbar is a forward-like blend of each position's taps, sbar
// the adjoint gather (weights -v g and +v g, v g formed from the staged g) in
// the same fixed ascending order, and the row's gradient the backward's
// reduction with ubar in place of s, through the same partials and counters.
// A tile is TC columns, fewer where a launch would have too few tiles to
// fill the card (the matrix levels' 60^3 and 120^3); a few persistent
// blocks an SM loop over an item's tiles with two stage buffers. Each item's
// results equal a single-table launch's to the bit and a run repeats to the
// bit: gbar and sbar add their terms in an order fixed by the positions
// alone, the row's gradient in one fixed by the card and the item's shape.
//
// The slab mode (a volume split into slabs over a mesh, the Slab note
// below) runs the affine form, its second order and, along the split axis,
// the flow form, whose backward reads the field's channel as a buffer with
// the halo (FlowQ's uvol): the halo's outputs reach the slab's rows.
//
// Images are f32 or bf16 (the matrix stages sweep bf16 images); coordinates,
// weights and all sums are f32 and an image output is rounded once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                   // forward: lanes of a tile
constexpr int kStep = kThreads / kLanes;     // rows a tile steps by
constexpr int kRows = 4;                     // forward: rows of each thread
constexpr int kTileRows = kStep * kRows;     // forward: rows of a tile
constexpr int kFwdMinBlocks = 6;             // forward: blocks an SM (caps its registers)
constexpr int kCols = 32;                    // backward: columns of a tile
constexpr int kChunk = 64;                   // backward: positions of a chunk

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Tap positions and masks of one output element (shared by all kernels).
struct Taps {
  int xf;     // floor tap index q0 (valid only where mf or mc)
  bool mf;    // floor tap counts
  bool mc;    // ceil tap counts
  float fr;   // fractional weight
  float q0;   // floor(q)
};

__device__ __forceinline__ Taps taps_of(float q, int x, int X, int K) {
  Taps t;
  const float q0 = floorf(q);
  t.q0 = q0;
  t.fr = q - q0;
  float k = q0 - (float)x;
  bool in_f = (k >= (float)(-K)) && (k <= (float)(K + 1));
  bool in_c = (k >= (float)(-K - 1)) && (k <= (float)K);
  // k is bounded by the window here, so the int conversion is safe.
  t.xf = (in_f || in_c) ? x + (int)k : -2;
  t.mf = in_f && t.xf >= 0 && t.xf < X;
  t.mc = in_c && t.xf + 1 >= 0 && t.xf + 1 < X;
  return t;
}

__device__ __forceinline__ float w_floor(float g, float fr) {
  return __fmul_rn(g, __fsub_rn(1.0f, fr));
}
__device__ __forceinline__ float w_ceil(float g, float fr) { return __fmul_rn(g, fr); }

// out = floor * (1 - fr) + ceil * fr over the taps that count. Masked
// products rather than products on zeros: a NaN coordinate gives 0 like the
// reference sweep, not NaN.
__device__ __forceinline__ float blend(const Taps& t, float vf, float vc) {
  return __fadd_rn(t.mf ? w_floor(vf, t.fr) : 0.0f, t.mc ? w_ceil(vc, t.fr) : 0.0f);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1, set on the host).
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, s};
}

// Every kernel sees a tensor as rows along the swept axis: [outer, L,
// inner], element e = (o * L + p) * inner + i at position p of row (o, i).
struct Rows {
  long long outer, inner;
  int L, K;
};

// A slab's pass (the slab mode): the output holds rows [p0, p0 + L) of a
// volume of Xg rows along the swept axis, the source a buffer of its global
// rows [b0, b0 + Lb) (the slab and its halo, parallel/halo.py). Positions,
// coordinates and the taps' zero test are global, so each output is the
// unsharded launch's to the bit. Outside the slab mode p0 = b0 = 0 and
// Lb = Xg = L.
struct Slab {
  int p0, b0, Lb, Xg;
};

// An image [N, C, Z, Y, X] (2-D: Z = 1) swept along `axis` (0: z, 1: y,
// 2: x): what the affine and flow forms need to find an element's voxel.
struct Img {
  int Z, Y, X, axis;
  int C;              // channels of a batch item
  long long vol;      // voxels of one image
  FastDiv by_x, by_y, by_z;
  FastDiv by_ob;      // rows of `outer` per image
  FastDiv by_c;
  int oz = 0, oy = 0, ox = 0;  // a slab's origin in the volume (AffineQ<kPer, true>)
};

Img make_img(int Z, int Y, int X, int axis, int C) {
  const unsigned ob = axis == 0 ? 1u : (axis == 1 ? (unsigned)Z : (unsigned)Z * Y);
  return Img{Z, Y, X, axis, C, (long long)Z * Y * X, make_div(X), make_div(Y), make_div(Z),
             make_div(ob), make_div(C)};
}

// ------------------------------------------------------------------ modes
// Each form gives q at an element; the backward asks once per row (o, i)
// for what stays along it (`col`) and then for q at each position.

struct DenseQ {
  const float* q;
  static constexpr bool kRowGrad = false;
  struct Col {};
  __device__ void load(int) {}
  __device__ float at(long long e, int, int, int) const { return q[e]; }
  __device__ Col col(int, int) const { return {}; }
  __device__ float at(const Col&, long long e, int) const { return q[e]; }
  __device__ long long dq_index(const Col&, long long e) const { return e; }
};

// kPer: one table per batch item, `rn` floats apart. The forward finds an
// element's item from its row (a tile may span two items); the backward's
// blocks each lie in one item and load its row once. kOrg (the slab mode):
// the voxel's coordinates across the swept axis are offset by the slab's
// origin in the volume (im.oz, im.oy, im.ox).
template <bool kPer, bool kOrg = false>
struct AffineQ {
  const float* row;  // coef[d], offset (of batch item 0)
  int d;
  Img im;
  long long rn;      // the table's batch stride (0: one table)
  float t, c0, c1, c2;
  static constexpr bool kRowGrad = true;  // the backward reduces dq to the row
  struct Col {
    float pz, py, px;  // the products of the voxel's coordinates (the swept one unused)
    float z, y, x;     // the coordinates
  };
  __device__ __forceinline__ void read(const float* r, float& a0, float& a1, float& a2,
                                       float& tt) const {
    if (d == 3) {
      a0 = r[0]; a1 = r[1]; a2 = r[2]; tt = r[3];
    } else {  // 2-D: z is 0 and has no term
      a0 = 0.0f; a1 = r[0]; a2 = r[1]; tt = r[2];
    }
  }
  __device__ void load(int n) { read(row + n * rn, c0, c1, c2, t); }
  // the voxel (z, y, x) of position p of row (o, i); p is global along the
  // swept axis, the other two are offset by a slab's origin
  __device__ __forceinline__ void voxel(int o, int p, int i, int& z, int& y, int& x) const {
    if (im.axis == 0) {
      z = p; y = im.by_x.div(i); x = i - y * im.X;
    } else if (im.axis == 1) {
      z = o - im.by_z.div(o) * im.Z; y = p; x = i;
    } else {
      const int oz = im.by_y.div(o);
      y = o - oz * im.Y; z = oz - im.by_z.div(oz) * im.Z; x = p;
    }
    if constexpr (kOrg) {
      if (im.axis != 0) z += im.oz;
      if (im.axis != 1) y += im.oy;
      if (im.axis != 2) x += im.ox;
    }
  }
  // q from the three rounded products, summed in the plain grid's order
  __device__ __forceinline__ float sum(float tt, float pz, float py, float px) const {
    float q = tt;
    if (d == 3) q = __fadd_rn(q, pz);
    q = __fadd_rn(q, py);
    return __fadd_rn(q, px);
  }
  __device__ float at(long long, int o, int p, int i) const {
    int z, y, x;
    voxel(o, p, i, z, y, x);
    if constexpr (kPer) {
      float a0, a1, a2, tt;
      read(row + (long long)im.by_c.div(im.by_ob.div(o)) * rn, a0, a1, a2, tt);
      return sum(tt, __fmul_rn(a0, (float)z), __fmul_rn(a1, (float)y), __fmul_rn(a2, (float)x));
    }
    return sum(t, __fmul_rn(c0, (float)z), __fmul_rn(c1, (float)y), __fmul_rn(c2, (float)x));
  }
  __device__ Col col(int o, int i) const {
    int z, y, x;
    voxel(o, 0, i, z, y, x);
    return {__fmul_rn(c0, (float)z), __fmul_rn(c1, (float)y), __fmul_rn(c2, (float)x),
            (float)z, (float)y, (float)x};
  }
  __device__ float at(const Col& c, long long, int p) const {
    const int a = im.axis;
    const float m = __fmul_rn(a == 0 ? c0 : (a == 1 ? c1 : c2), (float)p);
    return sum(t, a == 0 ? m : c.pz, a == 1 ? m : c.py, a == 2 ? m : c.px);
  }
};

// kOne: one image (N = C = 1), whose field channel and du are indexed like
// src. A column then needs no offsets, which cost the backward 15 registers
// and so a block an SM (63 against 48 registers at 240³, K = 8). `uvol` is
// the voxels of one image of the field's layout: im.vol, but in the slab
// mode's backward, whose field is a buffer with a halo laid out as src's
// (du is laid out as the slab's outputs, im.vol an image).
template <bool kOne>
struct FlowQ {
  const float* u;      // channel a of the field, batch item 0
  long long un;        // the field's batch stride
  Img im;
  long long dqn, dqc;  // backward: du's batch and channel strides
  long long uvol;      // voxels of an image of u's layout
  static constexpr bool kRowGrad = false;
  struct Col {
    long long u_off;   // u's index of an element: u_off + e
    long long dq_off;  // du's index of an element: dq_off + e
  };
  __device__ void load(int) {}
  __device__ float at(long long e, int o, int p, int) const {
    if constexpr (kOne) return __fadd_rn(u[e], (float)p);
    const int b = im.by_ob.div(o);
    return __fadd_rn(u[im.by_c.div(b) * un + (e - (long long)b * uvol)], (float)p);
  }
  __device__ Col col(int o, int) const {
    if constexpr (kOne) return {0, 0};
    const int b = im.by_ob.div(o), n = im.by_c.div(b);
    return {n * un - (long long)b * uvol,
            n * dqn + (b - n * im.C) * dqc - (long long)b * im.vol};
  }
  __device__ float at(const Col& c, long long e, int p) const {
    return __fadd_rn(u[c.u_off + e], (float)p);
  }
  __device__ long long dq_index(const Col& c, long long e) const { return c.dq_off + e; }
};

// --------------------------------------------------------------- tiles
// The forward and the affine backward tile the rows in one of two ways.
// inner > 1: lanes take 32 consecutive i, the thread's rows are positions p
// (so the taps along the axis are reused inside the block), a block is one
// o. inner == 1 (the last axis): lanes take 32 consecutive p, the thread's
// rows are rows o.

dim3 tile_grid(const Rows& r) {
  const bool lanes_p = r.inner == 1;
  const long long lanes = lanes_p ? r.L : r.inner;
  const long long rows = lanes_p ? r.outer : r.L;
  const long long planes = lanes_p ? 1 : r.outer;
  const long long gy = (rows + kTileRows - 1) / kTileRows;
  return dim3((unsigned)((lanes + kLanes - 1) / kLanes), (unsigned)(gy < 65535 ? gy : 65535),
              (unsigned)(planes < 65535 ? planes : 65535));
}

bool rows_ok(const Rows& r) {
  return r.outer > 0 && r.inner > 0 && r.L > 0 && r.K >= 0 && r.outer < INT_MAX &&
         r.inner < INT_MAX && (r.inner == 1 || (r.inner + kLanes - 1) / kLanes < INT_MAX);
}

// --------------------------------------------------------------- forward

template <typename T, typename Q, bool kSlab>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
sweep_fwd_kernel(const T* __restrict__ src, Q qf, T* __restrict__ out,
                 float* __restrict__ diff, Rows r, Slab sl) {
  Q qm = qf;
  qm.load(0);
  // the slab mode's geometry (constants outside it)
  const int p0 = kSlab ? sl.p0 : 0, b0 = kSlab ? sl.b0 : 0, Xg = kSlab ? sl.Xg : r.L;
  const bool lanes_p = r.inner == 1;
  const long long n_lanes = lanes_p ? r.L : r.inner;
  const long long n_rows = lanes_p ? r.outer : r.L;
  const long long n_planes = lanes_p ? 1 : r.outer;
  const long long lane = (long long)blockIdx.x * kLanes + threadIdx.x % kLanes;
  if (lane >= n_lanes) return;
  const int ty = threadIdx.x / kLanes;
  for (long long plane = blockIdx.z; plane < n_planes; plane += gridDim.z) {
    for (long long rb = (long long)blockIdx.y * kTileRows; rb < n_rows;
         rb += (long long)gridDim.y * kTileRows) {
      long long e[kRows];
      int o[kRows], p[kRows];
      bool live[kRows];
      Taps t[kRows];
      float qv[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        // a row past the end reads the last row's coordinate and writes nothing
        const long long rr = rb + ty + k * kStep;
        live[k] = rr < n_rows;
        const long long rc = live[k] ? rr : n_rows - 1;
        o[k] = lanes_p ? (int)rc : (int)plane;
        p[k] = lanes_p ? (int)lane : (int)rc;
        const int i = lanes_p ? 0 : (int)lane;
        e[k] = ((long long)o[k] * r.L + p[k]) * r.inner + i;
        qv[k] = qm.at(e[k], o[k], p[k] + p0, i);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) t[k] = taps_of(qv[k], p[k] + p0, Xg, r.K);
      float vf[kRows], vc[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        // the source row's element at global position 0 (a slab's buffer
        // holds its rows from b0)
        const long long row =
            kSlab ? ((long long)o[k] * sl.Lb - b0) * r.inner + (lanes_p ? 0 : lane)
                  : e[k] - (long long)p[k] * r.inner;
        vf[k] = live[k] && t[k].mf ? load_f(src, row + t[k].xf * r.inner) : 0.0f;
        vc[k] = live[k] && t[k].mc ? load_f(src, row + (t[k].xf + 1) * r.inner) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!live[k]) continue;
        store_f(out, e[k], blend(t[k], vf[k], vc[k]));
        if (diff) diff[e[k]] = __fsub_rn(vc[k], vf[k]);
      }
    }
  }
}

// ------------------------------------------------------------- backward

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// a warp's float4s summed into lane 0 in a fixed order
__device__ __forceinline__ float4 warp_sum(float4 v) {
  for (int wd = 16; wd > 0; wd >>= 1)
    v = add4(v, make_float4(__shfl_down_sync(0xffffffffu, v.x, wd),
                            __shfl_down_sync(0xffffffffu, v.y, wd),
                            __shfl_down_sync(0xffffffffu, v.z, wd),
                            __shfl_down_sync(0xffffffffu, v.w, wd)));
  return v;
}

// The affine form's row gradient, from each thread's sums (of d*z, d*y, d*x,
// d): the block's share in a fixed tree, within each warp by shuffles, then
// the warps' sums in order, into the item's partials (the grid's y index is
// the item); the last block to finish (the item's counter tells it) adds
// every block's partial in a fixed order, whichever block is last (each
// thread a strided share, then a tree), and writes the row (coef[d], offset).
__device__ __forceinline__ void reduce_row(float4 sums, float4* partials, unsigned* done,
                                           float* drow, long long drn, int d) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  partials += (long long)blockIdx.y * gridDim.x;
  done += blockIdx.y;
  drow += blockIdx.y * drn;
  __shared__ float4 red[kThreads / 32];
  __shared__ bool last;
  sums = warp_sum(sums);
  if (lane == 0) red[w] = sums;
  __syncthreads();
  if (tid == 0) {
    float4 a = red[0];
    for (int k = 1; k < kThreads / 32; ++k) a = add4(a, red[k]);
    partials[blockIdx.x] = a;
    __threadfence();  // the partial is visible before the count says so
    last = atomicInc(done, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (unsigned b = tid; b < gridDim.x; b += kThreads) acc = add4(acc, partials[b]);
  acc = warp_sum(acc);
  __syncthreads();
  if (lane == 0) red[w] = acc;
  __syncthreads();
  if (tid == 0) {
    float4 r = red[0];
    for (int k = 1; k < kThreads / 32; ++k) r = add4(r, red[k]);
    // row layout (coef[d], offset); 2-D has no z coefficient
    const float all[4] = {r.x, r.y, r.z, r.w};
    const int first = d == 3 ? 0 : 1;
    for (int k = first; k < 4; ++k) drow[k - first] = all[k];
  }
}

// The staged backward's tile: kCols columns (TI inner x TO outer, TI a
// power of 2) by a chunk of L positions, staged with the window around it.
// `outer` and `blocks` count one batch item's rows and blocks when the
// grid's y index is the item (the affine form's table per item), else all.
struct Tile {
  long long outer, inner;
  int X, K;               // X: the volume's extent along the axis (the taps' zero test)
  int Lo;                 // output positions a row (X but in the slab mode)
  int TI, ti_shift, TO;
  int L, LhM;             // chunk length; staged positions per column (at most)
  int n_chunks;
  long long n_inner_tiles, blocks;
};

// bytes a staged position takes: code, fr, g and src
constexpr int kStageBytes = 16;
// the staged backward's dynamic shared memory may exceed the 48 KB default
constexpr int kStageBudget = 112 * 1024;

long long tile_bytes(int TO, int TI, int LhM) {
  return (long long)TO * TI * LhM * kStageBytes;
}

// false when no tile fits the budget. The rows hold r.L outputs of a volume
// of X along the axis (X = r.L but in the slab mode).
bool make_tile(const Rows& r, int X, Tile& tl) {
  const int Lo = r.L, K = r.K;
  tl.outer = r.outer; tl.inner = r.inner; tl.X = X; tl.K = K; tl.Lo = Lo;
  int TI = 1;
  while (TI * 2 <= kCols && TI * 2 <= r.inner) TI *= 2;
  int TO = kCols / TI;
  tl.L = Lo < kChunk ? Lo : kChunk;
  // a window wider than the chunk would stage its halo more than twice:
  // stage whole rows, with no halo at all
  if (2LL * K + 2 > tl.L) tl.L = Lo;
  const long long span = (long long)tl.L + 2LL * K + 2;
  tl.LhM = (int)(span < X ? span : X);
  while (tile_bytes(TO, TI, tl.LhM) > kStageBudget && TO > 1) TO /= 2;
  while (tile_bytes(TO, TI, tl.LhM) > kStageBudget && TI > 1) TI /= 2;
  if (tile_bytes(TO, TI, tl.LhM) > kStageBudget) return false;
  tl.TI = TI; tl.TO = TO;
  tl.ti_shift = 0;
  while ((1 << tl.ti_shift) < TI) ++tl.ti_shift;
  tl.n_chunks = (Lo + tl.L - 1) / tl.L;
  tl.n_inner_tiles = (r.inner + TI - 1) / TI;
  tl.blocks = ((r.outer + TO - 1) / TO) * tl.n_inner_tiles * tl.n_chunks;
  return tl.blocks <= 0x7fffffffLL;
}

// code of a staged position x: (k + K + 2) << 2 | floor counts << 1 | ceil
// counts, with k = floor(q) - x clamped to [-K-2, K+2] (a NaN q to -K-2);
// where a tap counts, k is within the window and x + k is its floor index
__device__ __forceinline__ int tap_code(const Taps& t, int x, int K) {
  const float k = fminf(fmaxf(t.q0 - (float)x, (float)(-K - 2)), (float)(K + 2));
  return (((int)k + K + 2) << 2) | ((int)t.mf << 1) | (int)t.mc;
}

template <typename T, typename Q, bool kSlab>
__global__ void __launch_bounds__(kThreads)
sweep_bwd_kernel(const T* __restrict__ g, const T* __restrict__ src, Q qf,
                 T* __restrict__ dsrc, float* __restrict__ dq, float4* __restrict__ partials,
                 unsigned* __restrict__ done, float* __restrict__ drow, long long drn,
                 Tile tl, Slab sl) {
  extern __shared__ int smem[];
  const int n_stage = tl.TO * tl.LhM * tl.TI;        // each array [TO][LhM][TI]
  int* code = smem;
  float* s_fr = (float*)(code + n_stage);
  float* s_src = s_fr + n_stage;
  float* s_g = s_src + n_stage;
  // per column: does its floor index x + k never decrease along x?
  __shared__ int s_mono[kCols];
  Q qm = qf;
  qm.load(blockIdx.y);
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % tl.n_chunks;
  const long long tile = blockIdx.x / tl.n_chunks;
  const long long ob = (long long)blockIdx.y * tl.outer;  // the item's first row
  const long long o0 = (tile / tl.n_inner_tiles) * tl.TO;
  const long long i0 = (tile % tl.n_inner_tiles) * tl.TI;
  const int X = tl.X, K = tl.K, TI = tl.TI;
  // positions are global: the slab mode's outputs are [P0, P0 + Lo), its g
  // and src buffers of Lb rows from B0 (a halo of K + 1 rows a side)
  const int P0 = kSlab ? sl.p0 : 0, B0 = kSlab ? sl.b0 : 0;
  const long long Lb = kSlab ? sl.Lb : X, Lo = kSlab ? tl.Lo : X;
  const int j0 = P0 + chunk * tl.L;
  // the chunk's end: the row's (X) outside the slab mode
  const int jend = kSlab ? min(j0 + tl.L, P0 + (int)Lo) : X;
  // staged positions: the chunk and the window around it (its outputs'
  // taps reach K + 1 past it, the sources it gathers K + 1 before it)
  const int s0 = max(0, j0 - K - 1);
  const int s1 = min(X, (kSlab ? jend : j0 + tl.L) + K + 1);
  const int Lh = s1 - s0;
  // each lane keeps one column (one row (o, i) of the view) for a run of
  // positions: a warp takes 32 / TI positions of TI columns a step
  const int lane = tid & 31, w = tid >> 5;
  const int ti = lane & (TI - 1), pl = lane >> tl.ti_shift;
  const int P = kLanes >> tl.ti_shift;
  const int wpc = tl.TO >= 8 ? 1 : 8 / tl.TO;  // warps per column
  const int to0 = w / wpc, to_step = 8 / wpc;
  const int p0 = pl + P * (w % wpc), p_step = P * wpc;
  const long long i = i0 + ti;
  if (tid < kCols) s_mono[tid] = 1;

  // 1. one pass over global memory: each staged position's coordinate, g
  //    and src; its taps' code and fr
  for (int to = to0; to < tl.TO; to += to_step) {
    const long long o = o0 + to;
    if (o >= tl.outer || i >= tl.inner) continue;
    const typename Q::Col c = qm.col((int)(ob + o), (int)i);
    const long long base = ((ob + o) * Lb - B0) * tl.inner + i;
    const int sb = ti + TI * tl.LhM * to;
    for (int p = p0; p < Lh; p += p_step) {
      const int x = s0 + p;
      const long long idx = base + (long long)x * tl.inner;
      const float qv = qm.at(c, idx, x);
      const float gv = load_f(g, idx);
      const float sv = load_f(src, idx);
      const int e = sb + TI * p;
      const Taps t = taps_of(qv, x, X, K);
      code[e] = tap_code(t, x, K);
      s_fr[e] = t.fr;
      s_src[e] = sv;
      s_g[e] = gv;
    }
  }
  __syncthreads();
  // 2. per column: does its floor index x + k never decrease along x?
  if (dsrc) {
    for (int to = to0; to < tl.TO; to += to_step) {
      const int sb = ti + TI * tl.LhM * to;
      bool mono = true;
      for (int p = p0; p + 1 < Lh; p += p_step)
        mono &= (code[sb + TI * p] >> 2) <= (code[sb + TI * (p + 1)] >> 2) + 1;
      if (!mono) atomicAnd(&s_mono[ti + TI * to], 0);
    }
    __syncthreads();
  }
  // 3. each position of the chunk: dq from its staged taps (or its share of
  //    the table row's gradient); on a column without folds, dsrc by
  //    gathering the x that hit it
  float4 sums = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // of dq*z, dq*y, dq*x, dq
  for (int to = to0; to < tl.TO; to += to_step) {
    const long long o = o0 + to;
    if (o >= tl.outer || i >= tl.inner) continue;
    const typename Q::Col c = qm.col((int)(ob + o), (int)i);
    // the output's element at global position 0 (dq and dsrc have Lo rows)
    const long long base = ((ob + o) * Lo - P0) * tl.inner + i;
    const int sb = ti + TI * tl.LhM * to;
    for (int jj = p0; jj < tl.L; jj += p_step) {
      const int j = j0 + jj;
      if (j >= jend) break;
      const long long idx = base + (long long)j * tl.inner;
      if (dq || Q::kRowGrad) {
        const int s = sb + TI * (j - s0);
        const int cd = code[s];
        const int f = j + (cd >> 2) - K - 2;
        const float vf = (cd & 2) ? s_src[sb + TI * (f - s0)] : 0.0f;
        const float vc = (cd & 1) ? s_src[sb + TI * (f + 1 - s0)] : 0.0f;
        const float d = __fmul_rn(s_g[s], __fsub_rn(vc, vf));
        if constexpr (Q::kRowGrad) {
          const int a = qm.im.axis;
          sums.x = __fadd_rn(sums.x, __fmul_rn(d, a == 0 ? (float)j : c.z));
          sums.y = __fadd_rn(sums.y, __fmul_rn(d, a == 1 ? (float)j : c.y));
          sums.z = __fadd_rn(sums.z, __fmul_rn(d, a == 2 ? (float)j : c.x));
          sums.w = __fadd_rn(sums.w, d);
        } else {
          dq[qm.dq_index(c, idx)] = d;
        }
      }
      if (!dsrc || !s_mono[ti + TI * to]) continue;
      // the x that hit j form one run: walk from a first guess (j minus the
      // k at j) to its start, then take the run in ascending x (x hits j
      // only if its floor index is j - 1 or j, inside the window)
      float acc = 0.0f;
      const int xlo = max(s0, j - K - 1), xhi = min(s1 - 1, j + K);
      auto floor_at = [&](int x) { return x + (code[sb + TI * (x - s0)] >> 2) - K - 2; };
      int x = min(max(2 * j - floor_at(j) - 1, xlo), xhi);
      while (x > xlo && floor_at(x - 1) >= j - 1) --x;
      while (x <= xhi && floor_at(x) < j - 1) ++x;
      for (; x <= xhi; ++x) {
        const int s = sb + TI * (x - s0);
        const int cd = code[s];
        const int f = x + (cd >> 2) - K - 2;
        if (f > j) break;
        if ((cd & 2) && f == j) acc = __fadd_rn(acc, w_floor(s_g[s], s_fr[s]));
        else if ((cd & 1) && f + 1 == j) acc = __fadd_rn(acc, w_ceil(s_g[s], s_fr[s]));
      }
      store_f(dsrc, idx, acc);
    }
  }
  // 4. dsrc of the columns with folds: one thread a column adds each staged
  //    x's taps into the chunk's outputs in ascending x (the gather's order,
  //    so the same bits), in the column's src stage, which only phase 3 read
  if (dsrc) {
    __syncthreads();
    if (tid < tl.TO * TI && !s_mono[tid] && o0 + (tid >> tl.ti_shift) < tl.outer &&
        i0 + (tid & (TI - 1)) < tl.inner) {
      const int sb = (tid & (TI - 1)) + TI * tl.LhM * (tid >> tl.ti_shift);
      float* acc = s_src + sb;  // acc[TI * (j - j0)]
      for (int jj = 0; jj < tl.L; ++jj) acc[TI * jj] = 0.0f;
      for (int x = s0; x < s1; ++x) {
        const int s = sb + TI * (x - s0);
        const int cd = code[s];
        const int f = x + (cd >> 2) - K - 2 - j0;
        if ((cd & 2) && f >= 0 && f < tl.L)
          acc[TI * f] = __fadd_rn(acc[TI * f], w_floor(s_g[s], s_fr[s]));
        if ((cd & 1) && f + 1 >= 0 && f + 1 < tl.L)
          acc[TI * (f + 1)] = __fadd_rn(acc[TI * (f + 1)], w_ceil(s_g[s], s_fr[s]));
      }
    }
    __syncthreads();
    for (int to = to0; to < tl.TO; to += to_step) {
      const long long o = o0 + to;
      if (o >= tl.outer || i >= tl.inner || s_mono[ti + TI * to]) continue;
      const long long base = ((ob + o) * Lo - P0) * tl.inner + i;
      const float* acc = s_src + ti + TI * tl.LhM * to;
      for (int jj = p0; jj < tl.L && j0 + jj < jend; jj += p_step)
        store_f(dsrc, base + (long long)(j0 + jj) * tl.inner, acc[TI * jj]);
    }
  }
  if constexpr (Q::kRowGrad) {
    if (partials) reduce_row(sums, partials, done, drow, drn, qm.d);
  }
}

// sweep_bwd2 (the note at the top) on a tile of its own: TC = TO x TI
// columns (TI a power of 2 along inner, TO <= 8 along outer) by a chunk of up
// to kChunk2 positions, a whole row up to kChunk2 or where the window is
// wider than the chunk, staged with the window around it. Each thread owns
// one column of a tile and every 256 / TC-th position of it, for staging and
// for compute alike. A launch has a few blocks an SM, each looping over the
// item's tiles t, t + G, ... (G the blocks of an item) with two stage
// buffers: right after a barrier each thread stages its share of the next
// tile into the buffer the last tile left and then computes this tile from
// the other, so one warp's loads are in flight while the block's other warps
// and the SM's other blocks compute. Measured on the H100 (PERF.md): holding
// the next tile in registers across the compute spilled and was slower, and
// cp.async (f32 only: it has no 2-byte copy for bf16) was no faster; TMA
// boxes need 16-byte strides, which rows of 60 bf16 voxels do not have.
struct Tile2 {
  long long outer, inner;
  int X, K;               // X: the volume's extent along the axis (the taps' zero test)
  // the slab mode (the Slab note): the rows are a buffer of Lb positions,
  // global positions [B0, B0 + Lb), whose outputs are the Lo from local
  // position P0; outside it Lb = Lo = X and P0 = B0 = 0
  int Lb, Lo, P0, B0;
  int TI, ti_shift, TO;
  int L, LhM;             // chunk length; staged positions per column (at most)
  int n_chunks;
  int ns;                 // a buffer's staged elements (TC * LhM), padded
  long long buf_bytes;    // bytes of a buffer
  int nbuf;               // stage buffers: 2, or 1 where two do not fit
  int n_inner_tiles, tiles;  // tiles of one item
};

constexpr int kChunk2 = 256;  // positions of a chunk
// positions of each input a thread loads at once (a tile of up to
// 256 * kAhead positions; the rest of a longer one loads one at a time)
constexpr int kAhead = 8;
// blocks an SM the compiler fits the registers to (80 a thread; with 2 it
// ran slower, with 4 it spilled: PERF.md)
constexpr int kBwd2MinBlocks = 3;
constexpr int kFill = 264;    // tiles a launch should have at least: 2 on each of 132 SMs
constexpr int kTcMin = 8;     // fewest columns a tile is cut to, to reach kFill

// a buffer: src, ubar and g in the image dtype and a 16-bit tap code
// (tap_code) a staged position
long long bwd2_buf_bytes(long long ns, int elem) { return (ns * (3LL * elem + 2) + 15) / 16 * 16; }

// false when no tile fits the budget or the tap code does not fit 16 bits.
// The rows hold r.L outputs; in the slab mode (sl) of a buffer of sl.Lb
// positions of a volume of sl.Xg.
bool make_tile2(const Rows& r, int elem, Tile2& tl, const Slab* sl = nullptr) {
  const int Lo = r.L, K = r.K;
  if (4LL * (2LL * K + 4) + 3 > 32767) return false;
  tl.outer = r.outer; tl.inner = r.inner; tl.K = K; tl.Lo = Lo;
  tl.X = sl ? sl->Xg : Lo;
  tl.Lb = sl ? sl->Lb : Lo;
  tl.P0 = sl ? sl->p0 - sl->b0 : 0;
  tl.B0 = sl ? sl->b0 : 0;
  tl.L = Lo < kChunk2 ? Lo : kChunk2;
  if (2LL * K + 2 > tl.L) tl.L = Lo;  // the window would stage the halo twice: whole rows
  const long long span = (long long)tl.L + 2LL * K + 2;
  tl.LhM = (int)(span < tl.Lb ? span : tl.Lb);
  tl.n_chunks = (Lo + tl.L - 1) / tl.L;
  int ti_max = 1;
  while (ti_max * 2 <= kCols && ti_max * 2 <= r.inner) ti_max *= 2;
  long long tiles = 0;
  auto set = [&](int TC) {
    tl.TI = TC < ti_max ? TC : ti_max;
    tl.TO = TC / tl.TI;
    tl.ns = (int)(((long long)TC * tl.LhM + 7) / 8 * 8);
    tl.buf_bytes = bwd2_buf_bytes(tl.ns, elem);
    const long long n_inner = (r.inner + tl.TI - 1) / tl.TI;
    tiles = ((r.outer + tl.TO - 1) / tl.TO) * n_inner * tl.n_chunks;
    tl.n_inner_tiles = (int)(n_inner < INT_MAX ? n_inner : INT_MAX);
    tl.tiles = (int)(tiles < INT_MAX ? tiles : INT_MAX);
  };
  // the most columns (at most 8 along outer: a thread owns one column) whose
  // two buffers fit and that one round of loads ahead covers, then fewer
  // while the launch has too few tiles to fill the card
  int TC = kCols < 8 * ti_max ? kCols : 8 * ti_max;
  set(TC);
  while (TC > 1 && ((long long)TC * tl.LhM > (long long)kAhead * kThreads ||
                    2 * tl.buf_bytes > kStageBudget))
    set(TC /= 2);
  while (TC > kTcMin && tiles < kFill) set(TC /= 2);
  tl.nbuf = 2 * tl.buf_bytes <= kStageBudget ? 2 : 1;
  if (tl.nbuf * tl.buf_bytes > kStageBudget) return false;
  tl.ti_shift = 0;
  while ((1 << tl.ti_shift) < tl.TI) ++tl.ti_shift;
  return tiles < INT_MAX;
}

// a tile's place: its first column (o0, i0), its chunk from j0, the staged
// positions [s0, s1) (positions of the buffer: a position x is the volume's
// B0 + x; only those inside the volume are staged)
struct TileAt {
  long long o0, i0;
  int j0, s0, s1;
};

__device__ __forceinline__ TileAt tile_at(const Tile2& tl, int t) {
  TileAt a;  // 32-bit divisions: a 64-bit one costs some hundred instructions
  const unsigned ct = (unsigned)t / (unsigned)tl.n_chunks;
  const unsigned oi = ct / (unsigned)tl.n_inner_tiles;
  a.j0 = tl.P0 + (int)((unsigned)t - ct * tl.n_chunks) * tl.L;
  a.o0 = (long long)oi * tl.TO;
  a.i0 = (long long)(ct - oi * tl.n_inner_tiles) * tl.TI;
  a.s0 = max(max(0, -tl.B0), a.j0 - tl.K - 1);
  a.s1 = min(min(tl.Lb, tl.X - tl.B0), a.j0 + tl.L + tl.K + 1);
  return a;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// a thread's positions of a tile (p0 + r * p_step), all loads issued
// before the first store
template <typename T>
struct Ahead {
  T s[kAhead], u[kAhead], g[kAhead];
};

// q (or v) along one row of an affine pass: q(p) = ((P + c p) + R1) + R2,
// the terms before the swept axis's product folded into P and only those
// after it (nr of them) left: AffineQ::at's sums in its order, with no
// select a position
struct Line {
  float P, c, R1, R2;
  int nr;
};

template <bool kPer, bool kOrg>
__device__ __forceinline__ Line line_of(const AffineQ<kPer, kOrg>& q,
                                        const typename AffineQ<kPer, kOrg>::Col& c) {
  const int a = q.im.axis;
  float P = q.t;
  if (q.d == 3 && a > 0) P = __fadd_rn(P, c.pz);
  if (a > 1) P = __fadd_rn(P, c.py);
  return Line{P, a == 0 ? q.c0 : (a == 1 ? q.c1 : q.c2), a == 0 ? c.py : c.px, c.px, 2 - a};
}

__device__ __forceinline__ float line_at(const Line& l, int p) {
  float q = __fadd_rn(l.P, __fmul_rn(l.c, (float)p));
  if (l.nr > 0) q = __fadd_rn(q, l.R1);
  if (l.nr > 1) q = __fadd_rn(q, l.R2);
  return q;
}

// sweep_bwd2 (the note at the top). gbar, the row's gradient and sbar of
// each position of a tile come from the staged tile alone: g is read from
// memory once, each tap code is computed once. A buffer holds src, ubar and
// g as the image dtype and a 16-bit tap code (tap_code) a staged position,
// each [TO][LhM][TI]. Null ubar reads as zeros; null gbar, sbar or partials
// skip that output. kOrg: the slab mode, whose g, src and ubar are buffers
// of tl.Lb rows (with a halo along the swept axis) and whose outputs are
// the tl.Lo rows from tl.P0, at the volume's positions and coordinates, so
// gbar and sbar are the unsharded launch's to the bit.
template <typename T, bool kPer, bool kOrg>
__global__ void __launch_bounds__(kThreads, kBwd2MinBlocks)
sweep_bwd2_kernel(const T* __restrict__ g, const T* __restrict__ src,
                  const T* __restrict__ ubar, AffineQ<kPer, kOrg> qf, AffineQ<kPer, kOrg> rf,
                  T* __restrict__ gbar, T* __restrict__ sbar, float4* __restrict__ partials,
                  unsigned* __restrict__ done, float* __restrict__ drow, long long drn,
                  Tile2 tl) {
  extern __shared__ __align__(16) unsigned char smem2[];
  AffineQ<kPer, kOrg> qm = qf, rm = rf;
  qm.load(blockIdx.y);
  rm.load(blockIdx.y);
  const int tid = threadIdx.x;
  const long long ob = (long long)blockIdx.y * tl.outer;  // the item's first row
  const long long inner = tl.inner;
  const int X = tl.X, K = tl.K, TI = tl.TI, axis = qm.im.axis, ns = tl.ns;
  const int Lb = tl.Lb, Lo = tl.Lo, P0 = tl.P0, B0 = tl.B0;
  // q = ((t + c0 z) + c1 y) + c2 x is rounded monotonically in each product,
  // so with the swept axis's coefficient >= 0 (or NaN: q is NaN and every
  // code alike) each column's floor index never decreases along the row:
  // sbar walks to the run of x that reach j; else it scans the window
  const bool walk = !((axis == 0 ? qm.c0 : (axis == 1 ? qm.c1 : qm.c2)) < 0.0f);
  // this thread's column (to, ti) of every tile and its positions p0 + k * p_step
  const int lane = tid & 31, w = tid >> 5;
  const int ti = lane & (TI - 1);
  const int wpc = 8 / tl.TO;  // warps a column
  const int to = w / wpc;
  const int p0 = (lane >> tl.ti_shift) + (kLanes >> tl.ti_shift) * (w % wpc);
  const int p_step = kThreads / (tl.TO * TI);
  auto fetch = [&](const TileAt& a, Ahead<T>& ah) {
    const long long o = a.o0 + to, i = a.i0 + ti;
    const bool live = o < tl.outer && i < inner;
    const long long base = ((ob + o) * Lb + a.s0) * inner + i;
    const int Lh = a.s1 - a.s0;
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int p = p0 + r * p_step;
      const bool in = live && p < Lh;
      const long long idx = base + (long long)p * inner;
      ah.s[r] = in ? src[idx] : zero_of<T>();
      ah.u[r] = in && ubar ? ubar[idx] : zero_of<T>();
      ah.g[r] = in ? g[idx] : zero_of<T>();
    }
  };
  // the thread's positions of tile a and their tap codes into the buffer at b
  auto commit = [&](const TileAt& a, const Ahead<T>& ah, unsigned char* b) {
    const long long o = a.o0 + to, i = a.i0 + ti;
    if (o >= tl.outer || i >= inner) return;
    T* bs = reinterpret_cast<T*>(b);
    short* code = reinterpret_cast<short*>(bs + 3 * ns);
    const Line l = line_of(qm, qm.col((int)(ob + o), (int)i));
    const long long base = ((ob + o) * Lb + a.s0) * inner + i;
    const int Lh = a.s1 - a.s0, sb = ti + TI * tl.LhM * to;
    auto put = [&](int p, T sv, T uv, T gv) {
      const int x = B0 + a.s0 + p, e = sb + TI * p;  // x: the volume's position
      code[e] = (short)tap_code(taps_of(line_at(l, x), x, X, K), x, K);
      bs[e] = sv;
      bs[ns + e] = uv;
      bs[2 * ns + e] = gv;
    };
#pragma unroll
    for (int r = 0; r < kAhead; ++r)
      if (p0 + r * p_step < Lh) put(p0 + r * p_step, ah.s[r], ah.u[r], ah.g[r]);
    for (int p = p0 + kAhead * p_step; p < Lh; p += p_step) {  // past the round ahead
      const long long idx = base + (long long)p * inner;
      put(p, src[idx], ubar ? ubar[idx] : zero_of<T>(), g[idx]);
    }
  };
  float4 sums = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // of d*z, d*y, d*x, d
  // the positions of the thread's column of a tile: gbar and its share of
  // the row's gradient from its taps, then sbar by gathering the x that hit
  // each, in ascending x
  auto compute = [&](const TileAt& a, const unsigned char* b) {
    const long long o = a.o0 + to, i = a.i0 + ti;
    if (o >= tl.outer || i >= inner) return;
    const T* bs = reinterpret_cast<const T*>(b);
    const T* bu = bs + ns;
    const T* bg = bs + 2 * ns;
    const short* code = reinterpret_cast<const short*>(bs + 3 * ns);
    const typename AffineQ<kPer, kOrg>::Col c = qm.col((int)(ob + o), (int)i);
    const Line lq = line_of(qm, c), lv = line_of(rm, rm.col((int)(ob + o), (int)i));
    const int sb = ti + TI * (tl.LhM * to - a.s0);  // staged element of x: sb + TI * x
    auto floor_at = [&](int x) { return x + (code[sb + TI * x] >> 2) - K - 2; };
    // outputs: the Lo rows from P0 (a position j of the buffer is output j - P0)
    const long long idx0 = ((ob + o) * Lo + a.j0 - P0 + p0) * inner + i;
    const long long step = (long long)p_step * inner;
    const int jend = min(a.j0 + tl.L, P0 + Lo);
    // gbar and the row's gradient: no loop-carried branch, so positions overlap
    if (gbar || partials) {
      long long idx = idx0;
#pragma unroll 2
      for (int j = a.j0 + p0; j < jend; j += p_step, idx += step) {
        const int s = sb + TI * j;
        const int cd = code[s];
        const int f = sb + TI * (j + (cd >> 2) - K - 2);
        const float uf = (cd & 2) ? to_f(bu[f]) : 0.0f;
        const float uc = (cd & 1) ? to_f(bu[f + TI]) : 0.0f;
        const int jg = B0 + j;  // the volume's position
        if (partials) {
          const float d = __fmul_rn(to_f(bg[s]), __fsub_rn(uc, uf));
          sums.x = __fadd_rn(sums.x, __fmul_rn(d, axis == 0 ? (float)jg : c.z));
          sums.y = __fadd_rn(sums.y, __fmul_rn(d, axis == 1 ? (float)jg : c.y));
          sums.z = __fadd_rn(sums.z, __fmul_rn(d, axis == 2 ? (float)jg : c.x));
          sums.w = __fadd_rn(sums.w, d);
        }
        if (gbar) {
          const float q = line_at(lq, jg);
          const float fr = q - floorf(q);  // taps_of's weight
          const float sf = (cd & 2) ? to_f(bs[f]) : 0.0f;
          const float sc = (cd & 1) ? to_f(bs[f + TI]) : 0.0f;
          const float bl = __fadd_rn((cd & 2) ? w_floor(uf, fr) : 0.0f,
                                     (cd & 1) ? w_ceil(uc, fr) : 0.0f);
          store_f(gbar, idx, __fadd_rn(bl, __fmul_rn(line_at(lv, jg), __fsub_rn(sc, sf))));
        }
      }
    }
    if (!sbar) return;
    // sbar: the x that hit j, in ascending x
    long long idx = idx0;
    for (int j = a.j0 + p0; j < jend; j += p_step, idx += step) {
      float acc = 0.0f;
      const int xlo = max(a.s0, j - K - 1), xhi = min(a.s1 - 1, j + K);
      int x = xlo;
      if (walk) {  // from a first guess (j minus the k at j) to the run's start
        x = min(max(2 * j - floor_at(j) - 1, xlo), xhi);
        while (x > xlo && floor_at(x - 1) >= j - 1) --x;
        while (x <= xhi && floor_at(x) < j - 1) ++x;
      }
      for (; x <= xhi; ++x) {
        const int sx = sb + TI * x;
        const int cd = code[sx];
        const int f = x + (cd >> 2) - K - 2;
        if (walk && f > j) break;
        if ((cd & 2) && f == j)
          acc = __fsub_rn(acc, __fmul_rn(line_at(lv, B0 + x), to_f(bg[sx])));
        else if ((cd & 1) && f + 1 == j)
          acc = __fadd_rn(acc, __fmul_rn(line_at(lv, B0 + x), to_f(bg[sx])));
      }
      store_f(sbar, idx, acc);
    }
  };
  // each tile is staged into the buffer the last tile's compute has left,
  // right after the barrier: one warp's loads are in flight while the
  // others stage and compute
  auto stage = [&](const TileAt& a, unsigned char* b) {
    Ahead<T> ah;
    fetch(a, ah);
    commit(a, ah, b);
  };
  long long t = blockIdx.x;
  const long long G = gridDim.x;
  TileAt a = tile_at(tl, (int)t);
  stage(a, smem2);
  for (bool first = true; t < tl.tiles; t += G) {
    __syncthreads();  // this tile is staged; the other buffer's last reader is done
    const bool more = t + G < tl.tiles;
    const TileAt an = more ? tile_at(tl, (int)(t + G)) : a;
    if (more && tl.nbuf == 2) stage(an, first ? smem2 + tl.buf_bytes : smem2);
    compute(a, first ? smem2 : smem2 + tl.buf_bytes);
    if (more && tl.nbuf == 1) {
      __syncthreads();
      stage(an, smem2);
    }
    if (tl.nbuf == 2) first = !first;
    a = an;
  }
  if (partials) reduce_row(sums, partials, done, drow, drn, qm.d);
}

// ---------------------------------------------------------------- launch

template <typename T, typename Q, bool kSlab>
int launch_fwd(const void* src, Q q, void* out, void* diff, const Rows& r, const Slab& sl,
               cudaStream_t stream) {
  if (!rows_ok(r)) return (int)cudaErrorInvalidValue;
  sweep_fwd_kernel<T, Q, kSlab><<<tile_grid(r), kThreads, 0, stream>>>(
      (const T*)src, q, (T*)out, (float*)diff, r, sl);
  return (int)cudaGetLastError();
}

template <bool kSlab = false, typename Q>
int fwd_dtype(int dtype, const void* src, Q q, void* out, void* diff, const Rows& r,
              cudaStream_t s, const Slab& sl = Slab{}) {
  if (dtype == 0) return launch_fwd<float, Q, kSlab>(src, q, out, diff, r, sl, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16, Q, kSlab>(src, q, out, diff, r, sl, s);
  return (int)cudaErrorInvalidValue;
}

// The rows of one of `items` batch items (each its own grid row), false
// when they do not split evenly or the grid is too large; X the volume's
// extent along the axis (r.L but in the slab mode).
bool item_tile(const Rows& r, long long items, int X, Tile& tl) {
  if (items < 1 || items > 65535 || r.outer % items) return false;
  const Rows ri{r.outer / items, r.inner, r.L, r.K};
  return rows_ok(ri) && make_tile(ri, X, tl);
}

// Floats of the workspace: the items' counters (four to 16 bytes), then 4
// partial sums a block.
long long work_floats(const Tile& tl, long long items) {
  return 4 * (items * tl.blocks + (items + 3) / 4);
}

template <typename T, typename Q, bool kSlab>
int launch_bwd(const void* g, const void* src, Q q, void* dsrc, void* dq, void* work,
               void* drow, long long drn, long long items, const Rows& r, const Slab& sl,
               cudaStream_t stream) {
  Tile tl;
  if (!rows_ok(r) || !item_tile(r, items, kSlab ? sl.Xg : r.L, tl))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)tile_bytes(tl.TO, tl.TI, tl.LhM);
  static bool opted = false;  // one attribute per instantiation
  if (!opted) {
    cudaError_t rc = cudaFuncSetAttribute(sweep_bwd_kernel<T, Q, kSlab>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kStageBudget);
    if (rc != cudaSuccess) return (int)rc;
    opted = true;
  }
  // the affine form's workspace: a counter of finished blocks an item, 0 on
  // entry and left 0 (atomicInc wraps), then one partial sum a block
  unsigned* done = drow ? (unsigned*)work : nullptr;
  float4* partials = drow ? (float4*)work + (items + 3) / 4 : nullptr;
  sweep_bwd_kernel<T, Q, kSlab>
      <<<dim3((unsigned)tl.blocks, (unsigned)items), kThreads, smem, stream>>>(
          (const T*)g, (const T*)src, q, (T*)dsrc, (float*)dq, partials, done, (float*)drow,
          drn, tl, sl);
  return (int)cudaGetLastError();
}

template <bool kSlab = false, typename Q>
int bwd_dtype(int dtype, const void* g, const void* src, Q q, void* dsrc, void* dq, void* work,
              void* drow, long long drn, long long items, const Rows& r, cudaStream_t s,
              const Slab& sl = Slab{}) {
  if (dtype == 0)
    return launch_bwd<float, Q, kSlab>(g, src, q, dsrc, dq, work, drow, drn, items, r, sl, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, Q, kSlab>(g, src, q, dsrc, dq, work, drow, drn, items, r,
                                               sl, s);
  return (int)cudaErrorInvalidValue;
}

// sweep_bwd2's tile for the rows of one of `items` batch items (in the slab
// mode `sl`), false as item_tile's
bool item_tile2(const Rows& r, long long items, int elem, Tile2& tl,
                const Slab* sl = nullptr) {
  if (items < 1 || items > 65535 || r.outer % items) return false;
  const Rows ri{r.outer / items, r.inner, r.L, r.K};
  return rows_ok(ri) && make_tile2(ri, elem, tl, sl);
}

template <typename T, bool kPer, bool kOrg>
int launch_bwd2(const void* g, const void* src, const void* ubar,
                const AffineQ<kPer, kOrg>& q, const AffineQ<kPer, kOrg>& rq, void* gbar,
                void* sbar, void* work, void* drow, long long items, const Rows& r,
                const Slab* sl, cudaStream_t stream) {
  Tile2 tl;
  if (!rows_ok(r) || !item_tile2(r, items, sizeof(T), tl, sl))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(tl.nbuf * tl.buf_bytes);
  static bool opted = false;  // one attribute per instantiation
  if (!opted) {
    cudaError_t rc = cudaFuncSetAttribute(sweep_bwd2_kernel<T, kPer, kOrg>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kStageBudget);
    if (rc != cudaSuccess) return (int)rc;
    opted = true;
  }
  // the blocks an item: as many as the card holds at once, at most its tiles
  // (a function of the card and the item's shape alone, so a pair's sums are
  // those of a launch on it alone)
  static int seen_dev = -1, seen_smem = -1, resident = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev != seen_dev || smem != seen_smem) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_bwd2_kernel<T, kPer, kOrg>, kThreads, smem);
    if (rc != cudaSuccess) return (int)rc;
    resident = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    seen_dev = dev;
    seen_smem = smem;
  }
  const long long G = tl.tiles < resident ? tl.tiles : resident;
  unsigned* done = drow ? (unsigned*)work : nullptr;
  float4* partials = drow ? (float4*)work + (items + 3) / 4 : nullptr;
  sweep_bwd2_kernel<T, kPer, kOrg>
      <<<dim3((unsigned)G, (unsigned)items), kThreads, smem, stream>>>(
          (const T*)g, (const T*)src, (const T*)ubar, q, rq, (T*)gbar, (T*)sbar, partials,
          done, (float*)drow, q.rn, tl);
  return (int)cudaGetLastError();
}

template <bool kPer, bool kOrg = false>
int bwd2_dtype(int dtype, const void* g, const void* src, const void* ubar,
               const AffineQ<kPer, kOrg>& q, const AffineQ<kPer, kOrg>& rq, void* gbar,
               void* sbar, void* work, void* drow, long long items, const Rows& r,
               cudaStream_t s, const Slab* sl = nullptr) {
  if (dtype == 0)
    return launch_bwd2<float, kPer, kOrg>(g, src, ubar, q, rq, gbar, sbar, work, drow, items, r,
                                          sl, s);
  if (dtype == 1)
    return launch_bwd2<__nv_bfloat16, kPer, kOrg>(g, src, ubar, q, rq, gbar, sbar, work, drow,
                                                  items, r, sl, s);
  return (int)cudaErrorInvalidValue;
}

bool img_ok(int Z, int Y, int X, int axis, int C) {
  return Z > 0 && Y > 0 && X > 0 && C > 0 && axis >= 0 && axis <= 2 &&
         (long long)Z * Y * X < INT_MAX;
}

// the rows hold one image (N = C = 1)
bool one_image(const Rows& r, const Img& im) { return r.outer * r.L * r.inner == im.vol; }

// batch items N of rows holding images [N, C, *S]: 0 when they do not
long long items_of(const Rows& r, const Img& im) {
  const long long per = im.vol * im.C, all = r.outer * r.L * r.inner;
  return all % per ? 0 : all / per;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16
// for src/out/g/dsrc; coordinates, fields, tables, diff, dq and du are
// float32. Output pointers may be null to skip that output. Each returns
// cudaGetLastError() after its launch(es).
//
// Every tensor is seen as rows [outer, L, inner] along the swept axis, with
// window K. mode 0 (dense): `qp` is q, src's shape. mode 1 (affine): `qp`
// is a table row (coef[d], offset). mode 2 (flow): `qp` is channel a of the
// field at batch item 0, `un` the field's batch stride. The affine and flow
// forms also take the image [N, C, Z, Y, X] (2-D: Z = 1) and its swept
// `axis` (0: z, 1: y, 2: x) to find each element's voxel. In the affine form
// `un` is the table's batch stride: 0 for one table [d, d+1], else that of
// a table [N, d, d+1] whose row p of item 0 `qp` points at.
extern "C" int sweep_fwd(int mode, const void* src, const void* qp, void* out, void* diff,
                         long long outer, int L, long long inner, int K, int dtype, int d,
                         int Z, int Y, int X, int axis, int C, long long un, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (mode == 0) return fwd_dtype(dtype, src, DenseQ{(const float*)qp}, out, diff, r, s);
  if (!img_ok(Z, Y, X, axis, C)) return (int)cudaErrorInvalidValue;
  const Img im = make_img(Z, Y, X, axis, C);
  if (mode == 1) {
    if (d != 2 && d != 3) return (int)cudaErrorInvalidValue;
    if (un == 0)
      return fwd_dtype(dtype, src, AffineQ<false>{(const float*)qp, d, im, 0}, out, diff, r, s);
    if (items_of(r, im) < 1) return (int)cudaErrorInvalidValue;
    return fwd_dtype(dtype, src, AffineQ<true>{(const float*)qp, d, im, un}, out, diff, r, s);
  }
  if (mode == 2) {
    if (one_image(r, im))
      return fwd_dtype(dtype, src, FlowQ<true>{(const float*)qp, un, im, 0, 0, im.vol}, out,
                       diff, r, s);
    return fwd_dtype(dtype, src, FlowQ<false>{(const float*)qp, un, im, 0, 0, im.vol}, out,
                     diff, r, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Floats of the affine backward's workspace for `items` tables (1: one
// table; else one per batch item), for sweep_bwd and sweep_bwd2 alike: a
// counter an item, then 4 partial sums a block; 0 when no tile fits. The counters must be 0 before the first
// launch; each launch leaves them 0.
extern "C" long long sweep_bwd_work(long long outer, int L, long long inner, int K,
                                    long long items) {
  const Rows r{outer, inner, L, K};
  Tile tl;
  if (!rows_ok(r) || !item_tile(r, items, r.L, tl)) return 0;
  long long n = work_floats(tl, items);
  for (int elem : {2, 4}) {  // sweep_bwd2's partials (one a block, at most one a tile)
    Tile2 t2;
    if (item_tile2(r, items, elem, t2)) {
      const long long n2 = 4 * (items * t2.tiles + (items + 3) / 4);
      n = n2 > n ? n2 : n;
    }
  }
  return n;
}

// The backward. dense (mode 0): dq of q's shape. affine (mode 1): the
// gradient of the pass's table row into `drow` (d + 1 floats; with a table
// per batch item, each item's `un` apart), through `work` (sweep_bwd_work
// floats for as many items, its counters 0). flow (mode 2): du to batch n, channel c,
// voxel s at n*dqn + c*dqc + s (dqc = 0 writes one channel of a field
// gradient: C must then be 1).
extern "C" int sweep_bwd(int mode, const void* g, const void* src, const void* qp,
                         void* dsrc, void* dq, void* work, void* drow, long long outer, int L,
                         long long inner, int K, int dtype, int d, int Z, int Y, int X,
                         int axis, int C, long long un, long long dqn, long long dqc,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (mode == 0)
    return bwd_dtype(dtype, g, src, DenseQ{(const float*)qp}, dsrc, dq, nullptr, nullptr, 0, 1,
                     r, s);
  if (!img_ok(Z, Y, X, axis, C)) return (int)cudaErrorInvalidValue;
  const Img im = make_img(Z, Y, X, axis, C);
  if (mode == 1) {
    if (d != 2 && d != 3) return (int)cudaErrorInvalidValue;
    const long long items = un ? items_of(r, im) : 1;
    if (items < 1) return (int)cudaErrorInvalidValue;
    return bwd_dtype(dtype, g, src, AffineQ<false>{(const float*)qp, d, im, un}, dsrc, nullptr,
                     work, drow, un, items, r, s);
  }
  if (mode == 2) {
    if (one_image(r, im))
      return bwd_dtype(dtype, g, src, FlowQ<true>{(const float*)qp, un, im, dqn, dqc, im.vol},
                       dsrc, dq, nullptr, nullptr, 0, 1, r, s);
    return bwd_dtype(dtype, g, src, FlowQ<false>{(const float*)qp, un, im, dqn, dqc, im.vol},
                     dsrc, dq, nullptr, nullptr, 0, 1, r, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The affine form's second order (the note at the top): given the backward's
// inputs g, src and the pass's table row `qp` (as sweep_bwd takes them) and
// the cotangents `ubar` (of dsrc, src's shape and dtype; null: zeros) and
// `rbar` (of the row gradient, a row laid out as the table's, its items `un`
// apart), writes gbar (g's shape and dtype), sbar (src's) and the row's
// gradient `drow` (as sweep_bwd writes it, through `work`: sweep_bwd_work
// floats, its counters 0, left 0). Null gbar, sbar or drow skip that output.
extern "C" int sweep_bwd2(const void* g, const void* src, const void* qp, const void* ubar,
                          const void* rbar, void* gbar, void* sbar, void* work, void* drow,
                          long long outer, int L, long long inner, int K, int dtype, int d,
                          int Z, int Y, int X, int axis, int C, long long un, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || (d != 2 && d != 3)) return (int)cudaErrorInvalidValue;
  const Img im = make_img(Z, Y, X, axis, C);
  const long long items = un ? items_of(r, im) : 1;
  if (items < 1) return (int)cudaErrorInvalidValue;
  if (un == 0)
    return bwd2_dtype<false>(dtype, g, src, ubar, AffineQ<false>{(const float*)qp, d, im, 0},
                             AffineQ<false>{(const float*)rbar, d, im, 0}, gbar, sbar, work,
                             drow, items, r, s);
  return bwd2_dtype<true>(dtype, g, src, ubar, AffineQ<true>{(const float*)qp, d, im, un},
                          AffineQ<true>{(const float*)rbar, d, im, un}, gbar, sbar, work, drow,
                          items, r, s);
}

// The slab mode of the affine form (a volume split into slabs along one
// axis, ops/cuda/sweep.py's slab passes). The output is rows [outer, L,
// inner] of a slab image [N, C, Z, Y, X] (the slab's own extents) whose
// origin in the volume is (oz, oy, ox) along the axes the pass does not
// sweep; along the swept axis it holds the volume's rows [p0, p0 + L) of Xg,
// and the source (in the backward, g and src) is a buffer of the volume's
// rows [b0, b0 + Lb). A pass across the split axis takes p0 = b0 = 0 and
// Lb = Xg = L with the slab's origin; the pass along it a buffer with a
// halo: b0 <= max(0, p0 - K - 1) and b0 + Lb >= min(Xg, p0 + L + K + 1)
// (rows past the volume are never read). Every position and coordinate is
// the volume's, so each output and dsrc entry is the unsharded launch's to
// the bit, and the row gradients of the slabs sum to its row gradient. The
// arguments are otherwise sweep_fwd's and sweep_bwd's in the affine form;
// the backward's workspace takes sweep_slab_bwd_work floats.
static bool slab_ok(int L, int K, int oz, int oy, int ox, int p0, int b0, int Lb, int Xg) {
  const long long lo = p0 - (long long)K - 1 > 0 ? p0 - (long long)K - 1 : 0;
  const long long hi = (long long)p0 + L + K + 1 < Xg ? (long long)p0 + L + K + 1 : Xg;
  return oz >= 0 && oy >= 0 && ox >= 0 && p0 >= 0 && Lb > 0 && (long long)p0 + L <= Xg &&
         b0 <= lo && (long long)b0 + Lb >= hi;
}

extern "C" int sweep_slab_fwd(const void* src, const void* qp, void* out, long long outer,
                              int L, long long inner, int K, int dtype, int d, int Z, int Y,
                              int X, int axis, int C, long long un, int oz, int oy, int ox,
                              int p0, int b0, int Lb, int Xg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || (d != 2 && d != 3) ||
      !slab_ok(L, K, oz, oy, ox, p0, b0, Lb, Xg))
    return (int)cudaErrorInvalidValue;
  Img im = make_img(Z, Y, X, axis, C);
  im.oz = oz; im.oy = oy; im.ox = ox;
  const Slab sl{p0, b0, Lb, Xg};
  if (un == 0)
    return fwd_dtype<true>(dtype, src, AffineQ<false, true>{(const float*)qp, d, im, 0}, out,
                           nullptr, r, s, sl);
  if (items_of(r, im) < 1) return (int)cudaErrorInvalidValue;
  return fwd_dtype<true>(dtype, src, AffineQ<true, true>{(const float*)qp, d, im, un}, out,
                         nullptr, r, s, sl);
}

// Floats of the slab mode's workspace, for sweep_slab_bwd and
// sweep_slab_bwd2 alike (as sweep_bwd_work), the slab's source buffer of Lb
// rows along the swept axis.
extern "C" long long sweep_slab_bwd_work(long long outer, int L, long long inner, int K,
                                         long long items, int Xg, int Lb) {
  const Rows r{outer, inner, L, K};
  Tile tl;
  if (!rows_ok(r) || L > Xg || Lb < L || !item_tile(r, items, Xg, tl)) return 0;
  long long n = work_floats(tl, items);
  const Slab sl{0, 0, Lb, Xg};  // the tile count depends on Lb and Xg alone
  for (int elem : {2, 4}) {
    Tile2 t2;
    if (item_tile2(r, items, elem, t2, &sl)) {
      const long long n2 = 4 * (items * t2.tiles + (items + 3) / 4);
      n = n2 > n ? n2 : n;
    }
  }
  return n;
}

extern "C" int sweep_slab_bwd(const void* g, const void* src, const void* qp, void* dsrc,
                              void* work, void* drow, long long outer, int L, long long inner,
                              int K, int dtype, int d, int Z, int Y, int X, int axis, int C,
                              long long un, int oz, int oy, int ox, int p0, int b0, int Lb,
                              int Xg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || (d != 2 && d != 3) ||
      !slab_ok(L, K, oz, oy, ox, p0, b0, Lb, Xg))
    return (int)cudaErrorInvalidValue;
  Img im = make_img(Z, Y, X, axis, C);
  im.oz = oz; im.oy = oy; im.ox = ox;
  const Slab sl{p0, b0, Lb, Xg};
  const long long items = un ? items_of(r, im) : 1;
  if (items < 1) return (int)cudaErrorInvalidValue;
  return bwd_dtype<true>(dtype, g, src, AffineQ<false, true>{(const float*)qp, d, im, un},
                         dsrc, nullptr, work, drow, un, items, r, s, sl);
}

// The slab mode of the affine form's second order: sweep_bwd2 on a slab,
// its g, src and ubar buffers of the volume's rows [b0, b0 + Lb) along the
// swept axis (a halo of K + 1 rows a side along the split axis), gbar and
// sbar the slab's rows [p0, p0 + L), the row's gradient the slab's share
// (its own outputs), through sweep_slab_bwd_work floats. The geometry is
// sweep_slab_bwd's; gbar and sbar equal the unsharded launch's to the bit.
extern "C" int sweep_slab_bwd2(const void* g, const void* src, const void* qp,
                               const void* ubar, const void* rbar, void* gbar, void* sbar,
                               void* work, void* drow, long long outer, int L, long long inner,
                               int K, int dtype, int d, int Z, int Y, int X, int axis, int C,
                               long long un, int oz, int oy, int ox, int p0, int b0, int Lb,
                               int Xg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || (d != 2 && d != 3) ||
      !slab_ok(L, K, oz, oy, ox, p0, b0, Lb, Xg))
    return (int)cudaErrorInvalidValue;
  Img im = make_img(Z, Y, X, axis, C);
  im.oz = oz; im.oy = oy; im.ox = ox;
  const Slab sl{p0, b0, Lb, Xg};
  const long long items = un ? items_of(r, im) : 1;
  if (items < 1) return (int)cudaErrorInvalidValue;
  if (un == 0)
    return bwd2_dtype<false, true>(
        dtype, g, src, ubar, AffineQ<false, true>{(const float*)qp, d, im, 0},
        AffineQ<false, true>{(const float*)rbar, d, im, 0}, gbar, sbar, work, drow, items, r, s,
        &sl);
  return bwd2_dtype<true, true>(
      dtype, g, src, ubar, AffineQ<true, true>{(const float*)qp, d, im, un},
      AffineQ<true, true>{(const float*)rbar, d, im, un}, gbar, sbar, work, drow, items, r, s,
      &sl);
}

// The slab mode of the flow form: one pass along the split axis of a slab
// [N, C, Z, Y, X] (its own extents) holding the volume's rows [p0, p0 + L)
// of Xg. The forward reads src as a buffer of the volume's rows [b0, b0 +
// Lb) and the field's channel `up` (batch stride un) at the slab's own
// outputs, the field being split like the image. The backward reads g, src
// and the field's channel as buffers of those rows alike (the field's halo
// gives the coordinates of the halo's outputs, whose taps reach the slab's
// rows) and writes dsrc and du at the slab's own outputs (du as sweep_bwd's
// flow form: batch n, channel c at n*dqn + c*dqc). Positions are the
// volume's, so out, dsrc and du equal the unsharded launch's to the bit.
extern "C" int sweep_slab_flow_fwd(const void* src, const void* up, void* out, long long outer,
                                   int L, long long inner, int K, int dtype, int Z, int Y,
                                   int X, int axis, int C, long long un, int p0, int b0, int Lb,
                                   int Xg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || !slab_ok(L, K, 0, 0, 0, p0, b0, Lb, Xg))
    return (int)cudaErrorInvalidValue;
  const Img im = make_img(Z, Y, X, axis, C);
  const Slab sl{p0, b0, Lb, Xg};
  if (one_image(r, im))
    return fwd_dtype<true>(dtype, src, FlowQ<true>{(const float*)up, un, im, 0, 0, im.vol}, out,
                           nullptr, r, s, sl);
  return fwd_dtype<true>(dtype, src, FlowQ<false>{(const float*)up, un, im, 0, 0, im.vol}, out,
                         nullptr, r, s, sl);
}

extern "C" int sweep_slab_flow_bwd(const void* g, const void* src, const void* up, void* dsrc,
                                   void* dq, long long outer, int L, long long inner, int K,
                                   int dtype, int Z, int Y, int X, int axis, int C,
                                   long long un, long long dqn, long long dqc, int p0, int b0,
                                   int Lb, int Xg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows r{outer, inner, L, K};
  if (!img_ok(Z, Y, X, axis, C) || !slab_ok(L, K, 0, 0, 0, p0, b0, Lb, Xg))
    return (int)cudaErrorInvalidValue;
  const Img im = make_img(Z, Y, X, axis, C);
  const Slab sl{p0, b0, Lb, Xg};
  const long long uvol = im.vol / L * Lb;  // an image of the buffers' layout
  if (one_image(r, im))
    return bwd_dtype<true>(dtype, g, src, FlowQ<true>{(const float*)up, un, im, dqn, dqc, uvol},
                           dsrc, dq, nullptr, nullptr, 0, 1, r, s, sl);
  return bwd_dtype<true>(dtype, g, src, FlowQ<false>{(const float*)up, un, im, dqn, dqc, uvol},
                         dsrc, dq, nullptr, nullptr, 0, 1, r, s, sl);
}
