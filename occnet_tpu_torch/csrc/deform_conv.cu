// Modulated deformable convolution (DCNv2), 3x3 taps, pad 1, dilation 1,
// stride 1 or 2.  Two kernels over one sample arithmetic:
//
//   cols[b, oy*wo + ox, k*C + c] = sum_{i,j in {0,1}} wy_i * (wx_j * mask)
//       * x[b, oy*stride - 1 + ky + floor(dy) + i,
//              ox*stride - 1 + kx + floor(dx) + j, c]
//   y[b, oy, ox, n] = sum_{k, c} cols[b, oy*wo + ox, k*C + c] * W[k*C + c, n]
//
// for tap k = ky*3 + kx with offset (dy, dx) and mask of that tap and pixel,
// wy_0 = 1 - fy, wy_1 = fy with fy = dy - floor(dy) (likewise x); a corner
// outside the image adds nothing.  Weights in that order in fp32, corners
// summed from 0 in the order (0,0), (0,1), (1,0), (1,1) without fused
// multiply-adds, one rounding to x's dtype: the plain versions in
// occnet_tpu_torch/ops/deform_conv.py do the same operations in the same
// order, so the columns agree bitwise.
//
// Replaces the Pallas kernels of occnet_tpu/ops/dcn_window.py,
// `_window_kernel_dymajor` (:174, the default) and `_window_kernel` (:133,
// the same function with another loop order), called at :253, the einsum
// that contracts their samples with the weight (:342), and the XLA gather
// form of occnet_tpu/ops/deform_conv.py that the JAX package uses for the
// stride-2 and wide layers.  A TPU gathers per row, so the JAX package made
// the sampling dense: a (2R+2)^2 window of shifted rows and lane rolls per
// tap, samples outside the window zeroed and counted by a certificate.
// Hopper reads a 16-byte vector per lane from L1/L2 as cheaply as a shifted
// row, so both kernels gather the <= 4 corners of each sample directly:
// exact at any offset, every stride, no window.
//
// `occ_deform_conv` (bf16, the served path) is one implicit-GEMM kernel:
// the columns never reach device memory.  What bounds it on the H100 is the
// tensor cores' operations: an R101-DCN layer is 2 * M * K * N = 41.05
// GFLOP (stage 3: M = 6*58*100, K = 9*256, N = 256; stage 4: M = 6*29*50,
// K = 9*512, N = 512), 41.5 us at 989 TFLOP/s, against 5.4 us for its
// compulsory bytes (x, offsets, mask, weight, y).  Sampling into columns and
// multiplying them apart writes and reads back 160 MB a stage-3 layer.
// Design:
//   - a block owns a 16 x 8 tile of output pixels of one sample (so the
//     corners of its taps come from a small window of x, which L1 keeps)
//     times 256 output channels (8 warps of 64 x 64), and walks K in steps
//     of one tap x 32 input channels, the channel chunk outer and the tap
//     inner;
//   - the sample arithmetic of every (pixel, tap) of the tile runs once, at
//     the start, into shared memory (corner offsets, fp32 weights), by the
//     same device function as the sampling kernel;
//   - per step, each thread loads the <= 4 corner vectors (16 bytes, 8
//     channels) of two (pixel, channel-group) pairs for the NEXT step into
//     registers while the tensor cores (`mma.sync.m16n8k16`, bf16 in, fp32
//     accumulators) consume the current A and B tiles; it then blends them
//     in fp32 in the sampling kernel's order, rounds once to bf16 and stores
//     the A tile (row pitch 80 bytes: `ldmatrix` reads without bank
//     conflicts).  A is therefore bitwise the columns of the plain version;
//   - the weight tile (32 x 256) arrives by 16-byte `cp.async`, double
//     buffered with A, one `__syncthreads` a step;
//   - the epilogue rounds the fp32 sums once to bf16 and writes y (NHWC:
//     the channels-last NCHW tensor of the trunk).  One writer an element
//     and a fixed K order: two launches agree bitwise, and so do a batch
//     and its samples one at a time.
// Measured on the H100 it is held back not by the tensor cores but by the
// SM's shared-memory / L1 data path and issue: per K step the corner
// gathers (32 KB through L1), the operand reads of `ldmatrix` (64 KB) and
// the tile stores compete with the MMA, which `mma.sync` runs well below
// the bf16 peak; `wgmma` (operands read by the tensor cores from shared
// memory) is the next step.
// The JAX window model's certificate rides along in the same kernel: for a
// window layer the blocks of the first column tile count the samples whose
// floor(dy) or floor(dx) lies outside [-R, R] and whose support meets the
// image (the test of ops/dcn_window.window_overflow, py = (oy + ky - 1) + dy
// in fp32), and each block adds its count with one integer atomicAdd.
//
// `occ_deform_sample` writes the columns (bf16 or fp32): the fp32 path of
// the layer (the card's correctness configs), followed by torch.matmul.  One
// warp per (b, pixel, tap) sample, lanes split the channels in 16-byte
// vectors; bound by bytes (the columns it writes).
#include "common.cuh"

namespace {

// The sample arithmetic of one (pixel, tap): the element rows of x of its
// four corners (-1 where a corner adds nothing) and their fp32 weights.
// Positions are tested in float (-1 <= corner-0 row <= h - 1, likewise
// columns) before any float->int conversion, so far-away offsets never form
// an address outside the image.
__device__ __forceinline__ void sample_corners(float dy, float dx, float m,
                                               int b, int oy, int ox, int k,
                                               int stride, int h, int w,
                                               int row[4], float wc[4]) {
  const float fy = floorf(dy);
  const float fx = floorf(dx);
  const float ty = __fsub_rn(dy, fy);
  const float tx = __fsub_rn(dx, fx);
  // row / column of corner (0, 0): integer-valued, exact in fp32
  const float ry = __fadd_rn((float)(oy * stride - 1 + k / 3), fy);
  const float rx = __fadd_rn((float)(ox * stride - 1 + k % 3), fx);
  const bool inside =
      ry > -2.0f && ry < (float)h && rx > -2.0f && rx < (float)w;
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wx[2] = {__fmul_rn(__fsub_rn(1.0f, tx), m), __fmul_rn(tx, m)};
  const int y0 = inside ? (int)ry : 0;          // in [-1, h - 1]
  const int x0 = inside ? (int)rx : 0;          // in [-1, w - 1]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = y0 + (c >> 1);
    const int cx = x0 + (c & 1);
    const bool ok = inside && cy >= 0 && cy < h && cx >= 0 && cx < w;
    wc[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
    row[c] = ok ? (b * h + cy) * w + cx : -1;
  }
}

// 1 if the JAX window model at ``radius`` would zero this contributing
// sample (`window_overflow` of ops/dcn_window.py, for an h x w image).
__device__ __forceinline__ int window_over(float dy, float dx, int oy, int ox,
                                           int k, int h, int w, int radius) {
  const float py = __fadd_rn((float)(oy + k / 3 - 1), dy);
  const float px = __fadd_rn((float)(ox + k % 3 - 1), dx);
  const bool contributes =
      py > -1.0f && py < (float)h && px > -1.0f && px < (float)w;
  const float fy = floorf(dy);
  const float fx = floorf(dx);
  const float r = (float)radius;
  return (contributes && (fy < -r || fy > r || fx < -r || fx > r)) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// occ_deform_sample: the columns

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    occ::load8(p, o);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    occ::store8(p, v);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    occ::load4(p, o);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    occ::store4(p, v);
  }
};

template <typename T>
__global__ void __launch_bounds__(256) deform_sample_kernel(
    const T* __restrict__ x,             // (B, h, w, C)
    const float* __restrict__ offset,    // (B, ho, wo, 9, 2)
    const float* __restrict__ mask,      // (B, ho, wo, 9) or null
    T* __restrict__ cols,                // (B, ho * wo, 9 * C)
    int B, int h, int w, int C, int ho, int wo, int stride) {
  constexpr int kV = Vec<T>::kN;
  const long long s =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;   // sample
  const int lane = threadIdx.x & 31;
  if (s >= (long long)B * ho * wo * 9) return;
  const int k = (int)(s % 9);
  const long long pix = s / 9;                  // (b * ho + oy) * wo + ox
  const int ox = (int)(pix % wo);
  const int oy = (int)((pix / wo) % ho);
  const int b = (int)(pix / ((long long)wo * ho));

  const float dy = __ldg(offset + 2 * s);
  const float dx = __ldg(offset + 2 * s + 1);
  const float m = mask != nullptr ? __ldg(mask + s) : 1.0f;
  int row[4];
  float wc[4];
  sample_corners(dy, dx, m, b, oy, ox, k, stride, h, w, row, wc);

  T* out = cols + s * C;
  for (int v = lane * kV; v < C; v += 32 * kV) {
    float acc[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (row[c] < 0) continue;
      float xv[kV];
      Vec<T>::load(x + (long long)row[c] * C + v, xv);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        acc[e] = __fadd_rn(acc[e], __fmul_rn(wc[c], xv[e]));
      }
    }
    Vec<T>::store(out + v, acc);
  }
}

template <typename T>
int launch_sample(const void* x, const void* offset, const void* mask,
                  void* cols, int B, int h, int w, int C, int ho, int wo,
                  int stride, cudaStream_t stream) {
  if (C % Vec<T>::kN != 0) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * ho * wo * 9 * 32;
  const int block = 256;
  const dim3 grid((unsigned)((threads + block - 1) / block));
  deform_sample_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(cols), B, h, w, C, ho,
      wo, stride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// occ_deform_conv: sampling and product in one tensor-core kernel

constexpr int kTH = 16;        // output rows of a block's pixel tile
constexpr int kTW = 8;         // output columns of a block's pixel tile
constexpr int kBM = kTH * kTW; // output pixels a block (128)
constexpr int kBK = 32;        // input channels a K step (of one tap)
constexpr int kThreads = 256;  // 8 warps: 2 (pixels, 64 each) x 4 (channels)
constexpr int kAS = kBK + 8;   // A row pitch in shared memory, bf16 (80 B)

// BN output channels a block (256: the A tile is sampled once for all the
// products of a 256-wide layer): each warp owns 64 x BN / 4.
template <int BN>
struct ConvSmem {
  static constexpr int kBS = BN + 8;   // B row pitch, bf16 (272 / 528 B)
  __nv_bfloat16 a[2][kBM * kAS];       // A tiles: pixel-major, 32 channels
  __nv_bfloat16 b[2][kBK * kBS];       // B tiles: K-major, BN channels
  int4 off[9 * kBM];     // element offsets of each (tap, pixel)'s corners
  float4 wt[9 * kBM];    // their weights (0 where a corner adds nothing)
  int count;             // the block's certificate count
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K step st = chunk * 9 + tap (chunk outer, tap inner).
__device__ __forceinline__ void step_of(int st, int& chunk, int& tap) {
  chunk = st / 9;
  tap = st - chunk * 9;
}

// The corner vectors (8 channels each) of this thread's two A entries at
// step st: pixels pa and pa + 64, channels g8 .. g8 + 7 of the chunk;
// zeros for corners that add nothing.
template <int BN>
__device__ __forceinline__ void gather_a(uint4 (&raw)[2][4],
                                         const ConvSmem<BN>& s,
                                         const __nv_bfloat16* __restrict__ x,
                                         int st, int pa, int g8) {
  int chunk, tap;
  step_of(st, chunk, tap);
  const __nv_bfloat16* xc = x + chunk * kBK + g8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 o = s.off[tap * kBM + pa + 64 * j];
    const int oo[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      raw[j][c] = oo[c] >= 0
                      ? __ldg(reinterpret_cast<const uint4*>(xc + oo[c]))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Blend the gathered corners as the sampling kernel does (weights and
// order), round once to bf16 and store them into A tile ``buf``.  A corner
// that adds nothing has weight 0 and zero values: it adds +0, which leaves
// the sum unchanged bitwise (a sum started at +0 is never -0), so no branch
// is needed.
template <int BN>
__device__ __forceinline__ void store_a(const uint4 (&raw)[2][4],
                                        ConvSmem<BN>& s, int buf, int st,
                                        int pa, int g8) {
  int chunk, tap;
  step_of(st, chunk, tap);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = pa + 64 * j;
    const float4 wt = s.wt[tap * kBM + p];
    const float ww[4] = {wt.x, wt.y, wt.z, wt.w};
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const __nv_bfloat162* hv =
          reinterpret_cast<const __nv_bfloat162*>(&raw[j][c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hv[i]);
        acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(ww[c], f.x));
        acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(ww[c], f.y));
      }
    }
    occ::store8(&s.a[buf][p * kAS + g8], acc);
  }
}

// The weight tile of step st (32 rows of W from tap * C + chunk * 32, BN
// columns from n0) into B tile ``buf`` by 16-byte cp.async.
template <int BN>
__device__ __forceinline__ void load_b(ConvSmem<BN>& s, int buf,
                                       const __nv_bfloat16* __restrict__ wmat,
                                       int C, int N, int n0, int st,
                                       int tid) {
  constexpr int kPieces = kBK * BN / 8 / kThreads;   // 2 or 4 a thread
  int chunk, tap;
  step_of(st, chunk, tap);
  const long long k0 = (long long)tap * C + chunk * kBK;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int e = tid + kThreads * j;
    const int r = e / (BN / 8);
    const int col = (e % (BN / 8)) * 8;
    occ::cp_async16(&s.b[buf][r * ConvSmem<BN>::kBS + col],
                    wmat + (k0 + r) * N + n0 + col);
  }
  occ::cp_async_commit();
}

// One K step of the warp's 64 x BN/4 product from A / B tile ``buf``.
template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[4][BN / 32][4],
                                         const ConvSmem<BN>& s, int buf,
                                         int wm, int wn, int lane) {
  constexpr int kNT = BN / 32;                 // n8 tiles of the warp
  const __nv_bfloat16* A = s.a[buf];
  const __nv_bfloat16* Bt = s.b[buf];
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned bf[kNT][2];
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      unsigned r[4];
      ldmatrix_x4_trans(r, Bt + (kk + (lane & 15)) * ConvSmem<BN>::kBS +
                               wn + np * 16 + (lane >> 4) * 8);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      unsigned af[4];
      ldmatrix_x4(af, A + (wm + mt * 16 + (lane & 15)) * kAS + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
    }
  }
}

// Output pixel (row of y) of tile pixel p, or -1 past the image's edge.
__device__ __forceinline__ int tile_pixel(int p, int b, int oy0, int ox0,
                                          int ho, int wo) {
  const int oy = oy0 + p / kTW;
  const int ox = ox0 + p % kTW;
  return (oy < ho && ox < wo) ? (b * ho + oy) * wo + ox : -1;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    deform_conv_kernel(
        const __nv_bfloat16* __restrict__ x,     // (B, h, w, C)
        const float* __restrict__ offset,        // (B, ho, wo, 9, 2)
        const float* __restrict__ mask,          // (B, ho, wo, 9) or null
        const __nv_bfloat16* __restrict__ wmat,  // (9 * C, N), tap-major
        __nv_bfloat16* __restrict__ y,           // (B, ho, wo, N)
        int* __restrict__ count,                 // certificate or null
        int h, int w, int C, int ho, int wo, int N, int stride, int radius) {
  constexpr int kNT = BN / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ConvSmem<BN>& s = *reinterpret_cast<ConvSmem<BN>*>(smem_raw);
  const int tid = threadIdx.x;
  // the block's pixel tile: kTH x kTW output pixels of one sample
  const int tiles_x = (wo + kTW - 1) / kTW;
  const int tiles = tiles_x * ((ho + kTH - 1) / kTH);
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const int oy0 = (t / tiles_x) * kTH;
  const int ox0 = (t % tiles_x) * kTW;
  const int n0 = blockIdx.y * BN;
  const bool certify = count != nullptr && blockIdx.y == 0;

  // 1. the sample arithmetic of every (pixel, tap) of the tile, once
  if (tid == 0) s.count = 0;
  __syncthreads();
  int over = 0;
  for (int i = tid; i < kBM * 9; i += kThreads) {
    const int p = i / 9;
    const int k = i - p * 9;
    const int pix = tile_pixel(p, b, oy0, ox0, ho, wo);
    int row[4] = {-1, -1, -1, -1};
    float wc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (pix >= 0) {
      const int oy = oy0 + p / kTW;
      const int ox = ox0 + p % kTW;
      const long long si = (long long)pix * 9 + k;
      const float dy = __ldg(offset + 2 * si);
      const float dx = __ldg(offset + 2 * si + 1);
      const float m = mask != nullptr ? __ldg(mask + si) : 1.0f;
      sample_corners(dy, dx, m, b, oy, ox, k, stride, h, w, row, wc);
      if (certify) over += window_over(dy, dx, oy, ox, k, ho, wo, radius);
    }
    int o[4];
    float ws[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c] = row[c] >= 0 ? row[c] * C : -1;
      ws[c] = row[c] >= 0 ? wc[c] : 0.0f;
    }
    s.off[k * kBM + p] = make_int4(o[0], o[1], o[2], o[3]);
    s.wt[k * kBM + p] = make_float4(ws[0], ws[1], ws[2], ws[3]);
  }
  if (certify) {
    over = __reduce_add_sync(0xffffffffu, over);
    if ((tid & 31) == 0 && over != 0) atomicAdd(&s.count, over);
  }
  __syncthreads();
  if (certify && tid == 0 && s.count != 0) atomicAdd(count, s.count);

  // 2. the K loop: gather step st + 1 while the tensor cores run step st
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * (BN / 4);
  const int pa = tid >> 2;
  const int g8 = (tid & 3) * 8;
  const int steps = 9 * (C / kBK);
  float acc[4][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  uint4 raw[2][4];
  load_b(s, 0, wmat, C, N, n0, 0, tid);
  gather_a(raw, s, x, 0, pa, g8);
  store_a(raw, s, 0, 0, pa, g8);
  occ::cp_async_wait_all();
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < steps;
    if (more) {
      load_b(s, cur ^ 1, wmat, C, N, n0, st + 1, tid);
      gather_a(raw, s, x, st + 1, pa, g8);
    }
    mma_step<BN>(acc, s, cur, wm, wn, lane);
    if (more) store_a(raw, s, cur ^ 1, st + 1, pa, g8);
    occ::cp_async_wait_all();
    __syncthreads();
  }

  // 3. epilogue: one bf16 rounding, one writer an element
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = tile_pixel(wm + mt * 16 + (lane >> 2) + 8 * half, b,
                                 oy0, ox0, ho, wo);
      if (pix < 0) continue;
      __nv_bfloat16* yr = y + (long long)pix * N + n0 + wn + (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(yr + nt * 8) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                  acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

template <int BN>
int launch_conv(const void* x, const void* offset, const void* mask,
                const void* wmat, void* y, void* count, int blocks, int h,
                int w, int C, int ho, int wo, int N, int stride, int radius,
                cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      deform_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ConvSmem<BN>));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)blocks, (unsigned)(N / BN));
  deform_conv_kernel<BN><<<grid, kThreads, sizeof(ConvSmem<BN>), stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(wmat),
      static_cast<__nv_bfloat16*>(y), static_cast<int*>(count), h, w, C, ho,
      wo, N, stride, radius);
  return (int)cudaGetLastError();
}

bool valid_geometry(int B, int h, int w, int ho, int wo, int stride) {
  return (stride == 1 || stride == 2) &&
         ho == (h + stride - 1) / stride && wo == (w + stride - 1) / stride &&
         (long long)B * h * w < (1LL << 31) &&
         (long long)B * ho * wo * 9 < (1LL << 31);
}

}  // namespace

// x NHWC (bf16 if is_bf16, else fp32), offset (B, ho, wo, 9, 2) fp32, mask
// (B, ho, wo, 9) fp32 or null (all ones), cols (B, ho * wo, 9 * C) of x's
// type; ho = ceil(h / stride), wo likewise.  All contiguous, 16-byte aligned.
extern "C" int occ_deform_sample(const void* x, const void* offset,
                                 const void* mask, void* cols, int is_bf16,
                                 int B, int h, int w, int C, int ho, int wo,
                                 int stride, void* stream) {
  if (!valid_geometry(B, h, w, ho, wo, stride)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ho * wo == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sample<__nv_bfloat16>(x, offset, mask, cols, B, h,
                                                w, C, ho, wo, stride, s)
                 : launch_sample<float>(x, offset, mask, cols, B, h, w, C,
                                        ho, wo, stride, s);
}

// x NHWC bf16 (B, h, w, C), offset (B, ho, wo, 9, 2) fp32, mask (B, ho, wo,
// 9) fp32 or null, wmat (9 * C, N) bf16 (row k * C + c: tap k, channel c),
// y (B, ho, wo, N) bf16; C a multiple of 32, N of 256; all contiguous and
// 16-byte aligned.  With radius >= 0 the window certificate of the layer is
// ADDED to *count (int32, zeroed by the caller); radius < 0 counts nothing.
extern "C" int occ_deform_conv(const void* x, const void* offset,
                               const void* mask, const void* wmat, void* y,
                               void* count, int B, int h, int w, int C,
                               int ho, int wo, int N, int stride, int radius,
                               void* stream) {
  if (!valid_geometry(B, h, w, ho, wo, stride) || C % kBK != 0 ||
      N % 256 != 0 || (radius >= 0) != (count != nullptr) ||
      (long long)B * h * w * C >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ho * wo == 0 || N == 0) return 0;
  if (C == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * ((ho + kTH - 1) / kTH) *
                           ((wo + kTW - 1) / kTW);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch_conv<256>(x, offset, mask, wmat, y, count, (int)blocks, h, w,
                          C, ho, wo, N, stride, radius,
                          static_cast<cudaStream_t>(stream));
}
