// DCNv2 sampling, backward: the transpose of `occ_deform_sample`
// (csrc/deform_conv.cu), 3x3 taps, pad 1, dilation 1, stride 1 or 2.  The
// forward writes, for tap k = ky*3 + kx of output pixel (oy, ox) with offset
// (dy, dx) and mask m,
//
//   cols[b, oy*wo + ox, k*C + c] = sum_{i,j in {0,1}} wy_i * (wx_j * m) * x_ij
//
// with x_ij = x[b, oy*stride - 1 + ky + floor(dy) + i,
//                 ox*stride - 1 + kx + floor(dx) + j, c] (0 outside the
// image), wy_0 = 1 - ty, wy_1 = ty, ty = dy - floor(dy) (likewise x).  For
// the columns' gradient g = dcols of that sample:
//
//   dx[corner ij]  += wy_i * (wx_j * m) * g          (each valid corner)
//   doffset_y = m * sum_c g * [(1 - tx)(x10 - x00) + tx (x11 - x01)]
//   doffset_x = m * sum_c g * [(1 - ty)(x01 - x00) + ty (x11 - x10)]
//   dmask     =     sum_c g * sum_ij wy_i * wx_j * x_ij   (unmasked sample)
//
// The integer part and the fraction come from the offset alone, as in the
// forward; a corner outside the image adds nothing and takes no gradient.
// The plain version, `deform_sample_backward_plain` in
// occnet_tpu_torch/ops/deform_conv.py, writes the same sums out in PyTorch.
//
// Replaces the sampling half of the DCN backward of the JAX package: the
// VJP of the exact gather form `_sampled_gather` that
// occnet_tpu/ops/dcn_window.py `_svw_bwd` (:310) delegates to (window
// layers), and XLA's autodiff of occnet_tpu/ops/deform_conv.py
// `modulated_deform_conv` (:34; stride-2 and gather layers).  The einsum's
// VJP around it (dweight = cols^T dy, dcols = dy W^T) is two plain matrix
// products left to torch.matmul, as the JAX package leaves them to XLA.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the byte
// bound is 1.53 ms a train step's 26 launches at B = 6 in bf16 (dcols and
// x read, offsets and mask read, dx / doffset / dmask written; stage 3:
// dcols 160 MB bf16).  The first port (a warp a sample, one 16-byte fp32
// atomicAdd a corner into dx: ~36 adds an element of dx, x's corners read
// ~36 times) took 11.6 ms.  Adding dx in shared memory first does not pay
// on this card: an fp32 atomicAdd there compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN in the SASS), and development builds that did so
// (tiles of output pixels, by shared atomics or warp-owned regions), or
// sorted the samples by first corner before the scatter, were slower than
// the first port in chip_smoke.py's phase 20.
//
// Design: gather dx instead of scattering it where that pays, and take
// doffset / dmask from 4 dot products a sample.  Every gradient of a
// sample is linear in d_ij = sum_c g_c x_ij,c, the dot of its columns'
// gradient with the input at corner ij: dmask = sum wy_i wx_j d_ij,
// doffset_y = m [(1 - tx)(d10 - d00) + tx (d11 - d01)], doffset_x = m
// [(1 - ty)(d01 - d00) + ty (d11 - d10)].  So:
// - `deform_sample_bwd_gather`: a block owns an 8 x 8 tile of input pixels
//   of one image.  It reads the offsets of every sample that can reach the
//   tile with |floor(offset)| <= kR = 4 (the served window is R = 3) and
//   lists, by a counting sort in shared memory (native int atomics), the
//   near samples whose first corner falls on the tile or the row and
//   column before it.  A warp a pixel then walks the 4 lists of samples
//   whose corners reach the pixel, kBatch samples' columns-gradient loads
//   at a time: dx += weight x g in registers, one plain store of the
//   pixel's dx at the end (no atomics, no zeroed buffer), and each
//   sample's dot with the pixel's x, reduced by shuffles and written as
//   that sample's d_ij (one writer: the pixel of corner ij).
// - `deform_sample_bwd_far_list` / `deform_sample_bwd_scatter`: the
//   samples inside the image but farther out (a share of phase 12's
//   N(0, 2^2) px draw, none of the calibrated train steps') take the
//   first port's scatter, a warp a sample: d_ij by shuffles, dx by one
//   16-byte fp32 atomicAdd a corner, after the gather's stores.
// - `deform_sample_bwd_offset`: a thread a sample turns its d_ij (0 for a
//   corner off the image) into doffset and dmask.
// The gather reads each sample's columns' gradient 4 times (once a corner)
// where the scatter reads it once, holds a pixel's channels in registers,
// and needs many tiles to fill the card: at stage 4 (C = 512, 29 x 50 and
// 58 x 100 inputs at B = 6) and at layer3_1's shape below B = 4 it was
// slower than the first port.  So `gather_route` takes it only for C <=
// 256 and at least 150 output pixels an SM; otherwise dx is zeroed and
// `deform_sample_bwd_scatter` takes every sample, as the first port did.
// `occnet_tpu_torch.ops.deform_conv.backward_far_share` mirrors the route
// and the near test, to report which share of the samples scattered.
// With dx null the gather stores nothing and the far samples add nothing
// (x needs no gradient: a frozen input).
//
// Measured by chip_smoke.py phases 20 and 24 in turns with the first
// port, two runs each in one call (NVIDIA H100 80GB HBM3, 700.00 W):
// 10.7779 / 10.8997 against 12.0138 / 11.6971 ms a train step's 26
// launches at phase 12's offsets, 10.0773 / 10.0175 against 12.0059 /
// 12.0625 at calibrated offsets, a real r101_dcn_occ step's layer3_1
// 0.4057 / 0.4176 against 0.4809 / 0.4901; stage 4, on the scatter
// route, within 1.3 % of the first port's mean, inside the runs' spread.
//
// Determinism: a cell's samples come out of the shared-memory sort, and
// the far samples' atomics land, in an order that changes from launch to
// launch, so dx is not bitwise reproducible; doffset and dmask are (each
// d_ij has one writer and a fixed reduction order).  chip_smoke.py holds
// the kernel to 1e-4 x max|plain| in f32 and 2e-2 x max|plain| in bf16.
#include "common.cuh"

namespace {

constexpr int kTile = 8;          // input pixels a side of a gather block
constexpr int kR = 4;             // near: |floor(offset)| <= kR both ways
constexpr int kCells = (kTile + 1) * (kTile + 1);   // first corners
constexpr int kGatherThreads = 512;
constexpr int kBatch = 4;         // samples of a cell whose loads go together
constexpr int kGatherMaxC = 256;  // channels a gather warp holds a pixel
// candidate samples of a tile at stride 1 (fewer at stride 2): outputs
// oy * stride in [ty0 - 2 - kR, ty0 + kTile + kR], likewise ox, 9 taps
constexpr int kMaxCand = (kTile + 2 * kR + 3) * (kTile + 2 * kR + 3) * 9;

// The sample arithmetic of `sample_corners` (deform_conv.cu): fractions,
// mask, the first corner (y0, x0), whether the 2x2 support meets the image
// (tested in float, before any conversion to int) and whether the sample
// is near (|floor| <= kR both ways).
struct Sample {
  float ty, tx, m;
  int y0, x0;
  bool inside, near;
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ offset,
                                            const float* __restrict__ mask,
                                            long long s, int oy, int ox,
                                            int k, int h, int w,
                                            int stride) {
  Sample q;
  const float2 d = __ldg(reinterpret_cast<const float2*>(offset) + s);
  q.m = mask != nullptr ? __ldg(mask + s) : 1.0f;
  const float fy = floorf(d.x);
  const float fx = floorf(d.y);
  q.ty = __fsub_rn(d.x, fy);
  q.tx = __fsub_rn(d.y, fx);
  const float ry = __fadd_rn((float)(oy * stride - 1 + k / 3), fy);
  const float rx = __fadd_rn((float)(ox * stride - 1 + k % 3), fx);
  q.inside = ry > -2.0f && ry < (float)h && rx > -2.0f && rx < (float)w;
  q.near = fy >= (float)-kR && fy <= (float)kR && fx >= (float)-kR &&
           fx <= (float)kR;
  q.y0 = q.inside ? (int)ry : 0;                 // in [-1, h - 1]
  q.x0 = q.inside ? (int)rx : 0;                 // in [-1, w - 1]
  return q;
}

// the forward's weight of corner (i, j)
__device__ __forceinline__ float corner_weight(float ty, float tx, float m,
                                               int i, int j) {
  const float wy = i ? ty : __fsub_rn(1.0f, ty);
  const float wx = j ? tx : __fsub_rn(1.0f, tx);
  return __fmul_rn(wy, __fmul_rn(wx, m));
}

// doffset and dmask of sample s from its corner dots d (0 for a corner
// off the image), 0 for a sample off the image
__device__ __forceinline__ void offset_grads(const Sample& q,
                                             const float d[4], long long s,
                                             float* __restrict__ doffset,
                                             float* __restrict__ dmask) {
  const float wy[2] = {__fsub_rn(1.0f, q.ty), q.ty};
  const float wxu[2] = {__fsub_rn(1.0f, q.tx), q.tx};
  const float sm = wy[0] * (wxu[0] * d[0] + wxu[1] * d[1]) +
                   wy[1] * (wxu[0] * d[2] + wxu[1] * d[3]);
  const float sy = wxu[0] * (d[2] - d[0]) + wxu[1] * (d[3] - d[1]);
  const float sx = wy[0] * (d[1] - d[0]) + wy[1] * (d[3] - d[2]);
  reinterpret_cast<float2*>(doffset)[s] = q.inside
      ? make_float2(q.m * sy, q.m * sx) : make_float2(0.0f, 0.0f);
  if (dmask != nullptr) dmask[s] = q.inside ? sm : 0.0f;
}

struct Cand {
  int s;                         // sample index
  float ty, tx, m;
};

// Gather: a block owns a kTile x kTile tile of input pixels of image b.
// It lists the near samples whose first corner falls on the tile or the
// row and column before it (a counting sort in shared memory, by cell),
// then a warp a pixel walks the 4 cells whose samples reach the pixel: for
// each, dx += weight x g (registers; one plain store of the pixel's dx at
// the end: no atomics, every pixel written once) and the dot product of g
// with x at the pixel, written as that sample's corner dot (one writer).
template <typename T>
__global__ void __launch_bounds__(kGatherThreads) deform_sample_bwd_gather(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const T* __restrict__ dcols,
    float* __restrict__ dx, float* __restrict__ dots, int h, int w, int C,
    int ho, int wo, int stride) {
  extern __shared__ int4 smem_i4[];
  Cand* cand = reinterpret_cast<Cand*>(smem_i4);            // [kMaxCand]
  short* list = reinterpret_cast<short*>(cand + kMaxCand);   // [kMaxCand]
  short* cell_of = list + kMaxCand;                          // [kMaxCand]
  __shared__ int cnt[kCells], start[kCells + 1];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  // candidate outputs: oy * stride in [ty0 - 2 - kR, ty0 + kTile + kR]
  // (the lower end rounded up; 64 * stride keeps the numerator positive)
  const int oy_lo = max(0, (ty0 - 2 - kR + stride - 1 + 64 * stride) / stride
                           - 64);
  const int oy_hi = min(ho - 1, (ty0 + kTile + kR) / stride);
  const int ox_lo = max(0, (tx0 - 2 - kR + stride - 1 + 64 * stride) / stride
                           - 64);
  const int ox_hi = min(wo - 1, (tx0 + kTile + kR) / stride);
  const int ncol = ox_hi - ox_lo + 1;
  const int n = (oy_hi - oy_lo + 1) * ncol * 9;
  for (int i = threadIdx.x; i < kCells; i += kGatherThreads) cnt[i] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kGatherThreads) {
    const int k = c % 9;
    const int p = c / 9;
    const int oy = oy_lo + p / ncol, ox = ox_lo + p % ncol;
    const long long s = ((long long)(b * ho + oy) * wo + ox) * 9 + k;
    const Sample q = sample_at(offset, mask, s, oy, ox, k, h, w, stride);
    const int cy = q.y0 - (ty0 - 1), cx = q.x0 - (tx0 - 1);
    short cell = -1;
    if (q.inside && q.near && cy >= 0 && cy <= kTile && cx >= 0 &&
        cx <= kTile) {
      cell = (short)(cy * (kTile + 1) + cx);
      cand[c] = Cand{(int)s, q.ty, q.tx, q.m};
      atomicAdd(&cnt[cell], 1);
    }
    cell_of[c] = cell;
  }
  __syncthreads();
  if (threadIdx.x < 32) {          // exclusive scan of the kCells counts
    int run = 0;
    for (int base = 0; base < kCells; base += 32) {
      const int i = base + threadIdx.x;
      const int v = i < kCells ? cnt[i] : 0;
      int inc = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, off);
        if ((int)threadIdx.x >= off) inc += t;
      }
      if (i < kCells) start[i] = run + inc - v;
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (threadIdx.x == 0) start[kCells] = run;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCells; i += kGatherThreads) cnt[i] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kGatherThreads) {
    const int cell = cell_of[c];
    if (cell >= 0) list[start[cell] + atomicAdd(&cnt[cell], 1)] = (short)c;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kMaxIt = kGatherMaxC / 128;   // 128 channels an iteration
  for (int p = warp; p < kTile * kTile; p += kGatherThreads / 32) {
    const int y = ty0 + p / kTile, xx = tx0 + p % kTile;
    if (y >= h || xx >= w) continue;             // (warp-uniform)
    const long long pix = ((long long)b * h + y) * w + xx;
    float xv[kMaxIt][4], acc[kMaxIt][4];
#pragma unroll
    for (int it = 0; it < kMaxIt; ++it) {
      const int ch = it * 128 + lane * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[it][e] = 0.0f;
      if (ch < C) {
        occ::load4(x + pix * C + ch, xv[it]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[it][e] = 0.0f;
      }
    }
    const int py = p / kTile, px = p % kTile;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int i = corner >> 1, j = corner & 1;
      const int cell = (py - i + 1) * (kTile + 1) + (px - j + 1);
      const int e1 = start[cell + 1];
      // kBatch samples at a time, their columns' gradient loads together
      for (int e = start[cell]; e < e1; e += kBatch) {
        const int nb = min(kBatch, e1 - e);          // (warp-uniform)
        Cand cd[kBatch];
        float wc[kBatch], dot[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          cd[u] = u < nb ? cand[list[e + u]] : Cand{0, 0.0f, 0.0f, 0.0f};
          wc[u] = corner_weight(cd[u].ty, cd[u].tx, cd[u].m, i, j);
          dot[u] = 0.0f;
        }
#pragma unroll
        for (int it = 0; it < kMaxIt; ++it) {
          const int ch = it * 128 + lane * 4;
          if (it * 128 >= C) break;                  // (warp-uniform)
          float g[kBatch][4];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < nb && ch < C) {
              occ::load4(dcols + (long long)cd[u].s * C + ch, g[u]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) g[u][q] = 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[it][q] += wc[u] * g[u][q];
              dot[u] += g[u][q] * xv[it][q];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
          }
          if (lane == 0 && u < nb) {
            dots[(long long)cd[u].s * 4 + corner] = dot[u];
          }
        }
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int it = 0; it < kMaxIt; ++it) {
        const int ch = it * 128 + lane * 4;
        if (ch < C) {
          *reinterpret_cast<float4*>(dx + pix * C + ch) =
              make_float4(acc[it][0], acc[it][1], acc[it][2], acc[it][3]);
        }
      }
    }
  }
}

// the samples inside the image but not near: listed for
// deform_sample_bwd_scatter
__global__ void __launch_bounds__(256) deform_sample_bwd_far_list(
    const float* __restrict__ offset, const float* __restrict__ mask,
    int* __restrict__ far, int* __restrict__ n_far, int B, int h, int w,
    int ho, int wo, int stride) {
  const long long s = (long long)blockIdx.x * 256 + threadIdx.x;
  if (s >= (long long)B * ho * wo * 9) return;
  const int k = (int)(s % 9);
  const long long pix = s / 9;
  const int ox = (int)(pix % wo);
  const int oy = (int)((pix / wo) % ho);
  const Sample q = sample_at(offset, mask, s, oy, ox, k, h, w, stride);
  if (q.inside && !q.near) far[atomicAdd(n_far, 1)] = (int)s;
}

// The first port's scatter, a warp a sample: the 4 corners' rows of x
// loaded together, their dots d_ij with the sample's columns' gradient
// (shuffle sums) and, with dx, the sample's contribution to each corner
// added with one 16-byte fp32 atomicAdd.  With ``far`` it takes the listed
// samples (all inside the image) and leaves d_ij in ``dots`` for
// deform_sample_bwd_offset; with far null it takes all n samples and
// writes doffset and dmask itself (0 for a sample off the image).
template <typename T>
__global__ void __launch_bounds__(256) deform_sample_bwd_scatter(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const T* __restrict__ dcols,
    const int* __restrict__ far, const int* __restrict__ n_far, long long n,
    float* __restrict__ dx, float* __restrict__ dots,
    float* __restrict__ doffset, float* __restrict__ dmask, int h, int w,
    int C, int ho, int wo, int stride) {
  const int lane = threadIdx.x & 31;
  const long long nw = (long long)gridDim.x * 8;
  const long long count = far != nullptr ? (long long)*n_far : n;
  for (long long e = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
       e < count; e += nw) {
    const long long s = far != nullptr ? (long long)__ldg(far + e) : e;
    const int k = (int)(s % 9);
    const long long pix = s / 9;
    const int ox = (int)(pix % wo);
    const int oy = (int)((pix / wo) % ho);
    const int b = (int)(pix / ((long long)wo * ho));
    const Sample q = sample_at(offset, mask, s, oy, ox, k, h, w, stride);
    long long row[4];
    float wc[4], d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cy = q.y0 + (c >> 1);
      const int cx = q.x0 + (c & 1);
      row[c] = q.inside && cy >= 0 && cy < h && cx >= 0 && cx < w
                   ? ((long long)(b * h + cy) * w + cx) * C : -1;
      wc[c] = corner_weight(q.ty, q.tx, q.m, c >> 1, c & 1);
    }
    const T* gs = dcols + s * C;
    for (int v = lane * 4; v < C && q.inside; v += 128) {
      float g[4], xv[4][4];
      occ::load4(gs + v, g);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row[c] >= 0) {
          occ::load4(x + row[c] + v, xv[c]);
        } else {
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) xv[c][q2] = 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2) d[c] += g[q2] * xv[c][q2];
      }
      if (dx != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (row[c] < 0) continue;
          atomicAdd(reinterpret_cast<float4*>(dx + row[c] + v),
                    make_float4(wc[c] * g[0], wc[c] * g[1], wc[c] * g[2],
                                wc[c] * g[3]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        d[c] += __shfl_xor_sync(0xffffffffu, d[c], off);
      }
    }
    if (lane != 0) continue;
    if (far != nullptr) {
      *reinterpret_cast<float4*>(dots + s * 4) =
          make_float4(d[0], d[1], d[2], d[3]);
    } else {
      offset_grads(q, d, s, doffset, dmask);
    }
  }
}

// doffset and dmask of every sample from its 4 corner dots d_ij (0 for a
// corner off the image): dmask = sum wy_i wx_j d_ij, doffset_y = m [(1 -
// tx)(d10 - d00) + tx (d11 - d01)], doffset_x = m [(1 - ty)(d01 - d00) +
// ty (d11 - d10)]; 0 for a sample off the image
__global__ void __launch_bounds__(256) deform_sample_bwd_offset(
    const float* __restrict__ offset, const float* __restrict__ mask,
    const float* __restrict__ dots, float* __restrict__ doffset,
    float* __restrict__ dmask, int B, int h, int w, int ho, int wo,
    int stride) {
  const long long s = (long long)blockIdx.x * 256 + threadIdx.x;
  if (s >= (long long)B * ho * wo * 9) return;
  const int k = (int)(s % 9);
  const long long pix = s / 9;
  const int ox = (int)(pix % wo);
  const int oy = (int)((pix / wo) % ho);
  const Sample q = sample_at(offset, mask, s, oy, ox, k, h, w, stride);
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q.inside) {
    const float4 t = *reinterpret_cast<const float4*>(dots + s * 4);
    const float r[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cy = q.y0 + (c >> 1);
      const int cx = q.x0 + (c & 1);
      if (cy >= 0 && cy < h && cx >= 0 && cx < w) d[c] = r[c];
    }
  }
  offset_grads(q, d, s, doffset, dmask);
}

// ints of workspace: the corner dots (4 floats a sample), the far list and
// its count
long long workspace_ints(int B, int ho, int wo) {
  const long long n = (long long)B * ho * wo * 9;
  return 4 * n + n + 1;
}

// the gather where a warp holds a pixel's channels (C <= kGatherMaxC)
// and the output fills the card (kGatherMinPixels an SM; between B = 3
// and B = 4 of layer3_1's 58 x 100, where the routes cross); else the
// first port's scatter of every sample
constexpr long long kGatherMinPixels = 150;
bool gather_route(int B, int ho, int wo, int C, int sms) {
  return C <= kGatherMaxC &&
         (long long)B * ho * wo >= kGatherMinPixels * sms;
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* dcols, void* dx, void* doffset, void* dmask, int* ws,
           int B, int h, int w, int C, int ho, int wo, int stride,
           cudaStream_t stream) {
  const long long n = (long long)B * ho * wo * 9;
  float* dots = reinterpret_cast<float*>(ws);
  int* far = ws + 4 * n;
  int* n_far = far + n;
  const T* xt = static_cast<const T*>(x);
  const float* off = static_cast<const float*>(offset);
  const float* mk = static_cast<const float*>(mask);
  const T* dc = static_cast<const T*>(dcols);
  float* dxf = static_cast<float*>(dx);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (!gather_route(B, ho, wo, C, sms)) {        // every sample scattered
    if (dxf != nullptr) {
      err = cudaMemsetAsync(dxf, 0, sizeof(float) * B * h * w * C, stream);
      if (err != cudaSuccess) return (int)err;
    }
    deform_sample_bwd_scatter<T><<<(unsigned)((n + 7) / 8), 256, 0,
                                   stream>>>(
        xt, off, mk, dc, nullptr, nullptr, n, dxf, nullptr,
        static_cast<float*>(doffset), static_cast<float*>(dmask), h, w, C,
        ho, wo, stride);
    return (int)cudaGetLastError();
  }
  err = cudaMemsetAsync(n_far, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kMaxCand * (sizeof(Cand) + 2 * sizeof(short));
  err = cudaFuncSetAttribute(deform_sample_bwd_gather<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((w + kTile - 1) / kTile),
                  (unsigned)((h + kTile - 1) / kTile), (unsigned)B);
  deform_sample_bwd_gather<T><<<grid, kGatherThreads, smem, stream>>>(
      xt, off, mk, dc, dxf, dots, h, w, C, ho, wo, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_sample_bwd_far_list<<<blocks, 256, 0, stream>>>(
      off, mk, far, n_far, B, h, w, ho, wo, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the far list, a grid-stride loop of 8 blocks an SM
  deform_sample_bwd_scatter<T><<<(unsigned)sms * 8, 256, 0, stream>>>(
      xt, off, mk, dc, far, n_far, n, dxf, dots, nullptr, nullptr, h, w, C,
      ho, wo, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_sample_bwd_offset<<<blocks, 256, 0, stream>>>(
      off, mk, dots, static_cast<float*>(doffset),
      static_cast<float*>(dmask), B, h, w, ho, wo, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x NHWC (bf16 if is_bf16, else fp32), offset (B, ho, wo, 9, 2) fp32, mask
// (B, ho, wo, 9) fp32 or null, dcols (B, ho * wo, 9 * C) of x's type; dx
// (B, h, w, C) fp32, any content (every pixel is written), or null to skip
// it; doffset shaped as offset, dmask as mask (null exactly when mask is);
// a workspace of 4 * (5 n + 1) bytes, n = B * ho * wo * 9 (16-byte
// aligned; the gather route's corner dots and far list).
// ho = ceil(h / stride), wo likewise; C a multiple of 4; all contiguous,
// x and dcols 8-byte aligned, dx 16-byte aligned.  On the gather route
// four launches (gather, far list, far samples, offset gradients) after a
// memset of the far count, else a memset of dx and one (the first port's
// scatter of every sample); returns the first error.
extern "C" int occ_deform_sample_bwd(const void* x, const void* offset,
                                     const void* mask, const void* dcols,
                                     void* dx, void* doffset, void* dmask,
                                     void* workspace,
                                     long long workspace_bytes, int is_bf16,
                                     int B, int h, int w, int C, int ho,
                                     int wo, int stride, void* stream) {
  if ((stride != 1 && stride != 2) || ho != (h + stride - 1) / stride ||
      wo != (w + stride - 1) / stride || C % 4 != 0 ||
      (mask == nullptr) != (dmask == nullptr) ||
      (long long)B * h * w >= (1LL << 31) ||
      (long long)B * ho * wo * 9 >= (1LL << 31) || B >= 65536 ||
      workspace_bytes < 4 * workspace_ints(B, ho, wo)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ho * wo == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  return is_bf16 ? launch<__nv_bfloat16>(x, offset, mask, dcols, dx, doffset,
                                         dmask, ws, B, h, w, C, ho, wo,
                                         stride, s)
                 : launch<float>(x, offset, mask, dcols, dx, doffset, dmask,
                                 ws, B, h, w, C, ho, wo, stride, s);
}
