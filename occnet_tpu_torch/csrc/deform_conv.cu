// Modulated deformable convolution (DCNv2) sampling, 3x3 taps, pad 1,
// dilation 1, stride 1 or 2 (forward):
//
//   cols[b, oy*wo + ox, k*C + c] = sum_{i,j in {0,1}} wy_i * (wx_j * mask)
//       * x[b, oy*stride - 1 + ky + floor(dy) + i,
//              ox*stride - 1 + kx + floor(dx) + j, c]
//
// for tap k = ky*3 + kx with offset (dy, dx) and mask of that tap and pixel,
// wy_0 = 1 - fy, wy_1 = fy with fy = dy - floor(dy) (likewise x); a corner
// outside the image adds nothing.  Weights in that order in fp32, corners
// summed from 0 in the order (0,0), (0,1), (1,0), (1,1) without fused
// multiply-adds, one rounding to x's dtype: the plain version in
// occnet_tpu_torch/ops/deform_conv.py does the same operations in the same
// order, so the two agree bitwise.  The DCN layer then contracts the columns
// with its weight in one matrix product (torch.matmul, outside this kernel).
//
// Replaces the Pallas kernels of occnet_tpu/ops/dcn_window.py,
// `_window_kernel_dymajor` (:174, the default) and `_window_kernel` (:133,
// the same function with another loop order), and the XLA gather form of
// occnet_tpu/ops/deform_conv.py that the JAX package uses for the stride-2
// and wide layers and for gather mode.  A TPU gathers per row, so the JAX
// package made DCN sampling dense: image columns on lanes, a (2R+2)^2 window
// of statically shifted rows and lane rolls per tap, and samples outside the
// window zeroed and counted by a certificate.  Hopper reads a 16-byte vector
// per lane from L2 as cheaply as a shifted row, so this kernel gathers the
// <= 4 corners of each sample directly: exact at any offset, every stride,
// no window, no radius.  (The certificate of the JAX window model is
// computed beside it from the offsets, ops/dcn_window.py.)
//
// One warp per (b, pixel, tap) sample, the sample index in the columns'
// row order, so the warp writes one contiguous run of C values.  Lanes split
// the channels in 16-byte vectors (8 bf16 or 4 fp32 values a lane): at
// C = 256 bf16 a warp covers the row in one pass, at C = 512 in two.  Offset
// and mask are broadcast loads; each corner is one coalesced read of a
// C-value row of the NHWC input.  Positions are tested in float
// (-1 <= corner-0 row <= h - 1, likewise columns) before any float->int
// conversion, so far-away offsets never form an address outside the image.
//
// Bound on the H100: bytes.  At the R101-DCN stage-3 shape (B = 6,
// 58 x 100 x 256, stride 1, bf16) the kernel must read x (17.8 MB) and the
// offsets and mask (3.8 MB) and write the columns (160.4 MB): 54 us at
// 3.35 TB/s.  The corner reads (4 x 9 per pixel) come from L2: each input
// row is read by up to 36 samples.
#include "common.cuh"

namespace {

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
  const float fy = floorf(dy);
  const float fx = floorf(dx);
  const float ty = __fsub_rn(dy, fy);
  const float tx = __fsub_rn(dx, fx);
  // row / column of corner (0, 0): integer-valued, exact in fp32
  const float ry = __fadd_rn((float)(oy * stride - 1 + k / 3), fy);
  const float rx = __fadd_rn((float)(ox * stride - 1 + k % 3), fx);
  const bool inside =
      ry > -2.0f && ry < (float)h && rx > -2.0f && rx < (float)w;

  float wc[4];
  const T* pc[4];
  bool ok[4];
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wx[2] = {__fmul_rn(__fsub_rn(1.0f, tx), m), __fmul_rn(tx, m)};
  const int y0 = inside ? (int)ry : 0;          // in [-1, h - 1]
  const int x0 = inside ? (int)rx : 0;          // in [-1, w - 1]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = y0 + (c >> 1);
    const int cx = x0 + (c & 1);
    ok[c] = inside && cy >= 0 && cy < h && cx >= 0 && cx < w;
    wc[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
    pc[c] = ok[c] ? x + (((long long)b * h + cy) * w + cx) * C : x;
  }

  T* out = cols + s * C;
  for (int v = lane * kV; v < C; v += 32 * kV) {
    float acc[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!ok[c]) continue;
      float xv[kV];
      Vec<T>::load(pc[c] + v, xv);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        acc[e] = __fadd_rn(acc[e], __fmul_rn(wc[c], xv[e]));
      }
    }
    Vec<T>::store(out + v, acc);
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, void* cols,
           int B, int h, int w, int C, int ho, int wo, int stride,
           cudaStream_t stream) {
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

}  // namespace

// x NHWC (bf16 if is_bf16, else fp32), offset (B, ho, wo, 9, 2) fp32, mask
// (B, ho, wo, 9) fp32 or null (all ones), cols (B, ho * wo, 9 * C) of x's
// type; ho = ceil(h / stride), wo likewise.  All contiguous, 16-byte aligned.
extern "C" int occ_deform_sample(const void* x, const void* offset,
                                 const void* mask, void* cols, int is_bf16,
                                 int B, int h, int w, int C, int ho, int wo,
                                 int stride, void* stream) {
  if ((stride != 1 && stride != 2) || ho != (h + stride - 1) / stride ||
      wo != (w + stride - 1) / stride) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ho * wo == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, offset, mask, cols, B, h, w, C,
                                         ho, wo, stride, s)
                 : launch<float>(x, offset, mask, cols, B, h, w, C, ho, wo,
                                 stride, s);
}
