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
// Design (simple first, as the forward sampling kernel): one warp per
// (b, pixel, tap) sample, lanes across the channels, 4 channels a lane (one
// 8- or 16-byte load of x and of dcols a corner).  Each lane adds its share
// of the three sums for doffset / dmask and scatters its 4 channels of
// dx into a zeroed fp32 buffer with one 16-byte atomicAdd (float4, sm_90)
// a corner (the first build, four scalar atomics, took 41.7 ms for a train
// step's 26 launches in chip_smoke.py's phase 20 against 11.6 ms, NVIDIA
// H100 80GB HBM3 at 700 W); the warp reduces the sums with shuffles and
// lane 0 writes doffset and dmask.  With dx null the scatter is skipped (x
// needs no gradient: a frozen input).
//
// Bound on the H100: bytes and atomics.  The compulsory bytes are dcols
// and x read, offsets and mask read, dx / doffset / dmask written (stage 3,
// B = 6: dcols 160 MB bf16); every sample adds 4 corners x C fp32 values
// into dx, which L2 takes as 16-byte atomics (~36 adds an element of dx:
// 9 taps x 4 corners).
//
// Determinism: dx's fp32 atomics land in an order that changes from launch
// to launch, so dx is not bitwise reproducible; doffset and dmask are (one
// writer, a fixed reduction order).  chip_smoke.py holds the kernel to
// 1e-4 x max|plain| in f32 and 2e-2 x max|plain| in bf16.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) deform_sample_bwd_kernel(
    const T* __restrict__ x,             // (B, h, w, C)
    const float* __restrict__ offset,    // (B, ho, wo, 9, 2)
    const float* __restrict__ mask,      // (B, ho, wo, 9) or null
    const T* __restrict__ dcols,         // (B, ho * wo, 9 * C)
    float* __restrict__ dx,              // (B, h, w, C) fp32 zeroed, or null
    float* __restrict__ doffset,         // (B, ho, wo, 9, 2)
    float* __restrict__ dmask,           // (B, ho, wo, 9), null without mask
    int B, int h, int w, int C, int ho, int wo, int stride) {
  const long long s =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;   // sample
  const int lane = threadIdx.x & 31;
  if (s >= (long long)B * ho * wo * 9) return;   // whole warps leave
  const int k = (int)(s % 9);
  const long long pix = s / 9;                  // (b * ho + oy) * wo + ox
  const int ox = (int)(pix % wo);
  const int oy = (int)((pix / wo) % ho);
  const int b = (int)(pix / ((long long)wo * ho));

  const float dy = __ldg(offset + 2 * s);
  const float dxo = __ldg(offset + 2 * s + 1);
  const float m = mask != nullptr ? __ldg(mask + s) : 1.0f;
  // the sample arithmetic of `sample_corners` (deform_conv.cu)
  const float fy = floorf(dy);
  const float fx = floorf(dxo);
  const float ty = __fsub_rn(dy, fy);
  const float tx = __fsub_rn(dxo, fx);
  const float ry = __fadd_rn((float)(oy * stride - 1 + k / 3), fy);
  const float rx = __fadd_rn((float)(ox * stride - 1 + k % 3), fx);
  const bool inside =
      ry > -2.0f && ry < (float)h && rx > -2.0f && rx < (float)w;
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wxu[2] = {__fsub_rn(1.0f, tx), tx};       // unmasked
  const float wxm[2] = {__fmul_rn(wxu[0], m), __fmul_rn(wxu[1], m)};
  const int y0 = inside ? (int)ry : 0;                   // in [-1, h - 1]
  const int x0 = inside ? (int)rx : 0;                   // in [-1, w - 1]
  long long row[4];
  float wc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = y0 + (c >> 1);
    const int cx = x0 + (c & 1);
    const bool ok = inside && cy >= 0 && cy < h && cx >= 0 && cx < w;
    row[c] = ok ? ((long long)(b * h + cy) * w + cx) * C : -1;
    wc[c] = __fmul_rn(wy[c >> 1], wxm[c & 1]);           // the forward's
  }

  float sm = 0.0f, sy = 0.0f, sx = 0.0f;
  if (inside) {
    const T* gs = dcols + s * C;
    for (int v = lane * 4; v < C; v += 128) {
      float g[4];
      occ::load4(gs + v, g);
      float xv[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row[c] >= 0) {
          occ::load4(x + row[c] + v, xv[c]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[c][e] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float un = wy[0] * (wxu[0] * xv[0][e] + wxu[1] * xv[1][e]) +
                         wy[1] * (wxu[0] * xv[2][e] + wxu[1] * xv[3][e]);
        const float gy = wxu[0] * (xv[2][e] - xv[0][e]) +
                         wxu[1] * (xv[3][e] - xv[1][e]);
        const float gx = wy[0] * (xv[1][e] - xv[0][e]) +
                         wy[1] * (xv[3][e] - xv[2][e]);
        sm += g[e] * un;
        sy += g[e] * gy;
        sx += g[e] * gx;
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
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sm += __shfl_xor_sync(0xffffffffu, sm, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
  }
  if (lane == 0) {
    reinterpret_cast<float2*>(doffset)[s] = make_float2(m * sy, m * sx);
    if (dmask != nullptr) dmask[s] = sm;
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* dcols, void* dx, void* doffset, void* dmask, int B,
           int h, int w, int C, int ho, int wo, int stride,
           cudaStream_t stream) {
  const long long threads = (long long)B * ho * wo * 9 * 32;
  const int block = 256;
  const long long blocks = (threads + block - 1) / block;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  deform_sample_bwd_kernel<T><<<(unsigned)blocks, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(dcols),
      static_cast<float*>(dx), static_cast<float*>(doffset),
      static_cast<float*>(dmask), B, h, w, C, ho, wo, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x NHWC (bf16 if is_bf16, else fp32), offset (B, ho, wo, 9, 2) fp32, mask
// (B, ho, wo, 9) fp32 or null, dcols (B, ho * wo, 9 * C) of x's type; dx
// (B, h, w, C) fp32 zeroed by the caller, or null to skip it; doffset
// shaped as offset, dmask as mask (null exactly when mask is).  ho =
// ceil(h / stride), wo likewise; C a multiple of 4; all contiguous, x and
// dcols 8-byte aligned, dx 16-byte aligned.
extern "C" int occ_deform_sample_bwd(const void* x, const void* offset,
                                     const void* mask, const void* dcols,
                                     void* dx, void* doffset, void* dmask,
                                     int is_bf16, int B, int h, int w, int C,
                                     int ho, int wo, int stride,
                                     void* stream) {
  if ((stride != 1 && stride != 2) || ho != (h + stride - 1) / stride ||
      wo != (w + stride - 1) / stride || C % 4 != 0 ||
      (mask == nullptr) != (dmask == nullptr) ||
      (long long)B * h * w >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ho * wo == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, offset, mask, dcols, dx, doffset,
                                         dmask, B, h, w, C, ho, wo, stride, s)
                 : launch<float>(x, offset, mask, dcols, dx, doffset, dmask,
                                 B, h, w, C, ho, wo, stride, s);
}
