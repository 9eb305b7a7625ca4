// Planar-homography lift, one FPN level: camera-summed, count-normalised
// separable resample of camera features onto the (z, BEV row, BEV column)
// grid.
//
// Replaces the three Pallas kernels of the TPU lift forward
// (occnet_tpu/ops/lift_pallas.py): `_pass1_kernel` (:101), `_pass1w_kernel`
// (:176) and `_pass2_compact`'s inner kernel (:443).  Same math as
// `occnet_tpu.ops.planar_lift.lift_and_average`:
//
//   out[b,zr,m,:] = inv_count[b,r,m] * sum_cam valid *
//       sum_k hat(pos2 - k) * sum_j hat(pos1[k] - j) * feat[pixel(k, j), :]
//
// where k runs along the BEV row's image line (image x for order A, image y
// for order B, picked per (cam, z, row) by line steepness) and j across it,
// at tap k's own line height.  All positions are computed in fp32 by the
// caller (occnet_tpu_torch/ops/planar_lift.py): -2 marks a dead position
// (band-limited out, wrong pass order, or camera-invisible cell).
//
// Design.  The TPU built 2-banded hat MATRICES and contracted them on the MXU
// because a TPU cannot gather; that forced a ~1 GB tmp buffer (pass-1 output)
// per level-0 frame.  A hat row has at most two nonzero taps, and Hopper
// gathers cheaply, so this is a direct sampler: one warp per output cell
// (lane = 8 channels, 16-byte loads), up to 2 x 2 feature reads per visible
// camera, fp32 accumulation in registers, one store.  No tmp buffer exists.
// Every output element is written (cells no camera sees get zeros), so no
// caller ever reads uninitialised memory through a zero weight (0 * NaN).
//
// Bound on the H100: the output write, B x 4 levels x 8 x 40000 x 256 bf16 =
// 655 MB per frame, ~0.2 ms at 3.35 TB/s.  Feature reads are gathers of
// 512-byte channel runs; a level's features (<= 71 MB at level 0, 6 cams)
// mostly stay in the 50 MB L2 because neighbouring cells read neighbouring
// pixels.  A later PR can raise occupancy/ILP (several cells per warp) and
// skip the per-camera geometry reads for invisible cameras.
#include "common.cuh"

namespace {

template <typename OutT>
__global__ void __launch_bounds__(256) lift_level_kernel(
    const __nv_bfloat16* __restrict__ feat,  // (B, A, h, w, C)
    const float* __restrict__ pos1,          // (B, A, ZR, w + h) pass-1 pos
    const float* __restrict__ pos2,          // (B, A, ZR, M) pass-2 pos
    const uint8_t* __restrict__ steep,       // (B, A, ZR) 1 = order B
    const float* __restrict__ inv_count,     // (B, R * M)
    OutT* __restrict__ out,                  // (B, ZR, M, C), batch stride
    int B, int A, int h, int w, int C, int ZR, int R, int M,
    long long out_bstride) {
  const long long cell = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (cell >= (long long)B * ZR * M) return;
  const int m = (int)(cell % M);
  const long long bz = cell / M;
  const int zr = (int)(bz % ZR);
  const int b = (int)(bz / ZR);
  const int c0 = threadIdx.x * 8;
  const int K1 = w + h;

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;

  for (int a = 0; a < A; ++a) {
    const long long plane = ((long long)b * A + a) * ZR + zr;
    const float p2 = __ldg(pos2 + plane * M + m);
    if (p2 <= -1.0f) continue;               // dead cell for this camera
    const bool st = __ldg(steep + plane) != 0;
    const int n2 = st ? h : w;               // extent along the line
    const int n1 = st ? w : h;               // extent across the line
    const float* p1row = pos1 + plane * K1 + (st ? w : 0);
    const __nv_bfloat16* fb = feat + ((long long)b * A + a) * h * w * C + c0;
    const float k0f = floorf(p2);
    const int k0 = (int)k0f;
    const float f2 = p2 - k0f;
#pragma unroll
    for (int dk = 0; dk < 2; ++dk) {
      const int k = k0 + dk;
      if (k < 0 || k >= n2) continue;        // grid_sample zero padding
      const float w2 = dk ? f2 : 1.0f - f2;
      const float p1 = __ldg(p1row + k);
      if (p1 <= -1.0f) continue;
      const float j0f = floorf(p1);
      const int j0 = (int)j0f;
      const float f1 = p1 - j0f;
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const int j = j0 + dj;
        if (j < 0 || j >= n1) continue;
        const float wt = __fmul_rn(w2, dj ? f1 : 1.0f - f1);
        const int y = st ? k : j;
        const int x = st ? j : k;
        float v[8];
        occ::load8(fb + ((long long)y * w + x) * C, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(wt, v[i], acc[i]);
      }
    }
  }
  const float ic = __ldg(inv_count + (long long)b * R * M
                         + (long long)(zr % R) * M + m);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] *= ic;
  occ::store8(out + (long long)b * out_bstride + ((long long)zr * M + m) * C
              + c0, acc);
}

}  // namespace

// C = channels (multiple of 8, <= 2048); out_is_bf16 selects the output type.
extern "C" int occ_lift_level(const void* feat, const void* pos1,
                              const void* pos2, const void* steep,
                              const void* inv_count, void* out,
                              int out_is_bf16, int B, int A, int h, int w,
                              int C, int ZR, int R, int M,
                              long long out_bstride, void* stream) {
  const int lanes = C / 8;
  const int cells = lanes >= 256 ? 1 : 256 / lanes;
  const dim3 block(lanes, cells);
  const long long ncell = (long long)B * ZR * M;
  const dim3 grid((unsigned)((ncell + cells - 1) / cells));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  const float* p1 = static_cast<const float*>(pos1);
  const float* p2 = static_cast<const float*>(pos2);
  const uint8_t* st = static_cast<const uint8_t*>(steep);
  const float* ic = static_cast<const float*>(inv_count);
  if (out_is_bf16) {
    lift_level_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        f, p1, p2, st, ic, static_cast<__nv_bfloat16*>(out), B, A, h, w, C,
        ZR, R, M, out_bstride);
  } else {
    lift_level_kernel<float><<<grid, block, 0, s>>>(
        f, p1, p2, st, ic, static_cast<float*>(out), B, A, h, w, C, ZR, R, M,
        out_bstride);
  }
  return (int)cudaGetLastError();
}
