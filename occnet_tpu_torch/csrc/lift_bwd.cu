// Planar-homography lift backward, one FPN level: the exact transpose of
// lift.cu.  For every output cell (b, zr, m) and every camera that sees it,
//
//   dfeat[b,a,pixel(k,j),:] += hat(pos2 - k) * hat(pos1[k] - j)
//                              * inv_count[b,r,m] * g[b,zr,m,:]
//
// over the same <= 2 x 2 taps, with the same skip rules (dead position
// p <= -1, tap outside [0, n)) and the same __fmul_rn(w2, w1) weight as the
// forward sampler.
//
// Replaces the two Pallas kernels of the TPU lift backward
// (occnet_tpu/ops/lift_pallas.py): `_pass2_bwd_kernel` (:493, dtmp =
// W2^T (g * inv_count)) and `_pass1_bwd_kernel` (:270, dfeat = W1^T dtmp
// accumulated over zr blocks).  The TPU needed the (ZR, A, w+h, C) dtmp
// buffer and the sequential zr grid axis to accumulate dfeat in VMEM; here
// one warp per output cell (lane = 8 channels) reads g * inv_count once into
// registers and scatters wt * g straight into an fp32 dfeat with vector
// atomics, so no dtmp buffer exists and blocks need no order.
//
// Bound on the H100: the g read (B x 8 x 40000 x 256 bf16 = 164 MB per level
// at full width, 4 levels share it) and the atomics into dfeat, which is
// small (<= 142 MB fp32 at level 0) and L2-resident per camera slab.  Many
// cells fold onto one feature pixel at the coarse levels (level 3 is 15 x 25
// pixels per camera), so the atomics contend there.  A gather form (one
// thread per feature pixel) or shared-memory privatisation is a later PR.
// Atomics make the summation order change from run to run.
//
// dfeat must be zeroed by the caller: pixels no cell reaches stay 0.
#include "common.cuh"

namespace {

template <typename GT>
__global__ void __launch_bounds__(256) lift_level_bwd_kernel(
    const GT* __restrict__ g,                // (B, ZR, M, C), batch stride
    const float* __restrict__ pos1,          // (B, A, ZR, w + h) pass-1 pos
    const float* __restrict__ pos2,          // (B, A, ZR, M) pass-2 pos
    const uint8_t* __restrict__ steep,       // (B, A, ZR) 1 = order B
    const float* __restrict__ inv_count,     // (B, R * M)
    float* __restrict__ dfeat,               // (B, A, h, w, C) fp32, zeroed
    int B, int A, int h, int w, int C, int ZR, int R, int M,
    long long g_bstride) {
  const long long cell = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (cell >= (long long)B * ZR * M) return;
  const int m = (int)(cell % M);
  const long long bz = cell / M;
  const int zr = (int)(bz % ZR);
  const int b = (int)(bz / ZR);
  const int c0 = threadIdx.x * 8;
  const int K1 = w + h;

  const float ic = __ldg(inv_count + (long long)b * R * M
                         + (long long)(zr % R) * M + m);
  float gv[8];
  occ::load8(g + (long long)b * g_bstride + ((long long)zr * M + m) * C + c0,
             gv);
#pragma unroll
  for (int i = 0; i < 8; ++i) gv[i] *= ic;

  for (int a = 0; a < A; ++a) {
    const long long plane = ((long long)b * A + a) * ZR + zr;
    const float p2 = __ldg(pos2 + plane * M + m);
    if (p2 <= -1.0f) continue;               // dead cell for this camera
    const bool st = __ldg(steep + plane) != 0;
    const int n2 = st ? h : w;               // extent along the line
    const int n1 = st ? w : h;               // extent across the line
    const float* p1row = pos1 + plane * K1 + (st ? w : 0);
    float* fb = dfeat + ((long long)b * A + a) * h * w * C + c0;
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
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(wt, gv[i]);
        occ::atomic_add8(fb + ((long long)y * w + x) * C, v);
      }
    }
  }
}

}  // namespace

// C = channels (multiple of 8, <= 2048); g_is_bf16 selects the gradient type
// (bf16 or fp32); dfeat is fp32 and must be zeroed.
extern "C" int occ_lift_level_bwd(const void* g, const void* pos1,
                                  const void* pos2, const void* steep,
                                  const void* inv_count, void* dfeat,
                                  int g_is_bf16, int B, int A, int h, int w,
                                  int C, int ZR, int R, int M,
                                  long long g_bstride, void* stream) {
  const int lanes = C / 8;
  const int cells = lanes >= 256 ? 1 : 256 / lanes;
  const dim3 block(lanes, cells);
  const long long ncell = (long long)B * ZR * M;
  const dim3 grid((unsigned)((ncell + cells - 1) / cells));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p1 = static_cast<const float*>(pos1);
  const float* p2 = static_cast<const float*>(pos2);
  const uint8_t* st = static_cast<const uint8_t*>(steep);
  const float* ic = static_cast<const float*>(inv_count);
  float* df = static_cast<float*>(dfeat);
  if (g_is_bf16) {
    lift_level_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), p1, p2, st, ic, df, B, A, h, w,
        C, ZR, R, M, g_bstride);
  } else {
    lift_level_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(g), p1, p2, st, ic, df, B, A, h, w, C, ZR,
        R, M, g_bstride);
  }
  return (int)cudaGetLastError();
}
