// Pass-2 of the planar lift from a tmp slab (the uncompacted form):
//
//   out[zr,m,:] = inv_count[zr % bev_h, m] *
//       ( sum_a sum_k hatA(pos2A[zr,a,m] - k) * tmpA[zr,a,k,:]
//       + sum_a sum_k hatB(pos2B[zr,a,m] - k) * tmpB[zr,a,k,:] )
//
// with hat(d) = bf16(max(0, 1 - |d|)), fp32 accumulation and one rounding to
// the output type.  Replaces `_pass2_kernel` via `_pass2`
// (occnet_tpu/ops/lift_pallas.py:385-427, pallas_call at :408).
//
// Design.  The TPU built the concatenated hat matrix (A*(w+h), M) per zr and
// contracted it with the whole tmp slab on the MXU.  A hat row has at most
// two nonzero taps (floor(p) and floor(p) + 1), so here a warp per output
// cell (zr, m) reads only those taps: lane = 8 channels (16-byte loads),
// pos2 read once per camera and axis (broadcast within the warp), fp32
// accumulation in registers.  Taps of zero weight are never read, so a NaN
// in a tmp row no weight reaches stays out of the output (the dense MXU form
// would give 0 * NaN = NaN there).  The weights are bf16, so each product
// w * t of two bf16 values is exact in fp32 and the fused multiply-add
// equals the plain version's separate multiply and add: with the plain
// version's summation order (cameras of order A, then of order B; tap
// floor(p) before floor(p) + 1) the two are bitwise equal.
//
// Bound on the H100: the bytes of the tmp rows some nonzero weight reaches,
// pos2 and the output.  At the bench shapes (pos2B all dead) that is tmpA
// (0.98 GB) + 16 MB of pos2 + 164 MB of bf16 output, ~0.35 ms at 3.35 TB/s.
// All 200 cells of one zr read the same 614 KB tmpA slab, consecutive in
// the grid, so each row comes from device memory once and from L2 after.
#include "common.cuh"

namespace {

// bf16(max(0, 1 - |p - k|)) in fp32, the rounding of `_hat_t`.
__device__ __forceinline__ float hat_bf16(float p, int k) {
  const float d = __fsub_rn(p, (float)k);
  const float w = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
  return __bfloat162float(__float2bfloat16_rn(w));
}

// acc += sum over the <= 2 nonzero taps of one (camera, axis).
__device__ __forceinline__ void add_taps(float p, int K,
                                         const __nv_bfloat16* rows, int C,
                                         float* acc) {
  const int k0 = (int)floorf(p);
#pragma unroll
  for (int dk = 0; dk < 2; ++dk) {
    const int k = k0 + dk;
    if (k < 0 || k >= K) continue;
    const float w = hat_bf16(p, k);
    if (w == 0.0f) continue;
    float v[8];
    occ::load8(rows + (long long)k * C, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, v[i], acc[i]);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(256) lift_pass2_kernel(
    const float* __restrict__ pos2A,      // (ZR_pad, A, M)
    const float* __restrict__ pos2B,      // (ZR_pad, A, M)
    const float* __restrict__ inv_count,  // (bev_h, M)
    const __nv_bfloat16* __restrict__ tmpA,  // (ZR_pad, A, w_pad, C)
    const __nv_bfloat16* __restrict__ tmpB,  // (ZR_pad, A, h_pad, C)
    OutT* __restrict__ out,               // (ZR, M, C)
    int ZR, int A, int M, int w_pad, int h_pad, int C, int bev_h) {
  const long long cell = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (cell >= (long long)ZR * M) return;
  const int m = (int)(cell % M);
  const int zr = (int)(cell / M);
  const int c0 = threadIdx.x * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int a = 0; a < A; ++a) {
    const long long pa = ((long long)zr * A + a);
    add_taps(__ldg(pos2A + pa * M + m), w_pad,
             tmpA + pa * w_pad * C + c0, C, acc);
  }
  for (int a = 0; a < A; ++a) {
    const long long pa = ((long long)zr * A + a);
    add_taps(__ldg(pos2B + pa * M + m), h_pad,
             tmpB + pa * h_pad * C + c0, C, acc);
  }
  const float ic = __ldg(inv_count + (long long)(zr % bev_h) * M + m);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = __fmul_rn(acc[i], ic);
  occ::store8(out + cell * C + c0, acc);
}

}  // namespace

// C = channels (multiple of 8, <= 2048); out_is_bf16 selects the output type.
extern "C" int occ_lift_pass2(const void* pos2A, const void* pos2B,
                              const void* inv_count, const void* tmpA,
                              const void* tmpB, void* out, int out_is_bf16,
                              int ZR, int A, int M, int w_pad, int h_pad,
                              int C, int bev_h, void* stream) {
  const int lanes = C / 8;
  const int cells = lanes >= 256 ? 1 : 256 / lanes;
  const dim3 block(lanes, cells);
  const long long ncell = (long long)ZR * M;
  const dim3 grid((unsigned)((ncell + cells - 1) / cells));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(pos2A);
  const float* pb = static_cast<const float*>(pos2B);
  const float* ic = static_cast<const float*>(inv_count);
  const __nv_bfloat16* ta = static_cast<const __nv_bfloat16*>(tmpA);
  const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(tmpB);
  if (out_is_bf16) {
    lift_pass2_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        pa, pb, ic, ta, tb, static_cast<__nv_bfloat16*>(out), ZR, A, M,
        w_pad, h_pad, C, bev_h);
  } else {
    lift_pass2_kernel<float><<<grid, block, 0, s>>>(
        pa, pb, ic, ta, tb, static_cast<float*>(out), ZR, A, M, w_pad,
        h_pad, C, bev_h);
  }
  return (int)cudaGetLastError();
}
