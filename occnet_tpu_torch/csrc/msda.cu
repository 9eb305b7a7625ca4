// Multi-scale deformable attention sampling (forward):
//
//   out[b,q,h*D+d] = sum_{l,p} attn[b,q,h,l,p]
//                    * bilinear(value_l[b,:,h,d], loc[b,q,h,l,p])
//
// with grid_sample semantics (bilinear, zero padding, align_corners=False:
// x = loc_x * w - 0.5), fp32 corner weights times fp32 attention, fp32
// accumulation and one rounding of the output to the value dtype.  The plain
// version and the full contract are in occnet_tpu_torch/ops/msda.py.
//
// Replaces the Pallas kernels of occnet_tpu/ops/msda_pallas.py:
// `_level_kernel` (:78, f32 values), `_level_kernel_aligned` (:120, bf16
// values) and `_level_kernel_banded` (:156, levels too large for VMEM), and
// the XLA patch-table gather `_sample_level_xla` (:63) that the JAX package
// uses for level 0.  On the TPU a gather costs per row, so those kernels held
// a whole level in VMEM, fetched the 2x2 corners as two 2-row slabs (16-row
// aligned slabs for bf16) and split large levels into row bands.  Hopper
// gathers from L2 directly, so none of that carries over: one kernel serves
// every level, both value dtypes (template) and both attentions (SCA and
// TSA), in the simplest right form of mmcv's ms_deform_attn_im2col.
//
// One thread per output element (b, q, h, d), d fastest: with D = 32 a warp
// is one (q, h), its location and weight loads are broadcasts and each corner
// read is 32 consecutive channels.  The linear index has b outermost, so the
// blocks in flight share one camera's pyramid (15.8 MB in bf16 at full
// width) in the 50 MB L2.  Out-of-range samples are rejected in float before
// any float->int conversion (random offsets reach far outside the image), and
// out-of-range corners are skipped: no address outside the level is formed.
//
// Bound on the H100: L2 gather traffic.  At the SCA shape (6 x 12288 queries
// x 8 heads x 4 levels x 8 points) it reads up to 4 corner runs of 64 bytes
// (bf16) per warp and sample, ~4.8 GB from L1/L2 for 38 MB written.  Shared
// memory staging and asynchronous copies are later work.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];   // first row of the level in V
};

template <typename T>
__global__ void __launch_bounds__(256) msda_kernel(
    const T* __restrict__ value,       // (B, V, H, D)
    const float* __restrict__ loc,     // (B, Q, H, L, P, 2)
    const float* __restrict__ attn,    // (B, Q, H, L, P)
    T* __restrict__ out,               // (B, Q, H, D)
    Levels lv, int B, int V, int Q, int H, int D, int L, int P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Q * H * D) return;
  const int d = (int)(idx % D);
  const long long qh = idx / D;                 // (b * Q + q) * H + h
  const int h = (int)(qh % H);
  const int b = (int)(qh / H / Q);
  const long long row = (long long)H * D;       // stride of one value row
  const T* vb = value + (long long)b * V * row + (long long)h * D + d;
  const float* lp = loc + qh * L * P * 2;
  const float* ap = attn + qh * L * P;

  float acc = 0.0f;
  // unrolled over the level slots, so `lv` is indexed by constants and stays
  // in parameter space instead of being copied to the stack
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const T* vl = vb + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      // no fused multiply-add here, so the position rounds as in the plain
      // version and floor() sees the same value
      const float x =
          __fsub_rn(__fmul_rn(__ldg(lp + 2 * s), (float)wl), 0.5f);
      const float y =
          __fsub_rn(__fmul_rn(__ldg(lp + 2 * s + 1), (float)hl), 0.5f);
      if (!(x > -1.0f && x < (float)wl && y > -1.0f && y < (float)hl)) {
        continue;
      }
      const float a = __ldg(ap + s);
      const float xf = floorf(x);
      const float yf = floorf(y);
      const float tx = x - xf;
      const float ty = y - yf;
      const int x0 = (int)xf;                    // in [-1, wl - 1]
      const int y0 = (int)yf;                    // in [-1, hl - 1]
      const float wx[2] = {1.0f - tx, tx};
      const float wy[2] = {1.0f - ty, ty};
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= hl) continue;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= wl) continue;
          const float wt = __fmul_rn(__fmul_rn(wy[dy], wx[dx]), a);
          const float v = occ::to_float(vl[((long long)cy * wl + cx) * row]);
          acc = fmaf(wt, v, acc);
        }
      }
    }
  }
  occ::store1(out + idx, acc);
}

}  // namespace

// hw holds (h, w) of each of the L <= 4 levels, flattened row-major in V in
// that order; loc and attn are fp32; is_bf16 selects the type of value and
// out (both the same).
extern "C" int occ_msda(const void* value, const void* loc, const void* attn,
                        void* out, const int* hw, int is_bf16, int B, int V,
                        int Q, int H, int D, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < L ? hw[2 * l] : 0;
    lv.w[l] = l < L ? hw[2 * l + 1] : 0;
    lv.start[l] = start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != V) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Q * H * D;
  if (n == 0) return 0;
  const int block = 256;
  const dim3 grid((unsigned)((n + block - 1) / block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    msda_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<__nv_bfloat16*>(out), lv, B, V, Q, H, D, L, P);
  } else {
    msda_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), lv, B, V,
        Q, H, D, L, P);
  }
  return (int)cudaGetLastError();
}
