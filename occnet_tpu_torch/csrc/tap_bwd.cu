// Dense TSA 3x3 tap attention, backward (the forward is tap.cu):
//
//   dv[b,n,y,x,c]       = (1/nq) * sum_t attn[b,y+dy,x+dx,n,t,h(c)]
//                                        * g[b,y+dy,x+dx,c]
//   dattn[b,y,x,n,t,h]  = (1/nq) * sum_d v[b,n,y-dy,x-dx,hD+d] * g[b,y,x,hD+d]
//
// with taps t = (dy+1)*3 + (dx+1) and zero padding: a tap whose cell falls
// outside the grid contributes nothing (dv) or is exactly 0 (dattn).
//
// Replaces `_tap_attention_bwd` (occnet_tpu/ops/tsa_pallas.py:155), which is
// not a Pallas kernel but the plain-XLA closed form: nine shift + einsum
// passes over the 41 MB value grid per step and layer.  Here:
//   - dv is a pure gather, no atomics: one thread owns 4 channels of one value
//     cell and reads, for each of the 9 taps, the attention weight and the 4
//     gradient channels of the output cell that read it;
//   - dattn is a per-head dot over D channels: one thread holds 4 channels of
//     g for its output cell, dots them with the 4 shifted value channels, and
//     the D/4 threads of a head sum their partials with warp shuffles (heads
//     are aligned to D/4-lane groups inside a warp), one store per (n, t, h).
//
// Bound on the H100: memory.  At the main-path shape (1, 2, 200, 200, 256)
// bf16 the two kernels read v (41 MB), attn (11.5 MB) and g (41 MB fp32) and
// write dv (41 MB) and dattn (11.5 MB); the 9x re-reads hit L1/L2 because
// neighbouring threads touch neighbouring cells.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) tap_bwd_dv_kernel(
    const T* __restrict__ attn,   // (B, H, W, nq, 9, heads)
    const float* __restrict__ g,  // (B, H, W, C)
    T* __restrict__ dv,           // (B, nq, H, W, C)
    int B, int nq, int H, int W, int C, int heads) {
  const int chunks = C / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * nq * H * W * chunks) return;
  const int c0 = (int)(idx % chunks) * 4;
  long long p = idx / chunks;
  const int x = (int)(p % W);
  p /= W;
  const int y = (int)(p % H);
  p /= H;
  const int n = (int)(p % nq);
  const int b = (int)(p / nq);
  const int hd = c0 / (C / heads);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int yy = y + (t / 3 - 1);          // the output cell that read
    const int xx = x + (t % 3 - 1);          // v[n, y, x] through tap t
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const long long cell = ((long long)b * H + yy) * W + xx;
    const float wt = occ::to_float(
        attn[cell * (nq * 9 * heads) + (n * 9 + t) * heads + hd]);
    float gv[4];
    occ::load4(g + cell * C + c0, gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(wt, gv[i], acc[i]);
  }
  const float s = 1.0f / (float)nq;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] *= s;
  occ::store4(dv + ((((long long)b * nq + n) * H + y) * W + x) * C + c0, acc);
}

// Every thread of the grid reaches the shuffles (no early return): a head's
// D/4 threads are consecutive and aligned, so a group is all in range or all
// out of range, and out-of-range threads only contribute zeros.
template <typename T>
__global__ void __launch_bounds__(256) tap_bwd_dattn_kernel(
    const T* __restrict__ v,      // (B, nq, H, W, C)
    const float* __restrict__ g,  // (B, H, W, C)
    T* __restrict__ dattn,        // (B, H, W, nq, 9, heads)
    int B, int nq, int H, int W, int C, int heads) {
  const int chunks = C / 4;
  const int group = C / heads / 4;           // threads per head, power of 2
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < (long long)B * H * W * chunks;
  const long long i0 = live ? idx : 0;
  const int c0 = (int)(i0 % chunks) * 4;
  long long p = i0 / chunks;
  const int x = (int)(p % W);
  p /= W;
  const int y = (int)(p % H);
  const int b = (int)(p / H);
  const int hd = c0 / (C / heads);
  const long long cell = ((long long)b * H + y) * W + x;

  float gv[4];
  occ::load4(g + cell * C + c0, gv);
  const float s = 1.0f / (float)nq;
  T* out = dattn + cell * (nq * 9 * heads) + hd;
  for (int n = 0; n < nq; ++n) {
    const T* vn = v + ((long long)b * nq + n) * H * W * C + c0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y - (t / 3 - 1);
      const int xx = x - (t % 3 - 1);
      float part = 0.0f;
      if (live && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        float val[4];
        occ::load4(vn + ((long long)yy * W + xx) * C, val);
#pragma unroll
        for (int i = 0; i < 4; ++i) part = fmaf(val[i], gv[i], part);
      }
      for (int off = group / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (live && (c0 / 4) % group == 0)
        occ::store1(out + (n * 9 + t) * heads, part * s);
    }
  }
}

template <typename T>
int launch(const void* v, const void* attn, const void* g, void* dv,
           void* dattn, int B, int nq, int H, int W, int C, int heads,
           cudaStream_t s) {
  const int block = 256;
  const long long nv = (long long)B * nq * H * W * (C / 4);
  tap_bwd_dv_kernel<T><<<(unsigned)((nv + block - 1) / block), block, 0, s>>>(
      static_cast<const T*>(attn), static_cast<const float*>(g),
      static_cast<T*>(dv), B, nq, H, W, C, heads);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long na = (long long)B * H * W * (C / 4);
  tap_bwd_dattn_kernel<T><<<(unsigned)((na + block - 1) / block), block, 0,
                            s>>>(
      static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<T*>(dattn), B, nq, H, W, C, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// C = heads * D with D / 4 a power of two <= 32; is_bf16 selects the type of
// v, attn, dv and dattn (all the same); g is always fp32.
extern "C" int occ_tap_attention_bwd(const void* v, const void* attn,
                                     const void* g, void* dv, void* dattn,
                                     int is_bf16, int B, int nq, int H, int W,
                                     int C, int heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(v, attn, g, dv, dattn, B, nq, H, W, C,
                                 heads, s);
  return launch<float>(v, attn, g, dv, dattn, B, nq, H, W, C, heads, s);
}
