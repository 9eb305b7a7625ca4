// Dense TSA 3x3 tap attention (forward):
//
//   out[b,y,x,h*D+d] = (1/nq) * sum_{n,t} attn[b,y,x,n,t,h]
//                                        * v[b,n,y-dy_t,x-dx_t,h*D+d]
//
// with zero padding outside the grid (the `_shift2d` semantics of
// occnet_tpu/ops/tsa_pallas.py:49-55) and taps t = (dy+1)*3 + (dx+1).
//
// Replaces the Pallas kernel `_tap_kernel` (occnet_tpu/ops/tsa_pallas.py:88).
// The TPU version staged a row tile plus halo in VMEM and expanded the
// per-head weights to channels with a one-hot MXU product (lane-interleaved
// broadcasts are not expressible there).  Here one thread owns 4 channels of
// one output cell: it reads its head's 2 x 9 weights directly and the 18
// shifted 4-channel runs (8 or 16 bytes, coalesced across the warp), and
// accumulates in fp32 registers.  No halo buffer is needed: out-of-grid taps
// are skipped.
//
// Bound on the H100: memory.  At the main-path shape (1, 2, 200, 200, 256)
// bf16 it must read v (41 MB) + attn (11.5 MB) and write the fp32 output
// (41 MB); the 9x re-reads of v hit L1/L2 because neighbouring threads read
// neighbouring cells.  Staging tiles in shared memory is a later PR's work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) tap_kernel(
    const T* __restrict__ v,      // (B, nq, H, W, C)
    const T* __restrict__ attn,   // (B, H, W, nq, 9, heads)
    float* __restrict__ out,      // (B, H, W, C)
    int B, int nq, int H, int W, int C, int heads) {
  const int chunks = C / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * H * W * chunks) return;
  const int c0 = (int)(idx % chunks) * 4;
  long long p = idx / chunks;
  const int x = (int)(p % W);
  p /= W;
  const int y = (int)(p % H);
  const int b = (int)(p / H);
  const int hd = c0 / (C / heads);
  const T* arow = attn + (((long long)b * H + y) * W + x) * (nq * 9 * heads)
                  + hd;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < nq; ++n) {
    const T* vn = v + ((long long)b * nq + n) * H * W * C + c0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y - (t / 3 - 1);
      const int xx = x - (t % 3 - 1);
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const float wt = occ::to_float(arow[(n * 9 + t) * heads]);
      float val[4];
      occ::load4(vn + ((long long)yy * W + xx) * C, val);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(wt, val[i], acc[i]);
    }
  }
  const float s = 1.0f / (float)nq;
  *reinterpret_cast<float4*>(out + (((long long)b * H + y) * W + x) * C + c0) =
      make_float4(acc[0] * s, acc[1] * s, acc[2] * s, acc[3] * s);
}

}  // namespace

// C = heads * D with D a multiple of 4; is_bf16 selects the input type of v
// and attn (both the same); the output is always fp32.
extern "C" int occ_tap_attention(const void* v, const void* attn, void* out,
                                 int is_bf16, int B, int nq, int H, int W,
                                 int C, int heads, void* stream) {
  const long long n = (long long)B * H * W * (C / 4);
  const int block = 256;
  const dim3 grid((unsigned)((n + block - 1) / block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    tap_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(attn), static_cast<float*>(out), B,
        nq, H, W, C, heads);
  } else {
    tap_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(v), static_cast<const float*>(attn),
        static_cast<float*>(out), B, nq, H, W, C, heads);
  }
  return (int)cudaGetLastError();
}
