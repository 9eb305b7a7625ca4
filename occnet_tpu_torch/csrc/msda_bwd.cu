// Multi-scale deformable attention sampling, backward: the three gradients
// of the forward contract of csrc/msda.cu (occnet_tpu_torch/ops/msda.py),
//
//   out[b,q,h*D+d] = sum_{l,p} attn[b,q,h,l,p]
//                    * bilinear(value_l[b,:,h,d], loc[b,q,h,l,p]),
//
// with x = loc_x * w - 0.5, y = loc_y * h - 0.5, tx = x - floor(x) (likewise
// ty) and v_c the value row of corner c, zero where the corner lies outside
// the level.  For a sample and the output gradient g:
//
//   dattn  = sum_d g * bilinear
//   dloc_x = w * attn * sum_d g * [(1 - ty)(v01 - v00) + ty (v11 - v10)]
//   dloc_y = h * attn * sum_d g * [(1 - tx)(v10 - v00) + tx (v11 - v01)]
//   dvalue[corner row] += (wy * wx) * attn * g     (each valid corner)
//
// The plain version, `msda_backward_plain` in ops/msda.py, writes the same
// sums out in PyTorch.
//
// Replaces the backward of occnet_tpu/ops/msda_pallas.py, `_bwd` (:366):
// there the VJP of the XLA patch-table form (ops/msda.py:132), query-chunked
// at 4,096 and rematerialised so that no (BH, Q*P, 4D) gather temporary
// outlives its chunk.  Here nothing is kept between forward and backward
// but value, loc and attn, and the kernel recomputes each sample's corners.
//
// Design (a simple one that is right first): D / 4 lanes serve one (b, q, h)
// slot, each lane 4 channels, so a warp serves 32 / (D / 4) slots (D = 32:
// 8 lanes a slot, 4 slots a warp).  Each lane walks the slot's L * P
// samples: it loads the <= 4 corner vectors of its channels, adds its share
// of the three sums for dattn / dloc, and scatters attn * corner weight * g
// into a zeroed fp32 dvalue with one 16-byte atomicAdd (float4, sm_90) a
// corner: 4 channels in one L2 operation (the first build, four scalar
// atomics a corner, took 8.44 ms a base_occ layer in chip_smoke.py's phase
// 19 against 3.43 ms, NVIDIA H100 80GB HBM3 at 700 W).  The slot's
// lanes then reduce the three sums with warp shuffles and its first lane
// writes dattn and dloc.  A sample whose 2x2 support misses the level
// (x < -1, x >= w, or likewise y) takes no gradient; its dattn and dloc
// are written as 0.
//
// Bound on the H100: the gathers and the atomics.  The compulsory bytes
// (value, loc, attn and g read once; dvalue, dloc, dattn written once) are
// ~0.45 GB at base_occ's SCA shape in bf16 (6 x 12288 queries x 8 heads x
// 32 samples); the atomics are 4 corners x D / 4 16-byte adds a sample,
// 0.6 G (9.7 GB) there, which L2 serialises where samples of many queries
// meet on one value row.
//
// Determinism: the fp32 atomics land in an order that changes from launch
// to launch, so dvalue is not bitwise reproducible (dloc and dattn are: one
// writer each, a fixed reduction order).  chip_smoke.py holds it to
// 1e-4 x max|plain| in f32 and 2e-2 x max|plain| in bf16.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];         // first row of the level in V
};

__device__ __forceinline__ int pick(const int (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_bwd_kernel(
    const T* __restrict__ value,       // (B, V, H, D)
    const float* __restrict__ loc,     // (B, Q, H, L, P, 2)
    const float* __restrict__ attn,    // (B, Q, H, L, P)
    const T* __restrict__ grad,        // (B, Q, H, D)
    float* __restrict__ dvalue,        // (B, V, H, D), zeroed
    float* __restrict__ dloc,          // (B, Q, H, L, P, 2)
    float* __restrict__ dattn,         // (B, Q, H, L, P)
    Levels lv, int B, int V, int Q, int H, int D, int L, int P) {
  const int G = D / 4;                 // lanes a slot: a power of two <= 32
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_slots = (long long)B * Q * H;
  // a warp whose first slot is past the end leaves whole; in any other
  // warp every lane stays to the end (the shuffles need all 32)
  if ((t & ~31LL) / G >= n_slots) return;
  const long long slot = t / G;
  const bool active = slot < n_slots;
  const long long sl = active ? slot : 0;
  const int sub = (int)(t % G);        // the lane's place in its slot
  const int h = (int)(sl % H);
  const long long b = sl / H / Q;
  const long long HD = (long long)H * D;
  const int c0 = sub * 4;
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) occ::load4(grad + sl * D + c0, g);
  const T* vb = value + b * V * HD + (long long)h * D + c0;
  float* dvb = dvalue + b * V * HD + (long long)h * D + c0;
  const int LP = L * P;

  for (int l = 0; l < L; ++l) {
    const int hl = pick(lv.h, l);
    const int wl = pick(lv.w, l);
    const int base = pick(lv.start, l);
    for (int p = 0; p < P; ++p) {
      const long long s = sl * LP + l * P + p;
      float sa = 0.0f, sx = 0.0f, sy = 0.0f, a = 0.0f;
      if (active) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + s);
        a = __ldg(attn + s);
        // the forward's rounding of the position (no fused multiply-add)
        const float x = __fsub_rn(__fmul_rn(xy.x, (float)wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(xy.y, (float)hl), 0.5f);
        // some corner lies inside the level: tested in float, before any
        // conversion to int, so far samples never form an address
        if (x >= -1.0f && x < (float)wl && y >= -1.0f && y < (float)hl) {
          const float xf = floorf(x);
          const float yf = floorf(y);
          const float tx = __fsub_rn(x, xf);
          const float ty = __fsub_rn(y, yf);
          const int x0 = (int)xf;        // in [-1, wl - 1]
          const int y0 = (int)yf;        // in [-1, hl - 1]
          const float wx[2] = {__fsub_rn(1.0f, tx), tx};
          const float wy[2] = {__fsub_rn(1.0f, ty), ty};
          float v[4][4];
          int r[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cy = y0 + (c >> 1);
            const int cx = x0 + (c & 1);
            const bool ok = cy >= 0 && cy < hl && cx >= 0 && cx < wl;
            r[c] = ok ? base + cy * wl + cx : -1;
            if (ok) {
              occ::load4(vb + r[c] * HD, v[c]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[c][e] = 0.0f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float bil = wy[0] * (wx[0] * v[0][e] + wx[1] * v[1][e]) +
                              wy[1] * (wx[0] * v[2][e] + wx[1] * v[3][e]);
            const float gx = wy[0] * (v[1][e] - v[0][e]) +
                             wy[1] * (v[3][e] - v[2][e]);
            const float gy = wx[0] * (v[2][e] - v[0][e]) +
                             wx[1] * (v[3][e] - v[1][e]);
            sa += g[e] * bil;
            sx += g[e] * gx;
            sy += g[e] * gy;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (r[c] < 0) continue;
            // the forward's weight, rounded in its order
            const float wc = __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), a);
            atomicAdd(reinterpret_cast<float4*>(dvb + r[c] * HD),
                      make_float4(wc * g[0], wc * g[1], wc * g[2],
                                  wc * g[3]));
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sx += __shfl_xor_sync(0xffffffffu, sx, off);
        sy += __shfl_xor_sync(0xffffffffu, sy, off);
      }
      if (active && sub == 0) {
        dattn[s] = sa;
        reinterpret_cast<float2*>(dloc)[s] =
            make_float2((float)wl * (a * sx), (float)hl * (a * sy));
      }
    }
  }
}

}  // namespace

// value and grad (B, V, H, D) / (B, Q, H * D) of one type (bf16 if is_bf16,
// else fp32), loc (B, Q, H, L, P, 2) and attn (B, Q, H, L, P) fp32; hw holds
// (h, w) of each of the L <= 4 levels; dvalue (B, V, H, D) fp32 zeroed by the
// caller, dloc and dattn fp32 shaped as loc and attn.  D a multiple of 4
// with 32 / (D / 4) whole; value and grad 8-byte aligned, dvalue 16-byte
// aligned (the wrapper checks, and allocates dvalue).
extern "C" int occ_msda_bwd(const void* value, const void* loc,
                            const void* attn, const void* grad, void* dvalue,
                            void* dloc, void* dattn, const int* hw,
                            int is_bf16, int B, int V, int Q, int H, int D,
                            int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 4 || D % 4 || 32 % (D / 4)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  long long start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < L ? hw[2 * l] : 0;
    lv.w[l] = l < L ? hw[2 * l + 1] : 0;
    lv.start[l] = (int)start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != V || (long long)V * H * D >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = (long long)B * Q * H * (D / 4);
  if (threads == 0) return 0;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    msda_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<const __nv_bfloat16*>(grad), static_cast<float*>(dvalue),
        static_cast<float*>(dloc), static_cast<float*>(dattn), lv, B, V, Q,
        H, D, L, P);
  } else {
    msda_bwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const float*>(grad),
        static_cast<float*>(dvalue), static_cast<float*>(dloc),
        static_cast<float*>(dattn), lv, B, V, Q, H, D, L, P);
  }
  return (int)cudaGetLastError();
}
