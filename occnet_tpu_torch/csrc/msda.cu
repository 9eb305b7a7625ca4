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
// gathers from L2 directly: one kernel serves every level, both value
// dtypes (template) and both attentions (SCA and TSA).
//
// Design.  A lane owns 16 bytes of one head's channels (8 bf16 or 4 fp32),
// so D / 8 (bf16) or D / 4 (fp32) lanes serve a head and a warp serves
// 32 / (D / vec) consecutive (b, q, h) slots: with D = 32 and H = 8, one
// query's 8 heads in bf16 (its 512-byte output row is one coalesced store),
// 4 heads in fp32.  The per-sample arithmetic is done once per sample, not
// once per lane: the warp reads its slots' loc / attn coalesced (lane i takes
// samples i, i + 32, ...), computes each sample's 4 corner rows (-1 where the
// corner lies outside the level, no address outside it is ever formed) and
// 4 weights bilinear x attention, and stages them in shared memory (32 bytes
// a sample, laid out so that the head groups read neighbouring words).  Each
// head group then walks (level, corner, point) and gathers each corner's
// 16-byte vector, up to 8 points' loads in flight (4 where P <= 4).  The
// fp32 sums follow the plain version's order exactly (per level, per
// corner, the points reduced in four interleaved partial sums as PyTorch's
// CUDA sum over them reduces, then added to the total), with
// __fmul_rn/__fadd_rn/__fsub_rn so nvcc contracts nothing: fp32 values give
// the plain version's bits.
//
// Bound on the H100: the gathers.  At the SCA shape (6 x 12288 queries x 8
// heads x 4 levels x 8 points) a warp request moves 8 heads x 64 bytes, and
// the volume from L1/L2 is up to 4.8 GB (in-level samples only) for 38 MB
// written; the compulsory HBM bytes are loc / attn (fp32) and the values.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 4;        // warps a block (each has its own table)

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];         // first row of the level in V
};

// the slot of level l without a dynamic index into the parameter struct
__device__ __forceinline__ int pick(const int (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// 16 bytes of value channels -> fp32
__device__ __forceinline__ void to_f32(const uint4& r, const __nv_bfloat16*,
                                       float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_f32(const uint4& r, const float*,
                                       float* o) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}

// kInFlight points' corner loads in flight: 8 for P = 8 (SCA); 4 for
// P <= 4 (TSA), where the smaller register file lets 8 blocks share an SM
template <typename T, int kInFlight>
__global__ void __launch_bounds__(kWarps * 32, kInFlight == 4 ? 8 : 4)
msda_kernel(
    const T* __restrict__ value,       // (B, V, H, D)
    const float* __restrict__ loc,     // (B, Q, H, L, P, 2)
    const float* __restrict__ attn,    // (B, Q, H, L, P)
    T* __restrict__ out,               // (B, Q, H, D)
    Levels lv, int B, int V, int Q, int H, int D, int L, int P) {
  constexpr int NC = 16 / sizeof(T);   // channels a lane
  extern __shared__ int smem[];
  const int LH = D / NC;               // lanes a head
  const int HW = 32 / LH;              // slots a warp
  const int LP = L * P;
  const int NS = HW * LP;              // samples a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_slots = (long long)B * Q * H;
  const long long slot0 =
      ((long long)blockIdx.x * kWarps + warp) * (long long)HW;
  if (slot0 >= n_slots) return;        // the whole warp leaves together
  // table of this warp: corner rows [4][NS], then weights [4][NS]; entry
  // (sample s, slot g) at s * HW + g
  int* rows = smem + warp * 8 * NS;
  float* wts = reinterpret_cast<float*>(rows + 4 * NS);

  for (int i = lane; i < NS; i += 32) {
    const int g = i / LP;
    const int s = i - g * LP;
    const long long slot = slot0 + g;
    int r[4] = {-1, -1, -1, -1};
    float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (slot < n_slots) {
      const int l = s / P;
      const int hl = pick(lv.h, l);
      const int wl = pick(lv.w, l);
      const float2 xy =
          __ldg(reinterpret_cast<const float2*>(loc) + slot * LP + s);
      // no fused multiply-add: the position rounds as in the plain version
      const float x = __fsub_rn(__fmul_rn(xy.x, (float)wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, (float)hl), 0.5f);
      // far samples are rejected in float, before any conversion to int
      if (x > -1.0f && x < (float)wl && y > -1.0f && y < (float)hl) {
        const float a = __ldg(attn + slot * LP + s);
        const float xf = floorf(x);
        const float yf = floorf(y);
        const float tx = __fsub_rn(x, xf);
        const float ty = __fsub_rn(y, yf);
        const int x0 = (int)xf;        // in [-1, wl - 1]
        const int y0 = (int)yf;        // in [-1, hl - 1]
        const float wx[2] = {__fsub_rn(1.0f, tx), tx};
        const float wy[2] = {__fsub_rn(1.0f, ty), ty};
        const int base = pick(lv.start, l);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cy = y0 + (c >> 1);
          const int cx = x0 + (c & 1);
          if (cy >= 0 && cy < hl && cx >= 0 && cx < wl) {
            r[c] = base + cy * wl + cx;
            wt[c] = __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), a);
          }
        }
      }
    }
    const int e = s * HW + g;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rows[c * NS + e] = r[c];
      wts[c * NS + e] = wt[c];
    }
  }
  __syncwarp();

  const int g = lane / LH;
  const long long slot = slot0 + g;
  const int h = (int)(slot % H);
  const long long b = slot / H / Q;
  const long long row_stride = (long long)H * D;
  const T* vb = value + b * V * row_stride + (long long)h * D
                + (lane % LH) * NC;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float part[4][NC];               // point p goes to part[p % 4]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i) part[j][i] = 0.0f;
      for (int p0 = 0; p0 < P; p0 += kInFlight) {
        uint4 raw[kInFlight];
        float w[kInFlight];
        bool ok[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int e = (l * P + p0 + u) * HW + g;
          const int r = p0 + u < P ? rows[c * NS + e] : -1;
          ok[u] = r >= 0;
          w[u] = ok[u] ? wts[c * NS + e] : 0.0f;
          if (ok[u]) {
            raw[u] =
                __ldg(reinterpret_cast<const uint4*>(vb + r * row_stride));
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (p0 + u >= P) break;
          if (!ok[u]) continue;          // a zero term: the sum is unchanged
          float v[NC];
          to_f32(raw[u], value, v);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            part[u & 3][i] = __fadd_rn(part[u & 3][i], __fmul_rn(v[i], w[u]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float s = __fadd_rn(__fadd_rn(__fadd_rn(part[0][i], part[1][i]),
                                            part[2][i]), part[3][i]);
        acc[i] = __fadd_rn(acc[i], s);
      }
    }
  }
  if (slot < n_slots) {
    T* o = out + slot * D + (lane % LH) * NC;
    if constexpr (NC == 8) {
      occ::store8(o, acc);
    } else {
      occ::store4(o, acc);
    }
  }
}

template <typename T, int kInFlight>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, const Levels& lv, int B, int V, int Q, int H,
                   int D, int L, int P, dim3 grid, size_t smem,
                   cudaStream_t s) {
  auto k = msda_kernel<T, kInFlight>;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), lv, B, V, Q, H,
      D, L, P);
  return cudaGetLastError();
}

}  // namespace

// hw holds (h, w) of each of the L <= 4 levels, flattened row-major in V in
// that order; loc and attn are fp32; is_bf16 selects the type of value and
// out (both the same).  D must be a multiple of 8 (bf16) or 4 (fp32) channels
// with 32 / (D / that) a whole number of slots a warp; value and out 16-byte
// aligned (the wrapper checks).
extern "C" int occ_msda(const void* value, const void* loc, const void* attn,
                        void* out, const int* hw, int is_bf16, int B, int V,
                        int Q, int H, int D, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1) return (int)cudaErrorInvalidValue;
  const int nc = is_bf16 ? 8 : 4;
  if (D % nc || 32 % (D / nc)) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < L ? hw[2 * l] : 0;
    lv.w[l] = l < L ? hw[2 * l + 1] : 0;
    lv.start[l] = (int)start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != V || start >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long n_slots = (long long)B * Q * H;
  if (n_slots == 0) return 0;
  const int hw_slots = 32 / (D / nc);
  const long long warps = (n_slots + hw_slots - 1) / hw_slots;
  const size_t smem = (size_t)kWarps * 8 * hw_slots * L * P * sizeof(int);
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = P <= 4 ? launch<__nv_bfloat16, 4>(value, loc, attn, out, lv, B, V,
                                            Q, H, D, L, P, grid, smem, s)
                 : launch<__nv_bfloat16, 8>(value, loc, attn, out, lv, B, V,
                                            Q, H, D, L, P, grid, smem, s);
  } else {
    err = P <= 4 ? launch<float, 4>(value, loc, attn, out, lv, B, V, Q, H, D,
                                    L, P, grid, smem, s)
                 : launch<float, 8>(value, loc, attn, out, lv, B, V, Q, H, D,
                                    L, P, grid, smem, s);
  }
  return (int)err;
}
