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
// Replaces the backward of occnet_tpu/ops/msda_pallas.py, `_bwd` (:369):
// there the VJP of the XLA patch-table form (ops/msda.py:132), query-chunked
// at 4,096 and rematerialised so that no (BH, Q*P, 4D) gather temporary
// outlives its chunk.  Here nothing is kept between forward and backward
// but value, loc and attn, and the kernel recomputes each sample's corners.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W).  The
// compulsory bytes (value, loc, attn and g read once, dvalue, dloc and
// dattn written once) are 0.68 GB at base_occ's SCA shape in bf16 (6 x
// 12288 queries x 8 heads x 4 levels x 8 points): 0.20 ms.  The first port
// (D / 4 lanes a (b, q, h) slot, each lane walking the slot's samples one
// at a time and working out every sample's position, corners and weights
// itself) took 2.79-2.82 ms there, about the same on every level alone
// (0.58-0.79 ms; chip_smoke.py phase 19's split), and development builds of it
// without its scatter into dvalue kept most of that time: the 0.6 G
// 16-byte atomics are not the larger part, the walk itself is.
// Adding in shared memory first does not pay on this card: an fp32
// atomicAdd to shared memory compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), and development builds that summed the
// coarse levels there, or sorted the samples by cell first, were slower
// than the first port in chip_smoke.py's phase 19.
//
// Design (the forward's staging, csrc/msda.cu): a warp serves 32 / (D / 4)
// slots (D = 32: 4 slots, the 8 heads of a query in two warps), D / 4
// lanes a slot, 4 channels a lane.  The warp first reads its slots' loc /
// attn coalesced (lane i takes samples i, i + 32, ...), works out each
// sample's 4 corner rows (-1 outside the level) and fractions once, and
// stages them in shared memory as one 32-byte record, sample-major so that
// the slots read neighbouring records.  Each slot's lanes then walk the
// samples kInFlight at a time (their corner gathers issued together), add
// their share of the three sums for dattn / dloc, and scatter into dvalue
// with one 16-byte fp32 atomicAdd (float4) a corner, except that a run of
// the slot's samples on one cell (points of a query that meet on a coarse
// cell, as on a real step's inputs) adds once: g is the slot's, so
// the run's contribution to a corner row is its summed weight x g.  The
// slot's lanes reduce the sums with warp shuffles in a fixed order and its
// first lane puts them in the table; the warp writes dattn and dloc
// coalesced at the end.  A sample whose 2x2 support misses the level takes
// no gradient; its dattn and dloc are written as 0.
//
// Measured by chip_smoke.py phases 19 and 22 in turns with the first
// port, two runs each in one call (NVIDIA H100 80GB HBM3, 700.00 W): SCA
// 2.5410 / 2.5325 against 2.7940 / 2.8197 ms on uniform locations,
// 2.9562 / 2.9436 against 3.4364 / 3.4318 on a real base_occ step's
// first layer; TSA 0.6016 / 0.5991 against 0.6125 / 0.6194 (uniform),
// 0.5247 / 0.5346 against 0.5463 / 0.5602 (real).
//
// Determinism: the fp32 atomics land in an order that changes from launch
// to launch, so dvalue is not bitwise reproducible (dloc and dattn are: one
// writer each, a fixed reduction order).  chip_smoke.py holds it to
// 1e-4 x max|plain| in f32 and 2e-2 x max|plain| in bf16.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 4;              // warps a block, a table each
constexpr int kInFlight = 2;           // samples of a slot in flight

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];         // first row of the level in V
};

__device__ __forceinline__ int pick(const int (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// a sample's record in the warp's table: the 4 corner rows of value
// (b * V + level start + cell; -1 outside the level), tx, ty, attn
struct Rec {
  int4 rows;
  float4 frac;                   // tx, ty, attn, unused
};

// a run's corner weights x g added to dvalue (rows -1: no corner)
__device__ __forceinline__ void add_run(float* __restrict__ dvh, int HD,
                                        const int (&row)[4],
                                        const float (&w)[4],
                                        const float (&g)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (row[c] < 0) continue;
    atomicAdd(reinterpret_cast<float4*>(dvh + (long long)row[c] * HD),
              make_float4(w[c] * g[0], w[c] * g[1], w[c] * g[2],
                          w[c] * g[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) msda_bwd_kernel(
    const T* __restrict__ value,       // (B, V, H, D)
    const float* __restrict__ loc,     // (B, Q, H, L, P, 2)
    const float* __restrict__ attn,    // (B, Q, H, L, P)
    const T* __restrict__ grad,        // (B, Q, H, D)
    float* __restrict__ dvalue,        // (B, V, H, D), zeroed
    float* __restrict__ dloc,          // (B, Q, H, L, P, 2)
    float* __restrict__ dattn,         // (B, Q, H, L, P)
    Levels lv, int B, int V, int Q, int H, int D, int L, int P) {
  extern __shared__ float4 smem4[];
  const int G = D / 4;                 // lanes a slot: a power of two <= 32
  const int HW = 32 / G;               // slots a warp
  const int LP = L * P;
  const int NS = HW * LP;              // samples a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_slots = (long long)B * Q * H;
  const long long slot0 =
      ((long long)blockIdx.x * kWarps + warp) * (long long)HW;
  if (slot0 >= n_slots) return;        // the whole warp leaves together
  Rec* rec = reinterpret_cast<Rec*>(smem4 + warp * 3 * NS);
  float4* sums = smem4 + warp * 3 * NS + 2 * NS;   // sa, sx, sy

  // the sample arithmetic, once a sample: lane i takes samples i, i + 32,
  // ... of the warp's slots (coalesced loads), stored sample-major (e =
  // s * HW + g) so that the slots read neighbouring records
  for (int i = lane; i < NS; i += 32) {
    const int g = i / LP;
    const int s = i - g * LP;
    const long long slot = slot0 + g;
    int r[4] = {-1, -1, -1, -1};
    float tx = 0.0f, ty = 0.0f, a = 0.0f;
    if (slot < n_slots) {
      const int l = s / P;
      const int hl = pick(lv.h, l);
      const int wl = pick(lv.w, l);
      const float2 xy =
          __ldg(reinterpret_cast<const float2*>(loc) + slot * LP + s);
      a = __ldg(attn + slot * LP + s);
      // the forward's rounding of the position (no fused multiply-add);
      // some corner lies inside the level: tested in float, before any
      // conversion to int, so far samples never form an address
      const float x = __fsub_rn(__fmul_rn(xy.x, (float)wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, (float)hl), 0.5f);
      if (x >= -1.0f && x < (float)wl && y >= -1.0f && y < (float)hl) {
        const float xf = floorf(x);
        const float yf = floorf(y);
        tx = __fsub_rn(x, xf);
        ty = __fsub_rn(y, yf);
        const int base = (int)(slot / H / Q) * V + pick(lv.start, l);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cy = (int)yf + (c >> 1);
          const int cx = (int)xf + (c & 1);
          if (cy >= 0 && cy < hl && cx >= 0 && cx < wl) {
            r[c] = base + cy * wl + cx;
          }
        }
      }
    }
    rec[s * HW + g] = Rec{make_int4(r[0], r[1], r[2], r[3]),
                          make_float4(tx, ty, a, 0.0f)};
  }
  __syncwarp();

  const int g = lane / G;
  const int sub = lane % G;
  const long long slot = slot0 + g;
  const bool live = slot < n_slots;
  const int HD = H * D;
  const int c0 = sub * 4;
  const T* vh = value + (live ? slot % H : 0) * D + c0;
  float* dvh = dvalue + (live ? slot % H : 0) * D + c0;
  float gv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) occ::load4(grad + slot * D + c0, gv);
  // the corner weights of a run of the slot's samples on one cell: g is
  // the slot's, so a run's contribution to a corner row is (sum of its
  // weights) x g, added to dvalue once when the cell changes
  int prow[4] = {-1, -1, -1, -1};
  float pw[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int s0 = 0; s0 < LP; s0 += kInFlight) {
    Rec q[kInFlight];
    float v[kInFlight][4][4];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      q[u] = s0 + u < LP && live
                 ? rec[(s0 + u) * HW + g]
                 : Rec{make_int4(-1, -1, -1, -1), make_float4(0, 0, 0, 0)};
      const int r[4] = {q[u].rows.x, q[u].rows.y, q[u].rows.z, q[u].rows.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (r[c] >= 0) {
          occ::load4(vh + (long long)r[c] * HD, v[u][c]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][c][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r[4] = {q[u].rows.x, q[u].rows.y, q[u].rows.z, q[u].rows.w};
      const float tx = q[u].frac.x, ty = q[u].frac.y, a = q[u].frac.z;
      const float wx[2] = {__fsub_rn(1.0f, tx), tx};
      const float wy[2] = {__fsub_rn(1.0f, ty), ty};
      // the channel sums of g x (top row, bottom row, and the two rows'
      // x-differences) give dattn, dloc_y and dloc_x
      float st = 0.0f, sb = 0.0f, d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float top = wx[0] * v[u][0][e] + wx[1] * v[u][1][e];
        const float bot = wx[0] * v[u][2][e] + wx[1] * v[u][3][e];
        st += gv[e] * top;
        sb += gv[e] * bot;
        d0 += gv[e] * (v[u][1][e] - v[u][0][e]);
        d1 += gv[e] * (v[u][3][e] - v[u][2][e]);
      }
      float sa = wy[0] * st + wy[1] * sb;
      float sx = wy[0] * d0 + wy[1] * d1;
      float sy = sb - st;
      if (r[0] != prow[0] || r[1] != prow[1] || r[2] != prow[2] ||
          r[3] != prow[3]) {
        add_run(dvh, HD, prow, pw, gv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          prow[c] = r[c];
          pw[c] = 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the forward's weight, rounded in its order
        pw[c] += __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), a);
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sx += __shfl_xor_sync(0xffffffffu, sx, off);
        sy += __shfl_xor_sync(0xffffffffu, sy, off);
      }
      if (sub == 0 && s0 + u < LP) {
        sums[(s0 + u) * HW + g] = make_float4(sa, sx, sy, 0.0f);
      }
    }
  }
  add_run(dvh, HD, prow, pw, gv);
  __syncwarp();
  // dattn and dloc, coalesced; a sample outside its level (no valid
  // corner) is written 0
  for (int i = lane; i < NS; i += 32) {
    const int gi = i / LP;
    const int s = i - gi * LP;
    const long long si = slot0 + gi;
    if (si >= n_slots) break;
    const int e = s * HW + gi;
    const int l = s / P;
    const float4 t = sums[e];
    const float a = rec[e].frac.z;
    dattn[si * LP + s] = t.x;
    reinterpret_cast<float2*>(dloc)[si * LP + s] =
        make_float2((float)pick(lv.w, l) * (a * t.y),
                    (float)pick(lv.h, l) * (a * t.z));
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn,
           const void* grad, void* dvalue, void* dloc, void* dattn,
           const Levels& lv, int B, int V, int Q, int H, int D, int L, int P,
           cudaStream_t s) {
  const long long n_slots = (long long)B * Q * H;
  const int HW = 32 / (D / 4);
  const long long warps = (n_slots + HW - 1) / HW;
  const size_t smem = (size_t)kWarps * 3 * HW * L * P * sizeof(float4);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // a table above the card's shared memory (many levels x points) fails
  // here, and the wrapper raises
  cudaError_t err = cudaFuncSetAttribute(
      msda_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  msda_bwd_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(grad),
      static_cast<float*>(dvalue), static_cast<float*>(dloc),
      static_cast<float*>(dattn), lv, B, V, Q, H, D, L, P);
  return (int)cudaGetLastError();
}

}  // namespace

// value and grad (B, V, H, D) / (B, Q, H * D) of one type (bf16 if is_bf16,
// else fp32), loc (B, Q, H, L, P, 2) and attn (B, Q, H, L, P) fp32; hw holds
// (h, w) of each of the L <= 4 levels; dvalue (B, V, H, D) fp32 zeroed by the
// caller, dloc and dattn fp32 shaped as loc and attn.  D a multiple of 4
// with 32 / (D / 4) whole; value and grad 8-byte aligned, dvalue 16-byte
// aligned (the wrapper checks, and allocates dvalue).  A shared-memory
// table above the card's limit (many levels x points) fails the launch.
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
  if (start != V || (long long)V * H * D >= (1LL << 31) ||
      (long long)B * V >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * Q * H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, grad, dvalue, dloc,
                                         dattn, lv, B, V, Q, H, D, L, P, s)
                 : launch<float>(value, loc, attn, grad, dvalue, dloc, dattn,
                                 lv, B, V, Q, H, D, L, P, s);
}
