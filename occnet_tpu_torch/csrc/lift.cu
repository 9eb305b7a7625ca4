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
// Bitwise equal to `lift_cuda.lift_level_plain`: the sum runs in its order
// (camera ascending, then dk, then dj), each step `acc + (w2 * w1) * f` in
// separate fp32 roundings (`__fmul_rn` / `__fadd_rn`, so nvcc fuses
// nothing), then `acc * inv_count` and one round to nearest even on the
// store.  Taps of weight 0 are skipped: adding +-0 to a sum that starts at
// +0 leaves it unchanged.
//
// Bound on the H100: bytes.  A turbo_occ frame writes B x 4 levels x 8 x
// 40000 x 256 bf16 = 655 MB and must read the features (95 MB) and the
// positions (53 MB): ~0.24 ms at 3.35 TB/s.  But a cell's ~6 taps are
// gathers of 512-byte channel runs, ~1 GB a level from L1/L2, and each
// level costs about the same whatever its footprint, so what decides the
// time is latency: how many gathers and geometry reads are in flight.  The
// design:
//   - a block owns one (b, BEV row r, run of TM columns) for ALL z-anchors
//     (zr = z * R + r), up to 256 cells.  A cell's z-anchors project onto
//     one image column and neighbouring columns onto neighbouring pixels,
//     so a block's gathers share L1 lines, and the grid sweeps a level's
//     features about once instead of once a z-plane;
//   - stage: a thread per cell reads pos2 and steep of kCamChunk cameras
//     at once (coalesced over the run of columns), then the <= 2 pos1 taps
//     of each of them, each round of loads issued before any is used, and
//     writes the cell's taps (element offset, fp32 weight) to shared memory
//     as one list in the plain version's order: <= 4 a camera, sized for
//     the worst case;
//   - gather: a lane owns 8 channels of a cell (a warp a cell at C = 256,
//     two at C = 128); it reads the cell's list from shared memory
//     (broadcast) and issues kBatch 16-byte feature loads before the adds;
//   - store: 16-byte streaming stores (st.global.cs), so the output, seven
//     times the features, does not push them out of L2.  Every element is
//     written (zeros where no camera sees the cell), so no caller reads
//     uninitialised memory through a zero weight (0 * NaN).
// Registers are what limit it: kBatch = kCamChunk = 4 keeps the kernel at
// 64 registers, four blocks an SM; 8 and 8 (all of a cell's usual taps and
// all six cameras in one round) take 96, two blocks an SM, and are slower
// (tools/bench_lift_tap.py --ablate; PERF.md).
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block = most cells a block
constexpr int kCamChunk = 4;    // cameras staged at a time
constexpr int kBatch = 4;       // feature loads in flight a lane

__device__ __forceinline__ void store8_cs(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store8_cs(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  __stcs(reinterpret_cast<uint4*>(p), raw);
}

// shared memory of a block of `cells` cells and A cameras: the tap lists
// (the pixel's element offset in the sample's features and the weight,
// entry-major so that a thread per cell writes without bank conflicts), the
// cell's tap count and its 1/count
size_t smem_bytes(int A, int cells) {
  return (size_t)cells * (4 * A * (sizeof(int) + sizeof(float))
                          + sizeof(int) + sizeof(float));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) lift_level_kernel(
    const __nv_bfloat16* __restrict__ feat,  // (B, A, h, w, C)
    const float* __restrict__ pos1,          // (B, A, ZR, w + h) pass-1 pos
    const float* __restrict__ pos2,          // (B, A, ZR, M) pass-2 pos
    const uint8_t* __restrict__ steep,       // (B, A, ZR) 1 = order B
    const float* __restrict__ inv_count,     // (B, R * M)
    OutT* __restrict__ out,                  // (B, ZR, M, C), batch stride
    int A, int h, int w, int C, int ZR, int R, int M, int TM, int tiles_m,
    long long out_bstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = ZR / R;
  const int cells = Z * TM;
  int* tap_off = reinterpret_cast<int*>(smem);            // [4A][cells]
  float* tap_wt = reinterpret_cast<float*>(tap_off + 4 * A * cells);
  int* count = reinterpret_cast<int*>(tap_wt + 4 * A * cells);
  float* inv = reinterpret_cast<float*>(count + cells);

  const int mt = blockIdx.x % tiles_m;
  const int br = blockIdx.x / tiles_m;
  const int r = br % R;
  const int b = br / R;
  const int m0 = mt * TM;
  const int K1 = w + h;

  // 1. stage: a thread per cell builds its tap list in the plain order
  if (threadIdx.x < cells) {
    const int t = threadIdx.x;
    const int z = t / TM;
    const int m = m0 + t - z * TM;
    const int zr = z * R + r;
    int n = 0;
    float ic = 0.0f;
    if (m < M) {
      for (int a0 = 0; a0 < A; a0 += kCamChunk) {
        float p2[kCamChunk];
        bool st[kCamChunk];
#pragma unroll
        for (int i = 0; i < kCamChunk; ++i) {
          p2[i] = -2.0f;
          st[i] = false;
          if (a0 + i < A) {
            const long long plane = ((long long)b * A + a0 + i) * ZR + zr;
            p2[i] = __ldg(pos2 + plane * M + m);
            st[i] = __ldg(steep + plane) != 0;
          }
        }
        float p1[kCamChunk][2];
#pragma unroll
        for (int i = 0; i < kCamChunk; ++i) {
          const int n2 = st[i] ? h : w;
          const int k0 = (int)floorf(p2[i]);
          const long long row = (((long long)b * A + a0 + i) * ZR + zr) * K1
                                + (st[i] ? w : 0);
#pragma unroll
          for (int dk = 0; dk < 2; ++dk) {
            const int k = k0 + dk;
            p1[i][dk] = (a0 + i < A && k >= 0 && k < n2)
                            ? __ldg(pos1 + row + k) : -2.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < kCamChunk; ++i) {
          if (a0 + i >= A) break;
          const int n2 = st[i] ? h : w;   // extent along the line
          const int n1 = st[i] ? w : h;   // extent across the line
          const float k0f = floorf(p2[i]);
          const int k0 = (int)k0f;
          const float f2 = p2[i] - k0f;
          const int cam = (a0 + i) * h * w * C;
#pragma unroll
          for (int dk = 0; dk < 2; ++dk) {
            const int k = k0 + dk;
            if (k < 0 || k >= n2) continue;     // grid_sample zero padding
            const float w2 = dk ? f2 : 1.0f - f2;
            const float j0f = floorf(p1[i][dk]);
            const int j0 = (int)j0f;
            const float f1 = p1[i][dk] - j0f;
#pragma unroll
            for (int dj = 0; dj < 2; ++dj) {
              const int j = j0 + dj;
              if (j < 0 || j >= n1) continue;
              const float wt = __fmul_rn(w2, dj ? f1 : 1.0f - f1);
              if (wt == 0.0f) continue;
              const int y = st[i] ? k : j;
              const int x = st[i] ? j : k;
              tap_off[n * cells + t] = cam + (y * w + x) * C;
              tap_wt[n * cells + t] = wt;
              ++n;
            }
          }
        }
      }
      ic = __ldg(inv_count + ((long long)b * R + r) * M + m);
    }
    count[t] = n;
    inv[t] = ic;
  }
  __syncthreads();

  // 2. gather: a lane an (8 channels, cell) item, the list's loads batched
  const int chunks = C >> 3;
  const __nv_bfloat16* fb = feat + (long long)b * A * h * w * C;
  OutT* ob = out + (long long)b * out_bstride;
  for (int it = threadIdx.x; it < cells * chunks; it += kThreads) {
    const int cell = it / chunks;
    const int c0 = (it - cell * chunks) * 8;
    const int z = cell / TM;
    const int m = m0 + cell - z * TM;
    if (m >= M) continue;
    const int n = count[cell];
    const __nv_bfloat16* fc = fb + c0;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    for (int t0 = 0; t0 < n; t0 += kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (t0 + q < n) {
          const __nv_bfloat16* src = fc + tap_off[(t0 + q) * cells + cell];
          raw[q] = __ldg(reinterpret_cast<const uint4*>(src));
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (t0 + q >= n) break;
        const float wt = tap_wt[(t0 + q) * cells + cell];
        const __nv_bfloat162* hv =
            reinterpret_cast<const __nv_bfloat162*>(&raw[q]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(hv[i]);
          acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(wt, f.x));
          acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(wt, f.y));
        }
      }
    }
    const float ic = inv[cell];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fmul_rn(acc[i], ic);
    store8_cs(ob + ((long long)(z * R + r) * M + m) * C + c0, acc);
  }
}

template <typename OutT>
int launch(const void* feat, const void* pos1, const void* pos2,
           const void* steep, const void* inv_count, void* out, int B, int A,
           int h, int w, int C, int ZR, int R, int M, long long out_bstride,
           cudaStream_t s) {
  const int Z = ZR / R;
  // the widest run of columns that fits Z * TM <= kThreads cells, evened
  // out over the row so the last run is not a sliver
  const int tiles_m = (M + kThreads / Z - 1) / (kThreads / Z);
  const int TM = (M + tiles_m - 1) / tiles_m;
  const size_t bytes = smem_bytes(A, Z * TM);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin || (long long)A * h * w * C > INT_MAX) {
    return (int)cudaErrorInvalidValue;      // tap offsets are int32
  }
  static cudaError_t attr = cudaFuncSetAttribute(
      lift_level_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)B * R * tiles_m;
  lift_level_kernel<OutT><<<(unsigned)blocks, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(pos1),
      static_cast<const float*>(pos2), static_cast<const uint8_t*>(steep),
      static_cast<const float*>(inv_count), static_cast<OutT*>(out), A, h, w,
      C, ZR, R, M, TM, tiles_m, out_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

// C = channels (multiple of 8); ZR = Z * R with Z <= 256 z-anchors;
// out_is_bf16 selects the output type.  feat and out 16-byte aligned.
extern "C" int occ_lift_level(const void* feat, const void* pos1,
                              const void* pos2, const void* steep,
                              const void* inv_count, void* out,
                              int out_is_bf16, int B, int A, int h, int w,
                              int C, int ZR, int R, int M,
                              long long out_bstride, void* stream) {
  if (C <= 0 || C % 8 != 0 || R <= 0 || ZR % R != 0 || ZR / R > kThreads ||
      A <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ZR * M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    return launch<__nv_bfloat16>(feat, pos1, pos2, steep, inv_count, out, B,
                                 A, h, w, C, ZR, R, M, out_bstride, s);
  }
  return launch<float>(feat, pos1, pos2, steep, inv_count, out, B, A, h, w,
                       C, ZR, R, M, out_bstride, s);
}
