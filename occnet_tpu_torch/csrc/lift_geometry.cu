// Planar-lift geometry: the homographies, every level's sampling positions
// and the camera count of `planar_lift.lift_and_average`, from ego2img alone,
// in one launch.
//
// Replaces no Pallas kernel: in the JAX package this is XLA-fused glue
// (`occnet_tpu/ops/lift_pallas.py` `_plane_positions`,
// `occnet_tpu/ops/planar_lift.py` `plane_homographies` and
// `warp_level_multi_z`).  The port's plain version (`plane_homographies`,
// `feature_homographies`, `level_geometry` and the count in
// `planar_lift.lift_geometry_plain`) is ~110 fp32 torch operations a level,
// each a launch over (B, A, Z, R, M) grids; this kernel writes the same
// outputs from the launch arguments (`GeomArgs`: grid constants and z-anchors
// by value), so nothing is uploaded and the host never waits.
//
// Bitwise equal to the plain version: each fp32 operation of it is one
// `__fmul_rn` / `__fadd_rn` / `__fsub_rn` / `__fdiv_rn` here (nvcc contracts
// nothing written so), in the same order, with the same comparisons and
// selections (`where`, `safe`, `_band_limit`) and torch's fp32 casts of its
// Python scalars done on the host.
//
// Bound on the H100: the bytes written.  A turbo_occ frame (B = 1, 6
// cameras, 8 z-anchors, 200 x 200 BEV, levels 116x200 .. 15x25) writes pos2
// 4 x 7.68 MB and pos1 12.1 + 6.1 + 3.0 + 1.5 MB: ~54 MB, 16 us at 3.35
// TB/s (~64 us at B = 4); its arithmetic (two IEEE divisions and ~12
// roundings a pos2 element) weighs less.  The design:
//   - a block per (level, b, BEV row), level 0's blocks first (the
//     heaviest, and they also count);
//   - a thread per (camera, z-anchor) plane builds its level homography and
//     the row's image line (a, b, a2, b2, steep) into shared memory and
//     writes steep;
//   - the block then writes the row's pos2 (all planes x M columns) and
//     pos1 (all planes x (w + h) taps), consecutive threads on consecutive
//     elements of a plane's run, so every store is coalesced;
//   - level 0's blocks mark each (camera, column) seen at any z-anchor in
//     shared memory (a plain store of 1: the result does not depend on the
//     order), then sum the marks over cameras: the count needs no atomics.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxZ = 256;

// ops/planar_lift._GeomArgs mirrors this layout field for field
struct GeomArgs {
  const float* ego2img;          // (B, A, 4, 4)
  float* pos1[kMaxLevels];       // (B, A, Z * R, w + h)
  float* pos2[kMaxLevels];       // (B, A, Z * R, M)
  uint8_t* steep[kMaxLevels];    // (B, A, Z * R)
  float* count;                  // (B, R * M)
  float* inv_count;              // (B, R * M)
  int B, A, Z, R, r0, M, levels;
  int h[kMaxLevels], w[kMaxLevels];
  float sx[kMaxLevels], sy[kMaxLevels];   // fp32(w / img_w), fp32(h / img_h)
  float dx, dy, x0, y0, eps;
  float z[kMaxZ];
};

__device__ __forceinline__ float band(float p, int n) {
  return (p > -1.0f && p < (float)n) ? p : -2.0f;
}

// `safe` of level_geometry: |d| < 1e-8 becomes +-1e-8 by the sign test d < 0
__device__ __forceinline__ float safe(float d) {
  const float tiny = d < 0.0f ? -1e-8f : 1e-8f;
  return fabsf(d) < 1e-8f ? tiny : d;
}

// shared memory: a plane's level homography (9), its line (a, b, a2, b2),
// steep, its output row and camera; level 0 adds the (camera, column) marks
size_t smem_bytes(int A, int Z, int M, bool counts) {
  return (size_t)A * Z * (13 * sizeof(float) + 3 * sizeof(int)) +
         (counts ? (size_t)A * M : 0);
}

// `__grid_constant__`: the arguments are read in place (the per-level and
// z-anchor arrays are indexed at run time), not copied to each thread's stack
__global__ void __launch_bounds__(kThreads)
    lift_geometry_kernel(const __grid_constant__ GeomArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BR = g.B * g.R;
  const int lvl = blockIdx.x / BR;
  const int br = blockIdx.x - lvl * BR;
  const int b = br / g.R;
  const int rl = br - b * g.R;
  const int A = g.A, Z = g.Z, M = g.M, P = A * Z;
  const int h = g.h[lvl], w = g.w[lvl], K1 = w + h;
  const bool counts = lvl == 0;
  float* Ml = reinterpret_cast<float*>(smem);          // [P][9]
  float* line = Ml + 9 * P;                             // [P][4]
  int* st = reinterpret_cast<int*>(line + 4 * P);       // [P]
  int* row = st + P;                                    // [P]
  int* cam = row + P;                                   // [P]
  unsigned char* seen = reinterpret_cast<unsigned char*>(cam + P);  // [A][M]
  const float iy = (float)(g.r0 + rl);

  // 1. a thread a plane: H (plane_homographies), Ml (feature_homographies),
  //    the image line of the row and its steepness (level_geometry)
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int a = p / Z;
    const int zi = p - a * Z;
    const float* E = g.ego2img + ((long long)b * A + a) * 16;
    const float zv = g.z[zi];
    float H[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float e0 = __ldg(E + 4 * i), e1 = __ldg(E + 4 * i + 1);
      const float e2 = __ldg(E + 4 * i + 2), e3 = __ldg(E + 4 * i + 3);
      H[i][0] = __fmul_rn(e0, g.dx);
      H[i][1] = __fmul_rn(e1, g.dy);
      H[i][2] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(e0, g.x0), __fmul_rn(e1, g.y0)),
                    __fmul_rn(e2, zv)),
          e3);
    }
    float m[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float half = __fmul_rn(0.5f, H[2][j]);
      m[0][j] = __fsub_rn(__fmul_rn(g.sx[lvl], H[0][j]), half);
      m[1][j] = __fsub_rn(__fmul_rn(g.sy[lvl], H[1][j]), half);
      m[2][j] = H[2][j];
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) Ml[9 * p + i] = m[i / 3][i % 3];
    // l = p_inf x p_r, p_inf = M[:, 0], p_r = M[:, 1] * iy + M[:, 2]
    float pr[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pr[k] = __fadd_rn(__fmul_rn(m[k][1], iy), m[k][2]);
    }
    const float l0 = __fsub_rn(__fmul_rn(m[1][0], pr[2]),
                               __fmul_rn(m[2][0], pr[1]));
    const float l1 = __fsub_rn(__fmul_rn(m[2][0], pr[0]),
                               __fmul_rn(m[0][0], pr[2]));
    const float l2 = __fsub_rn(__fmul_rn(m[0][0], pr[1]),
                               __fmul_rn(m[1][0], pr[0]));
    const float s1 = safe(l1), s0 = safe(l0);
    line[4 * p] = __fdiv_rn(-l0, s1);        // y = a * x + b
    line[4 * p + 1] = __fdiv_rn(-l2, s1);
    line[4 * p + 2] = __fdiv_rn(-l1, s0);    // x = a2 * y + b2
    line[4 * p + 3] = __fdiv_rn(-l2, s0);
    const int steep = fabsf(l1) < fabsf(l0);
    const int r = (((b * A + a) * Z) + zi) * g.R + rl;
    st[p] = steep;
    row[p] = r;
    cam[p] = a;
    g.steep[lvl][r] = (uint8_t)steep;
  }
  if (counts) {
    for (int i = threadIdx.x; i < A * M; i += kThreads) seen[i] = 0;
  }
  __syncthreads();

  // 2. pos2: a thread an element of a plane's run of M columns
  {
    float* out = g.pos2[lvl];
    const float xmax = (float)w - 0.5f, ymax = (float)h - 0.5f;
    const int dp = kThreads / M, dm = kThreads - dp * M;
    int p = threadIdx.x / M, mi = threadIdx.x - p * M;
    while (p < P) {
      const float* m = Ml + 9 * p;
      const float ix = (float)mi;
      const float px = __fadd_rn(
          __fadd_rn(__fmul_rn(m[0], ix), __fmul_rn(m[1], iy)), m[2]);
      const float py = __fadd_rn(
          __fadd_rn(__fmul_rn(m[3], ix), __fmul_rn(m[4], iy)), m[5]);
      const float pw = __fadd_rn(
          __fadd_rn(__fmul_rn(m[6], ix), __fmul_rn(m[7], iy)), m[8]);
      const bool front = pw > g.eps;
      const float den = front ? pw : g.eps;
      const float xf = __fdiv_rn(px, den);
      const float yf = __fdiv_rn(py, den);
      const bool valid = front && xf > -0.5f && xf < xmax && yf > -0.5f &&
                         yf < ymax;
      float v = -2.0f;
      if (valid) v = st[p] ? band(yf, h) : band(xf, w);
      out[(long long)row[p] * M + mi] = v;
      if (counts && valid) seen[cam[p] * M + mi] = 1;
      p += dp;
      mi += dm;
      if (mi >= M) {
        mi -= M;
        ++p;
      }
    }
  }

  // 3. pos1: a thread a tap of a plane's image line, order A ([0, w): the
  //    image row at column x) then order B ([w, w + h): the column at row y)
  {
    float* out = g.pos1[lvl];
    const int dp = kThreads / K1, dk = kThreads - dp * K1;
    int p = threadIdx.x / K1, k = threadIdx.x - p * K1;
    while (p < P) {
      const float* l = line + 4 * p;
      const float v =
          k < w ? band(__fadd_rn(__fmul_rn(l[0], (float)k), l[1]), h)
                : band(__fadd_rn(__fmul_rn(l[2], (float)(k - w)), l[3]), w);
      out[(long long)row[p] * K1 + k] = v;
      p += dp;
      k += dk;
      if (k >= K1) {
        k -= K1;
        ++p;
      }
    }
  }

  // 4. level 0: count = the cameras that see the cell at any z-anchor,
  //    clamped to >= 1, and its reciprocal
  if (counts) {
    __syncthreads();
    const long long q0 = ((long long)b * g.R + rl) * M;
    for (int mi = threadIdx.x; mi < M; mi += kThreads) {
      int c = 0;
      for (int a = 0; a < A; ++a) c += seen[a * M + mi];
      const float cf = fmaxf((float)c, 1.0f);
      g.count[q0 + mi] = cf;
      g.inv_count[q0 + mi] = __fdiv_rn(1.0f, cf);
    }
  }
}

}  // namespace

// One launch for all levels and the count.  `args` is a host pointer to the
// caller's GeomArgs (passed to the kernel by value), `args_bytes` its size as
// the caller laid it out.
extern "C" int occ_lift_geometry(const void* args, int args_bytes,
                                 void* stream) {
  if (args_bytes != (int)sizeof(GeomArgs)) return (int)cudaErrorInvalidValue;
  const GeomArgs& g = *static_cast<const GeomArgs*>(args);
  if (g.levels < 1 || g.levels > kMaxLevels || g.Z < 1 || g.Z > kMaxZ ||
      g.A < 1 || g.M < 1 || g.R < 1 || g.r0 < 0 || g.B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < g.levels; ++l) {
    if (g.h[l] < 1 || g.w[l] < 1) return (int)cudaErrorInvalidValue;
  }
  if (g.B == 0) return 0;
  const long long blocks = (long long)g.levels * g.B * g.R;
  const long long rows = (long long)g.B * g.A * g.Z * g.R;
  const size_t bytes = smem_bytes(g.A, g.Z, g.M, true);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin || blocks > INT_MAX || rows > INT_MAX) {
    return (int)cudaErrorInvalidValue;      // row indices are int32
  }
  static cudaError_t attr = cudaFuncSetAttribute(
      lift_geometry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin);
  if (attr != cudaSuccess) return (int)attr;
  lift_geometry_kernel<<<(unsigned)blocks, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
