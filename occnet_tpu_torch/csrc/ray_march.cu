// Voxel-traversal ray marchers of the evaluation path: the per-ray DDA that
// renders the synthetic benchmark's camera views, and the fan DDA that
// renders predicted and ground-truth grids along the simulated LiDAR fan.
//
// Neither is a Pallas kernel in the JAX package: both are XLA programs that
// replaced the reference's CUDA voxel traversal (`dvr.render_forward`).
// Their plain PyTorch transliterations are iteration-bound (up to 420
// masked steps over every ray), so here each is one thread per ray with a
// true early-exit loop.
//
// fp32 operation order.  Each kernel repeats its own JAX form as XLA
// compiles it: the per-ray DDA accumulates crossing times step by step
// (`tmax + tdelta`, occnet_tpu/ops/ray_march.py:99), from first crossings
// and steps that XLA computes as (x * |dir|) / dir where the source writes
// x / (dir / |dir|); the fan DDA computes
// them in closed form (`tmax0 + i * tdelta`, ray_march_vec.py:59-60).  XLA
// contracts a jitted `a + b * c` into one fused multiply-add, and so does
// nvcc by default, but not everywhere alike: so each such expression of the
// JAX programs is an explicit fmaf here (the crossing times, the z entry
// `z0 + t_in * dz`, the norms' sums of squares) and every other product and
// sum is written with __fmul_rn / __fadd_rn / __fsub_rn.  With fused
// crossing times an exact geometric tie (a 45-degree ray through a voxel
// corner) stays an exact tie.  Divisions stay true divisions (no fast
// math).
//
// Bound on the H100: bytes are the rays in and the results out (the grid,
// <= 640 KB, stays in L1/L2); operations are the steps this run's rays take,
// a handful of fp32 operations each.  Warps diverge where rays of one warp
// stop at different depths.
#include "common.cuh"

namespace {

constexpr float kBig = 1e30f;

// ---------------------------------------------------------------------------
// per-ray DDA: occnet_tpu/ops/ray_march.py:32-112
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) dda_kernel(
    const uint8_t* __restrict__ occ,      // (X, Y, Z) 1 = occupied
    const float* __restrict__ origins,    // (R, 3), row stride o_stride
    const float* __restrict__ dirs,       // (R, 3)
    float* __restrict__ dist,             // (R,)
    int* __restrict__ coord,              // (R, 3)
    uint8_t* __restrict__ hit_out,        // (R,)
    long long R, int o_stride, int X, int Y, int Z, int max_steps) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int size[3] = {X, Y, Z};
  float o[3], d[3], tmax[3], tdelta[3];
  int v[3], step[3];
  const float dx = __ldg(dirs + 3 * r), dy = __ldg(dirs + 3 * r + 1),
              dz = __ldg(dirs + 3 * r + 2);
  // |dir| as XLA sums it: fma(z, z, fma(y, y, x * x))
  const float norm = sqrtf(fmaf(dz, dz, fmaf(dy, dy, __fmul_rn(dx, dx))));
  const float nrm = fmaxf(norm, 1e-12f);
  const float din[3] = {dx, dy, dz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __ldg(origins + (long long)o_stride * r + a);
    d[a] = din[a] / nrm;
    v[a] = (int)floorf(o[a]);
    step[a] = d[a] >= 0.0f ? 1 : -1;
    const float nb = (float)v[a] + (step[a] > 0 ? 1.0f : 0.0f);
    // XLA rewrites x / (dir / nrm) as (x * nrm) / dir
    tmax[a] = d[a] != 0.0f ? __fmul_rn(__fsub_rn(nb, o[a]), nrm) / din[a]
                           : kBig;
    tdelta[a] = d[a] != 0.0f ? __fmul_rn((float)step[a], nrm) / din[a]
                             : kBig;
  }
  bool was_inside = false, hit = false;
  float last_d = 0.0f;
  int last_v[3] = {0, 0, 0};
  for (int s = 0; s < max_steps; ++s) {
    const bool inside = v[0] >= 0 && v[0] < X && v[1] >= 0 && v[1] < Y &&
                        v[2] >= 0 && v[2] < Z;
    if (was_inside && !inside) break;          // left the grid: done
    if (!was_inside && !inside) {
      // outside and moving away along some axis: never enters
      bool away = false;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        away |= (v[a] < 0 && d[a] < 0.0f) || (v[a] >= size[a] && d[a] > 0.0f);
      if (away) break;
    }
    // advancing axis with the kernel's nested strict comparisons
    const int axis = tmax[0] < tmax[1] ? (tmax[0] < tmax[2] ? 0 : 2)
                                       : (tmax[1] < tmax[2] ? 1 : 2);
    if (inside) {
      last_d = fminf(fminf(tmax[0], tmax[1]), tmax[2]);
      last_v[0] = v[0]; last_v[1] = v[1]; last_v[2] = v[2];
      was_inside = true;
      if (__ldg(occ + ((long long)v[0] * Y + v[1]) * Z + v[2])) {
        hit = true;
        break;
      }
    }
    v[axis] += step[axis];
    tmax[axis] = __fadd_rn(tmax[axis], tdelta[axis]);
  }
  // never-entered rays: zeros (dvr.cu leaves its outputs zero-initialised)
  dist[r] = was_inside ? last_d : 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) coord[3 * r + a] = was_inside ? last_v[a] : 0;
  hit_out[r] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// fan DDA: occnet_tpu/ops/ray_march_vec.py:43-227
// ---------------------------------------------------------------------------

// Data of one column crossing n of the xy walk.
struct Crossing {
  int vx, vy;
  float t_in, t_exit;
  int colbits;
};

struct SubWalk {
  bool hit, last_ok;
  float hit_s, last_s;
  int hit_z, last_z;
};

// (float(zb) - z0) / dz for dz != 0, else BIG
__device__ __forceinline__ float z_time(int zb, float z0, float dz) {
  return dz != 0.0f ? __fsub_rn((float)zb, z0) / dz : kBig;
}

// `_z_subwalk` (ray_march_vec.py:81-119) at one crossing.
__device__ SubWalk z_subwalk(const Crossing& c, float z0, float dz, int zstep,
                             int Z, int max_z_sub) {
  SubWalk w = {false, false, 0.0f, 0.0f, 0, 0};
  const int zi = (int)floorf(fmaf(c.t_in, dz, z0));
  for (int j = 0; j < max_z_sub; ++j) {
    const int zj = zi + j * zstep;
    const bool z_ok = zj >= 0 && zj < Z;
    const float s_zb = z_time(zj + (zstep > 0 ? 1 : 0), z0, dz);
    bool enters = true;
    if (j > 0)
      enters = z_time(zj + (zstep < 0 ? 1 : 0), z0, dz) < c.t_exit &&
               dz != 0.0f;
    const bool visit = z_ok && enters;
    const int zc = min(max(zj, 0), Z - 1);
    const bool occ_bit = ((c.colbits >> zc) & 1) != 0;
    const float s_exit = fminf(s_zb, c.t_exit);
    if (visit && occ_bit && !w.hit) {
      w.hit = true;
      w.hit_s = s_exit;
      w.hit_z = zj;
    }
    if (visit) {
      w.last_s = s_exit;
      w.last_z = zj;
      w.last_ok = true;
    }
  }
  return w;
}

__global__ void __launch_bounds__(128) fan_kernel(
    const int* __restrict__ cols,          // (G, X, Y) z-packed bitmasks
    const float* __restrict__ origins,     // (T, 3) voxel units
    const float* __restrict__ az_dirs,     // (A, 2)
    const float* __restrict__ pitch_dz,    // (K,)
    const float* __restrict__ pitch_scale,  // (K,)
    float* __restrict__ dist,              // (G, T, A, K)
    int* __restrict__ coord,               // (G, T, A, K, 3)
    uint8_t* __restrict__ hit_out,         // (G, T, A, K)
    int G, int T, int A, int K, int X, int Y, int Z, int N, int max_z_sub) {
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= (long long)G * T * A * K) return;
  const int k = (int)(ray % K);
  const int a = (int)(ray / K % A);
  const int t = (int)(ray / ((long long)K * A) % T);
  const int g = (int)(ray / ((long long)K * A * T));
  const int* col = cols + (long long)g * X * Y;

  // closed-form xy walk (`_column_walk`)
  const float ox = __ldg(origins + 3 * t), oy = __ldg(origins + 3 * t + 1);
  const float z0 = __ldg(origins + 3 * t + 2);
  const float d2[2] = {__ldg(az_dirs + 2 * a), __ldg(az_dirs + 2 * a + 1)};
  const float o2[2] = {ox, oy};
  int v0[2], st[2];
  float tmax0[2], tdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st[i] = d2[i] >= 0.0f ? 1 : -1;
    v0[i] = (int)floorf(o2[i]);
    const float nb = (float)v0[i] + (st[i] > 0 ? 1.0f : 0.0f);
    tmax0[i] = d2[i] != 0.0f ? __fsub_rn(nb, o2[i]) / d2[i] : kBig;
    tdelta[i] = d2[i] != 0.0f ? (float)st[i] / d2[i] : kBig;
  }
  const float dz = __ldg(pitch_dz + k);
  const int zstep = dz >= 0.0f ? 1 : -1;

  // merge of the two crossing progressions: y first on an exact tie (the
  // stable sort of [tY, tX]); ix / iy count the crossings taken so far
  int ix = 0, iy = 0;
  float t_prev = 0.0f;
  bool any_vis = false, any_hit = false;
  Crossing last = {0, 0, 0.0f, 0.0f, 0}, hitc = last;
  for (int n = 0; n < N; ++n) {
    const int vx = v0[0] + st[0] * ix, vy = v0[1] + st[1] * iy;
    const float tX = fmaf((float)ix, tdelta[0], tmax0[0]);
    const float tY = fmaf((float)iy, tdelta[1], tmax0[1]);
    const bool take_y = tY <= tX;
    const float t_exit = take_y ? tY : tX;
    const bool inside = vx >= 0 && vx < X && vy >= 0 && vy < Y;
    if (!inside && ((vx < 0 && st[0] < 0) || (vx >= X && st[0] > 0) ||
                    (vy < 0 && st[1] < 0) || (vy >= Y && st[1] > 0)))
      break;                                   // never (re)enters the grid
    if (inside) {
      // contiguous z-range crossed inside this column
      const float t_in = t_prev;
      const int zi = (int)floorf(fmaf(t_in, dz, z0));
      int extra = 0;
      for (int j = 1; j < max_z_sub; ++j)
        extra += (z_time(zi + j * zstep + (zstep < 0 ? 1 : 0), z0, dz) <
                  t_exit && dz != 0.0f) ? 1 : 0;
      const int z_far = zi + extra * zstep;
      const int zmin = min(zi, z_far), zmax = max(zi, z_far);
      if (max(zmin, 0) <= min(zmax, Z - 1)) {
        const int lo = min(max(zmin, 0), Z - 1);
        const int hi = min(max(zmax, 0), Z - 1);
        const int range_mask = ((1 << (hi - lo + 1)) - 1) << lo;
        const int bits = __ldg(col + (long long)vx * Y + vy);
        last = {vx, vy, t_in, t_exit, bits};
        any_vis = true;
        if (bits & range_mask) {
          hitc = last;
          any_hit = true;
          break;
        }
      }
    }
    t_prev = t_exit;
    if (take_y) ++iy; else ++ix;
  }

  float s = 0.0f;
  int cz = 0, cx = 0, cy = 0;
  bool hit = false;
  if (any_hit) {
    const SubWalk w = z_subwalk(hitc, z0, dz, zstep, Z, max_z_sub);
    hit = w.hit;
    if (hit) { s = w.hit_s; cx = hitc.vx; cy = hitc.vy; cz = w.hit_z; }
  }
  if (!hit && any_vis) {
    const SubWalk w = z_subwalk(last, z0, dz, zstep, Z, max_z_sub);
    if (w.last_ok) { s = w.last_s; cx = last.vx; cy = last.vy; cz = w.last_z; }
  }
  dist[ray] = __fmul_rn(s, __ldg(pitch_scale + k));
  coord[3 * ray] = cx;
  coord[3 * ray + 1] = cy;
  coord[3 * ray + 2] = cz;
  hit_out[ray] = hit ? 1 : 0;
}

}  // namespace

extern "C" int occ_dda_raymarch(const void* occ, const void* origins,
                                const void* dirs, void* dist, void* coord,
                                void* hit, long long R, int o_stride, int X,
                                int Y, int Z, int max_steps, void* stream) {
  const dim3 block(256);
  const dim3 grid((unsigned)((R + 255) / 256));
  dda_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<const float*>(origins),
      static_cast<const float*>(dirs), static_cast<float*>(dist),
      static_cast<int*>(coord), static_cast<uint8_t*>(hit), R, o_stride, X,
      Y, Z, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int occ_fan_raymarch(const void* cols, const void* origins,
                                const void* az_dirs, const void* pitch_dz,
                                const void* pitch_scale, void* dist,
                                void* coord, void* hit, int G, int T, int A,
                                int K, int X, int Y, int Z, int N,
                                int max_z_sub, void* stream) {
  const long long rays = (long long)G * T * A * K;
  const dim3 block(128);
  const dim3 grid((unsigned)((rays + 127) / 128));
  fan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(origins),
      static_cast<const float*>(az_dirs), static_cast<const float*>(pitch_dz),
      static_cast<const float*>(pitch_scale), static_cast<float*>(dist),
      static_cast<int*>(coord), static_cast<uint8_t*>(hit), G, T, A, K, X, Y,
      Z, N, max_z_sub);
  return (int)cudaGetLastError();
}
