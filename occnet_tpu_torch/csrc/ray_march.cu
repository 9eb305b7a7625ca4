// Voxel-traversal ray marchers of the evaluation path, each widened to the
// jitted JAX program it serves, so that one launch does the work of one XLA
// program:
//
// - dda_kernel: the per-ray DDA (occnet_tpu/ops/ray_march.py:32).  Its
//   render epilogue is the whole synthetic scene render, one jitted program
//   in the JAX package (occnet_tpu/data/synthetic.py:165): every camera's
//   pixel directions, the march, the label lookup, the shading and the
//   uint8 cast, for all C cameras of a scene.  Its raw epilogue returns
//   (dist, coord, hit) of given rays.
// - fan_kernel: the fan DDA (occnet_tpu/ops/ray_march_vec.py:123).  Its
//   render epilogue is the eval frame's render (`_render_grids_impl`,
//   occnet_tpu/evaluation/ray_metrics.py:149): up to two label grids
//   (prediction and ground truth) marched together, the distance in metres,
//   the label and the flow written pitch-major.  Its raw epilogue returns
//   the (G, T, A, K) dist / coord / hit of packed columns.
//
// Neither is a Pallas kernel in the JAX package: both are XLA programs that
// replaced the reference's CUDA voxel traversal (`dvr.render_forward`).
//
// What bounds them on the H100 is neither bytes (rays in, results out) nor
// fp32 operations (a handful a step) but latency: each step's dependent
// compare-select-add chain, its occupancy lookup, and warps whose rays stop
// at different depths.  So:
// - dda: each block packs the occupancy once into Z-bit column masks in
//   shared memory (200 x 200 x 16 voxels: 80 KB as uint16), and a step is a
//   bit test of a column word kept in a register, reloaded from shared
//   memory only when the ray changes (x, y) column.  Blocks stay resident
//   (as many as fit on the card) and loop over the work; in the render
//   epilogue a warp takes an 8 x 4 pixel tile, so its rays start together
//   and travel similar depths, and writes the tile's RGB bytes as words.
// - fan: every pitch ring of one (grid, origin, azimuth) crosses the same
//   xy columns.  A warp walks that column sequence once, 32 crossings at a
//   time, a lane a crossing with its column bits (the chunk's merge of the
//   x and y crossing progressions found by binary searches across the
//   lanes, not by 32 dependent steps); then each ring still scanning tests
//   the 32 crossings at once (ballots pick its first hit, else its last
//   visited crossing), so a ring that has hit, or has left the grid's
//   z-range for good, costs nothing more, and the warp stops when every
//   ring has.  A block serves one origin and tabulates each ring's
//   z-boundary times (zb - z0) / dz once in shared memory, so a crossing
//   no longer divides: the table holds the same divisions.
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
// `z0 + t_in * dz`, the norms' sums of squares, the shading) and every other
// product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn.  With
// fused crossing times an exact geometric tie (a 45-degree ray through a
// voxel corner) stays an exact tie.  Divisions stay true divisions and
// `expf` the accurate one (no fast math).  The scene render's directions
// are the port's torch expression, `u * R[0][j] + v * R[1][j] + R[2][j]`
// with one rounding an operation, from host-built u / v tables.
#include "common.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// per-ray DDA: occnet_tpu/ops/ray_march.py:32-112
// ---------------------------------------------------------------------------

constexpr int kDdaThreads = 768;
constexpr int kTileW = 8, kTileH = 4;                // a warp's pixel tile
constexpr int kStageBytes = kTileW * kTileH * 3;     // its RGB bytes

struct DdaGrid {
  const uint8_t* vox;   // (X, Y, Z) labels (render) or 0 / 1 occupancy (raw)
  int X, Y, Z;
  int empty;            // a voxel is occupied where vox != empty
  int max_steps;
};

struct DdaRays {        // raw epilogue
  const float* origins;  // (R, 3), row stride o_stride (0: one origin)
  const float* dirs;     // (R, 3)
  float* dist;           // (R,)
  int* coord;            // (R, 3)
  uint8_t* hit;          // (R,)
  long long R;
  int o_stride;
};

struct DdaScene {       // render epilogue
  const float* rot;      // (C, 3, 3) ego -> camera rotation
  const float* origin;   // (C, 3) camera centres, voxel units
  const float* u;        // (W,) (px + 0.5 - cx) / fx
  const float* v;        // (H,) (py + 0.5 - cy) / fy
  const float* tex;      // (8,) 0.85 + 0.15 * (hash / 7)
  const float* sky;      // (H, 3) sky colour of each row
  const float* palette;  // (classes, 3)
  uint8_t* img;          // (C, H, W, 3)
  int C, H, W;
  float voxel_size;
};

struct DdaHit {
  float dist;
  int x, y, z;
  bool hit;
};

// Bit z of a column of Z voxels set where the voxel differs from `empty`.
__device__ __forceinline__ uint32_t pack_column(const uint8_t* col, int Z,
                                                int empty) {
  uint32_t bits = 0;
  if ((Z & 15) == 0 && (reinterpret_cast<uintptr_t>(col) & 15) == 0) {
    for (int z0 = 0; z0 < Z; z0 += 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(col + z0));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        bits |= (uint32_t)(((ws[i >> 2] >> (8 * (i & 3))) & 0xffu) !=
                           (uint32_t)empty) << (z0 + i);
    }
  } else {
    for (int z = 0; z < Z; ++z)
      bits |= (uint32_t)((int)__ldg(col + z) != empty) << z;
  }
  return bits;
}

// One ray through the packed grid, the JAX loop's results: the exit
// distance and voxel of the first occupied voxel, else of the last voxel
// visited, else zeros.  The loop of the JAX program in two phases with the
// same steps: outside, step until the ray enters (or moves away); inside,
// test the voxel, then advance one axis and check only that axis' bound.
template <typename ColT>
__device__ __forceinline__ DdaHit march(const ColT* cols, const DdaGrid& g,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  // |dir| as XLA sums it: fma(z, z, fma(y, y, x * x))
  const float nrm =
      fmaxf(sqrtf(fmaf(dz, dz, fmaf(dy, dy, __fmul_rn(dx, dx)))), 1e-12f);
  const float ux = dx / nrm, uy = dy / nrm, uz = dz / nrm;
  int vx = (int)floorf(ox), vy = (int)floorf(oy), vz = (int)floorf(oz);
  const int sx = ux >= 0.0f ? 1 : -1, sy = uy >= 0.0f ? 1 : -1,
            sz = uz >= 0.0f ? 1 : -1;
  // XLA rewrites x / (dir / nrm) as (x * nrm) / dir
  float tx = ux != 0.0f
                 ? __fmul_rn(__fsub_rn((float)vx + (sx > 0 ? 1.0f : 0.0f), ox),
                             nrm) / dx
                 : kBig;
  float ty = uy != 0.0f
                 ? __fmul_rn(__fsub_rn((float)vy + (sy > 0 ? 1.0f : 0.0f), oy),
                             nrm) / dy
                 : kBig;
  float tz = uz != 0.0f
                 ? __fmul_rn(__fsub_rn((float)vz + (sz > 0 ? 1.0f : 0.0f), oz),
                             nrm) / dz
                 : kBig;
  const float ddx = ux != 0.0f ? __fmul_rn((float)sx, nrm) / dx : kBig;
  const float ddy = uy != 0.0f ? __fmul_rn((float)sy, nrm) / dy : kBig;
  const float ddz = uz != 0.0f ? __fmul_rn((float)sz, nrm) / dz : kBig;
  // never-entered rays: zeros (dvr.cu leaves its outputs zero-initialised)
  const DdaHit none = {0.0f, 0, 0, 0, false};
  int s = 0;
  for (;; ++s) {                               // outside the grid
    if (s >= g.max_steps) return none;
    if ((unsigned)vx < (unsigned)g.X && (unsigned)vy < (unsigned)g.Y &&
        (unsigned)vz < (unsigned)g.Z)
      break;
    // moving away along some axis: never enters
    if ((vx < 0 && ux < 0.0f) || (vx >= g.X && ux > 0.0f) ||
        (vy < 0 && uy < 0.0f) || (vy >= g.Y && uy > 0.0f) ||
        (vz < 0 && uz < 0.0f) || (vz >= g.Z && uz > 0.0f))
      return none;
    // advancing axis with the kernel's nested strict comparisons
    if (tx < ty && tx < tz) {
      vx += sx;
      tx = __fadd_rn(tx, ddx);
    } else if (!(tx < ty) && ty < tz) {
      vy += sy;
      ty = __fadd_rn(ty, ddy);
    } else {
      vz += sz;
      tz = __fadd_rn(tz, ddz);
    }
  }
  // inside: step s visits (vx, vy, vz); the column's bits stay in `col`
  // while the ray keeps its (x, y)
  uint32_t col = cols[vx * g.Y + vy];
  DdaHit h;
  h.hit = false;
  for (;;) {
    h.dist = fminf(fminf(tx, ty), tz);         // exit distance of the voxel
    if ((col >> vz) & 1u) {
      h.hit = true;
      break;
    }
    if (++s >= g.max_steps) break;
    if (tx < ty && tx < tz) {
      vx += sx;
      tx = __fadd_rn(tx, ddx);
      if ((unsigned)vx >= (unsigned)g.X) {     // left the grid: done
        vx -= sx;
        break;
      }
      col = cols[vx * g.Y + vy];
    } else if (!(tx < ty) && ty < tz) {
      vy += sy;
      ty = __fadd_rn(ty, ddy);
      if ((unsigned)vy >= (unsigned)g.Y) {
        vy -= sy;
        break;
      }
      col = cols[vx * g.Y + vy];
    } else {
      vz += sz;
      tz = __fadd_rn(tz, ddz);
      if ((unsigned)vz >= (unsigned)g.Z) {
        vz -= sz;
        break;
      }
    }
  }
  h.x = vx;
  h.y = vy;
  h.z = vz;
  return h;
}

// The render epilogue of one pixel: `render_views` of the port, in its
// operation order.
template <typename ColT>
__device__ __forceinline__ void render_pixel(const ColT* cols,
                                             const DdaGrid& g,
                                             const DdaScene& sc, int c,
                                             int px, int py, uint8_t* rgb) {
  const float uu = __ldg(sc.u + px), vv = __ldg(sc.v + py);
  const float* R = sc.rot + 9 * c;
  float d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    d[j] = __fadd_rn(__fadd_rn(__fmul_rn(uu, __ldg(R + j)),
                               __fmul_rn(vv, __ldg(R + 3 + j))),
                     __ldg(R + 6 + j));
  const float* o = sc.origin + 3 * c;
  const DdaHit h = march(cols, g, __ldg(o), __ldg(o + 1), __ldg(o + 2), d[0],
                         d[1], d[2]);
  float col[3];
  if (h.hit) {
    const int label =
        __ldg(g.vox + ((long long)h.x * g.Y + h.y) * g.Z + h.z);
    // shade = 0.35 + 0.65 * exp(-dist_m / 25) as one fma; the texture of
    // the voxel hash (x * 7 + y * 13 + z * 3) % 8
    const float dm = __fmul_rn(h.dist, sc.voxel_size);
    const float shade = fmaf(expf(__fdiv_rn(-dm, 25.0f)), 0.65f, 0.35f);
    const float st = __fmul_rn(
        shade, __ldg(sc.tex + ((h.x * 7 + h.y * 13 + h.z * 3) & 7)));
#pragma unroll
    for (int i = 0; i < 3; ++i)
      col[i] = __fmul_rn(__ldg(sc.palette + 3 * label + i), st);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) col[i] = __ldg(sc.sky + 3 * py + i);
  }
  // clamp(img * 255, 0, 255), then the truncating cast
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rgb[i] = (uint8_t)fminf(fmaxf(__fmul_rn(col[i], 255.0f), 0.0f), 255.0f);
}

__host__ __device__ constexpr size_t cols_bytes(int X, int Y, size_t word) {
  return ((size_t)X * Y * word + 15) & ~(size_t)15;
}

template <bool kRender, typename ColT>
__global__ void __launch_bounds__(kDdaThreads, 2)
    dda_kernel(DdaGrid g, DdaRays rays, DdaScene sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  ColT* cols = reinterpret_cast<ColT*>(smem);
  const int n_cols = g.X * g.Y;
  for (int c = threadIdx.x; c < n_cols; c += blockDim.x)
    cols[c] = (ColT)pack_column(g.vox + (long long)c * g.Z, g.Z, g.empty);
  __syncthreads();

  if constexpr (!kRender) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < rays.R; r += stride) {
      const float* o = rays.origins + (long long)rays.o_stride * r;
      const float* d = rays.dirs + 3 * r;
      const DdaHit h = march(cols, g, __ldg(o), __ldg(o + 1), __ldg(o + 2),
                             __ldg(d), __ldg(d + 1), __ldg(d + 2));
      rays.dist[r] = h.dist;
      rays.coord[3 * r] = h.x;
      rays.coord[3 * r + 1] = h.y;
      rays.coord[3 * r + 2] = h.z;
      rays.hit[r] = h.hit ? 1 : 0;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    uint8_t* stage =
        smem + cols_bytes(g.X, g.Y, sizeof(ColT)) + warp * kStageBytes;
    const int tiles_x = (sc.W + kTileW - 1) / kTileW;
    const int tiles_y = (sc.H + kTileH - 1) / kTileH;
    const long long n_tiles = (long long)sc.C * tiles_x * tiles_y;
    const int tx_in = lane % kTileW, ty_in = lane / kTileW;
    for (long long tile = (long long)blockIdx.x * warps + warp;
         tile < n_tiles; tile += (long long)gridDim.x * warps) {
      const int tx = (int)(tile % tiles_x);
      const long long rest = tile / tiles_x;
      const int ty = (int)(rest % tiles_y), c = (int)(rest / tiles_y);
      const int px = tx * kTileW + tx_in, py = ty * kTileH + ty_in;
      const bool live = px < sc.W && py < sc.H;
      uint8_t rgb[3] = {0, 0, 0};
      if (live) render_pixel(cols, g, sc, c, px, py, rgb);
      // a whole tile whose rows start on 4-byte boundaries: 24 lanes write
      // the tile's 4 rows of 24 bytes as words; else each pixel its bytes
      const bool whole = (tx + 1) * kTileW <= sc.W &&
                         (ty + 1) * kTileH <= sc.H && (sc.W & 3) == 0;
      if (whole) {
        stage[3 * lane] = rgb[0];
        stage[3 * lane + 1] = rgb[1];
        stage[3 * lane + 2] = rgb[2];
        __syncwarp();
        if (lane < kTileH * 6) {
          const int r = lane / 6, w = lane % 6;
          uint8_t* row = sc.img + (((long long)c * sc.H + ty * kTileH + r) *
                                       sc.W + tx * kTileW) * 3;
          *reinterpret_cast<uint32_t*>(row + 4 * w) =
              *reinterpret_cast<const uint32_t*>(stage + 24 * r + 4 * w);
        }
        __syncwarp();
      } else if (live) {
        uint8_t* p = sc.img + (((long long)c * sc.H + py) * sc.W + px) * 3;
        p[0] = rgb[0];
        p[1] = rgb[1];
        p[2] = rgb[2];
      }
    }
  }
}

// Launches dda_kernel with as many resident blocks as the card holds, and
// no more than ``work`` threads need.
template <bool kRender, typename ColT>
cudaError_t launch_dda(const DdaGrid& g, const DdaRays& rays,
                       const DdaScene& sc, long long work,
                       cudaStream_t stream) {
  const size_t smem = cols_bytes(g.X, g.Y, sizeof(ColT)) +
                      (kRender ? (kDdaThreads / 32) * kStageBytes : 0);
  auto kern = dda_kernel<kRender, ColT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kDdaThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  long long blocks = (work + kDdaThreads - 1) / kDdaThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kDdaThreads, smem, stream>>>(g, rays, sc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fan DDA: occnet_tpu/ops/ray_march_vec.py:43-227
// ---------------------------------------------------------------------------

constexpr int kFanWarps = 8;       // (grid, azimuth) items of a block
constexpr int kFanMaxRings = 64;   // pitch rings: one bit each of a mask

struct FanGrid {        // render epilogue: one grid's labels and flow
  const void* labels;   // (X, Y, Z) integers of label_bytes (1, 4 or 8)
  const void* flow;     // (X, Y, Z, 2) fp32 (flow_bytes 4) or bf16 (2)
  int label_bytes, flow_bytes;
};

struct FanArgs {
  const int* cols;           // raw: (G, X, Y) z-packed bitmasks
  FanGrid grid[2];           // render: G <= 2 grids
  int free_id;               // render: the label of an empty voxel
  const float* origins;      // (T, 3) voxel units
  const float* az_dirs;      // (A, 2)
  const float* pitch_dz;     // (K,)
  const float* pitch_scale;  // (K,)
  float* dist;     // raw (G, T, A, K) voxel units; render (G, T, K*A) m
  int* coord;      // raw (G, T, A, K, 3)
  uint8_t* hit;    // raw (G, T, A, K)
  int* label;      // render (G, T, K*A)
  float* flow;     // render (G, T, K*A, 2)
  int G, T, A, K, X, Y, Z, N, max_z_sub;
  float voxel_size;
};

// A place of the xy walk's merge: the x and y crossings taken before it
// and its time.
struct Step {
  int ix, iy;
  float t;
};

// One column crossing of the xy walk: its column, entry and exit times and
// the column's occupancy bits.
struct Crossing {
  int vx, vy;
  float t_in, t_exit;
  uint32_t bits;
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

// z-boundary indices a ring can need: zb in [zlo, zhi] (see fan_kernel)
__host__ __device__ constexpr int z_lo(int max_z_sub) {
  return 2 - max_z_sub < 0 ? 2 - max_z_sub : 0;
}
__host__ __device__ constexpr int z_count(int Z, int max_z_sub) {
  return (max_z_sub > 2 ? Z + max_z_sub - 2 : Z) - z_lo(max_z_sub) + 1;
}

// `_z_subwalk` (ray_march_vec.py:81-119) at one crossing; tab[zb] is
// z_time(zb) of the ring
__device__ __forceinline__ SubWalk z_subwalk(float t_in, float t_exit,
                                             uint32_t bits,
                             float z0, float dz, int zstep, int Z,
                             int max_z_sub, const float* tab) {
  SubWalk w = {false, false, 0.0f, 0.0f, 0, 0};
  const int zi = (int)floorf(fmaf(t_in, dz, z0));
  for (int j = 0; j < max_z_sub; ++j) {
    const int zj = zi + j * zstep;
    if (zj < 0 || zj >= Z) continue;
    if (j > 0 && !(tab[zj + (zstep < 0 ? 1 : 0)] < t_exit && dz != 0.0f))
      continue;
    const float s_exit = fminf(tab[zj + (zstep > 0 ? 1 : 0)], t_exit);
    if (((bits >> zj) & 1u) && !w.hit) {
      w.hit = true;
      w.hit_s = s_exit;
      w.hit_z = zj;
    }
    w.last_s = s_exit;
    w.last_z = zj;
    w.last_ok = true;
  }
  return w;
}

__device__ __forceinline__ long long load_label(const FanGrid& gr,
                                                long long i) {
  if (gr.label_bytes == 8)
    return __ldg(static_cast<const long long*>(gr.labels) + i);
  if (gr.label_bytes == 4) return __ldg(static_cast<const int*>(gr.labels) + i);
  return __ldg(static_cast<const uint8_t*>(gr.labels) + i);
}

// Bit z of column `col` (x * Y + y) set where its label is not free.
__device__ uint32_t label_column(const FanGrid& gr, long long col, int Z,
                                 int free_id) {
  const int lb = gr.label_bytes;
  const char* p = static_cast<const char*>(gr.labels) + col * Z * lb;
  uint32_t bits = 0;
  if (((Z * lb) & 15) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const int per = 16 / lb;
    for (int w = 0; w < Z / per; ++w) {
      const uint4 x = __ldg(q + w);
      const uint32_t u[4] = {x.x, x.y, x.z, x.w};
      const int z0 = w * per;
      if (lb == 8) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const long long v = (long long)(((unsigned long long)u[2 * i + 1]
                                           << 32) | u[2 * i]);
          bits |= (uint32_t)(v != free_id) << (z0 + i);
        }
      } else if (lb == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bits |= (uint32_t)((int)u[i] != free_id) << (z0 + i);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          bits |= (uint32_t)((int)((u[i >> 2] >> (8 * (i & 3))) & 0xffu) !=
                             free_id) << (z0 + i);
      }
    }
  } else {
    for (int z = 0; z < Z; ++z)
      bits |= (uint32_t)(load_label(gr, col * Z + z) != free_id) << z;
  }
  return bits;
}

__device__ __forceinline__ float flow_at(const FanGrid& gr, long long i) {
  if (gr.flow_bytes == 4) return __ldg(static_cast<const float*>(gr.flow) + i);
  // bf16 -> fp32 is exact: the bf16 bits are the fp32 value's top half
  return __uint_as_float(
      (uint32_t)__ldg(static_cast<const unsigned short*>(gr.flow) + i) << 16);
}

// kZSub: max_z_sub fixed at compile time (0: p.max_z_sub)
template <bool kRender, int kZSub>
__global__ void __launch_bounds__(kFanWarps * 32, 6) fan_kernel(FanArgs p) {
  const int msub = kZSub > 0 ? kZSub : p.max_z_sub;
  // z_time(zb) of every ring of this block's origin, zb in [zlo, zhi]:
  // within a crossing whose z-range can be nonempty, a ring needs no other
  // zb (an upward ring's entry voxel zi in [1 - max_z_sub, Z - 1], a
  // downward ring's in [0, Z + max_z_sub - 2]; outside them the range is
  // empty whatever the extra voxels); then each warp's ring records
  extern __shared__ float ztab[];
  const int t = blockIdx.y;
  const int zlo = z_lo(msub), ntab = z_count(p.Z, msub);
  const float ox = __ldg(p.origins + 3 * t), oy = __ldg(p.origins + 3 * t + 1);
  const float z0 = __ldg(p.origins + 3 * t + 2);
  for (int i = threadIdx.x; i < p.K * ntab; i += blockDim.x)
    ztab[i] = z_time(zlo + i % ntab, z0, __ldg(p.pitch_dz + i / ntab));
  for (int k = threadIdx.x; k < p.K; k += blockDim.x)
    ztab[p.K * ntab + k] = __ldg(p.pitch_dz + k);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kFanWarps + warp;
  if (item >= p.G * p.A) return;
  const int g = item / p.A, a = item % p.A;
  const float* dzs = ztab + p.K * ntab;                // (K,) pitch_dz
  Crossing* rec = reinterpret_cast<Crossing*>(ztab + p.K * (ntab + 1)) +
                  warp * kFanMaxRings;
  Step* slot = reinterpret_cast<Step*>(
      reinterpret_cast<Crossing*>(ztab + p.K * (ntab + 1)) +
      kFanWarps * kFanMaxRings) + warp * 32;

  // the closed-form xy walk (`_column_walk`), the same on every lane
  const float d2[2] = {__ldg(p.az_dirs + 2 * a), __ldg(p.az_dirs + 2 * a + 1)};
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

  // rings still scanning (bit k), rings with a visited crossing, rings hit;
  // the same on every lane
  const uint64_t all = p.K == 64 ? ~0ull : (1ull << p.K) - 1ull;
  uint64_t done = 0, vis = 0, hits = 0;
  // ix / iy count the x / y crossings taken so far; t_prev is the last
  // crossing's time
  int ix = 0, iy = 0;
  float t_prev = 0.0f;
  for (int n0 = 0; n0 < p.N; n0 += 32) {
    // the next 32 crossings of the walk, lane j keeping crossing n0 + j.
    // Lane l holds crossing ix + l of the x progression and iy + l of the
    // y one; each finds its place in the merge by a binary search over the
    // other progression's 32 times (a y crossing goes first on an exact
    // tie, as the stable sort of [tY, tX]), and the first 32 places are
    // handed out through shared memory.
    const float tx = fmaf((float)(ix + lane), tdelta[0], tmax0[0]);
    const float ty = fmaf((float)(iy + lane), tdelta[1], tmax0[1]);
    int ys = 0, xs = 0;     // y times <= tx, x times < ty, of the 32 each
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, ty, ys + step - 1) <= tx) ys += step;
      if (__shfl_sync(kFull, tx, xs + step - 1) < ty) xs += step;
    }
    const float ty_last = __shfl_sync(kFull, ty, 31);
    const float tx_last = __shfl_sync(kFull, tx, 31);
    if (ys == 31 && ty_last <= tx) ys = 32;
    if (xs == 31 && tx_last < ty) xs = 32;
    if (lane + ys < 32) slot[lane + ys] = {ix + lane, iy + ys, tx};
    if (lane + xs < 32) slot[lane + xs] = {ix + xs, iy + lane, ty};
    __syncwarp();
    const Step m = slot[lane];
    __syncwarp();
    const float before_t = __shfl_up_sync(kFull, m.t, 1);
    Crossing c = {v0[0] + st[0] * m.ix, v0[1] + st[1] * m.iy,
                  lane ? before_t : t_prev, m.t, 0};
    const int taken_x = __popc(__ballot_sync(kFull, lane + ys < 32));
    t_prev = __shfl_sync(kFull, m.t, 31);
    ix += taken_x;
    iy += 32 - taken_x;
    const bool inside = c.vx >= 0 && c.vx < p.X && c.vy >= 0 && c.vy < p.Y;
    // past the cap, or outside and never (re)entering: the walk ends
    const bool stop =
        n0 + lane >= p.N ||
        (!inside && ((c.vx < 0 && st[0] < 0) || (c.vx >= p.X && st[0] > 0) ||
                     (c.vy < 0 && st[1] < 0) || (c.vy >= p.Y && st[1] > 0)));
    const unsigned stops = __ballot_sync(kFull, stop);
    const unsigned before = stops ? (1u << (__ffs(stops) - 1)) - 1u : kFull;
    const bool live = inside && ((before >> lane) & 1u);
    if (live) {
      const long long col = (long long)c.vx * p.Y + c.vy;
      if constexpr (kRender)
        c.bits = label_column(p.grid[g], col, p.Z, p.free_id);
      else
        c.bits = (uint32_t)__ldg(p.cols + (long long)g * p.X * p.Y + col);
    }
    // each ring still scanning tests the 32 crossings at once, a lane each
    for (uint64_t todo = all & ~done; todo; todo &= todo - 1) {
      const int k = __ffsll((long long)todo) - 1;
      const float dz = dzs[k];
      const int zstep = dz >= 0.0f ? 1 : -1;
      // contiguous z-range crossed inside this column
      const int zi = (int)floorf(fmaf(c.t_in, dz, z0));
      // above the grid going up, below it going down: never again
      const bool gone = zstep > 0 ? zi >= p.Z : zi < 0;
      bool visit = false, hit = false;
      if (live && !gone &&
          (zstep > 0 ? zi >= 1 - msub : zi <= p.Z + msub - 2)) {
        const float* tab = ztab + k * ntab - zlo;
        int extra = 0;
        for (int j = 1; j < msub; ++j)
          extra += (tab[zi + j * zstep + (zstep < 0 ? 1 : 0)] < c.t_exit &&
                    dz != 0.0f) ? 1 : 0;
        const int z_far = zi + extra * zstep;
        const int zmin = min(zi, z_far), zmax = max(zi, z_far);
        if (max(zmin, 0) <= min(zmax, p.Z - 1)) {
          const int lo = min(max(zmin, 0), p.Z - 1);
          const int hi = min(max(zmax, 0), p.Z - 1);
          const uint32_t span = (uint32_t)(hi - lo + 1);
          visit = true;
          hit = (c.bits & ((span >= 32 ? kFull : ((1u << span) - 1u))
                           << lo)) != 0;
        }
      }
      const unsigned hb = __ballot_sync(kFull, hit);
      const unsigned vb = __ballot_sync(kFull, visit);
      const uint64_t bit = 1ull << k;
      if (hb | vb) {
        // the first hit, else the last visited crossing of the chunk
        const int j = hb ? __ffs(hb) - 1 : 31 - __clz(vb);
        if (lane == j) rec[k] = c;
        vis |= bit;
        if (hb) hits |= bit;
      }
      if (hb || __ballot_sync(kFull, gone && ((before >> lane) & 1u)))
        done |= bit;
    }
    if (stops || done == all) break;
  }
  __syncwarp();

  // the z-sub-walk at the ring's hit crossing, else at its last visited one
  for (int k = lane; k < p.K; k += 32) {
    const uint64_t bit = 1ull << k;
    const float dz = __ldg(p.pitch_dz + k);
    float sv = 0.0f;
    int cx = 0, cy = 0, cz = 0;
    bool hit = false;
    if (vis & bit) {
      const Crossing r = rec[k];
      const SubWalk w = z_subwalk(r.t_in, r.t_exit, r.bits, z0, dz,
                                  dz >= 0.0f ? 1 : -1, p.Z, msub,
                                  ztab + k * ntab - zlo);
      if ((hits & bit) && w.hit) {
        hit = true;
        sv = w.hit_s;
        cz = w.hit_z;
      } else if (w.last_ok) {
        sv = w.last_s;
        cz = w.last_z;
      }
      if (hit || w.last_ok) {
        cx = r.vx;
        cy = r.vy;
      }
    }
    const float dist = __fmul_rn(sv, __ldg(p.pitch_scale + k));
    if constexpr (kRender) {
      // pitch-major (G, T, K * A); label and flow of the voxel
      const long long o = (((long long)g * p.T + t) * p.K + k) * p.A + a;
      const long long v = ((long long)cx * p.Y + cy) * p.Z + cz;
      p.dist[o] = __fmul_rn(dist, p.voxel_size);
      p.label[o] = (int)load_label(p.grid[g], v);
      p.flow[2 * o] = flow_at(p.grid[g], 2 * v);
      p.flow[2 * o + 1] = flow_at(p.grid[g], 2 * v + 1);
    } else {
      const long long o = (((long long)g * p.T + t) * p.A + a) * p.K + k;
      p.dist[o] = dist;
      p.coord[3 * o] = cx;
      p.coord[3 * o + 1] = cy;
      p.coord[3 * o + 2] = cz;
      p.hit[o] = hit ? 1 : 0;
    }
  }
}

template <bool kRender>
cudaError_t launch_fan(const FanArgs& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)p.K * (z_count(p.Z, p.max_z_sub) + 1) * sizeof(float) +
      kFanWarps * (kFanMaxRings * sizeof(Crossing) + 32 * sizeof(Step));
  const dim3 grid((unsigned)((p.G * p.A + kFanWarps - 1) / kFanWarps),
                  (unsigned)p.T);
  if (p.max_z_sub == 4)                        // the eval fan's cap
    fan_kernel<kRender, 4><<<grid, kFanWarps * 32, smem, stream>>>(p);
  else
    fan_kernel<kRender, 0><<<grid, kFanWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int occ_dda_raymarch(const void* occ, const void* origins,
                                const void* dirs, void* dist, void* coord,
                                void* hit, long long R, int o_stride, int X,
                                int Y, int Z, int max_steps, void* stream) {
  const DdaGrid g = {static_cast<const uint8_t*>(occ), X, Y, Z, 0, max_steps};
  const DdaRays rays = {static_cast<const float*>(origins),
                        static_cast<const float*>(dirs),
                        static_cast<float*>(dist), static_cast<int*>(coord),
                        static_cast<uint8_t*>(hit), R, o_stride};
  const DdaScene sc = {};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(Z <= 16 ? launch_dda<false, uint16_t>(g, rays, sc, R, s)
                       : launch_dda<false, uint32_t>(g, rays, sc, R, s));
}

extern "C" int occ_render_views(const void* labels, int free_id, int X,
                                int Y, int Z, int max_steps, const void* rot,
                                const void* origin, const void* u,
                                const void* v, const void* tex,
                                const void* sky, const void* palette,
                                void* img, int C, int H, int W,
                                float voxel_size, void* stream) {
  const DdaGrid g = {static_cast<const uint8_t*>(labels), X, Y, Z, free_id,
                     max_steps};
  const DdaRays rays = {};
  const DdaScene sc = {static_cast<const float*>(rot),
                       static_cast<const float*>(origin),
                       static_cast<const float*>(u),
                       static_cast<const float*>(v),
                       static_cast<const float*>(tex),
                       static_cast<const float*>(sky),
                       static_cast<const float*>(palette),
                       static_cast<uint8_t*>(img), C, H, W, voxel_size};
  const long long tiles = (long long)C * ((H + kTileH - 1) / kTileH) *
                          ((W + kTileW - 1) / kTileW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(Z <= 16
                   ? launch_dda<true, uint16_t>(g, rays, sc, 32 * tiles, s)
                   : launch_dda<true, uint32_t>(g, rays, sc, 32 * tiles, s));
}

extern "C" int occ_fan_raymarch(const void* cols, const void* origins,
                                const void* az_dirs, const void* pitch_dz,
                                const void* pitch_scale, void* dist,
                                void* coord, void* hit, int G, int T, int A,
                                int K, int X, int Y, int Z, int N,
                                int max_z_sub, void* stream) {
  FanArgs p = {};
  p.cols = static_cast<const int*>(cols);
  p.origins = static_cast<const float*>(origins);
  p.az_dirs = static_cast<const float*>(az_dirs);
  p.pitch_dz = static_cast<const float*>(pitch_dz);
  p.pitch_scale = static_cast<const float*>(pitch_scale);
  p.dist = static_cast<float*>(dist);
  p.coord = static_cast<int*>(coord);
  p.hit = static_cast<uint8_t*>(hit);
  p.G = G; p.T = T; p.A = A; p.K = K;
  p.X = X; p.Y = Y; p.Z = Z; p.N = N; p.max_z_sub = max_z_sub;
  return (int)launch_fan<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int occ_fan_render(const void* labels0, const void* flow0,
                              int label_bytes0, int flow_bytes0,
                              const void* labels1, const void* flow1,
                              int label_bytes1, int flow_bytes1, int free_id,
                              const void* origins, const void* az_dirs,
                              const void* pitch_dz, const void* pitch_scale,
                              void* dist, void* label, void* flow, int G,
                              int T, int A, int K, int X, int Y, int Z, int N,
                              int max_z_sub, float voxel_size, void* stream) {
  FanArgs p = {};
  p.grid[0] = {labels0, flow0, label_bytes0, flow_bytes0};
  p.grid[1] = {labels1, flow1, label_bytes1, flow_bytes1};
  p.free_id = free_id;
  p.origins = static_cast<const float*>(origins);
  p.az_dirs = static_cast<const float*>(az_dirs);
  p.pitch_dz = static_cast<const float*>(pitch_dz);
  p.pitch_scale = static_cast<const float*>(pitch_scale);
  p.dist = static_cast<float*>(dist);
  p.label = static_cast<int*>(label);
  p.flow = static_cast<float*>(flow);
  p.G = G; p.T = T; p.A = A; p.K = K;
  p.X = X; p.Y = Y; p.Z = Z; p.N = N; p.max_z_sub = max_z_sub;
  p.voxel_size = voxel_size;
  return (int)launch_fan<true>(p, static_cast<cudaStream_t>(stream));
}
