// Planar-homography lift backward, one FPN level: the exact transpose of
// lift.cu, as a gather.  Every feature-gradient pixel is
//
//   dfeat[b,a,pixel(k,j),:] = sum over the cells (zr, m) that read it of
//       hat(pos2 - k) * hat(pos1[k] - j) * inv_count[b,r,m] * g[b,zr,m,:]
//
// over the same <= 2 x 2 taps, with the same skip rules (dead position
// p <= -1, tap outside [0, n)) and the same __fmul_rn(w2, w1) weight as the
// forward sampler.
//
// Replaces the two Pallas kernels of the TPU lift backward
// (occnet_tpu/ops/lift_pallas.py): `_pass2_bwd_kernel` (:493, dtmp =
// W2^T (g * inv_count)) and `_pass1_bwd_kernel` (:270, dfeat = W1^T dtmp
// accumulated over zr blocks).  The TPU carried dfeat across a sequential
// zr grid axis in VMEM and needed a ~1 GB dtmp buffer for it.
//
// Design.  A plane (camera, z-anchor, BEV row) maps its BEV columns m onto
// its image line by one Moebius function, monotone over the plane's one run
// of live cells, so the cells whose pass-2 hat reaches line tap k are one
// contiguous run [m_lo, m_hi).  `lift_bwd_index_kernel` writes, per line
// (b, camera, kk: image column kk in pass order A, image row kk - w in
// order B) and plane, that run and the plane's pass-1 position pos1[kk],
// a warp a plane, and counts the (cell, tap) pairs its runs cover beyond
// the live taps (0 when the premise holds; the wrapper raises otherwise).
// `lift_bwd_kernel` gives a block to one line and one chunk of channels.
// It sorts the line's planes by the pixel j0 = floor(pos1) they reach (a
// stable radix sort in shared memory, so ties stay in plane order), takes
// the prefix sum of their run lengths, and splits the line's cells evenly
// over its lane groups (8 channels a lane, 16-byte loads of g, 4 cells in
// flight), whatever the pixels they reach: where far cells crowd near the
// horizon, many groups share a pixel.  A group walks its cells in pixel
// order with running sums of the pixels j0 and j0 + 1 and writes each pixel
// it alone reaches once; the <= 4 pixels it may share with its neighbours
// (its first two and last two) go to shared memory, and the block adds
// them in group order at the end.  Order A writes every pixel of an fp32
// scratch; order B reads it, adds its own sums and writes every pixel of
// dfeat in the caller's type (in place when that is fp32).  Each element
// has one writer a launch and a fixed summation order: no atomic adds into
// dfeat, no zeroing, and two runs give bitwise equal results.  A line of more than
// kTile planes is walked in tiles, its pixels carried in the fp32 scratch.
//
// Bound on the H100: the g read (B x 8 x 40000 x 256 bf16 = 164 MB per level
// at full width; each cell is read once per tap and camera that reach it,
// the second read mostly from L2) and the fp32 scratch round trip plus the
// output (355 MB at level 0, B = 1).  Each block also reads its line's
// index (8 bytes a plane: 24 MB at level 0, once per channel chunk).
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                     // planes a thread sorts
constexpr int kTile = kThreads * kItems;      // planes a block sorts at once
constexpr int kUnroll = 4;                    // cells of a group in flight
constexpr int kSlots = 4;                     // shared pixels of a group
constexpr int kPlanes = kThreads / 32;        // planes an index block takes
constexpr int kPartFloats = kThreads * 8 * kSlots;  // groups x slots x chunk

struct Level {
  int B, A, h, w, C, ZR, R, M;
};

// the per-plane index: a warp a plane (b, a, zr), its lanes over m, and
// kPlanes consecutive planes a block, so that each line's slots of the
// block's planes are written as one contiguous run
__global__ void __launch_bounds__(kThreads) lift_bwd_index_kernel(
    const float* __restrict__ pos1,          // (B, A, ZR, w + h)
    const float* __restrict__ pos2,          // (B, A, ZR, M)
    const uint8_t* __restrict__ steep,       // (B, A, ZR)
    int2* __restrict__ runs,                 // (B, A, w + h, ZR)
    unsigned long long* __restrict__ excess, // (1,), zeroed by the caller
    long long planes, int ZR, int M, int h, int w) {
  extern __shared__ int index_sh[];          // [kPlanes][lo, hi, pos1][K1]
  __shared__ int warp_sum[kPlanes];
  const int K1 = w + h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long plane0 = (long long)blockIdx.x * kPlanes;
  const long long plane = plane0 + warp;
  int* lo = index_sh + warp * 3 * K1;
  int* hi = lo + K1;
  int* p1 = hi + K1;
  int count = 0;                              // covered minus live pairs
  if (plane < planes) {
    for (int kk = lane; kk < K1; kk += 32) {
      lo[kk] = M;
      hi[kk] = -1;
      p1[kk] = __float_as_int(pos1[plane * K1 + kk]);
    }
    __syncwarp();
    const bool st = steep[plane] != 0;
    const int n2 = st ? h : w;
    const int kk0 = st ? w : 0;
    for (int m = lane; m < M; m += 32) {
      const float p = pos2[plane * M + m];
      if (p <= -1.0f) continue;
      const int k0 = (int)floorf(p);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int k = k0 + dk;
        if (k < 0 || k >= n2) continue;
        atomicMin(lo + kk0 + k, m);           // integer min / max: the same
        atomicMax(hi + kk0 + k, m);           // result in any order
        --count;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K1 * kPlanes; i += kThreads) {
    const int q = i % kPlanes;                // the block's planes fastest
    const int kk = i / kPlanes;
    const long long pl = plane0 + q;
    if (pl >= planes) continue;
    const int* ql = index_sh + q * 3 * K1;
    const int l = ql[kk];
    const int u = ql[K1 + kk];
    int packed = 0;
    if (u >= l) {
      count += u - l + 1;
      packed = l | ((u + 1) << 16);
    }
    runs[(pl / ZR * K1 + kk) * ZR + pl % ZR] = make_int2(packed,
                                                         ql[2 * K1 + kk]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(~0u, count, o);
  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kPlanes; ++i) total += warp_sum[i];
    if (total != 0) atomicAdd(excess, (unsigned long long)total);
  }
}

// 8 fp32 channels through the coherent path (not __ldg): the scratch is
// written by this kernel itself
__device__ __forceinline__ void load8_plain(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// pixel j of the block's line: order A stores (or, after the first tile,
// adds into) the fp32 scratch; order B adds the scratch and stores dfeat in
// its type at the last tile, else adds into the scratch
template <typename OutT, bool kOrderB>
__device__ __forceinline__ void write_pixel(const Level& L, long long ba,
                                            int k, int j, int c0,
                                            const float* acc, float* tmp,
                                            OutT* out, bool first,
                                            bool last) {
  const int y = kOrderB ? k : j;
  const int x = kOrderB ? j : k;
  const long long off = ((ba * L.h + y) * L.w + x) * L.C + c0;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = acc[i];
  if (kOrderB || !first) {
    float t[8];
    load8_plain(tmp + off, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = t[i] + v[i];
  }
  if (kOrderB && last) {
    occ::store8(out + off, v);
  } else {
    occ::store8(tmp + off, v);
  }
}

template <typename GT, typename OutT, bool kOrderB>
__global__ void __launch_bounds__(kThreads, 2) lift_bwd_kernel(
    const GT* __restrict__ g,                // (B, ZR, M, C), batch stride
    const float* __restrict__ pos2,          // (B, A, ZR, M) pass-2 pos
    const float* __restrict__ inv_count,     // (B, R * M)
    const int2* __restrict__ runs,           // (B, A, w + h, ZR)
    float* tmp,                              // (B, A, h, w, C) fp32 scratch
    OutT* out,                               // (B, A, h, w, C); may be tmp
    Level L, int cg, long long g_bstride) {
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } cubtmp;
  __shared__ int jfirst[kThreads], jlast[kThreads];
  extern __shared__ float line_sh[];
  float* part = line_sh;                     // groups x kSlots x chunk
  int* s_zr = reinterpret_cast<int*>(line_sh + kPartFloats);  // the tile's
                                                              // sorted planes
  int* s_lo = s_zr + kTile;
  float* s_p1 = reinterpret_cast<float*>(s_lo + kTile);
  int* s_cum = reinterpret_cast<int*>(s_p1 + kTile);   // kTile + 1

  const int n_lines = kOrderB ? L.h : L.w;   // lines of one camera
  const int n1 = kOrderB ? L.w : L.h;        // pixels along a line
  const int k = blockIdx.x % n_lines;
  const long long ba = blockIdx.x / n_lines;
  const int b = (int)(ba / L.A);
  const int K1 = L.w + L.h;
  const int kk = kOrderB ? L.w + k : k;
  const int2* line = runs + (ba * K1 + kk) * L.ZR;
  const int M = L.M;
  const int C = L.C;
  const int ch = 8 * cg;                     // channels of the block
  const int groups = kThreads / cg;
  const int gi = threadIdx.x / cg;
  const int c0 = blockIdx.y * ch + (threadIdx.x % cg) * 8;
  const GT* gb = g + (long long)b * g_bstride + c0;
  const float* icb = inv_count + (long long)b * L.R * M;
  const float* p2b = pos2 + ba * L.ZR * M;
  float* gpart = part + gi * kSlots * ch + (threadIdx.x % cg) * 8;

  for (int t0 = 0; t0 < L.ZR; t0 += kTile) {
    const bool first = t0 == 0;
    const bool last = t0 + kTile >= L.ZR;
    // the tile's planes that reach the line, keyed by j0 + 1 in [0, n1]
    unsigned key[kItems];
    int val[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int zr = t0 + threadIdx.x * kItems + i;
      key[i] = n1 + 1;                       // sorts after every kept one
      val[i] = zr;
      if (zr < L.ZR) {
        const int2 e = __ldg(line + zr);
        const int lo = e.x & 0xffff;
        const int hi = e.x >> 16;
        const float p1 = __int_as_float(e.y);
        if (hi > lo && p1 > -1.0f && p1 < (float)n1) {
          key[i] = (unsigned)((int)floorf(p1) + 1);
        }
      }
    }
    const int bits = 32 - __clz(n1 + 1);
    Sort(cubtmp.sort).Sort(key, val, 0, bits);
    __syncthreads();                         // cubtmp is reused by the scan
    int len[kItems], cum[kItems], total;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      len[i] = 0;
      if (key[i] <= (unsigned)n1) {
        const int2 e = __ldg(line + val[i]);
        len[i] = (e.x >> 16) - (e.x & 0xffff);
        const int r = threadIdx.x * kItems + i;
        s_zr[r] = val[i];
        s_lo[r] = e.x & 0xffff;
        s_p1[r] = __int_as_float(e.y);
      }
    }
    Scan(cubtmp.scan).ExclusiveSum(len, cum, total);
#pragma unroll
    for (int i = 0; i < kItems; ++i) s_cum[threadIdx.x * kItems + i] = cum[i];
    if (threadIdx.x == 0) s_cum[kTile] = total;
    __syncthreads();

    // this group's cells [c_begin, c_end) of the line, in pixel order
    const int c_begin = (int)((long long)total * gi / groups);
    const int c_end = (int)((long long)total * (gi + 1) / groups);
    int jf = 1 << 30, jl = 0;                // no cells: reaches no pixel
    if (c_begin < c_end) {
      int lo_e = 0, hi_e = kTile - 1;        // last entry with cum <= c
      while (lo_e < hi_e) {
        const int mid = (lo_e + hi_e + 1) >> 1;
        if (s_cum[mid] <= c_begin) lo_e = mid; else hi_e = mid - 1;
      }
      int e = lo_e;
      jf = (int)floorf(s_p1[e]);
      int e_last = e;
      while (s_cum[e_last + 1] <= c_end - 1) ++e_last;
      jl = (int)floorf(s_p1[e_last]);

      float acc0[8], acc1[8], s0[8], s1[8];  // pixels cur, cur + 1; entry
#pragma unroll
      for (int i = 0; i < 8; ++i) acc0[i] = acc1[i] = s0[i] = s1[i] = 0.0f;
      int cur = jf;
      int ecur = -1;
      float f1 = 0.0f;
      int j0 = jf;
      auto flush = [&]() {                   // pixel cur is complete here
        if (cur >= 0 && cur < n1) {
          if (cur >= jf + 2 && cur < jl) {   // no other group reaches it
            write_pixel<OutT, kOrderB>(L, ba, k, cur, c0, acc0, tmp, out,
                                       first, last);
          } else {
            const int slot = cur - jf < 2 ? cur - jf : cur - jl + 2;
            float* q = gpart + slot * ch;
            reinterpret_cast<float4*>(q)[0] =
                make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
            reinterpret_cast<float4*>(q)[1] =
                make_float4(acc0[4], acc0[5], acc0[6], acc0[7]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc0[i] = acc1[i];
          acc1[i] = 0.0f;
        }
        ++cur;
      };
      auto commit = [&]() {                  // entry ecur: s0 -> j0 = cur
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc0[i] += s0[i];
          acc1[i] += s1[i];
          s0[i] = s1[i] = 0.0f;
        }
      };

      for (int c = c_begin; c < c_end; c += kUnroll) {
        int eu[kUnroll];
        float p2[kUnroll], ic[kUnroll], gv[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int cu = min(c + u, c_end - 1);
          while (s_cum[e + 1] <= cu) ++e;
          eu[u] = e;
          const int zr = s_zr[e];
          const int m = s_lo[e] + (cu - s_cum[e]);
          p2[u] = __ldg(p2b + (long long)zr * M + m);
          ic[u] = __ldg(icb + (long long)(zr % L.R) * M + m);
          occ::load8(gb + ((long long)zr * M + m) * C, gv[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c + u >= c_end) break;
          if (eu[u] != ecur) {
            if (ecur >= 0) commit();
            ecur = eu[u];
            const float p1 = s_p1[ecur];
            const float j0f = floorf(p1);
            j0 = (int)j0f;
            f1 = p1 - j0f;
            while (cur < j0) flush();         // no later cell reaches it
          }
          if (p2[u] <= -1.0f) continue;
          const float k0f = floorf(p2[u]);
          const int k0 = (int)k0f;
          const float f2 = p2[u] - k0f;
          float w2;
          if (k0 == k) {
            w2 = 1.0f - f2;
          } else if (k0 + 1 == k) {
            w2 = f2;
          } else {
            continue;
          }
          const float wa = __fmul_rn(w2, 1.0f - f1);
          const float wb = __fmul_rn(w2, f1);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float gi8 = __fmul_rn(gv[u][i], ic[u]);
            s0[i] = fmaf(wa, gi8, s0[i]);
            s1[i] = fmaf(wb, gi8, s1[i]);
          }
        }
      }
      commit();
      flush();                                // pixel jl
      flush();                                // pixel jl + 1
    }
    if (threadIdx.x % cg == 0) {
      jfirst[gi] = jf;
      jlast[gi] = jl;
    }
    __syncthreads();

    // the pixels no single group owns: the groups' partial sums in group
    // order (zeros where no group reaches the pixel)
    for (int it = threadIdx.x; it < n1 * cg; it += kThreads) {
      const int j = it / cg;
      const int lane = it % cg;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      bool owned = false;
      for (int q = 0; q < groups; ++q) {
        const int qf = jfirst[q];
        const int ql = jlast[q];
        if (j >= qf + 2 && j < ql) {
          owned = true;
          break;
        }
        if (j >= qf && j <= ql + 1) {
          const int slot = j - qf < 2 ? j - qf : j - ql + 2;
          const float* p = part + (q * kSlots + slot) * ch + lane * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += p[i];
        }
      }
      if (!owned) {
        write_pixel<OutT, kOrderB>(L, ba, k, j, blockIdx.y * ch + lane * 8,
                                   acc, tmp, out, first, last);
      }
    }
    __syncthreads();                          // before the next tile
  }
}

template <typename GT, typename OutT, bool kOrderB>
cudaError_t launch_order(const GT* g, const float* p2, const float* ic,
                         const int2* runs, float* tmp, OutT* out,
                         const Level& L, int cg, long long g_bstride,
                         cudaStream_t s) {
  auto kern = lift_bwd_kernel<GT, OutT, kOrderB>;
  const size_t smem = (size_t)(kPartFloats + 4 * kTile + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long lines = (long long)L.B * L.A * (kOrderB ? L.h : L.w);
  const dim3 grid((unsigned)lines, (unsigned)(L.C / (8 * cg)));
  kern<<<grid, kThreads, smem, s>>>(g, p2, ic, runs, tmp, out, L, cg,
                                    g_bstride);
  return cudaGetLastError();
}

template <typename GT, typename OutT>
cudaError_t launch_both(const GT* g, const float* p2, const float* ic,
                        const int2* runs, float* tmp, OutT* out,
                        const Level& L, int cg, long long g_bstride,
                        cudaStream_t s) {
  const cudaError_t err = launch_order<GT, float, false>(
      g, p2, ic, runs, tmp, tmp, L, cg, g_bstride, s);
  if (err != cudaSuccess) return err;
  return launch_order<GT, OutT, true>(g, p2, ic, runs, tmp, out, L, cg,
                                      g_bstride, s);
}

}  // namespace

// The per-line runs of one level (see lift_bwd_index_kernel); excess is an
// int64 the caller zeroes.  M < 32768 (runs pack m_lo | m_hi << 16).
extern "C" int occ_lift_bwd_index(const void* pos1, const void* pos2,
                                  const void* steep, void* runs,
                                  void* excess, int B, int A, int ZR, int M,
                                  int h, int w, void* stream) {
  const long long planes = (long long)B * A * ZR;
  if (planes == 0) return 0;
  const size_t smem = (size_t)3 * kPlanes * (w + h) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      lift_bwd_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lift_bwd_index_kernel<<<(unsigned)((planes + kPlanes - 1) / kPlanes),
                          kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos1), static_cast<const float*>(pos2),
      static_cast<const uint8_t*>(steep), static_cast<int2*>(runs),
      static_cast<unsigned long long*>(excess), planes, ZR, M, h, w);
  return (int)cudaGetLastError();
}

// C = channels, a multiple of 8 * cg (cg = 1, 2, 4, 8, 16 or 32 lanes a
// group);
// g_is_bf16 / out_is_bf16 select the gradient and output types (bf16 or
// fp32).  tmp is an fp32 scratch of the output's shape (with an fp32 output
// it may be the output itself); runs come from occ_lift_bwd_index.
extern "C" int occ_lift_level_bwd(
    const void* g, const void* pos2, const void* inv_count, const void* runs,
    void* tmp, void* out, int g_is_bf16, int out_is_bf16, int B, int A,
    int h, int w, int C, int ZR, int R, int M, int cg, long long g_bstride,
    void* stream) {
  if (cg < 1 || cg > 32 || 32 % cg || C % (8 * cg)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level L{B, A, h, w, C, ZR, R, M};
  const float* p2 = static_cast<const float*>(pos2);
  const float* ic = static_cast<const float*>(inv_count);
  const int2* rn = static_cast<const int2*>(runs);
  float* tp = static_cast<float*>(tmp);
  cudaError_t err;
  if (g_is_bf16) {
    const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
    err = out_is_bf16
              ? launch_both(gp, p2, ic, rn, tp,
                            static_cast<__nv_bfloat16*>(out), L, cg,
                            g_bstride, s)
              : launch_both(gp, p2, ic, rn, tp, static_cast<float*>(out), L,
                            cg, g_bstride, s);
  } else {
    const float* gp = static_cast<const float*>(g);
    err = out_is_bf16
              ? launch_both(gp, p2, ic, rn, tp,
                            static_cast<__nv_bfloat16*>(out), L, cg,
                            g_bstride, s)
              : launch_both(gp, p2, ic, rn, tp, static_cast<float*>(out), L,
                            cg, g_bstride, s);
  }
  return (int)err;
}
