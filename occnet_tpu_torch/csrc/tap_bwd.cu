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
// not a Pallas kernel but the plain-XLA closed form of the Pallas forward's
// (#4, :136) gradient: nine shift + einsum passes over the value grid per
// step and layer.
//
// Bound on the H100: bytes.  At the main-path shape (1, 2, 200, 200, 256)
// bf16 it must read v (41 MB), attn (11.5 MB) and g (41 MB fp32) and write
// dv (41 MB) and dattn (11.5 MB): 146 MB, 43.6 us at 3.35 TB/s.  Each input
// element is used by nine outputs of each gradient, so the design reads each
// once from device memory and serves the reuse from shared memory:
//   - one launch; a block owns an 8 x 8 tile of BEV cells of one sample and
//     walks the channels in groups of 64 (whole heads), two blocks an SM;
//   - it stages the tile plus its one-cell halo with 16-byte `cp.async`:
//     attn for every head once (the rows are contiguous (nq, 9, heads)
//     runs), then per channel group g and v of both queue slots (row
//     pitches of an odd number of 16-byte units, so neighbouring cells' rows
//     fall in different banks);
//   - dv: a thread owns 8 channels of one cell for both slots: per tap one
//     read of 8 g channels and one attention weight a slot from shared
//     memory, one 16-byte store (bf16) a slot;
//   - dattn: a thread owns one (slot, cell, head): nine dots of D channels
//     of shifted v with the centre cell's g, read once a chunk of 8
//     channels for all taps; the tile's dattn is collected in shared memory
//     and written as whole (nq, 9, heads) rows in 16-byte stores after the
//     last group;
//   - no atomics: each output element has one writer and a fixed summation
//     order, so two launches agree bitwise, and a batch agrees with its
//     samples one at a time.
// The halo's cells are read again by the neighbouring tiles (100 staged
// cells for 64 outputs), from L2.
#include "common.cuh"

namespace {

constexpr int kTY = 8;                 // BEV rows a block
constexpr int kTX = 8;                 // BEV columns a block
constexpr int kHX = kTX + 2;           // halo tile width
constexpr int kHalo = (kTY + 2) * kHX; // staged cells
constexpr int kCG = 64;                // channels a group
constexpr int kMaxQ = 2;               // queue slots (nq) at most
constexpr int kThreads = 256;
constexpr int kGP = kCG + 4;           // g row pitch, fp32 (272 bytes)

template <typename T>
struct Tile {
  static constexpr int kE = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kVP = kCG + kE;        // v row pitch (144 / 272 B)
};

// shared-memory layout in bytes for arow = nq * 9 * heads
template <typename T>
size_t smem_bytes(int nq, int arow) {
  return (size_t)kHalo * arow * sizeof(T)            // attn, tile + halo
         + (size_t)kHalo * kGP * sizeof(float)       // g of a group
         + (size_t)nq * kHalo * Tile<T>::kVP * sizeof(T)  // v of a group
         + (size_t)kTY * kTX * arow * sizeof(T);     // dattn of the tile
}

// 8 consecutive values from shared memory -> fp32 (16-byte aligned).
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void lds8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void to_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void to_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tap_bwd_kernel(
    const T* __restrict__ v,      // (B, nq, H, W, C)
    const T* __restrict__ attn,   // (B, H, W, nq, 9, heads)
    const float* __restrict__ g,  // (B, H, W, C)
    T* __restrict__ dv,           // (B, nq, H, W, C)
    T* __restrict__ dattn,        // (B, H, W, nq, 9, heads)
    int nq, int H, int W, int C, int heads) {
  constexpr int kE = Tile<T>::kE;
  constexpr int kVP = Tile<T>::kVP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int arow = nq * 9 * heads;
  T* attn_s = reinterpret_cast<T*>(smem);
  float* g_s = reinterpret_cast<float*>(attn_s + (size_t)kHalo * arow);
  T* v_s = reinterpret_cast<T*>(g_s + kHalo * kGP);
  T* da_s = v_s + (size_t)nq * kHalo * kVP;

  const int tid = threadIdx.x;
  const int tiles_x = (W + kTX - 1) / kTX;
  const int y0 = (blockIdx.x / tiles_x) * kTY;
  const int x0 = (blockIdx.x % tiles_x) * kTX;
  const long long HW = (long long)H * W;
  const long long cell0 = (long long)blockIdx.y * HW;   // sample b's cells
  const int D = C / heads;
  const float s = 1.0f / (float)nq;

  // attn of every head for the tile and its halo, once
  const int apc = arow / kE;                 // 16-byte pieces a cell
  for (int e = tid; e < kHalo * apc; e += kThreads) {
    const int hc = e / apc;
    const int q = e - hc * apc;
    const int gy = y0 - 1 + hc / kHX;
    const int gx = x0 - 1 + hc % kHX;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    occ::cp_async16(attn_s + (size_t)hc * arow + q * kE,
                    attn + (cell0 + (long long)gy * W + gx) * arow + q * kE);
  }

  for (int c0 = 0; c0 < C; c0 += kCG) {
    // g and v (every slot) of this channel group, tile and halo
    for (int e = tid; e < kHalo * (kCG / 4); e += kThreads) {
      const int hc = e / (kCG / 4);
      const int q = (e % (kCG / 4)) * 4;
      const int gy = y0 - 1 + hc / kHX;
      const int gx = x0 - 1 + hc % kHX;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      occ::cp_async16(g_s + hc * kGP + q,
                      g + (cell0 + (long long)gy * W + gx) * C + c0 + q);
    }
    constexpr int vpc = kCG / kE;            // 16-byte pieces a (slot, cell)
    for (int e = tid; e < nq * kHalo * vpc; e += kThreads) {
      const int q = (e % vpc) * kE;
      const int nh = e / vpc;
      const int hc = nh % kHalo;
      const int n = nh / kHalo;
      const int gy = y0 - 1 + hc / kHX;
      const int gx = x0 - 1 + hc % kHX;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      occ::cp_async16(
          v_s + ((size_t)n * kHalo + hc) * kVP + q,
          v + ((cell0 * nq + (long long)n * HW) + (long long)gy * W + gx) * C +
              c0 + q);
    }
    occ::cp_async_commit();
    occ::cp_async_wait_all();
    __syncthreads();

    // dv: one thread an (8 channels, cell) item, every slot; each tap's 8 g
    // channels are read once for all slots
    for (int e = tid; e < kTY * kTX * (kCG / 8); e += kThreads) {
      const int q = (e % (kCG / 8)) * 8;
      const int cell = e / (kCG / 8);
      const int ty = cell / kTX;
      const int tx = cell % kTX;
      const int gy = y0 + ty;
      const int gx = x0 + tx;
      if (gy >= H || gx >= W) continue;
      const int hd = (c0 + q) / D;
      float acc[kMaxQ][8];
#pragma unroll
      for (int n = 0; n < kMaxQ; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[n][i] = 0.0f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = gy + (t / 3 - 1);       // the output cell that read
        const int xx = gx + (t % 3 - 1);       // v[n, gy, gx] through tap t
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
        const int hc = (ty + t / 3) * kHX + tx + t % 3;
        float gv[8];
        lds8(g_s + hc * kGP + q, gv);
        const T* arow_t = attn_s + (size_t)hc * arow + t * heads + hd;
#pragma unroll
        for (int n = 0; n < kMaxQ; ++n) {
          if (n >= nq) break;
          const float wt = occ::to_float(arow_t[n * 9 * heads]);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[n][i] = fmaf(wt, gv[i], acc[n][i]);
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxQ; ++n) {
        if (n >= nq) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[n][i] *= s;
        occ::store8(dv + ((cell0 * nq + (long long)n * HW) +
                          (long long)gy * W + gx) * C + c0 + q,
                    acc[n]);
      }
    }

    // dattn: one thread a (head of the group, slot, cell) item; the centre
    // cell's g is read once a chunk of 8 channels for all nine taps
    const int hg = kCG / D;
    for (int e = tid; e < nq * kTY * kTX * hg; e += kThreads) {
      const int hh = e % hg;
      const int nc = e / hg;
      const int n = nc % nq;
      const int cell = nc / nq;
      const int ty = cell / kTX;
      const int tx = cell % kTX;
      const int gy = y0 + ty;
      const int gx = x0 + tx;
      if (gy >= H || gx >= W) continue;
      const float* gc = g_s + ((ty + 1) * kHX + tx + 1) * kGP + hh * D;
      const T* vn = v_s + (size_t)n * kHalo * kVP + hh * D;
      bool live[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = gy - (t / 3 - 1);
        const int xx = gx - (t % 3 - 1);
        live[t] = yy >= 0 && yy < H && xx >= 0 && xx < W;
      }
      float part[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) part[t] = 0.0f;
      for (int d = 0; d < D; d += 8) {
        float gv[8];
        lds8(gc + d, gv);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          if (!live[t]) continue;
          float vv[8];
          lds8(vn + ((ty + 2 - t / 3) * kHX + tx + 2 - t % 3) * kVP + d, vv);
#pragma unroll
          for (int i = 0; i < 8; ++i) part[t] = fmaf(vv[i], gv[i], part[t]);
        }
      }
      T* out = da_s + (size_t)cell * arow + n * 9 * heads + c0 / D + hh;
#pragma unroll
      for (int t = 0; t < 9; ++t) to_out(out + t * heads, part[t] * s);
    }
    __syncthreads();
  }

  // the tile's dattn rows, 16-byte stores
  for (int e = tid; e < kTY * kTX * apc; e += kThreads) {
    const int cell = e / apc;
    const int q = e - cell * apc;
    const int gy = y0 + cell / kTX;
    const int gx = x0 + cell % kTX;
    if (gy >= H || gx >= W) continue;
    *reinterpret_cast<uint4*>(dattn + (cell0 + (long long)gy * W + gx) *
                                          arow + q * kE) =
        *reinterpret_cast<const uint4*>(da_s + (size_t)cell * arow + q * kE);
  }
}

template <typename T>
int launch(const void* v, const void* attn, const void* g, void* dv,
           void* dattn, int B, int nq, int H, int W, int C, int heads,
           cudaStream_t s) {
  const int arow = nq * 9 * heads;
  const size_t bytes = smem_bytes<T>(nq, arow);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      tap_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = ((H + kTY - 1) / kTY) * ((W + kTX - 1) / kTX);
  tap_bwd_kernel<T><<<dim3(tiles, B), kThreads, bytes, s>>>(
      static_cast<const T*>(v), static_cast<const T*>(attn),
      static_cast<const float*>(g), static_cast<T*>(dv),
      static_cast<T*>(dattn), nq, H, W, C, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// C = heads * D with C a multiple of 64, D a multiple of 8 dividing 64,
// nq <= 2, and
// an attn row (nq * 9 * heads values) a multiple of 16 bytes; is_bf16
// selects the type of v, attn, dv and dattn (all the same); g is always
// fp32.  All contiguous and 16-byte aligned.
extern "C" int occ_tap_attention_bwd(const void* v, const void* attn,
                                     const void* g, void* dv, void* dattn,
                                     int is_bf16, int B, int nq, int H, int W,
                                     int C, int heads, void* stream) {
  if (heads <= 0 || nq <= 0 || nq > kMaxQ || C % kCG != 0 ||
      C % heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = C / heads;
  const int esize = is_bf16 ? 2 : 4;
  if (D % 8 != 0 || kCG % D != 0 || (nq * 9 * heads * esize) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(v, attn, g, dv, dattn, B, nq, H, W, C,
                                 heads, s);
  return launch<float>(v, attn, g, dv, dattn, B, nq, H, W, C, heads, s);
}
