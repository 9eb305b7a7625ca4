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
// broadcasts are not expressible there).
//
// Bound on the H100: bytes.  At the main-path shape (1, 2, 200, 200, 256)
// bf16 it must read v (41 MB) and attn (11.5 MB) and write the fp32 output
// (41 MB): 93.5 MB, 27.9 us at 3.35 TB/s.  Each v element is read by nine
// output cells, so the design reads it once from device memory and serves
// the reuse from shared memory (the tiling of tap_bwd.cu):
//   - one launch; a block owns a kTY x 8 tile of BEV cells of one sample and
//     walks the channels in groups of 64 (whole heads);
//   - it stages the tile's attn rows once (contiguous (nq, 9, heads) runs)
//     and, per channel group, v of both queue slots for the tile plus its
//     one-cell halo, with 16-byte `cp.async` into two buffers, so the next
//     group's copy runs under the current group's sums.  Row pitches are an
//     odd number of 16-byte units, so neighbouring cells' rows fall in
//     different banks;
//   - a thread owns 8 channels of two cells four rows apart: per cell 18
//     reads of 16 bytes and 18 weights from shared memory, interleaved
//     between the two cells, fp32 sums, two 16-byte stores;
//   - each output element has one writer and a fixed order, so two launches
//     agree bitwise, and a batch agrees with its samples one at a time.
// The halo's cells are read again by the neighbouring tiles, from L2.  A
// 16 x 8 tile halves the blocks, fits one an SM and is slower
// (tools/bench_lift_tap.py --ablate; PERF.md).
#include "common.cuh"

namespace {

constexpr int kTY = 8;                 // BEV rows a block
constexpr int kTX = 8;                 // BEV columns a block
constexpr int kHX = kTX + 2;           // halo tile width
constexpr int kHalo = (kTY + 2) * kHX; // staged cells
constexpr int kCells = kTY * kTX;
constexpr int kCG = 64;                // channels a group
constexpr int kMaxQ = 2;               // queue slots (nq) at most
constexpr int kThreads = 256;
// (cell, 8 channels) items of a channel group a thread, kRowStep rows apart
constexpr int kItems = kCells * (kCG / 8) / kThreads;
constexpr int kRowStep = kThreads / (kCG / 8) / kTX;
static_assert(kItems * kThreads == kCells * (kCG / 8) &&
                  kRowStep * kItems == kTY,
              "a thread's items must tile the block's cells by rows");

template <typename T>
struct Tile {
  static constexpr int kE = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kVP = kCG + kE;        // v row pitch (144 / 272 B)
};

// shared-memory layout in bytes for arow = nq * 9 * heads
template <typename T>
size_t smem_bytes(int nq, int arow) {
  return (size_t)kCells * arow * sizeof(T)                      // attn
         + 2 * (size_t)nq * kHalo * Tile<T>::kVP * sizeof(T);   // v, x2
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

template <typename T>
__global__ void __launch_bounds__(kThreads) tap_kernel(
    const T* __restrict__ v,      // (B, nq, H, W, C)
    const T* __restrict__ attn,   // (B, H, W, nq, 9, heads)
    float* __restrict__ out,      // (B, H, W, C)
    int nq, int H, int W, int C, int heads) {
  constexpr int kE = Tile<T>::kE;
  constexpr int kVP = Tile<T>::kVP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int arow = nq * 9 * heads;
  T* attn_s = reinterpret_cast<T*>(smem);
  T* v_s = attn_s + (size_t)kCells * arow;     // [2][nq][kHalo][kVP]
  const size_t vbuf = (size_t)nq * kHalo * kVP;

  const int tid = threadIdx.x;
  const int tiles_x = (W + kTX - 1) / kTX;
  const int y0 = (blockIdx.x / tiles_x) * kTY;
  const int x0 = (blockIdx.x % tiles_x) * kTX;
  const long long HW = (long long)H * W;
  const long long cell0 = (long long)blockIdx.y * HW;   // sample b's cells
  const int D = C / heads;
  const float s = 1.0f / (float)nq;

  // v of every slot for the channel group at c0, tile and halo, into buf
  auto stage = [&](int c0, int buf) {
    constexpr int vpc = kCG / kE;            // 16-byte pieces a (slot, cell)
    T* dst = v_s + buf * vbuf;
    for (int e = tid; e < nq * kHalo * vpc; e += kThreads) {
      const int q = (e % vpc) * kE;
      const int nh = e / vpc;
      const int hc = nh % kHalo;
      const int n = nh / kHalo;
      const int gy = y0 - 1 + hc / kHX;
      const int gx = x0 - 1 + hc % kHX;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      occ::cp_async16(
          dst + ((size_t)n * kHalo + hc) * kVP + q,
          v + ((cell0 * nq + (long long)n * HW) + (long long)gy * W + gx) * C +
              c0 + q);
    }
  };

  // attn of every head for the tile's cells, once, with the first group
  const int apc = arow / kE;                 // 16-byte pieces a cell
  for (int e = tid; e < kCells * apc; e += kThreads) {
    const int cell = e / apc;
    const int q = e - cell * apc;
    const int gy = y0 + cell / kTX;
    const int gx = x0 + cell % kTX;
    if (gy >= H || gx >= W) continue;
    occ::cp_async16(attn_s + (size_t)cell * arow + q * kE,
                    attn + (cell0 + (long long)gy * W + gx) * arow + q * kE);
  }
  stage(0, 0);
  occ::cp_async_commit();

  const int groups = C / kCG;
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) {
      stage((g + 1) * kCG, (g + 1) & 1);
      occ::cp_async_commit();
      occ::cp_async_wait_one();      // group g has landed, g + 1 in flight
    } else {
      occ::cp_async_wait_all();
    }
    __syncthreads();

    // a thread's kItems items share their 8 channels and tile column and
    // lie kRowStep rows apart; their taps interleave, so twice the reads
    // are in flight
    const T* vg = v_s + (g & 1) * vbuf;
    const int c0 = g * kCG;
    const int q = (tid % (kCG / 8)) * 8;
    const int cell = tid / (kCG / 8);
    const int ty = cell / kTX;
    const int tx = cell % kTX;
    const int gx = x0 + tx;
    if (gx < W) {
      const T* arow_c = attn_s + (size_t)cell * arow + (c0 + q) / D;
      float acc[kItems][8];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxQ; ++n) {
        if (n >= nq) break;
        const T* vn = vg + (size_t)n * kHalo * kVP + q;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int xx = gx - (t % 3 - 1);     // the cell v is read from
          if (xx < 0 || xx >= W) continue;
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int yy = y0 + ty + j * kRowStep - (t / 3 - 1);
            if (yy < 0 || yy >= H) continue;
            const float wt = occ::to_float(arow_c[
                (size_t)j * kRowStep * kTX * arow + (n * 9 + t) * heads]);
            float val[8];
            lds8(vn + ((ty + j * kRowStep + 2 - t / 3) * kHX + tx + 2 - t % 3)
                          * kVP,
                 val);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(wt, val[i], acc[j][i]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int gy = y0 + ty + j * kRowStep;
        if (gy >= H) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] *= s;
        occ::store8(out + (cell0 + (long long)gy * W + gx) * C + c0 + q,
                    acc[j]);
      }
    }
    __syncthreads();                 // buffer g & 1 is refilled at g + 2
  }
}

template <typename T>
int launch(const void* v, const void* attn, void* out, int B, int nq, int H,
           int W, int C, int heads, cudaStream_t s) {
  const int arow = nq * 9 * heads;
  const size_t bytes = smem_bytes<T>(nq, arow);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      tap_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = ((H + kTY - 1) / kTY) * ((W + kTX - 1) / kTX);
  tap_kernel<T><<<dim3(tiles, B), kThreads, bytes, s>>>(
      static_cast<const T*>(v), static_cast<const T*>(attn),
      static_cast<float*>(out), nq, H, W, C, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// C = heads * D with C a multiple of 64, D a multiple of 8 dividing 64,
// nq <= 2, and an attn row (nq * 9 * heads values) a multiple of 16 bytes;
// is_bf16 selects the type of v and attn (both the same); the output is
// always fp32.  All contiguous and 16-byte aligned.
extern "C" int occ_tap_attention(const void* v, const void* attn, void* out,
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
    return launch<__nv_bfloat16>(v, attn, out, B, nq, H, W, C, heads, s);
  return launch<float>(v, attn, out, B, nq, H, W, C, heads, s);
}
