// conv3x3_gn_silu: implicit-GEMM 3x3, stride-1, SAME convolution on NHWC
// bf16 with the GroupNorm-apply + SiLU prologue and a bias/temb epilogue.
//
// Replaces (JAX package): eeg2video_tpu/ops/conv2d.py _conv3x3_t_kernel (:48),
// the 13 level-0 resnet convolutions of a UNet forward (Cout = 320).
//
//   out[n, y, x, co] = bias[co] + temb[n, co]
//       + sum_{dy, dx, ci} a[n, y+dy-1, x+dx-1, ci] * w[co, dy, dx, ci]
//   a = bf16(silu(x * scale[n, ci] + shift[n, ci]))  inside the image,
//   a = 0                                           in the padded border.
// Zero padding applies AFTER the prologue: the border is 0, not silu(shift)
// (ops/conv2d.py:67-79 zeroes the plane before writing the interior).
// Optional stats: (sum, sum of squares) over pixels of the STORED bf16 output
// per (image, channel), the partials the following GroupNorm needs
// (ops/conv2d.py:115-121).
//
// What bounds it on the H100: 2*N*H*W*9*Cin*Cout operations (12 x 36 x 64
// pixels, Cin = Cout = 320: 51 GFLOP, 0.0515 ms at 989 TFLOP/s) against
// 35 MB of x and out, so the tensor cores; behind them the L2 path, since
// every block reads its slice of the weights (9 Cin x 160 bf16) whole.
//
// Design (the first version, 64 x 64 WMMA tiles that gathered and re-ran the
// prologue for each of the 9 taps and each Cout block, took 26x its bound):
//   - a block owns a 4-row x 64-column tile of one image (256 output
//     pixels; tiles never cross an image, so an image's bits do not depend
//     on N or on what else is in the launch) and 160 output channels. The
//     GEMM is M = pixels, N = Cout, K = 9 taps x Cin, walked as Cin chunks
//     of 64 channels x the 9 taps (a ring step each);
//   - the input of a chunk is staged once as a halo tile of 6 x 66 pixels x
//     64 channels (cp.async, zero-filled outside the image and past Cin);
//     the prologue bf16(silu(x * scale + shift)) then runs once per element,
//     in place, on the pixels inside the image only, so the border stays 0.
//     Scale and shift of the chunk come with the copy into shared memory.
//     All 9 taps read shifted ldmatrix views of that tile: output pixel
//     (r, c) of tap (dy, dx) is halo pixel (r + dy, c + dx), rows of
//     64 + 8 bf16 (an odd multiple of 16 bytes: conflict-free ldmatrix);
//   - the halo tile is double-buffered: the next chunk's copy is in the
//     commit group of the ring step 4 taps before the chunk starts, and its
//     prologue runs in 16 parts, one behind each group of products of those
//     4 steps, while the tensor cores work on the group;
//   - the weights come as slab images (the wrapper lays the PyTorch (Cout,
//     Cin, 3, 3) weight out once per call): per (Cout block, chunk, tap) the
//     160 x 64 slab as the 8 x 8 core matrices that wgmma reads by
//     descriptor, 20 KB contiguous, so one thread moves a slab with one bulk
//     copy (cp.async.bulk, completion counted on an mbarrier) into a
//     four-stage ring, two in flight (a version that issued the slab as
//     1280 16-byte cp.async a step took 1.5x as long: PERF.md);
//   - products on wgmma.mma_async m64n160k16 (bf16 -> f32): two warpgroups,
//     each two tile rows (two m64 products, 160 f32 accumulators a thread in
//     registers); A is the m16n8k16 fragment each warp loads by ldmatrix from
//     the halo view (double-buffered), B the slab by descriptor; one group
//     of products stays in flight while the next A fragments load, the
//     copies are issued and the prologue runs. No WMMA, no f32 tile in
//     shared memory;
//   - the epilogue adds bias and temb in f32 to the accumulators and rounds
//     to bf16 into the (by then free) halo buffers; the tile leaves as
//     16-byte vectors, and the stats are summed per channel over the tile's
//     pixels in order from the stored values, one partial per tile. A
//     second small kernel (conv3x3_stats_kernel) adds an image's tile
//     partials in tile order: no atomics, the same bits on every run and
//     for every N.
// L2 reads per call (computed from the tiles; ops/conv2d.py l2_read_bytes):
// at (12, 36, 64), Cin = Cout = 320: 216 blocks x 921.6 KB of weights
// (199 MB) + 51 MB of halo tiles, against about 1.6 GB for the first version.
// Shared memory 196 KB (one block an SM), 216 blocks at that shape: two waves.
#include "ff_tiles.cuh"
#include "hopper.cuh"

namespace e2v {
namespace {

constexpr int kTR = 4, kTC = 64;              // output tile: rows x columns of pixels
constexpr int kHC = kTC + 2;                  // halo tile: (kTR + 2) x kHC pixels
constexpr int kHP = (kTR + 2) * kHC;          // 396
constexpr int kBN = 160;                      // output channels a block: one m64n160 product
constexpr int kKC = 64;                       // input channels a chunk
constexpr int kLD = kKC + 8;                  // halo row stride (odd multiple of 16 bytes)
constexpr int kVPP = kKC / 8;                 // 16-byte vectors a halo pixel or slab row
constexpr int kThreads = 256;                 // two warpgroups, two tile rows each
constexpr int kStagesC = 4;                   // weight ring slots
constexpr int kAhead = 2;                     // a slab's copy starts this many steps early
constexpr int kSlotC = kBN * kKC;             // bf16 values of a slab (core-matrix layout)
constexpr int kHaloLead = 4;                  // ring steps between a halo copy and its use
constexpr size_t kSmemC = (size_t)2 * kHP * kLD * sizeof(bf16)   // halo tiles
                          + (size_t)2 * 2 * kKC * sizeof(float)  // scale, shift
                          + (size_t)kStagesC * kSlotC * sizeof(bf16);
static_assert(kSmemC <= kSmemMax, "shared memory of one block");
// the slot refilled at step s held slab s + kAhead - kStagesC, whose products
// finished before step s - 1 ended (one wgmma group stays in flight)
static_assert(kStagesC >= kAhead + 2, "a slot is refilled only after its products are done");
// a halo buffer is refilled only after the chunk two back has been read
static_assert(kHaloLead >= 1 && kHaloLead + kAhead <= 9, "halo double buffer");

// silu(x) = x sigmoid(x) = h + h tanh(h), h = x / 2: one SFU operation
// (tanh.approx, about 2^-11 relative error, below bf16's rounding of the
// result) where x / (1 + e^-x) takes two
__device__ __forceinline__ float silu_fast(float f) {
  const float h = 0.5f * f;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

struct ConvArgs {
  const bf16* x;       // (N, H, W, Cin)
  const float* scale;  // (N, Cin)
  const float* shift;  // (N, Cin)
  const bf16* w;       // slabs (Cout blocks, Cin chunks, 9 taps, kSlotC), core-matrix order
  const float* bias;   // (Cout)
  const float* temb;   // (N, Cout) or null
  bf16* out;           // (N, H, W, Cout)
  float* partial;      // (N * tiles, 2, Cout) or null
  int N, H, W, Cin, Cout;
};

__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStagesC];                            // slab s landed in its slot
  bf16* halo = reinterpret_cast<bf16*>(smem);                    // [2][kHP][kLD]
  float* ss = reinterpret_cast<float*>(halo + 2 * kHP * kLD);    // [2][scale kKC | shift kKC]
  bf16* ring = reinterpret_cast<bf16*>(ss + 4 * kKC);            // [kStagesC][kSlotC]

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tiles_x = (W + kTC - 1) / kTC;
  const int tiles = tiles_x * ((H + kTR - 1) / kTR);
  const int cblocks = (Cout + kBN - 1) / kBN;
  // the Cout blocks of a tile are neighbours in the grid (they share its halo)
  const int tg = blockIdx.x / cblocks, cb = blockIdx.x % cblocks, co0 = cb * kBN;
  const int n = tg / tiles, tile = tg % tiles;
  const int y0 = (tile / tiles_x) * kTR, x0 = (tile % tiles_x) * kTC;
  const int nchunks = (Cin + kKC - 1) / kKC;
  const int nsteps = 9 * nchunks;  // ring step s: chunk s / 9, tap s % 9
  const bf16* xn = p.x + (long long)n * H * W * Cin;
  const bf16* slabs = p.w + (long long)cb * nsteps * kSlotC;  // in step order

  // halo pixel hp of chunk c, channels v*8 .. v*8+7: in the image and below Cin?
  auto halo_src = [&](int hp, int v, int c, long long& off) {
    const int y = y0 - 1 + hp / kHC, xx = x0 - 1 + hp % kHC, ch = c * kKC + v * 8;
    off = ((long long)y * W + xx) * Cin + ch;
    return y >= 0 && y < H && xx >= 0 && xx < W && ch < Cin;
  };
  auto copy_halo = [&](int c) {
    bf16* hb = halo + (c & 1) * (kHP * kLD);
    for (int e = threadIdx.x; e < kHP * kVPP; e += kThreads) {
      const int hp = e / kVPP, v = e % kVPP;
      long long off;
      const bool ok = halo_src(hp, v, c, off);
      cp_async16(hb + hp * kLD + v * 8, ok ? xn + off : xn, ok);
    }
    float* sb = ss + (c & 1) * (2 * kKC);
    for (int e = threadIdx.x; e < 2 * kKC; e += kThreads) {
      const int ch = c * kKC + e % kKC;
      const float* src = (e < kKC ? p.scale : p.shift) + (long long)n * Cin + ch;
      cp_async4(sb + e, ch < Cin ? src : p.scale, ch < Cin);
    }
  };
  // part `part` of `parts` of the prologue of chunk c, once per staged
  // element inside the image (the rest stays 0)
  auto prologue = [&](int c, int part, int parts) {
    bf16* hb = halo + (c & 1) * (kHP * kLD);
    const float* sb = ss + (c & 1) * (2 * kKC);
    const int v = threadIdx.x % kVPP;  // kThreads % kVPP == 0: a thread keeps its 8 channels
    for (int e = threadIdx.x + part * kThreads; e < kHP * kVPP; e += parts * kThreads) {
      const int hp = e / kVPP;
      long long off;
      if (!halo_src(hp, v, c, off)) continue;
      Vec8 a = load_vec8(hb + hp * kLD + v * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a.h[i] = __float2bfloat16(
            silu_fast(__bfloat162float(a.h[i]) * sb[v * 8 + i] + sb[kKC + v * 8 + i]));
      store_vec8(hb + hp * kLD + v * 8, a);
    }
  };
  // ring step s: the weight slab of (chunk s / 9, tap s % 9), one bulk copy
  // by thread 0 into slot s % kStagesC; the halo of chunk 0 (step 0) or of
  // chunk c + 1 (kHaloLead steps before chunk c + 1 starts) by cp.async, in
  // one commit group a step
  auto load_step = [&](int s) {
    if (s < nsteps) {
      if (threadIdx.x == 0)
        bulk_copy(ring + (s % kStagesC) * kSlotC, slabs + (long long)s * kSlotC,
                  kSlotC * sizeof(bf16), &full[s % kStagesC]);
      const int c = s / 9, tap = s % 9;
      if (s == 0) copy_halo(0);
      if (tap == 9 - kHaloLead && c + 1 < nchunks) copy_halo(c + 1);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  // warpgroup wg owns tile rows 2 wg and 2 wg + 1 (its two m64 products),
  // warp wq of it pixels 16 wq .. 16 wq + 15 of each; this lane's ldmatrix
  // row (pixel) and 8-channel half
  const int a_off =
      ((2 * wg) * kHC + 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD + (lane >> 4) * 8;

  float d[2][80];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 80; ++i) d[m][i] = 0.0f;
  uint32_t a[2][2][4];  // A fragments, double-buffered over k16 steps

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesC; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kAhead; ++s) load_step(s);
  cp_async_wait<kAhead - 1>();
  __syncthreads();  // halo 0 landed
  prologue(0, 0, 1);

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();  // the halo copied with step s landed; the products of slab s - 2 are done
    const int c = s / 9, tap = s % 9;
    const bf16* hb = halo + (c & 1) * (kHP * kLD) + a_off + ((tap / 3) * kHC + tap % 3) * kLD;
    const bf16* slab = ring + (s % kStagesC) * kSlotC;
    // the next chunk's halo arrived with step 9 (c + 1) - kHaloLead: its
    // prologue runs in 4 kHaloLead parts, one behind each group of products
    const bool pro = tap >= 9 - kHaloLead && c + 1 < nchunks;
    const int part0 = (tap - (9 - kHaloLead)) * (kKC / 16);
    mbar_wait(&full[s % kStagesC], (s / kStagesC) & 1);
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      // the buffer refilled here was read by the group before last: done
      ldmatrix_x4(a[kk & 1][0], hb + kk * 16);
      ldmatrix_x4(a[kk & 1][1], hb + kHC * kLD + kk * 16);
      wgmma_fence();
      const uint64_t desc = smem_desc(slab + kk * 128, 128, 1024);
      wgmma_m64n160k16(d[0], a[kk & 1][0], desc);
      wgmma_m64n160k16(d[1], a[kk & 1][1], desc);
      wgmma_commit();
      // behind the first group: the copies of step s + kAhead (into the slot
      // of slab s - 2, free since the barrier above)
      if (kk == 0) load_step(s + kAhead);
      if (pro) prologue(c + 1, part0 + kk, kHaloLead * (kKC / 16));
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // shared memory is free: the halo buffers stage the output tile

  // epilogue: bias and temb in f32 on the accumulators (the m16n8 C fragment
  // layout: row g and g + 8 of the warp's 16, columns 8 j + 2 t, + 1),
  // rounded to bf16 into a (256 pixels x 160) tile, then stored as 16-byte
  // vectors, and the stats of the stored values summed per channel over the
  // tile's pixels in order
  constexpr int kLDO = kBN + 8;  // the staged tile's row stride
  static_assert(kTR * kTC * kLDO <= 2 * kHP * kLD, "the output tile fits in the halo buffers");
  bf16* ot = halo;
  const int gr = lane >> 2, tq = lane & 3;
  const float* tn = p.temb ? p.temb + (long long)n * Cout : nullptr;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int cl = j * 8 + 2 * tq, col = co0 + cl;
    const bool c0ok = col < Cout, c1ok = col + 1 < Cout;
    const float bias0 = c0ok ? p.bias[col] : 0.0f, bias1 = c1ok ? p.bias[col + 1] : 0.0f;
    const float temb0 = tn && c0ok ? tn[col] : 0.0f, temb1 = tn && c1ok ? tn[col + 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // (sum + bias) + temb, rounded once: the order of the plain version
        const int px = (2 * wg + m) * kTC + 16 * wq + gr + 8 * h;
        *reinterpret_cast<uint32_t*>(ot + px * kLDO + cl) =
            pack_bf16(d[m][4 * j + 2 * h] + bias0 + temb0, d[m][4 * j + 2 * h + 1] + bias1 + temb1);
      }
  }
  __syncthreads();
  bf16* outn = p.out + (long long)n * H * W * Cout;
  const int ncols = Cout - co0 < kBN ? Cout - co0 : kBN;
  if (Cout % 8 == 0) {
    for (int e = threadIdx.x; e < kTR * kTC * (kBN / 8); e += kThreads) {
      const int px = e / (kBN / 8), v = e % (kBN / 8);
      const int y = y0 + px / kTC, xx = x0 + px % kTC;
      if (y < H && xx < W && v * 8 < ncols)
        store_vec8(outn + ((long long)y * W + xx) * Cout + co0 + v * 8,
                   load_vec8(ot + px * kLDO + v * 8));
    }
  } else {
    for (int e = threadIdx.x; e < kTR * kTC * kBN; e += kThreads) {
      const int px = e / kBN, cl = e % kBN;
      const int y = y0 + px / kTC, xx = x0 + px % kTC;
      if (y < H && xx < W && cl < ncols)
        outn[((long long)y * W + xx) * Cout + co0 + cl] = ot[px * kLDO + cl];
    }
  }
  if (p.partial == nullptr) return;
  // one partial per tile and channel: the tile's pixels inside the image, in order
  float* part = p.partial + (long long)tg * 2 * Cout;
  const int rows = H - y0 < kTR ? H - y0 : kTR, cols = W - x0 < kTC ? W - x0 : kTC;
  for (int cl = threadIdx.x; cl < ncols; cl += kThreads) {
    float sum = 0.0f, sq = 0.0f;
    for (int r = 0; r < rows; ++r)
      for (int x = 0; x < cols; ++x) {
        const float v = __bfloat162float(ot[(r * kTC + x) * kLDO + cl]);
        sum += v;
        sq += v * v;
      }
    part[co0 + cl] = sum;
    part[Cout + co0 + cl] = sq;
  }
}

// stats[n][k][co] = sum over the image's tiles, in tile order, of
// partial[n * tiles + t][k][co]
__global__ void conv3x3_stats_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                     int N, int tiles, int Cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * 2 * Cout) return;
  const long long n = i / (2 * Cout), k = i % (2 * Cout);
  const float* src = partial + n * tiles * 2 * Cout + k;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += src[(long long)t * 2 * Cout];
  stats[i] = s;
}

}  // namespace
}  // namespace e2v

// x (N, H, W, Cin) bf16; scale, shift (N, Cin) f32; w the slab images
// (ceil(Cout / 160), ceil(Cin / 64), 3, 3, 20, 8, 8, 8) bf16: [Cout block]
// [chunk][dy][dx][row / 8][channel / 8][row % 8][channel % 8] of the weight
// zero-padded to 160-row blocks and 64-channel chunks (ops/conv2d.py);
// bias (Cout) f32; temb (N, Cout) f32 or null; out (N, H, W, Cout) bf16;
// stats null, or (N * tiles + N, 2, Cout) f32 with tiles = ceil(H / 4) *
// ceil(W / 64): the per-tile partials, then each image's (sum, sum of
// squares) of the stored output. x and w 16-byte aligned, Cin % 8 == 0.
// Returns the CUDA launch status.
extern "C" int e2v_conv3x3(const void* x, const void* scale, const void* shift, const void* w,
                           const void* bias, const void* temb, void* out, void* stats, int N,
                           int H, int W, int Cin, int Cout, void* stream) {
  using namespace e2v;
  if (Cin % 8 != 0 || N < 0 || H < 1 || W < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int tiles = ((H + kTR - 1) / kTR) * ((W + kTC - 1) / kTC);
  float* partial = static_cast<float*>(stats);
  const ConvArgs args{static_cast<const bf16*>(x), static_cast<const float*>(scale),
                      static_cast<const float*>(shift), static_cast<const bf16*>(w),
                      static_cast<const float*>(bias), static_cast<const float*>(temb),
                      static_cast<bf16*>(out), partial, N, H, W, Cin, Cout};
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemC);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)N * tiles * ((Cout + kBN - 1) / kBN);
  conv3x3_kernel<<<(unsigned)blocks, kThreads, kSmemC, (cudaStream_t)stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const long long outs = (long long)N * 2 * Cout;
  conv3x3_stats_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      partial, partial + (long long)N * tiles * 2 * Cout, N, tiles, Cout);
  return (int)cudaGetLastError();
}
