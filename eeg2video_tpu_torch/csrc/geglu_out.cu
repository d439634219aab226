// geglu_out: the GEGLU gate fused into the out-projection GEMM,
//   out = bf16(bf16(h * gelu_erf(g)) W^T + b),   [h | g] = h2 (T, 2I),
// the gated product rounded to bf16 before the product, f32 accumulation,
// the bias added in f32.
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _geglu_kernel (:59), the
// feed-forward out-projection of the C = 1280 levels (level 2 and the mid
// block), where LN and the projection run as plain torch ops.
//
// What bounds it on the H100: 2 T I C operations (T = 1728, I = 5120,
// C = 1280: 22.6 GFLOP, 0.0229 ms at 989 TFLOP/s) against 35 MB of h2 and
// 13 MB of W: the tensor cores. Behind them two costs that a tiling sets:
// the gate (an erff per gated element, about as many instructions as the
// element's share of the products) and the L2 reads of h2 and W. The JAX
// kernel computes the gate once per row block and feeds one MXU dot against
// the whole resident (I, C) weight; 64 x 1280 f32 accumulators do not fit an
// SM's registers, so the columns are split over four blocks of a cluster,
// and the cluster, not the block, computes the gate: once per element (the
// first version's 64 x 64 tiles ran it 20 times, 64 x 320 tiles without a
// cluster 4 times, and there the gate set the pace: PERF.md).
//
// Design:
//   - a block owns 64 rows x 320 output columns: two warpgroups, each one
//     wgmma.mma_async m64n160k16 product (bf16 -> f32, 80 accumulators a
//     thread in registers) per k16 step, both on the same A tile, read by
//     descriptor. A cluster is the four 320-column blocks of a row block
//     (grid x rounded up to whole clusters; blocks past C only gate). At
//     T = 1728: 27 clusters, 108 blocks, one wave on 132 SMs;
//   - K = I is walked in chunks of 64. W (C, I) and h2 come by TMA
//     (cp.async.bulk.tensor, 2-D tensor maps made per call, boxes of 64
//     columns in the 128-byte swizzle, rows past C or T filled with zeros),
//     counted on mbarriers: W in a four-stage ring (a chunk's two 160-row
//     boxes, 40 KB, two chunks ahead), h2 in a four-stage ring (this block's
//     16 rows of h and of g, 4 KB, four chunks ahead), so h2 is read from L2
//     once per row block. No relayout or cache of W: the tensor map reads the
//     nn.Linear weight as it is;
//   - the gate: block r of a cluster turns its 16 rows of chunk c + 2 into
//     bf16(h * gelu_erf(g)) (erff, exact to f32, as the plain version's erf;
//     4 values a thread, read from the swizzled boxes without bank conflicts)
//     and stores them in its own A tile (a four-stage ring of 8 KB tiles in
//     the 8 x 8 core-matrix layout, where a block's 16 rows are 2 KB in one
//     piece), while chunk c's products run. One thread then sends those 2 KB
//     to the same place in the other three blocks by bulk copy
//     (cp.async.bulk.shared::cluster), counted on their mbarrier of that
//     tile, and arms its own for the other blocks' 6 KB: the A tile is
//     written through the async proxy on both sides, so no thread waits on a
//     fence or a cluster barrier. After a chunk's products, one thread tells
//     every block of the cluster that its copy of the tile is free (remote
//     mbarrier arrivals); a block writes a tile again only once all four
//     have;
//   - the epilogue adds the bias in f32 to the accumulators, rounds to bf16
//     into a staged 64 x 320 tile in the (free) W ring, and stores it as
//     16-byte vectors. No WMMA, no f32 tile in shared memory.
// Tried and not kept (PERF.md): the same tiles without a cluster (the gate 4
// times per element: 1.4x slower); the cluster with stores into the other
// blocks' shared memory and a cluster barrier and proxy fence a chunk, or
// mbarrier arrivals released at cluster scope (slower than no cluster); W
// multicast to two row blocks of a cluster (slower).
// Every output row is a sum over K in one fixed order (chunk by chunk, k16
// by k16), rows never share a reduction and no split depends on T: a row's
// bits do not depend on T or on the other rows in the call.
// L2 reads per call (computed from the tiling; ops/geglu.py
// geglu_out_l2_read_bytes): at T = 1728, 27 row blocks x 13.1 MB of W +
// 35.4 MB of h2 = 389.4 MB, against 1.06 GB for the first version.
#include "ff_tiles.cuh"
#include "hopper.cuh"

namespace e2v {
namespace {

constexpr int kBM = 64;                    // rows a block
constexpr int kWN = 160;                   // output columns a warpgroup: one m64n160 product
constexpr int kBN = 2 * kWN;               // output columns a block
constexpr int kKC = 64;                    // inner columns a chunk: one 128-byte swizzle row
constexpr int kThreads = 256;              // two warpgroups
constexpr int kCluster = 4;                // blocks of a cluster: neighbours along C
constexpr int kGR = kBM / kCluster;        // rows of each chunk a block gates for the cluster
constexpr int kStagesW = 4, kAheadW = 2;   // W ring: slots, chunks a copy starts early
constexpr int kStagesH = 4, kAheadH = 4;   // h2 ring
constexpr int kStagesA = 4, kLeadA = 2;    // gated A tiles; chunks the gate runs ahead
constexpr int kSlotW = kBN * kKC;          // bf16 values: W rows col0 .. col0+319 of a chunk
constexpr int kSlotH = 2 * kGR * kKC;      // the h box, then the g box, of the block's kGR rows
constexpr int kSlotA = kBM * kKC;          // the gated A tile, core-matrix layout
constexpr int kPartA = kGR * kKC;          // a block's rows of an A tile: contiguous
constexpr int kLDO = kBN + 8;              // row stride of the staged output tile
constexpr size_t kSmem = 1024  // slack: the swizzled boxes start on a 1024-byte boundary
                         + (size_t)(kStagesW * kSlotW + kStagesH * kSlotH + kStagesA * kSlotA) *
                               sizeof(bf16);
static_assert(kSmem <= kSmemMax, "shared memory of one block");
static_assert(kGR * kKC / 4 == kThreads, "a thread gates 4 values of a chunk");
// Chunk c's step: await its A tile and W; issue its products; await chunk
// c - 1's; free chunk c - 1's A tile and start the copies of chunks c + 2 (W,
// into chunk c - 2's slot) and c + 4 (h2, into chunk c's slot, gated in step
// c - 2); gate chunk c + 2 and send it.
static_assert(kStagesW == kAheadW + 2, "a W slot is refilled only after its products are done");
static_assert(kStagesH == kAheadH && kAheadH > kLeadA, "h2 ring");
// chunk c + 2's A tile held chunk c - 2, freed by every block in step c - 1
static_assert(kStagesA >= kLeadA + 2, "an A tile is rewritten only after its products are done");
static_assert((size_t)kBM * kLDO <= (size_t)kStagesW * kSlotW, "the output tile fits the W ring");

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    geglu_out_kernel(const __grid_constant__ CUtensorMap map_h2,
                     const __grid_constant__ CUtensorMap map_w, const float* __restrict__ b,
                     bf16* __restrict__ out, int T, int I, int C) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full_w[kStagesW], full_h[kStagesH];  // chunk landed in its slot
  // A tile s holds the other blocks' rows of its chunk (their bytes, once
  // this block has armed it) / every block's products of its chunk are done
  __shared__ uint64_t full_a[kStagesA], free_a[kStagesA];
  bf16* ring_w = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* ring_h = ring_w + kStagesW * kSlotW;
  bf16* tile_a = ring_h + kStagesH * kSlotH;

  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;
  const int nchunks = I / kKC;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();  // this block gates rows row0 + kGR rank .. of each chunk

  // the copies of chunk c, by thread 0: W rows col0 .. col0+319 (two boxes
  // of 160) and the h and g columns of this block's kGR rows
  auto load_w = [&](int c) {
    if (c >= nchunks) return;
    uint64_t* bar = &full_w[c % kStagesW];
    bf16* sw = ring_w + (c % kStagesW) * kSlotW;
    mbar_expect(bar, kSlotW * sizeof(bf16));
    tma_load_2d(sw, &map_w, c * kKC, col0, bar);
    tma_load_2d(sw + kWN * kKC, &map_w, c * kKC, col0 + kWN, bar);
  };
  auto load_h = [&](int c) {
    if (c >= nchunks) return;
    uint64_t* bar = &full_h[c % kStagesH];
    bf16* sh = ring_h + (c % kStagesH) * kSlotH;
    mbar_expect(bar, kSlotH * sizeof(bf16));
    tma_load_2d(sh, &map_h2, c * kKC, row0 + kGR * rank, bar);
    tma_load_2d(sh + kGR * kKC, &map_h2, I + c * kKC, row0 + kGR * rank, bar);
  };

  // Thread t gates row (t / 128) * 8 + (t / 2) % 8 of the block's kGR rows,
  // columns 8 j + 4 (t % 2) .. + 3, j = (t / 16) % 8: 16 threads read 8 rows
  // of one swizzled 16-byte column piece (8 bank groups) and write one
  // 128-byte core matrix; the block's rows start at core-matrix row group
  // 2 rank of the A tile, kPartA values on
  const int half = tid & 1, lo = (tid >> 1) & 7, j = (tid >> 4) & 7, hi = tid >> 7;
  const int g_src = (hi * 8 + lo) * kKC + ((j ^ lo) << 3) + half * 4;
  const int a_dst = rank * kPartA + (hi * 8 + j) * 64 + lo * 8 + half * 4;
  // this block's kGR rows of chunk c into its own A tile c % kStagesA, once
  // every block's products of the tile's last chunk are done
  auto gate = [&](int c) {
    if (c >= nchunks) return;
    if (c >= kStagesA) mbar_wait(&free_a[c % kStagesA], (c / kStagesA - 1) & 1);
    mbar_wait(&full_h[c % kStagesH], (c / kStagesH) & 1);
    const bf16* sh = ring_h + (c % kStagesH) * kSlotH;
    const Bf16s<4> hv = *reinterpret_cast<const Bf16s<4>*>(sh + g_src);
    const Bf16s<4> gv = *reinterpret_cast<const Bf16s<4>*>(sh + kGR * kKC + g_src);
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = __bfloat162float(hv.h[i]) * gelu_erf(__bfloat162float(gv.h[i]));
    *reinterpret_cast<uint2*>(tile_a + (c % kStagesA) * kSlotA + a_dst) =
        make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
    fence_proxy_async();  // read by wgmma and the bulk copies (async proxy)
  };
  // by thread 0, after a barrier over the gate of chunk c: this block's rows
  // to the other blocks' A tiles; this block's tile then awaits theirs
  auto publish = [&](int c) {
    if (c >= nchunks) return;
    const int s = c % kStagesA;
    const bf16* part = tile_a + s * kSlotA + rank * kPartA;
    for (uint32_t q = 1; q < kCluster; ++q)
      bulk_copy_to_cluster(part, kPartA * sizeof(bf16), &full_a[s], (rank + q) % kCluster);
    mbar_expect(&full_a[s], (kCluster - 1) * kPartA * sizeof(bf16));
  };
  auto release = [&](int c) {
    if (c < 0) return;
#pragma unroll
    for (uint32_t q = 0; q < kCluster; ++q) mbar_arrive_cluster(&free_a[c % kStagesA], q);
  };

  if (tid == 0) {
    for (int i = 0; i < kStagesW; ++i) mbar_init(&full_w[i]);
    for (int i = 0; i < kStagesH; ++i) mbar_init(&full_h[i]);
    for (int i = 0; i < kStagesA; ++i) mbar_init(&full_a[i]);
    for (int i = 0; i < kStagesA; ++i) mbar_init_count(&free_a[i], kCluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any copy or arrival
  if (tid == 0) {
    for (int c = 0; c < kAheadW; ++c) load_w(c);
    for (int c = 0; c < kAheadH; ++c) load_h(c);
  }
  for (int c = 0; c < kLeadA; ++c) {
    gate(c);
    __syncthreads();
    if (tid == 0) publish(c);
  }

  const int wg = tid >> 7;  // warpgroup: output columns col0 + 160 wg ..
  float d[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) d[i] = 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(&full_a[c % kStagesA], (c / kStagesA) & 1);  // the other blocks' rows of chunk c
    mbar_wait(&full_w[c % kStagesW], (c / kStagesW) & 1);
    const bf16* sa = tile_a + (c % kStagesA) * kSlotA;
    const bf16* sw = ring_w + (c % kStagesW) * kSlotW + wg * kWN * kKC;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
      wgmma_m64n160k16_ss(d, smem_desc(sa + kk * 128, 128, 1024), smem_desc_sw128(sw + kk * 16));
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's products of chunk c - 1 are done
    __syncthreads();  // both warpgroups': chunk c - 1's A tile and W slot are free here
    if (tid == 0) {
      release(c - 1);
      load_w(c + kAheadW);
      load_h(c + kAheadH);
    }
    gate(c + kLeadA);
    __syncthreads();  // every thread's rows of chunk c + 2 are in the A tile
    if (tid == 0) publish(c + kLeadA);
  }
  wgmma_wait<0>();
  cluster_sync();  // no copy or arrival into this block is still on its way

  // epilogue: the bias in f32 on the accumulators (the m16n8 C fragment
  // layout: rows g and g + 8 of the warp's 16, columns 8 j + 2 t, + 1),
  // rounded to bf16 into a 64 x 320 tile, then stored as 16-byte vectors
  bf16* ot = ring_w;
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n8 = 0; n8 < kWN / 8; ++n8) {
    const int cl = wg * kWN + n8 * 8 + 2 * tq, col = col0 + cl;
    const float b0 = col < C ? b[col] : 0.0f, b1 = col + 1 < C ? b[col + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + gr + 8 * h;
      *reinterpret_cast<uint32_t*>(ot + r * kLDO + cl) =
          pack_bf16(d[4 * n8 + 2 * h] + b0, d[4 * n8 + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  for (int e = tid; e < kBM * (kBN / 8); e += kThreads) {
    const int r = e / (kBN / 8), v = e % (kBN / 8);
    const int row = row0 + r, col = col0 + v * 8;
    if (row < T && col < C)
      store_vec8(out + (long long)row * C + col, load_vec8(ot + r * kLDO + v * 8));
  }
}

// tensor map of a row-major (rows, cols) bf16 matrix, boxes of 64 columns x
// box_rows rows in the 128-byte swizzle, zeros outside the matrix
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return make_map_2d(map, base, rows, cols, (long long)cols * sizeof(bf16), box_rows);
}

}  // namespace
}  // namespace e2v

// h2 (T, 2I) bf16; w (C, I) bf16 (nn.Linear layout); b (C) f32; out (T, C)
// bf16. I % 64 == 0, C % 8 == 0, h2 and w 16-byte aligned. Returns the CUDA
// launch status.
extern "C" int e2v_geglu_out(const void* h2, const void* w, const void* b, void* out, int T,
                             int I, int C, void* stream) {
  using namespace e2v;
  if (I < kKC || I % kKC != 0 || C < 1 || C % 8 != 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  CUtensorMap map_h2, map_w;
  if (!make_map(&map_h2, h2, T, 2 * I, kGR) || !make_map(&map_w, w, C, I, kWN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      geglu_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((C + kBN - 1) / kBN + kCluster - 1) / kCluster * kCluster,
                  (T + kBM - 1) / kBM);
  geglu_out_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      map_h2, map_w, static_cast<const float*>(b), static_cast<bf16*>(out), T, I, C);
  return (int)cudaGetLastError();
}
