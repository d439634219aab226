// geglu_out_bwd: input gradient of the gate-fused out-projection
// (geglu_out.cu), out = (h * gelu(gate)) W^T + b with [h | gate] = h2:
//   dgated = g W,   dh2 = [dgated gelu(gate) | dgated h gelu'(gate)]
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _geglu_bwd_kernel (:113),
// the feed-forward backward of the C = 1280 levels. The weight and bias
// gradients are not computed here: the caller forms them with plain ops when
// a parameter asks for one.
//
// What bounds it on the H100: a 2*T*C*I FLOP GEMM (T = 8640, C = 1280,
// I = 5120: 113 GFLOP) whose epilogue reads the (T, 2I) h2 once and writes
// the (T, 2I) dh2 once (177 MB each): the two limits nearly meet at these
// shapes (0.116 ms by bytes at 3.35 TB/s, 0.1145 ms by operations at 989
// TFLOP/s). dgated and the gated product never reach device memory.
//
// Design (redesigned for Hopper; the first version was 64 x 64 WMMA tiles
// with synchronous loads and an element-wise epilogue):
//   - a block owns 128 x 128 tiles of dgated (T x I): two warpgroups, each
//     one wgmma.mma_async m64n128k16 product (bf16 -> f32, 64 accumulators a
//     thread) per k16 step, A and B by descriptor. The grid is persistent
//     (one block an SM, tiles t = blockIdx.x, + gridDim.x, ... in row-block
//     order), so the copies of a tile's first slabs are in flight during the
//     previous tile's epilogue;
//   - K = C is walked in 64-wide slabs through a four-stage ring filled by
//     TMA (2-D tensor maps made per call in the C entry, boxes of 64 columns
//     in the 128-byte swizzle, zeros past T, C and I), three slabs ahead,
//     counted on mbarriers: A is g (T, C) K-major (smem_desc_sw128), B is W
//     (C, I) as it lies in nn.Linear layout, rows c of 64 values of i:
//     MN-major (smem_desc_sw128_mn, wgmma's tnsp-b), no transposed copy;
//   - the tile's h and gate columns of h2 (4 boxes, 64 KB) come by TMA while
//     the tile's products run. The epilogue reads them from the swizzled
//     boxes at the accumulators' fragment positions (conflict-free: the
//     8 rows of a fragment fall into 8 different 16-byte pieces), computes
//     gelu(gate) and gelu'(gate) in f32 with erff as the plain version,
//     writes both halves of dh2 over h and gate in place and stores them by
//     TMA (rows past T and columns past I are not written). The buffer is
//     refilled for the next tile once that store has read it, during the
//     next tile's main loop.
// Every output row is a sum over K in one fixed order (slab by slab, k16 by
// k16); rows never share a reduction and no split depends on T: a row's bits
// do not depend on T or on the other rows in the call.
// L2 reads per call: g once per column of tiles, W once per row of tiles, h2
// once (ops/geglu.py geglu_out_bwd_l2_read_bytes).
#include "ff_tiles.cuh"
#include "hopper.cuh"

namespace e2v {
namespace {

constexpr int kBM = 128;                  // rows (T) a tile: two m64 warpgroups
constexpr int kBN = 128;                  // columns (I) a tile: one n128 product each
constexpr int kKC = 64;                   // C a slab: one 128-byte swizzle row of g
constexpr int kThreads = 256;
constexpr int kStages = 4, kAhead = kStages - 1;  // slab ring; slabs a copy starts early
constexpr int kSlotA = kBM * kKC;         // bf16 values: g rows of the tile, one slab of C
constexpr int kBoxW = kKC * 64;           // a 64 (c) x 64 (i) box of W
constexpr int kSlotB = 2 * kBoxW;         // W rows of the slab, the tile's 128 columns
constexpr int kBoxE = kBM * 64;           // a 128-row x 64-column box of h or gate
constexpr size_t kSmem = 1024  // slack: the swizzled boxes start on a 1024-byte boundary
                         + (size_t)(kStages * (kSlotA + kSlotB) + 4 * kBoxE) * sizeof(bf16);
static_assert(kSmem <= kSmemMax, "shared memory of one block");

__global__ void __launch_bounds__(kThreads, 1)
    geglu_out_bwd_kernel(const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_gate,
                         const __grid_constant__ CUtensorMap map_dh,
                         const __grid_constant__ CUtensorMap map_dgate, int T, int I, int C) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], full_e;  // a slab / a tile's h and gate landed
  bf16* ring_a = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* ring_b = ring_a + kStages * kSlotA;
  bf16* epi = ring_b + kStages * kSlotB;  // [h cols 0-63, h 64-127, gate 0-63, gate 64-127]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (I + kBN - 1) / kBN;
  const int ntiles = (T + kBM - 1) / kBM * tiles_n;
  const int nslabs = (C + kKC - 1) / kKC;
  const int grid = gridDim.x;
  // this block's j-th tile: rows row0.., columns col0..
  auto tile_at = [&](int j, int& row0, int& col0) {
    const int t = blockIdx.x + j * grid;
    row0 = t / tiles_n * kBM;
    col0 = t % tiles_n * kBN;
    return t < ntiles;
  };
  // by thread 0: slab s of this block's sequence (tile s / nslabs, slab s % nslabs)
  auto load_slab = [&](int s) {
    int row0, col0;
    if (!tile_at(s / nslabs, row0, col0)) return;
    const int c0 = s % nslabs * kKC, slot = s % kStages;
    uint64_t* bar = &full[slot];
    mbar_expect(bar, (kSlotA + kSlotB) * sizeof(bf16));
    tma_load_2d(ring_a + slot * kSlotA, &map_g, c0, row0, bar);
    tma_load_2d(ring_b + slot * kSlotB, &map_w, col0, c0, bar);
    tma_load_2d(ring_b + slot * kSlotB + kBoxW, &map_w, col0 + 64, c0, bar);
  };
  // by thread 0: the h and gate columns of tile j
  auto load_epi = [&](int j) {
    int row0, col0;
    if (!tile_at(j, row0, col0)) return;
    mbar_expect(&full_e, 4 * kBoxE * sizeof(bf16));
    tma_load_2d(epi, &map_h, col0, row0, &full_e);
    tma_load_2d(epi + kBoxE, &map_h, col0 + 64, row0, &full_e);
    tma_load_2d(epi + 2 * kBoxE, &map_gate, col0, row0, &full_e);
    tma_load_2d(epi + 3 * kBoxE, &map_gate, col0 + 64, row0, &full_e);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
    mbar_init(&full_e);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kAhead; ++s) load_slab(s);
    load_epi(0);
  }

  // the epilogue's fragment positions (the m16n8 C fragment layout: rows g
  // and g + 8 of the warp's 16, columns 8 j + 2 t, + 1), in the swizzled
  // boxes: row r's 16-byte piece p of a 128-byte row lies at piece p ^ (r % 8)
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int r0 = 64 * wg + 16 * wq + (lane >> 2), tq = lane & 3;

  float d[64];
  int row0, col0;
  for (int j = 0; tile_at(j, row0, col0); ++j) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    for (int c = 0; c < nslabs; ++c) {
      const int s = j * nslabs + c;
      mbar_wait(&full[s % kStages], (s / kStages) & 1);
      const bf16* sa = ring_a + (s % kStages) * kSlotA + wg * 64 * kKC;
      const bf16* sb = ring_b + (s % kStages) * kSlotB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
        wgmma_m64n128k16_ss_tb(d, smem_desc_sw128(sa + kk * 16),
                               smem_desc_sw128_mn(sb + kk * 16 * 64, kBoxW * sizeof(bf16)));
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's products of slab s - 1 are done
      __syncthreads();  // both warpgroups': slab s - 1's slot is free
      if (tid == 0) {
        load_slab(s + kAhead);
        // the last tile's dh2 store has read the buffer: this tile's h and gate in
        if (j > 0 && c == (nslabs > 1 ? 1 : 0)) {
          bulk_wait_read();
          load_epi(j);
        }
      }
    }
    wgmma_wait<0>();
    mbar_wait(&full_e, j & 1);
#pragma unroll
    for (int n8 = 0; n8 < kBN / 8; ++n8) {
      const int box = n8 / 8, piece = n8 % 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int at = box * kBoxE + r * 64 + ((piece ^ (r & 7)) << 3) + 2 * tq;
        uint32_t* ph = reinterpret_cast<uint32_t*>(epi + at);
        uint32_t* pg = reinterpret_cast<uint32_t*>(epi + 2 * kBoxE + at);
        const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ph));
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pg));
        float gelu0, dgelu0, gelu1, dgelu1;
        gelu_erf_grad(gv.x, gelu0, dgelu0);
        gelu_erf_grad(gv.y, gelu1, dgelu1);
        const float dg0 = d[4 * n8 + 2 * h], dg1 = d[4 * n8 + 2 * h + 1];
        *ph = pack_bf16(dg0 * gelu0, dg1 * gelu1);
        *pg = pack_bf16(dg0 * hv.x * dgelu0, dg1 * hv.y * dgelu1);
      }
    }
    fence_proxy_async();  // the writes above are read by the TMA store (async proxy)
    __syncthreads();
    if (tid == 0) {
      tma_store_2d(&map_dh, col0, row0, epi);
      tma_store_2d(&map_dh, col0 + 64, row0, epi + kBoxE);
      tma_store_2d(&map_dgate, col0, row0, epi + 2 * kBoxE);
      tma_store_2d(&map_dgate, col0 + 64, row0, epi + 3 * kBoxE);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();  // the last stores are done before the block ends
}

}  // namespace
}  // namespace e2v

// h2, dh2 (T, 2I) bf16; g (T, C) bf16; w (C, I) bf16 (nn.Linear layout).
// C % 32 == 0, I % 8 == 0, every pointer 16-byte aligned. Returns the CUDA
// launch status.
extern "C" int e2v_geglu_out_bwd(const void* h2, const void* g, const void* w, void* dh2, int T,
                                 int I, int C, void* stream) {
  using namespace e2v;
  if (C < 32 || C % 32 != 0 || I < 8 || I % 8 != 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const long long row2 = 2LL * I * sizeof(bf16);  // bytes of an h2 / dh2 row
  const bf16* h2b = static_cast<const bf16*>(h2);
  bf16* dh2b = static_cast<bf16*>(dh2);
  CUtensorMap map_g, map_w, map_h, map_gate, map_dh, map_dgate;
  if (!make_map_2d(&map_g, g, T, C, (long long)C * sizeof(bf16), kBM) ||
      !make_map_2d(&map_w, w, C, I, (long long)I * sizeof(bf16), kKC) ||
      !make_map_2d(&map_h, h2b, T, I, row2, kBM) ||
      !make_map_2d(&map_gate, h2b + I, T, I, row2, kBM) ||
      !make_map_2d(&map_dh, dh2b, T, I, row2, kBM) ||
      !make_map_2d(&map_dgate, dh2b + I, T, I, row2, kBM))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geglu_out_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (T + kBM - 1) / kBM * ((I + kBN - 1) / kBN);
  geglu_out_bwd_kernel<<<ntiles < sms ? ntiles : sms, kThreads, kSmem, (cudaStream_t)stream>>>(
      map_g, map_w, map_h, map_gate, map_dh, map_dgate, T, I, C);
  return (int)cudaGetLastError();
}
