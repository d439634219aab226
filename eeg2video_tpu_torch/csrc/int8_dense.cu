// int8_dense: weight-only int8 dense layer,
//   out[m, n] = (sum_k bf16(x[m, k]) * bf16(w_q[k, n])) * scale[n] + bias[n],
// f32 accumulation, f32 in and out.
//
// Replaces (JAX package): eeg2video_tpu/ops/int8_dense.py _int8_dense_kernel
// (:62, pallas_call at :76), the five layers of the 894M-parameter semantic
// MLP behind `serve --semantic_int8` (310 -> 4 x 10000 -> 59136, 100 rows a
// call).
//
// What bounds it on the H100: bytes. The out layer streams a (10016, 59392)
// int8 weight, 595 MB, 0.178 ms at 3.35 TB/s, against 119 GFLOP at 100 rows;
// a middle layer 103 MB. Three costs stand behind the weight's bytes: the
// int8 -> bf16 step for every weight element (a cvt takes the conversion
// pipe, 16 a clock on an SM), the L2 reads of x by every column block, and
// the tensor cores at 100 rows. The Pallas grid keeps all of K for 512
// columns in VMEM, 5 MB, which no SM holds; it is not carried over.
//
// Design (redesigned for Hopper; the first version was bf16 WMMA on 128
// columns, converted with cvt and staged through shared memory):
//   - products swapped: out^T = W^T x^T. A warpgroup's wgmma M is 64 output
//     columns, its N is x's rows (8 or 104 instantiated: 8 up to 8 rows, 104
//     above, which holds the serving chunk's 100; more rows take more row
//     blocks of 104; N = 128 did not fit the registers a thread has beside
//     the producer warp). A block owns 256 columns: two consumer warpgroups of
//     two m64nNk16 products each per k16 step, N accumulators a thread;
//   - W comes by TMA (a 2-D uint8 tensor map read as quantize_int8 lays it
//     out, N contiguous: boxes of 128 columns x 64 k in the 128-byte swizzle,
//     zeros past Kp and Np) into a four-stage ring (16 KB of W a slot; 4
//     stages ran the out layer 3% faster than 6 or 7), one mbarrier a slot,
//     from a producer warp;
//   - the int8 -> bf16 step without a conversion instruction: ldmatrix .trans
//     of the swizzled int8 tile hands each thread, in one register, the bytes
//     W[k][n], W[k][n + 1], W[k + 1][n], W[k + 1][n + 1] (two output columns
//     at two k): the wgmma A fragment's pairs along k for the rows (columns)
//     n and n + 1, once the A rows of a warp are ordered 2 g -> row g,
//     2 g + 1 -> row g + 8. Each byte is XORed with 0x80 (one LOP3 for four),
//     permuted into the low byte of 0x4B000000 (PRMT: 2^23 + v + 128 as f32,
//     exact), 8388736.0f subtracted (FADD: v, exact); v has at most 8
//     significant bits, so its bf16 is the f32's upper half and a second
//     PRMT packs two. The SASS of a step (16 elements a thread): 1 LDSM, 4
//     LOP3, 24 PRMT, 16 FADD, 2.81 instructions an element, and no I2F / F2F
//     / F2FP in the kernel (chip_smoke.py's build phase reads it). The
//     fragments go to wgmma from registers: the bf16 W tile never touches
//     shared memory. A warpgroup converts step i + 2 while its products of
//     steps i and i + 1 run (four fragment sets, each rewritten once
//     wgmma.wait_group 2 has seen its last reader finish; two sets and one
//     step ahead ran the out layer 8% slower);
//   - x, rounded to bf16 once by a first pass over the call's rows, is the B
//     operand, K-major by descriptor: a slab of 64 k for the block's rows, in
//     the ring beside W. A cluster of four neighbouring column blocks shares
//     it: each block loads a quarter of its 8-row boxes by TMA multicast into
//     all four, so x is read from L2 once per 1024 columns (out layer: 58 x
//     2.0 MB = 116 MB, 0.19 x the weight's bytes, against 0.93 GB for the
//     first version). A slot is refilled once every consumer warp of the
//     cluster has released it (remote mbarrier arrivals). Without the cluster
//     the out layer ran 12% slower;
//   - the GEMM is launched behind the first pass (programmatic dependent
//     launch): its set-up and the ring's first W copies overlap that pass,
//     and only the x copies and the counters wait for it (griddepcontrol);
//   - K is split over blocks where the clusters of column tiles fill fewer
//     than the card's 33 cluster slots (int8_plan.cuh, from (Kp, Np) alone:
//     the first and middle layers 3 splits, 120 blocks; the out layer none,
//     232 blocks in 58 clusters, 30 of which the card holds at once). The
//     splits of a tile count their arrival; the earlier ones write their f32
//     partial sums and count them written; the last one keeps its own sums
//     in shared memory, waits for the others', adds all in split order and
//     applies scale and bias: the same bits every run, no atomics on the
//     sums. Clusters of a tile's splits adding through distributed shared
//     memory ran the middle layers 1.6x slower: a cluster of 2 x 3 blocks
//     fits 17 times on the card, against the 20 the layer needs. Without a
//     split the epilogue stores from the accumulators.
// Every output element is a sum over K in one fixed order (split by split,
// slab by slab, k16 by k16); the split does not depend on M, and rows never
// share a reduction. The output's bits equal the first version's.
#include "hopper.cuh"
#include "int8_plan.cuh"

namespace e2v {
namespace {

using namespace int8_plan;

constexpr int kConsumerWarps = 8;                   // two warpgroups, 128 columns each
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;           // and the producer warp
constexpr int kBoxCols = kCols / 2;                 // a W box: 128 columns (bytes) x kSlabK k
constexpr int kSlotW = kCols * kSlabK;              // bytes of a slot's W: a box a warpgroup
constexpr int kXRows = 8;                           // x rows a TMA box: one 1024-byte swizzle atom
static_assert(smem_of(kMaxWidth) <= kSmemMax, "shared memory of one block");

// the end of the first pass (x in bf16, counters at zero) is visible to this
// thread; until then only the weight may be read
__device__ __forceinline__ void wait_first_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the first slab of each split and the end (int8_plan.cuh split_begin),
// computed on the host: the kernel divides nothing at run time
struct SplitTable {
  int begin[kMaxSplits + 1];
};

// 4 int8 values [W[k][n], W[k][n + 1], W[k + 1][n], W[k + 1][n + 1]] (one
// ldmatrix .trans register) -> the bf16 pairs (W[k][n], W[k + 1][n]) and
// (W[k][n + 1], W[k + 1][n + 1]), exact, with no conversion instruction
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& col0, uint32_t& col1) {
  const uint32_t u = w ^ 0x80808080u;  // each byte v + 128, in 0..255
  // 0x4B0000uu = 2^23 + u as f32; minus 2^23 + 128: v, exact
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  // |v| <= 128 has a zero low half in f32: its bf16 is the upper half
  col0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  col1 = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// x (M, K) f32 -> xb (M, Kp) bf16, zeros past K; the call's counters to zero
__global__ void int8_dense_prepare_kernel(const float* __restrict__ x, bf16* __restrict__ xb,
                                          int* __restrict__ counters, int ncounters, int M,
                                          int K, int Kp) {
  // the GEMM may launch now: it waits (griddepcontrol.wait) before it reads
  // what this pass writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int half = Kp / 2;
  const long long pairs = (long long)M * half;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = first; i < ncounters; i += stride) counters[i] = 0;
  for (long long i = first; i < pairs; i += stride) {
    const int m = (int)(i / half), k = (int)(i % half) * 2;
    const float* row = x + (long long)m * K;
    reinterpret_cast<__nv_bfloat162*>(xb)[i] =
        __floats2bfloat162_rn(k < K ? row[k] : 0.0f, k + 1 < K ? row[k + 1] : 0.0f);
  }
}

// grid (tiles, splits, row blocks), clusters of kCluster column tiles.
// splits == 1: out gets the finished result. splits > 1: each block writes
// part[(split, m, n)], and the last of a tile's blocks to arrive finishes it.
template <int NX>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    int8_dense_kernel(const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_x, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ counters, int M, int Np,
                      int n_out, const SplitTable splits_at) {
  constexpr int kSlotX = NX * kSlabK * 2;  // bytes of a slot's x: NX rows of kSlabK bf16
  static_assert(NX * kSumStride * 4 <= kStages * (kSlotW + kSlotX), "the sums fit the ring");
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ int finisher;
  // the swizzled boxes start on a 1024-byte boundary (the same offset in every block)
  unsigned char* ring_w = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring_x = ring_w + kStages * kSlotW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int s_begin = splits_at.begin[split];
  const int nsl = splits_at.begin[split + 1] - s_begin;
  const int col0 = tile * kCols, row0 = blockIdx.z * NX;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i]);  // the producer's arrival with the slot's bytes
      mbar_init_count(&empty[i], kConsumerWarps * kCluster);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any copy or arrival

  if (warp == kConsumerWarps) {
    // the producer: slab s of this split into slot s % kStages, once every
    // consumer warp of the cluster has released the slot's last slab
    if (lane == 0) {
      const uint32_t rank = cluster_rank();
      auto load_w = [&](int s) {  // slab s's W, and the slot's expected bytes
        const int slot = s % kStages;
        mbar_expect(&full[slot], kSlotW + kSlotX);  // this block's W, x from the whole cluster
        unsigned char* w = ring_w + slot * kSlotW;
        const int k0 = (s_begin + s) * kSlabK;
        tma_load_2d(w, &map_w, col0, k0, &full[slot]);
        tma_load_2d(w + kBoxCols * kSlabK, &map_w, col0 + kBoxCols, k0, &full[slot]);
      };
      auto load_x = [&](int s) {  // this block's share of slab s's x, into the whole cluster
        const int slot = s % kStages;
        for (int b = (int)rank; b < NX / kXRows; b += kCluster)
          tma_load_2d_multicast(ring_x + slot * kSlotX + b * kXRows * 128, &map_x,
                                (s_begin + s) * kSlabK, row0 + b * kXRows, &full[slot],
                                (1u << kCluster) - 1);
      };
      // the ring's first slabs of W while the first pass may still run
      const int first = nsl < kStages ? nsl : kStages;
      for (int s = 0; s < first; ++s) load_w(s);
      wait_first_pass();
      for (int s = 0; s < first; ++s) load_x(s);
      for (int s = first; s < nsl; ++s) {
        mbar_wait(&empty[s % kStages], (s / kStages - 1) & 1);
        load_w(s);
        load_x(s);
      }
    }
    __syncwarp();
    cluster_sync();  // no copy or arrival into this block is still on its way
    return;
  }

  // consumer warp wq of warpgroup wg: output columns col0 + 128 wg + 64 j +
  // 16 wq .. (j = 0, 1: the two m64 products), x rows row0 ..
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  // this lane's row address of ldmatrix .x4 .trans: matrix lane / 8 is (k
  // rows 0-7 | 8-15 of the step) x (product 0 | 1), 16 columns each; row r's
  // 16-byte piece p of a swizzled box lies at piece p ^ (r % 8)
  const int a_off = wg * kBoxCols * kSlabK + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 128 +
                    (((wq + 4 * (lane >> 4)) ^ (lane & 7)) << 4);
  float d0[NX / 2], d1[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) d0[i] = d1[i] = 0.0f;
  // four sets of A fragments, one for each k16 step of a slab: [product 0:
  // a0-a3 | product 1: a0-a3]
  uint32_t f0[8], f1[8], f2[8], f3[8];

  // the fragments of k16 step kk of slab s, converted to bf16
  auto frags = [&](uint32_t (&f)[8], int s, int kk) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, ring_w + (s % kStages) * kSlotW + kk * 16 * 128 + a_off);
#pragma unroll
    for (int i = 0; i < 4; ++i) int8x4_to_bf16x2(r[i], f[2 * i], f[2 * i + 1]);
  };
  // the products of k16 step kk of slab s (one wgmma group)
  auto step = [&](const uint32_t (&f)[8], int s, int kk) {
    const uint64_t desc = smem_desc_sw128(ring_x + (s % kStages) * kSlotX + kk * 32);
    wgmma_fence();
    wgmma_m64k16_rs<NX>(d0, f, desc);
    wgmma_m64k16_rs<NX>(d1, f + 4, desc);
    wgmma_commit();
  };
  // this warp is done with slab s's slot, in every block of the cluster
  auto release = [&](int s) {
    if (lane < kCluster) mbar_arrive_cluster(&empty[s % kStages], lane);
  };
  // slab s's products; with `ahead`, the first two steps of slab s + 1 are
  // converted too (a literal at each call: no branch between the products)
  auto slab = [&](int s, bool ahead) {
    step(f0, s, 0);
    wgmma_wait<2>();
    frags(f2, s, 2);
    step(f1, s, 1);
    wgmma_wait<2>();  // slab s - 1's last products are done: its slot is free
    if (s > 0) release(s - 1);
    frags(f3, s, 3);
    step(f2, s, 2);
    wgmma_wait<2>();
    if (ahead) {
      mbar_wait(&full[(s + 1) % kStages], ((s + 1) / kStages) & 1);
      frags(f0, s + 1, 0);
    }
    step(f3, s, 3);
    wgmma_wait<2>();
    if (ahead) frags(f1, s + 1, 1);
  };

  // the conversion runs two steps ahead of the products: once step i is
  // issued, wgmma.wait_group 2 leaves steps i and i - 1 running and frees the
  // fragments of step i - 2 for step i + 2
  if (nsl > 0) {
    mbar_wait(&full[0], 0);
    frags(f0, 0, 0);
    frags(f1, 0, 1);
    for (int s = 0; s + 1 < nsl; ++s) slab(s, true);
    slab(nsl - 1, false);
  }
  wgmma_wait<0>();

  // epilogue. Accumulator i of product j (the m64nN C fragment: rows g and
  // g + 8 of the warp's 16, columns 8 q + 2 t, + 1 for i = 4 q ..) is output
  // column c (row g) or c + 1 (row g + 8) of x row 8 q + 2 t (+ 1)
  const int rows = min(NX, M - row0);
  auto write = [&](const float (&d)[NX / 2], int j) {
    const int c = col0 + wg * kBoxCols + 64 * j + 16 * wq + 2 * g;
    if (splits > 1) {  // this split's partial sums, columns past n_out too (c < Np)
      if (c >= Np) return;
#pragma unroll
      for (int q = 0; q < NX / 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * q + 2 * t + h;
          if (r < rows)
            *reinterpret_cast<float2*>(part + ((long long)split * M + row0 + r) * Np + c) =
                make_float2(d[4 * q + h], d[4 * q + 2 + h]);
        }
      return;
    }
    if (c >= n_out) return;
    const bool two = c + 1 < n_out, pair = two && (n_out & 1) == 0;
    const float s0 = scale[c], b0 = bias[c];
    const float s1 = scale[c + 1], b1 = two ? bias[c + 1] : 0.0f;
#pragma unroll
    for (int q = 0; q < NX / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * q + 2 * t + h;
        if (r >= rows) continue;
        float* o = out + (long long)(row0 + r) * n_out + c;
        const float v0 = d[4 * q + h] * s0 + b0, v1 = d[4 * q + 2 + h] * s1 + b1;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
  };
  if (splits > 1) {
    // the splits of a tile arrive in some order; the last to arrive adds all
    // the tile's sums in split order: the others' partials once they are
    // written, its own from shared memory (the ring: every copy into it has
    // landed)
    int* arrived = counters + 2 * (blockIdx.z * gridDim.x + tile);
    int* written = arrived + 1;
    float* sums = reinterpret_cast<float*>(ring_w);
    wait_first_pass();  // the counters are zero
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      int before;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(before)
                   : "l"(arrived)
                   : "memory");
      finisher = before == splits - 1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (!finisher) {
      write(d0, 0);
      write(d1, 1);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (tid == 0) asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(written) : "memory");
    } else {
      auto keep = [&](const float (&d)[NX / 2], int j) {
        const int c = wg * kBoxCols + 64 * j + 16 * wq + 2 * g;
#pragma unroll
        for (int q = 0; q < NX / 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(sums + (8 * q + 2 * t + h) * kSumStride + c) =
                make_float2(d[4 * q + h], d[4 * q + 2 + h]);
      };
      keep(d0, 0);
      keep(d1, 1);
      if (tid == 0) {
        int n = 0;
        do {
          asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(n) : "l"(written) : "memory");
        } while (n < splits - 1);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      // 4 columns a thread, the tile's rows in turn; the loads of kUnroll
      // items of kBatch splits are in flight together. Columns at and past
      // Np (a tile of the last cluster may lie past it, in part or whole)
      // have no partial sums: nothing is read there, and nothing is written
      constexpr int kQuads = kCols / 4, kUnroll = 4, kBatch = 4;
      const int items = rows * kQuads;
      const bool quads = (n_out & 3) == 0;  // out's rows keep 16-byte alignment
      for (int first = tid; first < items; first += kUnroll * kConsumers) {
        float4 acc[kUnroll];
        for (int sp0 = 0; sp0 < splits; sp0 += kBatch) {
          float4 v[kBatch][kUnroll];
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int i = first + u * kConsumers, sp = sp0 + b;
              const int r = i / kQuads, c = 4 * (i % kQuads);
              if (sp < splits && i < items && col0 + c < Np)
                v[b][u] = sp == split
                              ? *reinterpret_cast<const float4*>(sums + r * kSumStride + c)
                              : __ldcg(reinterpret_cast<const float4*>(
                                    part + ((long long)sp * M + row0 + r) * Np + col0 + c));
            }
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (sp0 + b < splits) {
                if (sp0 + b == 0) {
                  acc[u] = v[b][u];
                } else {
                  acc[u].x += v[b][u].x;
                  acc[u].y += v[b][u].y;
                  acc[u].z += v[b][u].z;
                  acc[u].w += v[b][u].w;
                }
              }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = first + u * kConsumers, c = col0 + 4 * (i % kQuads);
          if (i >= items || c >= n_out) continue;
          const float a[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = c + e < n_out ? a[e] * scale[c + e] + bias[c + e] : 0.0f;
          float* o = out + (long long)(row0 + i / kQuads) * n_out + c;
          if (quads) {
            *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < n_out) o[e] = y[e];
          }
        }
      }
    }
  } else {
    write(d0, 0);
    write(d1, 1);
  }
  cluster_sync();  // no copy or arrival into this block is still on its way
}

template <int NX>
int launch(const Plan& p, const CUtensorMap& map_w, const CUtensorMap& map_x, const float* scale,
           const float* bias, float* out, float* part, int* counters, int M, int Np, int n_out,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_dense_kernel<NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  SplitTable at{};
  for (int i = 0; i <= p.splits; ++i) at.begin[i] = split_begin(p.slabs, p.splits, i);
  // launched behind the first pass while it runs (programmatic dependent
  // launch): the block's set-up and first weight copies overlap it
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.splits, p.row_blocks);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_dense_kernel<NX>, map_w, map_x, scale, bias, out, part,
                           counters, M, Np, n_out, at);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NX>
int max_clusters(const Plan& p) {
  if (cudaFuncSetAttribute(int8_dense_kernel<NX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.splits, p.row_blocks);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, int8_dense_kernel<NX>, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace
}  // namespace e2v

// x (M, K) f32; wq (Kp, Np) int8, N contiguous, 16-byte aligned; scale (Np)
// f32; bias (n_out) f32; out (M, n_out) f32; ws: the call's workspace
// (int8_plan.cuh workspace_bytes, 256-byte aligned), ws_bytes its size.
// Kp % 32 == 0, Np % 128 == 0, K <= Kp, n_out <= Np. Returns the CUDA launch
// status.
extern "C" int e2v_int8_dense(const void* x, const void* wq, const void* scale, const void* bias,
                              void* out, void* ws, long long ws_bytes, int M, int K, int Kp,
                              int Np, int n_out, void* stream) {
  using namespace e2v;
  using namespace e2v::int8_plan;
  if (M < 1 || K < 1 || Kp % 32 != 0 || Np % kBoxCols != 0 || K > Kp || n_out < 1 ||
      n_out > Np)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, Kp, Np);
  if (ws_bytes < workspace_bytes(p, M, Kp, Np)) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  int* counters = reinterpret_cast<int*>(w);
  bf16* xb = reinterpret_cast<bf16*>(w + counters_bytes(p));
  float* part = p.splits > 1
                    ? reinterpret_cast<float*>(w + counters_bytes(p) + xb_bytes(M, Kp))
                    : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const int ncounters = p.tiles * p.row_blocks * 2;
  const long long pairs = (long long)M * Kp / 2;
  const long long items = pairs > ncounters ? pairs : ncounters;
  const int blocks = (int)((items + 255) / 256 < 1024 ? (items + 255) / 256 : 1024);
  int8_dense_prepare_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), xb, counters,
                                                    ncounters, M, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_w, map_x;
  if (!make_map_2d_of(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, Kp, Np, Np, kBoxCols, kSlabK) ||
      !make_map_2d_of(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb, M, Kp, 2LL * Kp, kSlabK,
                      kXRows))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  return p.width == 8
             ? launch<8>(p, map_w, map_x, sc, bi, o, part, counters, M, Np, n_out, st)
             : launch<kMaxWidth>(p, map_w, map_x, sc, bi, o, part, counters, M, Np, n_out, st);
}

// The plan of a call (int8_plan.cuh), for the wrapper and the reports: out[0]
// the workspace bytes e2v_int8_dense takes, out[1] the bytes of x its blocks
// read from L2, out[2..5] the column tiles, splits, x rows a block and row
// blocks, and with `occupancy` out[6] the clusters the card holds at once
// (the launch runs in waves of that many; -1 if the query failed).
extern "C" int e2v_int8_dense_plan(int M, int Kp, int Np, int occupancy, long long* out) {
  using namespace e2v;
  using namespace e2v::int8_plan;
  if (M < 1 || Kp < 1 || Np < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, Kp, Np);
  out[0] = workspace_bytes(p, M, Kp, Np);
  out[1] = x_l2_read_bytes(p, M, Kp);
  out[2] = p.tiles;
  out[3] = p.splits;
  out[4] = p.width;
  out[5] = p.row_blocks;
  if (occupancy) out[6] = p.width == 8 ? max_clusters<8>(p) : max_clusters<kMaxWidth>(p);
  return 0;
}
