// Hopper (sm_90a) building blocks shared by the kernels on wgmma: the
// level-0 conv (conv3x3.cu), the GEGLU out-projection (geglu_out.cu) and its
// backward (geglu_out_bwd.cu), the int8 dense layer (int8_dense.cu); the
// temporal backward's bulk copies.
//
// - shared-memory matrix descriptors of bf16 operands: K-major in the 8 x 8
//   core-matrix layout without swizzle (smem_desc), K-major rows of 64 bf16
//   (128 bytes) in the 128-byte swizzle that a TMA load with
//   CU_TENSOR_MAP_SWIZZLE_128B writes (smem_desc_sw128), and MN-major rows
//   of 64 bf16 along N in the same swizzle (smem_desc_sw128_mn);
// - wgmma.mma_async m64n160k16 (bf16 -> f32): A from registers (the m16n8k16
//   A fragment of each warp's 16 rows) or from shared memory, B from shared
//   memory, 80 f32 accumulators a thread; m64n128k16 with both by descriptor
//   and B MN-major (64 accumulators); m64nNk16 with A from registers and B
//   K-major by descriptor at N = 8 and 104; fence, commit and wait;
// - mbarriers counting the bytes of asynchronous copies: one arrival (the
//   copying thread's, with the byte count), completed by the copies;
// - copies by the bulk-copy engine: contiguous bytes device -> shared
//   (bulk_copy, bulk_load), a 2-D box of a tensor map device -> shared
//   (tma_load_2d; into every block of a cluster: tma_load_2d_multicast) and
//   shared -> device (tma_store_2d, with its bulk groups),
//   and contiguous bytes from this block's shared memory to another block's
//   of the cluster (bulk_copy_to_cluster);
// - thread-block clusters: a block's rank, the cluster-wide barrier, and
//   arrivals on another block's mbarrier;
// - on the host: 2-D tensor maps in the 128-byte swizzle (make_map_2d for
//   bf16 matrices, make_map_2d_of for any element type; through libcuda's
//   cuTensorMapEncodeTiled).
#pragma once

#include <cuda.h>

#include "flash_tiles.cuh"

namespace e2v {

// Shared-memory matrix descriptor of a K-major bf16 operand without swizzle:
// 8 x 8 core matrices of 128 contiguous bytes, lbo bytes between core
// matrices along K, sbo bytes between them along N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 64
// values (128 bytes), the 16-byte pieces of row r at piece ^ (r % 8), 8-row
// groups 1024 bytes apart from a 1024-byte aligned base; the leading offset
// is unused (1). A k16 step inside the row advances p by 16 values (32 bytes).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major bf16 operand (B read as B^T: rows of the
// operand's K, each 64 values of N in 128 bytes) in the 128-byte swizzle, as
// a TMA box of 64 columns writes it: 8-row (K) groups 1024 bytes apart, the
// next 64 values of N lbo bytes on. A k16 step advances p by 16 rows (2048
// bytes).
__device__ __forceinline__ uint64_t smem_desc_sw128_mn(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Writes of the generic proxy (st.shared) to this block's shared memory are
// seen by the async proxy (wgmma operands read by descriptor, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define E2V_WGMMA_D80                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),           \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),           \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define E2V_WGMMA_D80_LIST                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"                     \
  " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"           \
  " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"           \
  " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"           \
  " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"           \
  " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"           \
  " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"           \
  " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"

// d (64 x 160 f32 over the warpgroup, 80 a thread) += A (64 x 16 bf16, the
// m16n8k16 A fragment of each warp's 16 rows) B (16 x 160, K-major in shared
// memory, by descriptor)
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 " E2V_WGMMA_D80_LIST ","
      " {%80, %81, %82, %83}, "
      "%84, p, 1, 1, 0;\n}\n"
      : E2V_WGMMA_D80
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 160 f32, 80 a thread) += A (64 x 16 bf16, K-major in shared memory,
// by descriptor) B (16 x 160, K-major in shared memory, by descriptor)
__device__ __forceinline__ void wgmma_m64n160k16_ss(float (&d)[80], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 " E2V_WGMMA_D80_LIST ","
      " %80, %81, p, 1, 1, 0, 0;\n}\n"
      : E2V_WGMMA_D80
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef E2V_WGMMA_D80
#undef E2V_WGMMA_D80_LIST

#define E2V_WGMMA_D64                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])
#define E2V_WGMMA_D64_LIST                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"                     \
  " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"           \
  " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"           \
  " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"           \
  " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"           \
  " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"           \
  " %60, %61, %62, %63}"

// d (64 x 128 f32 over the warpgroup, 64 a thread) += A (64 x 16 bf16,
// K-major in shared memory, by descriptor) B (16 x 128, MN-major in shared
// memory, by descriptor: tnsp-b = 1)
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64], uint64_t desc_a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " E2V_WGMMA_D64_LIST ","
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : E2V_WGMMA_D64
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef E2V_WGMMA_D64
#undef E2V_WGMMA_D64_LIST

// d (64 x N f32 over the warpgroup, N / 2 a thread) += A (64 x 16 bf16, the
// m16n8k16 A fragment of each warp's 16 rows, in registers: a[0..3]) B (16 x N,
// K-major in shared memory, by descriptor), at the widths int8_dense.cu
// instantiates
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2], const uint32_t* a,
                                                uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<8>(float (&d)[4], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<104>(float (&d)[52], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// mbarrier of a ring slot: one arrival (the copying thread's, with the
// slot's byte count), completed by the copies' bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
// the one arrival of a fill: the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) device -> shared
// by the bulk-copy engine, counted on bar, whose fill expected them (one
// mbar_expect may cover several copies)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one copy as above that is its mbarrier's whole fill
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// The box of a 2-D tensor map (a __grid_constant__ CUtensorMap) at element
// (x, y), x the contiguous dimension, device -> shared, counted on bar (whose
// fill expected the box's bytes: parts outside the tensor come as zeros and
// count too)
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
        "r"(smem_addr(bar))
      : "memory");
}

// the same box into every block of the cluster in `mask` (bit r: block r),
// at this block's offsets of dst and bar in each of them
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const void* map, int x, int y,
                                                      uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
        "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) shared -> device
// by the bulk-copy engine, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// The box of a 2-D tensor map at element (x, y) shared -> device, in this
// thread's current bulk group (parts outside the tensor are not written)
__device__ __forceinline__ void tma_store_2d(const void* map, int x, int y, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk groups have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk groups are complete (their writes done)
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- thread-block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}
// the address in block `rank` of the cluster of this block's shared address a
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// an mbarrier that completes a phase after `count` arrivals
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// one arrival on the mbarrier at bar's offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               ::"r"(cluster_addr(smem_addr(bar), rank))
               : "memory");
}
// bytes of this block's shared memory to the same offset in block `rank`,
// by the bulk-copy engine, counted on that block's mbarrier at bar's offset
__device__ __forceinline__ void bulk_copy_to_cluster(const void* src, uint32_t bytes,
                                                     uint64_t* bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(cluster_addr(smem_addr(src), rank)), "r"(smem_addr(src)), "r"(bytes),
        "r"(cluster_addr(smem_addr(bar), rank))
      : "memory");
}

// --- tensor maps (host) -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// tensor map of a (rows, cols) matrix of `type` whose rows start row_bytes
// apart (a multiple of 16, as base's address), boxes of box_cols columns (128
// bytes) x box_rows rows in the 128-byte swizzle, zeros outside the matrix
inline bool make_map_2d_of(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
                           int cols, long long row_bytes, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same for a bf16 matrix, boxes of 64 columns
inline bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols,
                        long long row_bytes, int box_rows) {
  return make_map_2d_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols, row_bytes, 64,
                        box_rows);
}

}  // namespace e2v
