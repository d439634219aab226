// wgmma_probe: the product work of one conv3x3_gn_silu call at the main
// shape (216 blocks of 256 pixels x 160 channels, K = 45 slabs of 64), with no
// copies, prologue or epilogue, on mma.sync.m16n8k16 (8 warps of 64 x 80, the
// first design of csrc/conv3x3.cu) and on wgmma.mma_async m64n160k16 (two
// warpgroups of two m64 tiles, A by ldmatrix into registers, B from shared
// memory by descriptor); also checks the descriptor of a K-major slab of 8 x 8
// core matrices against a host product. Standalone (not part of the library):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o probe wgmma_probe.cu && ./probe
#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

typedef __nv_bfloat16 bf16;

constexpr int LDA = 72;    // halo rows (pixels) of 64 channels + 8
constexpr int NPIX = 396;  // halo pixels: 6 rows x 66

__device__ __forceinline__ uint32_t su32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(su32(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// no swizzle: lbo bytes between core matrices along K, sbo along N
__device__ __forceinline__ uint64_t mkdesc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((su32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma160(float (&d)[80], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// B slab (160 x 64) as 8 x 8 core matrices: [n / 8][k / 8][n % 8][k % 8]
__device__ __forceinline__ int bidx(int n, int k) {
  return (n / 8) * 512 + (k / 8) * 64 + (n % 8) * 8 + (k % 8);
}

// one warpgroup: C (64 x 160) = A (64 x 64) B^T (B as 160 x 64), with lbo / sbo
__global__ void wg_check(const bf16* A, const bf16* B, float* C, int lbo, int sbo) {
  __shared__ __align__(128) bf16 As[64 * LDA];
  __shared__ __align__(128) bf16 Bs[160 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += 128) As[(i / 64) * LDA + i % 64] = A[i];
  for (int i = threadIdx.x; i < 160 * 64; i += 128) Bs[bidx(i / 64, i % 64)] = B[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float d[80];
  for (int i = 0; i < 80; ++i) d[i] = 0.f;
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm4(a, As + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA + kk * 16 +
                 (lane >> 4) * 8);
    wg_fence();
    wgmma160(d, a, mkdesc(Bs + kk * 16 * 8, lbo, sbo));
    wg_commit();
    wg_wait<0>();
  }
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0; j < 20; ++j)
    for (int e = 0; e < 4; ++e)
      C[(warp * 16 + g + (e >= 2 ? 8 : 0)) * 160 + j * 8 + 2 * t + (e & 1)] = d[j * 4 + e];
}

// 2 warpgroups x 2 m64 tiles (4 rows x 64 pixels) x 160, K = 45 slabs x 64: A by
// ldmatrix from a halo tile shifted per tap, B from one slab; SYNC: a barrier a
// slab; PIPE: one group in flight (A double-buffered) in place of none
template <bool SYNC, bool PIPE>
__global__ void __launch_bounds__(256, 1) wg_time(float* sink, int lbo, int sbo) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* halo = (bf16*)sm;
  bf16* slab = halo + NPIX * LDA;
  for (int i = threadIdx.x; i < NPIX * LDA + 160 * 64; i += 256)
    halo[i] = __float2bfloat16((i % 7) * 0.01f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wgi = warp >> 2, wq = warp & 3;
  float d0[80], d1[80];
  for (int i = 0; i < 80; ++i) d0[i] = d1[i] = 0.f;
  const int aoff = (wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA + (lane >> 4) * 8;
  uint32_t a[2][2][4];
  for (int s = 0; s < 45; ++s) {
    if (SYNC) __syncthreads();
    const int tap = s % 9;
    const bf16* hb = halo + aoff + ((tap / 3) * 66 + tap % 3) * LDA + (wgi * 2) * 66 * LDA;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t(&x0)[4] = a[kk & 1][0];
      uint32_t(&x1)[4] = a[kk & 1][1];
      ldsm4(x0, hb + kk * 16);
      ldsm4(x1, hb + 66 * LDA + kk * 16);
      wg_fence();
      const uint64_t desc = mkdesc(slab + kk * 16 * 8, lbo, sbo);
      wgmma160(d0, x0, desc);
      wgmma160(d1, x1, desc);
      wg_commit();
      if (PIPE)
        wg_wait<1>();
      else
        wg_wait<0>();
    }
  }
  wg_wait<0>();
  float s = 0.f;
  for (int i = 0; i < 80; ++i) s += d0[i] + d1[i];
  if (s == 12345.f) sink[threadIdx.x] = s;
}

// the same work on mma.sync: 8 warps of 64 pixels x 80 channels
template <bool SYNC>
__global__ void __launch_bounds__(256, 1) mma_time(float* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* halo = (bf16*)sm;
  bf16* slab = halo + NPIX * LDA;
  for (int i = threadIdx.x; i < NPIX * LDA + 160 * LDA; i += 256)
    halo[i] = __float2bfloat16((i % 7) * 0.01f);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = warp >> 1, grp = warp & 1;
  float acc[4][10][4];
  for (int m = 0; m < 4; ++m)
    for (int j = 0; j < 10; ++j)
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  const int aoff = (rg * 66 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA + (lane >> 4) * 8;
  for (int s = 0; s < 45; ++s) {
    if (SYNC) __syncthreads();
    const int tap = s % 9;
    const bf16* hb = halo + aoff + ((tap / 3) * 66 + tap % 3) * LDA;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) ldsm4(a[m], hb + m * 16 * LDA + kk * 16);
#pragma unroll
      for (int j = 0; j < 10; j += 2) {
        uint32_t b[4];
        ldsm4(b, slab + (grp * 80 + j * 8 + (lane & 7) + (lane >> 4) * 8) * LDA + kk * 16 +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma16816(acc[m][j], a[m], b[0], b[1]);
          mma16816(acc[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  float t = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int j = 0; j < 10; ++j)
      for (int e = 0; e < 4; ++e) t += acc[m][j][e];
  if (t == 12345.f) sink[threadIdx.x] = t;
}

template <class F>
float time_ms(F launch) {  // median of 10 after a warm-up
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaDeviceSynchronize();
  std::vector<float> v;
  for (int r = 0; r < 10; ++r) {
    cudaEventRecord(a);
    launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    v.push_back(ms);
  }
  std::sort(v.begin(), v.end());
  return v[5];
}

int main() {
  std::vector<bf16> hA(64 * 64), hB(160 * 64);
  std::vector<float> fA(64 * 64), fB(160 * 64);
  srand(1);
  for (int i = 0; i < 64 * 64; ++i) {
    hA[i] = __float2bfloat16((rand() % 17 - 8) / 8.f);
    fA[i] = __bfloat162float(hA[i]);
  }
  for (int i = 0; i < 160 * 64; ++i) {
    hB[i] = __float2bfloat16((rand() % 13 - 6) / 8.f);
    fB[i] = __bfloat162float(hB[i]);
  }
  bf16 *dA, *dB;
  float *dC, *sink;
  cudaMalloc(&dA, 64 * 64 * 2);
  cudaMalloc(&dB, 160 * 64 * 2);
  cudaMalloc(&dC, 64 * 160 * 4);
  cudaMalloc(&sink, 4096);
  cudaMemcpy(dA, hA.data(), 64 * 64 * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB.data(), 160 * 64 * 2, cudaMemcpyHostToDevice);
  // the descriptor's two strides: (lbo, sbo) = (128, 1024) matches bidx
  const int conv[2][2] = {{128, 1024}, {1024, 128}};
  int good = -1;
  for (int c = 0; c < 2; ++c) {
    cudaMemset(dC, 0, 64 * 160 * 4);
    wg_check<<<1, 128>>>(dA, dB, dC, conv[c][0], conv[c][1]);
    const cudaError_t e = cudaDeviceSynchronize();
    std::vector<float> hC(64 * 160);
    cudaMemcpy(hC.data(), dC, 64 * 160 * 4, cudaMemcpyDeviceToHost);
    double err = 0;
    for (int r = 0; r < 64; ++r)
      for (int n = 0; n < 160; ++n) {
        double ref = 0;
        for (int k = 0; k < 64; ++k) ref += fA[r * 64 + k] * fB[n * 64 + k];
        err = std::max(err, std::fabs(ref - hC[r * 160 + n]));
      }
    printf("wgmma check lbo=%d sbo=%d: %s, max abs err %g\n", conv[c][0], conv[c][1],
           cudaGetErrorString(e), err);
    if (e == cudaSuccess && err < 1e-3 && good < 0) good = c;
  }
  const int smem = (NPIX * LDA + 160 * LDA) * 2 + 1024;
  cudaFuncSetAttribute(wg_time<true, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(wg_time<true, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(wg_time<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mma_time<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mma_time<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const double flops = 2.0 * 12 * 36 * 64 * 2880 * 320;  // the main shape: 216 blocks
  const int lb = conv[good < 0 ? 0 : good][0], sb = conv[good < 0 ? 0 : good][1];
  for (int blocks : {216, 432}) {
    const double f = flops * blocks / 216;
    const float t1 = time_ms([&] { mma_time<true><<<blocks, 256, smem>>>(sink); });
    const float t2 = time_ms([&] { mma_time<false><<<blocks, 256, smem>>>(sink); });
    const float t3 = time_ms([&] { wg_time<true, false><<<blocks, 256, smem>>>(sink, lb, sb); });
    const float t4 = time_ms([&] { wg_time<true, true><<<blocks, 256, smem>>>(sink, lb, sb); });
    const float t5 = time_ms([&] { wg_time<false, true><<<blocks, 256, smem>>>(sink, lb, sb); });
    printf("blocks %d: mma.sync %.4f ms (%.0f TFLOP/s), no barrier %.4f; wgmma wait0 %.4f, "
           "wait1 %.4f ms (%.0f TFLOP/s), wait1 no barrier %.4f; %s\n",
           blocks, t1, f / t1 / 1e9, t2, t3, t4, f / t4 / 1e9, t5,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
