// geglu_f32 / geglu_f32_bwd: the f32 counterparts of geglu_out /
// geglu_out_bwd,
//   out = (h * gelu_erf(g)) W^T + b,            h2 = [h | g] (T, 2I), W (C, I),
//   dh2 = [dgated gelu(g) | dgated h gelu'(g)],  dgated = dout W.
//
// Replaces (JAX package, eeg2video_tpu/ops/geglu.py), where it runs on f32
// operands (fused_geglu_out tests no dtype, :434): _geglu_pallas :87
// (_geglu_kernel :59) and _geglu_bwd_pallas :131 (_geglu_bwd_kernel :113).
//
// Forward: I % 32 == 0, C % 4 == 0; backward: I % 4 == 0, C % 32 == 0 (the
// wrapper asks for I % 64 / C % 8 and I % 8 / C % 32); any T. Every operand
// row starts 16-byte aligned (the wrapper sees to it). erff / expf in f32.
//
// What bounds it on the H100: one 2 T I C product each way. An f32 product
// has to keep f32 accuracy, so the least time is three tf32 products at the
// tensor cores' dense TF32 rate (494.7 TFLOP/s); the bytes (h2, W, the
// output, the forward's workspace) stay under half of that time at the
// model's shapes.
//
// Design: GEMMs on 3xTF32 (tf32_gemm.cuh, the out GEMM of ff_f32.cu), 128-row
// x 160-column block tiles, K in 32-wide slabs through a three-stage cp.async
// ring, each slab split once into big and small tiles, fresh accumulators a
// slab:
//   forward:  geglu_f32_gate: a row pass, gated = h gelu(g) into a workspace
//             the wrapper allocates (the gate evaluated once an element;
//             applied in the GEMM's split pass instead, with h and g landed
//             as two A tiles in a two-stage ring, it ran 10-15% slower on the
//             H100); geglu_f32_out: gated W^T over one of S runs of K's slabs
//             (S = 4 at the model's I: blocks of a quarter of the work, so
//             that the last wave of blocks is not a whole tile's time), into
//             S partial sums in the workspace; geglu_f32_sum: a row pass,
//             out = the partials in order + b;
//   backward: geglu_f32_bwd: dgated = dout W over a 128 x 160 tile of (T, I)
//             (B rows k: W's rows c, K = C), staged in shared memory, then a
//             pass of a thread a float4: h and g at the tile's columns of h2,
//             the gate's backward, both halves of dh2.
// Every sum runs in one fixed order (slabs and k in order, the partials in
// order): no atomics, the same bits on every run, and a row's bits do not
// depend on the other rows of the call (S depends on I alone).
#include "tf32_gemm.cuh"

namespace e2v {
namespace f32k {
namespace {

// the forward splits K = I into min(kSplitK, I / 32) runs of whole slabs
// (blocks of their own, summed in order by a row pass): a count that depends
// on I alone, so that a row's bits do not depend on T
constexpr int kSplitK = 4;

// gated[t, j] = h2[t, j] gelu_erf(h2[t, I + j]): a thread a float4
__global__ void __launch_bounds__(kThreads)
    geglu_f32_gate_kernel(const float* __restrict__ h2, float* __restrict__ gated, int T, int I) {
  const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e >= (long long)T * I) return;
  const long long row = e / I, col = e % I;
  const float* hr = h2 + row * 2 * I + col;
  const float4 h = *reinterpret_cast<const float4*>(hr);
  const float4 g = *reinterpret_cast<const float4*>(hr + I);
  *reinterpret_cast<float4*>(gated + e) = make_float4(
      h.x * gelu_erf(g.x), h.y * gelu_erf(g.y), h.z * gelu_erf(g.z), h.w * gelu_erf(g.w));
}

// Partial p of out = gated W^T over a 128-row x kOutN-column tile: slabs
// p n / S .. (p + 1) n / S - 1 of the n = I / 32 slabs of K, into part[p]
// (T, C). Block b: column tile b % nc, then split, then row tile.
__global__ void __launch_bounds__(kThreads, 1)
    geglu_f32_out_kernel(const float* __restrict__ gated, const float* __restrict__ w,
                         float* __restrict__ part, int T, int I, int C, int S) {
  extern __shared__ float4 smem4[];
  const int nc = (C + kOutN - 1) / kOutN, n = I / kBK;
  const int n0 = (blockIdx.x % nc) * kOutN, p = (blockIdx.x / nc) % S;
  const int r0 = (blockIdx.x / nc / S) * kBM, s_first = p * n / S;
  float acc[4][5][4];
  out_gemm<kRowsN>(acc, reinterpret_cast<float*>(smem4), gated, w, T, I, C, r0, n0, s_first,
                   (p + 1) * n / S - s_first);
  float* dst = part + (long long)p * T * C;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = out_row(r0, i, h);
      if (row >= T) continue;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int c = out_col(n0, j);
        if (c < C)
          *reinterpret_cast<float2*>(dst + (long long)row * C + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// out = part[0] + part[1] + ... + part[S - 1] + b, in that order: a thread a
// float4
__global__ void __launch_bounds__(kThreads)
    geglu_f32_sum_kernel(const float* __restrict__ part, const float* __restrict__ b,
                         float* __restrict__ out, int T, int C, int S) {
  const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x), n = (long long)T * C;
  if (e >= n) return;
  float4 v = *reinterpret_cast<const float4*>(part + e);
  for (int p = 1; p < S; ++p) {
    const float4 q = *reinterpret_cast<const float4*>(part + p * n + e);
    v.x += q.x, v.y += q.y, v.z += q.z, v.w += q.w;
  }
  const float4 bv = *reinterpret_cast<const float4*>(b + e % C);
  *reinterpret_cast<float4*>(out + e) =
      make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
}

constexpr int kLDD = kOutN + 8;  // row stride of the staged dgated tile
static_assert(kBM * kLDD <= OutTiles<kRowsK>::Smem::kFloats, "the staged dgated tile");

// dh2 over a 128-row x kOutN-column tile of dgated = dout W (B rows k: the
// rows of W): the accumulators staged in shared memory, then a pass of a
// thread a float4 that reads h and g at the tile's columns of h2 and writes
// [dgated gelu(g) | dgated h gelu'(g)]
__global__ void __launch_bounds__(kThreads, 1)
    geglu_f32_bwd_kernel(const float* __restrict__ h2, const float* __restrict__ dout,
                         const float* __restrict__ w, float* __restrict__ dh2, int T, int I,
                         int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nj = (I + kOutN - 1) / kOutN;
  const int r0 = (blockIdx.x / nj) * kBM, n0 = (blockIdx.x % nj) * kOutN;
  {
    float acc[4][5][4];
    out_gemm<kRowsK>(acc, smem, dout, w, T, C, I, r0, n0);
    cp_async_wait<0>();
    __syncthreads();  // every warp's last products are done: the tiles are free
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 5; ++j)
          *reinterpret_cast<float2*>(smem + (out_row(0, i, h)) * kLDD + out_col(0, j)) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  __syncthreads();
  constexpr int C4 = kOutN / 4;
  for (int e = threadIdx.x; e < kBM * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4, row = r0 + r, col = n0 + c;
    if (row >= T || col >= I) continue;
    const float4 d = *reinterpret_cast<const float4*>(smem + r * kLDD + c);
    const float* hr = h2 + (long long)row * 2 * I + col;
    const float4 hv = *reinterpret_cast<const float4*>(hr);
    const float4 gv = *reinterpret_cast<const float4*>(hr + I);
    float4 a, bq;
    float gelu, dgelu;
    gelu_erf_grad(gv.x, gelu, dgelu);
    a.x = d.x * gelu, bq.x = d.x * hv.x * dgelu;
    gelu_erf_grad(gv.y, gelu, dgelu);
    a.y = d.y * gelu, bq.y = d.y * hv.y * dgelu;
    gelu_erf_grad(gv.z, gelu, dgelu);
    a.z = d.z * gelu, bq.z = d.z * hv.z * dgelu;
    gelu_erf_grad(gv.w, gelu, dgelu);
    a.w = d.w * gelu, bq.w = d.w * hv.w * dgelu;
    float* dr = dh2 + (long long)row * 2 * I + col;
    *reinterpret_cast<float4*>(dr) = a;
    *reinterpret_cast<float4*>(dr + I) = bq;
  }
}

}  // namespace
}  // namespace f32k
}  // namespace e2v

// h2 (T, 2I), w (C, I) (nn.Linear layout), b (C), out (T, C); work, the
// workspace (T I + S T C floats, S = min(4, I / 32): the gated product, then
// the partial sums); all f32, contiguous, 16-byte aligned. I % 32 == 0,
// C % 4 == 0. Returns the CUDA launch status.
extern "C" int e2v_geglu_f32(const void* h2, const void* w, const void* b, void* out, void* work,
                             int T, int I, int C, void* stream) {
  using namespace e2v::f32k;
  if (T < 0 || I <= 0 || I % kBK != 0 || C <= 0 || C % 4 != 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;  // the workspace of no rows is empty: its pointer may be null
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gated = static_cast<float*>(work);
  float* part = gated + (long long)T * I;
  const int S = I / kBK < kSplitK ? I / kBK : kSplitK;
  const long long rows = (T + kBM - 1) / kBM, cols = (C + kOutN - 1) / kOutN;
  int rc = launch(geglu_f32_gate_kernel, ((long long)T * I / 4 + kThreads - 1) / kThreads, 0, s,
                  static_cast<const float*>(h2), gated, T, I);
  if (rc) return rc;
  rc = launch(geglu_f32_out_kernel, rows * S * cols, kOutSmem, s, (const float*)gated,
              static_cast<const float*>(w), part, T, I, C, S);
  if (rc) return rc;
  return launch(geglu_f32_sum_kernel, ((long long)T * C / 4 + kThreads - 1) / kThreads, 0, s,
                (const float*)part, static_cast<const float*>(b), static_cast<float*>(out), T, C,
                S);
}

// dh2 (T, 2I) of e2v_geglu_f32 from h2 and the output's gradient g (T, C);
// all f32, contiguous, 16-byte aligned. I % 4 == 0, C % 32 == 0. Returns the
// CUDA launch status.
extern "C" int e2v_geglu_f32_bwd(const void* h2, const void* g, const void* w, void* dh2, int T,
                                 int I, int C, void* stream) {
  using namespace e2v::f32k;
  if (T < 0 || I <= 0 || I % 4 != 0 || C <= 0 || C % kBK != 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const long long rows = (T + kBM - 1) / kBM, cols = (I + kOutN - 1) / kOutN;
  return launch(geglu_f32_bwd_kernel, rows * cols, kOutKSmem, static_cast<cudaStream_t>(stream),
                static_cast<const float*>(h2), static_cast<const float*>(g),
                static_cast<const float*>(w), static_cast<float*>(dh2), T, I, C);
}
