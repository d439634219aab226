// ff_ln: the whole pre-LN GEGLU feed-forward block with its residual,
//   out = x + (h * gelu_erf(g)) Wo^T + bo,   [h | g] = LN(x) Wp^T + bp,
// or without the residual (out = (h * gelu_erf(g)) Wo^T + bo): the partial
// product of a tensor-parallel rank, whose residual is added once after the
// sum over the ranks.
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _ff_kernel (:213), the
// C <= 640 feed-forward of every BasicTransformerBlock at levels 0 and 1.
//
// Rounding follows the Pallas kernel: LayerNorm in f32, xn cast to bf16
// before the first GEMM, h2 = xn Wp^T + bp kept in f32 up to the gate, the
// gated product cast to bf16 before the second GEMM, residual and bias added
// in f32. gelu uses erff (the Pallas kernel's rational erf approximation
// exists only because Mosaic has no erf).
//
// What bounds it on the H100: two GEMMs of 2*T*C*2I and 2*T*I*C operations
// (I = 4C): at T = 27648, C = 320 about 68 GFLOP against some 35 MB of x and
// out, so the tensor cores. The (T, 2I) intermediate must never reach device
// memory (a 283 MB round trip per call at level 0), and the weights (Wp 2I x C,
// Wo C x I: 2.5 MB at C = 320, 9.8 MB at C = 640) are read again by every
// block, so the fewer blocks and the fewer reads per block, the less of the
// L2 path they take.
//
// Design (the first version, 32-row WMMA blocks that read every weight
// fragment straight from device memory and staged f32 tiles through shared
// memory, took 25x its bound; this one follows the attention kernels'
// recipe, flash_tiles.cuh, with the slab ring of ff_tiles.cuh that ff_ln_bwd
// shares):
//   - one block = 64 token rows, two 32-row halves x NG column groups of
//     warps (NG = 4 at C = 320: 8 warps; NG = 8 at C = 640: 16 warps; 2 up to
//     C = 128). A warp's GEMM2 accumulator, 32 rows x C/NG columns (32 x 80
//     at C = 320 and 640) in f32, stays in registers for the whole block: 80
//     registers a thread. A 16 x C accumulator (C / 2 registers) would spill
//     at C = 640;
//   - the LN'd rows Xn stay in shared memory as bf16, row stride C + 8 (the
//     conflict-free ldmatrix layout, tile_ld); LN is one warp per row in f32
//     with 4- to 16-byte loads of x;
//   - the inner dimension is walked in 64-wide chunks. Wp and Wo stream
//     through one three-stage cp.async ring of weight slabs, each slab copied
//     once per block and read by every warp that needs it, two slabs in
//     flight while one computes: per chunk C/KP k-slabs of Wp (the chunk's 64
//     h and 64 g rows x KP = 160 columns, 40 KB) and then 64/KW slabs of Wo
//     (all C rows x KW = 32 columns of the chunk at C = 320, 16 at C = 640:
//     20 KB). A block copies the weights once (2.5 MB at C = 320) for 64
//     rows, where the first version read them twice per 32 rows;
//   - GEMM1 (mma.sync.m16n8k16, bf16 -> f32, operands by ldmatrix) gives
//     each warp its half's h columns j and g columns j of the chunk (64/NG of
//     each) in matching C fragment positions, one ldmatrix.x4 fetching the h
//     and the g fragment together, so the gate (bias, gelu_erf, product in
//     f32) runs in registers; the bf16 gated chunk (64 x 64, 9 KB) goes
//     through shared memory once, for the NG warps that share its rows, and
//     comes back as GEMM2's A fragments. No f32 tile is ever in shared memory;
//   - the epilogue adds x + bo in f32 to each C fragment in place and stores
//     bf16 pairs straight to out, masking rows past T.
// Shared memory: Xn, the gated chunk and three slabs, 176 KB at C = 320 and
// 216 KB at C = 640, so one block an SM; registers 177 a thread at C = 320
// (8 warps) and 128 at C = 640 (16 warps, the launch bound's cap), no spills
// (-Xptxas -v on the H100's build). The block shape is fixed by C, not chosen
// by an occupancy query: one block fits an SM at either C, and the variants
// timed beside this one on the H100 (PERF.md) were slower or no faster: C =
// 320 as 16 warps of 16 rows (121 registers), a four-stage ring. The gate's
// erff takes about a tenth of the time.
// Every output element's sum runs in one fixed order (chunks in order, k16
// steps in order, one warp): no atomics, no split of the inner dimension
// across blocks, the same bits on every run.
#include "ff_tiles.cuh"

namespace e2v {
namespace {

constexpr int kBM = 64;             // token rows per block
constexpr int kLDG = kIC + 8;       // row stride of the bf16 gated chunk

template <int CT>
struct FfShape {
  static constexpr int C = 64 * CT;
  // column groups of warps per 32-row half: the output columns a warp owns
  // (CW) stay a multiple of 16 and about 80 wide (112 and 144 at the C = 448
  // and 576 that no model uses)
  static constexpr int NG = CT <= 2 ? 2 : (CT % 2 == 0 && CT >= 6 ? 8 : 4);
  static constexpr int MT = 2;              // m16 tiles (16 MT rows) per warp
  static constexpr int RG = kBM / (16 * MT);  // row groups of a block
  static constexpr int kThreads = 32 * RG * NG;
  static constexpr int kStages = 3;         // ring depth: two slabs in flight
  static constexpr int LDX = tile_ld<C>();
  static constexpr int HW = kIC / NG;  // h (and g) columns of a chunk per warp
  static constexpr int NT1 = HW / 8;   // n8 tiles of h (and of g) per warp
  static constexpr int CW = C / NG;    // output columns per warp
  static constexpr int NT2 = CW / 8;   // n8 tiles of the output per warp
  static constexpr int KP = wp_slab_k(C);  // k-width of a Wp slab
  static constexpr int LDP = tile_ld<KP>();
  static constexpr int NP = C / KP;        // Wp slabs per chunk
  // k-width of a Wo slab (all C rows): 32 where it fits the Wp slab's room
  static constexpr int KW = C * tile_ld<32>() <= 2 * kIC * LDP ? 32 : 16;
  static constexpr int LDO = tile_ld<KW>();
  static constexpr int NW = kIC / KW;      // Wo slabs per chunk
  static constexpr int kSteps = NP + NW;   // ring steps per chunk
  static constexpr int kSlot = 2 * kIC * LDP > C * LDO ? 2 * kIC * LDP : C * LDO;
  static constexpr size_t kSmem =
      ((size_t)kBM * LDX + (size_t)kBM * kLDG + (size_t)kStages * kSlot) * sizeof(bf16);
  static_assert(CW % 16 == 0 && HW % 8 == 0, "warp tiles of whole n16 / n8 steps");
};

// Ring step s of nsteps: per chunk NP Wp slabs, then NW Wo slabs
template <int CT>
__device__ __forceinline__ void load_step(bf16* ring, const bf16* __restrict__ wp,
                                          const bf16* __restrict__ wo, int I, int s,
                                          int nsteps) {
  using S = FfShape<CT>;
  ring_step<S::kStages, S::kSlot>(ring, s, nsteps, [&](bf16* slot, int step) {
    const int j0 = (step / S::kSteps) * kIC, i = step % S::kSteps;
    if (i < S::NP)  // Wp: h rows j0.., g rows I + j0.., columns i KP ..
      copy_wp_hg<S::C, S::KP, S::LDP, S::kThreads>(slot, wp, I, j0, i * S::KP);
    else  // Wo: all C rows, columns j0 + KW (i - NP) .. + KW
      copy_block<S::C, S::KW, S::LDO, S::kThreads>(slot, wo, I, 0, j0 + (i - S::NP) * S::KW);
  });
}

// out[idx], out[idx + 1] = x + acc + bo, in f32, rounded once; x null: acc + bo
__device__ __forceinline__ void residual_pair(bf16* out, const bf16* x, long long idx, float a0,
                                              float a1, float2 b) {
  const float2 xv = x ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + idx))
                      : make_float2(0.f, 0.f);
  *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(xv.x + a0 + b.x, xv.y + a1 + b.y);
}

template <int CT>
__global__ void __launch_bounds__(FfShape<CT>::kThreads)
    ff_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ wp,
                 const float* __restrict__ bp, const bf16* __restrict__ wo,
                 const float* __restrict__ bo, const bf16* __restrict__ xres,
                 bf16* __restrict__ out, int T, int Cr, int I, float eps) {
  using S = FfShape<CT>;
  constexpr int C = S::C, LDX = S::LDX, NT1 = S::NT1, NT2 = S::NT2, MT = S::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* Gd = Xn + kBM * LDX;
  bf16* ring = Gd + kBM * kLDG;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / S::NG, grp = warp % S::NG;
  const int row0 = blockIdx.x * kBM;
  const int nsteps = (I / kIC) * S::kSteps;

  // the first slabs are in flight while LayerNorm runs
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load_step<CT>(ring, wp, wo, I, s, nsteps);

  // LayerNorm, one warp per row, f32; vectors of VEC values of x a lane
  {
    constexpr int VEC = C % 256 == 0 ? 8 : (C % 128 == 0 ? 4 : 2);
    constexpr int NV = C / (32 * VEC);
    for (int r = warp; r < kBM; r += S::kThreads / 32) {
      const int row = row0 + r;
      float v[NV][VEC];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (lane + 32 * i) * VEC;
        Bf16s<VEC> u;
        if (row < T) u = *reinterpret_cast<const Bf16s<VEC>*>(x + (long long)row * C + col);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] = row < T ? __bfloat162float(u.h[e]) : 0.0f;
          sum += v[i][e];
        }
      }
      const float mu = warp_sum(sum) / Cr;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          // the zero columns of a padded x stay zero (their gamma and beta
          // are zero too); at Cr == C this is the plain two-pass variance
          v[i][e] = (lane + 32 * i) * VEC + e < Cr ? v[i][e] - mu : 0.0f;
          sq += v[i][e] * v[i][e];
        }
      const float rstd = rsqrtf(warp_sum(sq) / Cr + eps);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (lane + 32 * i) * VEC;
        Bf16s<VEC> u;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          u.h[e] = __float2bfloat16(row < T ? v[i][e] * rstd * gamma[col + e] + beta[col + e]
                                            : 0.0f);
        *reinterpret_cast<Bf16s<VEC>*>(Xn + r * LDX + col) = u;
      }
    }
  }

  // a warp owns rows [16 MT rg, 16 MT (rg + 1)) as MT m16 tiles
  const bf16* xrows = Xn + rg * 16 * MT * LDX;
  bf16* grows = Gd + rg * 16 * MT * kLDG;
  const int gr = lane >> 2, tq = lane & 3;
  float acc[MT][NT2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  int s = 0;
  for (int j0 = 0; j0 < I; j0 += kIC) {
    // GEMM1: h tile n in hh[m][n], g tile n in gg[m][n], the same columns
    float hh[MT][NT1][4], gg[MT][NT1][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT1; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[m][n][e] = gg[m][n][e] = 0.0f;
    for (int p = 0; p < S::NP; ++p, ++s) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();  // slab s landed for all; slab s - 1's slot is free
      load_step<CT>(ring, wp, wo, I, s + S::kStages - 1, nsteps);
      const bf16* slab = ring + (s % S::kStages) * S::kSlot;
#pragma unroll
      for (int kk = 0; kk < S::KP / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a<LDX>(a[m], xrows + 16 * m * LDX, p * S::KP + kk * 16, lane);
#pragma unroll
        for (int n = 0; n < NT1; ++n) {
          uint32_t b[4];
          load_b_hg<S::LDP>(b, slab, grp * S::HW + n * 8, kk * 16, lane);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_16816(hh[m][n], a[m], b[0], b[1]);
            mma_16816(gg[m][n], a[m], b[2], b[3]);
          }
        }
      }
    }
    // the gate in registers: (h + bh) gelu(g + bg), rounded to bf16 pairs
#pragma unroll
    for (int n = 0; n < NT1; ++n) {
      const int col = grp * S::HW + n * 8 + 2 * tq;
      const float2 bh = *reinterpret_cast<const float2*>(bp + j0 + col);
      const float2 bg = *reinterpret_cast<const float2*>(bp + I + j0 + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float gated[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gated[e] = (hh[m][n][e] + (e & 1 ? bh.y : bh.x)) *
                     gelu_erf(gg[m][n][e] + (e & 1 ? bg.y : bg.x));
        bf16* grow = grows + (16 * m + gr) * kLDG + col;
        *reinterpret_cast<uint32_t*>(grow) = pack_bf16(gated[0], gated[1]);
        *reinterpret_cast<uint32_t*>(grow + 8 * kLDG) = pack_bf16(gated[2], gated[3]);
      }
    }
    // GEMM2: acc += gated chunk (16 MT x 64) . Wo[cols, j0 .. j0 + 64]^T, KW a slab
    for (int w = 0; w < S::NW; ++w, ++s) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();  // slab s landed; the gated chunk is written
      load_step<CT>(ring, wp, wo, I, s + S::kStages - 1, nsteps);
      const bf16* slab = ring + (s % S::kStages) * S::kSlot;
#pragma unroll
      for (int kk = 0; kk < S::KW / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a<kLDG>(a[m], grows + 16 * m * kLDG, w * S::KW + kk * 16, lane);
#pragma unroll
        for (int n = 0; n < NT2; n += 2) {
          uint32_t b[4];
          load_b_rows<S::LDO>(b, slab, grp * S::CW + n * 8, kk * 16, lane);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_16816(acc[m][n], a[m], b[0], b[1]);
            mma_16816(acc[m][n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: residual and bias in f32 on the C fragments, bf16 pairs to out
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r_lo = row0 + rg * 16 * MT + 16 * m + gr, r_hi = r_lo + 8;
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int col = grp * S::CW + n * 8 + 2 * tq;
      const float2 b = *reinterpret_cast<const float2*>(bo + col);
      if (col >= Cr) continue;  // a padded column: never stored
      if (r_lo < T)
        residual_pair(out, xres, (long long)r_lo * C + col, acc[m][n][0], acc[m][n][1], b);
      if (r_hi < T)
        residual_pair(out, xres, (long long)r_hi * C + col, acc[m][n][2], acc[m][n][3], b);
    }
  }
}

template <int CT>
int launch_ff(const bf16* x, const float* gamma, const float* beta, const bf16* wp,
              const float* bp, const bf16* wo, const float* bo, const bf16* xres, bf16* out,
              int T, int Cr, int I, float eps, void* stream) {
  using S = FfShape<CT>;
  if (T == 0) return 0;
  const dim3 grid((T + kBM - 1) / kBM);
  E2V_LAUNCH(ff_ln_kernel<CT>, grid, S::kThreads, S::kSmem, stream, x, gamma, beta, wp, bp, wo,
             bo, xres, out, T, Cr, I, eps);
}

}  // namespace
}  // namespace e2v

// x, out (T, C) bf16; gamma, beta (C) f32; wp (2I, C) bf16 (nn.Linear
// layout), bp (2I) f32; wo (C, I) bf16, bo (C) f32; x, wp, wo and out 16-byte
// aligned. C % 64 == 0, C <= 640, I % 64 == 0. Cr <= C is the true width: a
// narrower block comes zero-padded to C columns (x, gamma, beta, the columns
// of wp, the rows of wo, bo); LayerNorm then uses the first Cr columns only
// and the output's columns past Cr are not stored (Cr % 2 == 0). At Cr == C
// the arithmetic is the unpadded kernel's. residual 0 leaves x out of the sum
// (x then feeds LayerNorm only). Returns the CUDA launch status.
extern "C" int e2v_ff_ln(const void* x, const void* gamma, const void* beta, const void* wp,
                         const void* bp, const void* wo, const void* bo, void* out, int T,
                         int C, int Cr, int I, float eps, void* stream, int residual) {
  using namespace e2v;
  const bf16* xx = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const bf16* p = static_cast<const bf16*>(wp);
  const float* pb = static_cast<const float*>(bp);
  const bf16* o = static_cast<const bf16*>(wo);
  const float* ob = static_cast<const float*>(bo);
  bf16* y = static_cast<bf16*>(out);
  const bf16* xr = residual ? xx : nullptr;
  if (C % 64 != 0 || I % kIC != 0 || Cr > C || Cr <= C - 64 || Cr % 2 != 0)
    return (int)cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: return launch_ff<1>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 2: return launch_ff<2>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 3: return launch_ff<3>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 4: return launch_ff<4>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 5: return launch_ff<5>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 6: return launch_ff<6>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 7: return launch_ff<7>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 8: return launch_ff<8>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 9: return launch_ff<9>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    case 10: return launch_ff<10>(xx, g, b, p, pb, o, ob, xr, y, T, Cr, I, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
