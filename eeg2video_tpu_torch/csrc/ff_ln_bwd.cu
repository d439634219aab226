// ff_ln_bwd: input gradient of the whole pre-LN GEGLU feed-forward block
// with its residual (ff_ln.cu), everything recomputed from (x, g):
//   out = x + (h * gelu(gate)) Wo^T + bo,  [h | gate] = LN(x) Wp^T + bp
//   dx  = g + LN'(((g Wo) .* [gelu(gate) | h gelu'(gate)]) Wp .* gamma)
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _ff_bwd_kernel (:280).
// Parameter gradients are not computed here: the caller forms them with
// plain ops, and only when a parameter asks for one.
//
// Rounding follows the Pallas kernel: LN in f32, xn cast to bf16 before the
// first GEMM, h2 + bp in f32 up to the gate, dgated = g Wo in f32 from bf16
// operands, the gate's backward in f32, dh2 cast to bf16 before the last
// GEMM, the LayerNorm backward (xhat from x in f32) and the residual in f32.
//
// What bounds it on the H100: three GEMMs per 64-wide inner chunk, 2*T*C*2I
// (h2) + 2*T*C*I (dgated) + 2*T*2I*C (dh2 Wp) = 10*T*C*I operations, the
// tensor cores; as in the forward the (T, 2I) intermediates never reach
// device memory. The weights are read again by every block: Wp twice (for
// h2 and for dh2 Wp) and Wo once, 10*C*I bytes a block from L2, so FLOPs per
// byte of weights equal the block's rows.
//
// Design (the first version, 32-row WMMA blocks that read every weight
// fragment straight from device memory and staged the f32 h2 and dgated
// chunks and the accumulator through shared memory, took 23x its bound;
// this one follows ff_ln, with the building blocks of ff_tiles.cuh):
//   - one block = BM token rows as RG 32-row groups x NG column groups of
//     warps, 8 warps at the model's widths: C = 320 in 64-row blocks (2 x
//     4), C = 640 in 32-row blocks (1 x 8). Xn (LN'd x, bf16) and G (the
//     cotangent, bf16) stay in shared memory for the block, row stride C + 8,
//     with each row's mu and rstd; at C = 640 two 64-row tiles of them alone
//     would take 166 KB, which leaves no room for the ring;
//   - dxa, the (BM x C) f32 product dh2 Wp, stays in registers for the whole
//     block: a warp holds its group's 32 rows x C / NG columns (32 x 80 at
//     C = 320 and 640, 80 registers a thread; 235 and 201 registers in all,
//     no spills). No f32 tile is ever in shared memory. 16-row warp tiles
//     (MT = 1: 16 warps under the 128-register cap) ran slower on the H100
//     at both widths (PERF.md);
//   - per 64-wide chunk j0 of the inner dimension, one three-stage cp.async
//     ring of slabs carries, each slab copied once per block and read by
//     every warp: the Wp k-slabs of the chunk's h and g rows (GEMM1, k = c,
//     as ff_ln), then Wo row slabs of the chunk's columns (dgated, k = c,
//     read transposed by ldmatrix .trans), then the chunk's 128 Wp rows again
//     as row slabs of all C columns (GEMM3, k = j, read transposed). Wp is
//     streamed twice: keeping the chunk's Wp rows resident between GEMM1 and
//     GEMM3 (84 KB at C = 320, 166 KB at C = 640, twice that to prefetch the
//     next chunk) does not fit beside Xn and G. The slab widths are the
//     widest that fit three slots in what Xn, G and the dh2 chunk leave:
//     2 + 2 + 2 steps a chunk at C = 320, 4 + 2 + 4 at C = 640;
//   - GEMM1 (h and g columns j of the warp's rows, one ldmatrix.x4 fetching
//     both) and the dgated GEMM (the same columns j) land in the same C
//     fragment positions, so the bias, gelu_erf_grad and both products of
//     the gate's backward run in registers; the bf16 dh2 chunk (BM x 128)
//     goes through shared memory once and comes back as GEMM3's A fragments;
//   - epilogue from registers: dxn = dxa gamma on the C fragments, the row
//     sums of dxn and dxn xhat by quad shuffles and then over the NG column
//     groups through a small array (in the ring, free by then) added in a
//     fixed order; g + rstd (dxn - m1 - xhat m2) stored as bf16 pairs,
//     masking rows past T.
// Every sum runs in one fixed order (chunks, slabs and k16 steps in order,
// one warp an output element, the column groups in order): no atomics, no
// split of the inner dimension across blocks, the same bits on every run.
#include "ff_tiles.cuh"

namespace e2v {
namespace {

__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// token rows of a block at C = 64 CT: 64 where Xn, G and the ring fit
// beside each other at 64 rows, else 32
__host__ __device__ constexpr int ff_bwd_block_rows(int ct) { return ct <= 6 ? 64 : 32; }

template <int CT>
struct FfBwdShape {
  static constexpr int C = 64 * CT;
  static constexpr int BM = ff_bwd_block_rows(CT);  // token rows per block
  static constexpr int MT = 2;                  // m16 tiles (16 MT rows) per warp
  static constexpr int RG = BM / (16 * MT);     // row groups of a block
  // column groups of warps per row group, as in ff_ln: a warp's dxa columns
  // (CW) stay a multiple of 16 and about 80 wide
  static constexpr int NG = CT <= 2 ? 2 : (CT % 2 == 0 && CT >= 6 ? 8 : 4);
  static constexpr int kThreads = 32 * RG * NG;
  static constexpr int kStages = 3;  // ring depth: two slabs in flight
  static constexpr int LDX = tile_ld<C>();        // Xn, G, GEMM3's Wp slabs
  static constexpr int LDD = tile_ld<2 * kIC>();  // the bf16 dh2 chunk
  static constexpr int LDW = tile_ld<kIC>();      // Wo slabs
  static constexpr int HW = kIC / NG;  // h (g, dgated) columns of a chunk per warp
  static constexpr int NT1 = HW / 8;
  static constexpr int CW = C / NG;  // dxa columns per warp
  static constexpr int NT2 = CW / 8;
  // bytes besides the ring: Xn, G and the dh2 chunk (bf16), mu and rstd (f32)
  static constexpr int kFixed = (2 * BM * LDX + BM * LDD) * 2 + 2 * BM * 4;
  static constexpr int kRoom = (kSmemMax - kFixed) / (2 * kStages);  // bf16 values a slot
  static constexpr int KP = fit16(C, 160, 2 * kIC, 2 * kIC * 8, kRoom);  // GEMM1 k-slab
  static constexpr int LDP = tile_ld<KP>();
  static constexpr int KC = fit16(C, C, LDW, 0, kRoom);      // Wo rows per slab
  static constexpr int KJ = fit16(kIC, kIC, LDX, 0, kRoom);  // GEMM3 Wp rows per slab
  static constexpr int NP = C / KP, NW = C / KC, NJ = 2 * kIC / KJ;
  static constexpr int kSteps = NP + NW + NJ;  // ring steps per chunk
  static constexpr int kSlot = max3(2 * kIC * LDP, KC * LDW, KJ * LDX);
  static constexpr size_t kSmem = kFixed + (size_t)kStages * kSlot * sizeof(bf16);
  static_assert(kSmem <= kSmemMax, "Xn, G, the dh2 chunk and three slabs fit a block");
  static_assert(CW % 16 == 0 && HW % 8 == 0, "warp tiles of whole n16 / n8 steps");
  static_assert(BM * NG * 2 * sizeof(float) <= kStages * kSlot * sizeof(bf16),
                "the row-sum partials fit in the ring");
};

// Ring step s of nsteps: per chunk NP Wp k-slabs (GEMM1), NW Wo row slabs
// (dgated), NJ Wp row slabs (GEMM3)
template <int CT>
__device__ __forceinline__ void load_bwd_step(bf16* ring, const bf16* __restrict__ wp,
                                              const bf16* __restrict__ wo, int I, int s,
                                              int nsteps) {
  using S = FfBwdShape<CT>;
  ring_step<S::kStages, S::kSlot>(ring, s, nsteps, [&](bf16* slot, int step) {
    const int j0 = (step / S::kSteps) * kIC, i = step % S::kSteps;
    if (i < S::NP) {  // Wp: h rows j0.., g rows I + j0.., columns i KP ..
      copy_wp_hg<S::C, S::KP, S::LDP, S::kThreads>(slot, wp, I, j0, i * S::KP);
    } else if (i < S::NP + S::NW) {  // Wo: rows KC (i - NP) .., columns j0 .. j0 + 63
      copy_block<S::KC, kIC, S::LDW, S::kThreads>(slot, wo, I, (i - S::NP) * S::KC, j0);
    } else {  // Wp: KJ of the chunk's 128 [h | g] rows, all C columns
      const int q = (i - S::NP - S::NW) * S::KJ;
      copy_block<S::KJ, S::C, S::LDX, S::kThreads>(slot, wp, S::C,
                                                   q < kIC ? j0 + q : I + j0 + q - kIC, 0);
    }
  });
}

template <int CT>
__global__ void __launch_bounds__(FfBwdShape<CT>::kThreads)
    ff_ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const bf16* __restrict__ wp, const float* __restrict__ bp,
                     const bf16* __restrict__ wo, bf16* __restrict__ dx, int T, int Cr, int I,
                     float eps) {
  using S = FfBwdShape<CT>;
  constexpr int C = S::C, BM = S::BM, LDX = S::LDX, LDD = S::LDD, MT = S::MT;
  constexpr int NT1 = S::NT1, NT2 = S::NT2, NG = S::NG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Xn + BM * LDX;
  bf16* Dh = Gs + BM * LDX;
  bf16* ring = Dh + BM * LDD;
  float* mu_s = reinterpret_cast<float*>(ring + S::kStages * S::kSlot);
  float* rstd_s = mu_s + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / NG, grp = warp % NG;
  const int row0 = blockIdx.x * BM;
  const int nsteps = (I / kIC) * S::kSteps;

  // the cotangent rows (zero past T) and the first slabs are in flight while
  // LayerNorm runs; G lands with the first slab's group
  copy_rows<C, LDX>(Gs, g, C, row0, BM, T, C);
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load_bwd_step<CT>(ring, wp, wo, I, s, nsteps);

  // LayerNorm, one warp per row, f32; vectors of VEC values of x a lane
  {
    constexpr int VEC = C % 256 == 0 ? 8 : (C % 128 == 0 ? 4 : 2);
    constexpr int NV = C / (32 * VEC);
    for (int r = warp; r < BM; r += S::kThreads / 32) {
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
          // padded columns stay zero, as in ff_ln
          v[i][e] = (lane + 32 * i) * VEC + e < Cr ? v[i][e] - mu : 0.0f;
          sq += v[i][e] * v[i][e];
        }
      const float rstd = rsqrtf(warp_sum(sq) / Cr + eps);
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
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

  // a warp owns rows [16 MT rg, 16 MT (rg + 1)) of the block as MT m16 tiles
  const bf16* xrows = Xn + rg * 16 * MT * LDX;
  const bf16* grows = Gs + rg * 16 * MT * LDX;
  bf16* drows = Dh + rg * 16 * MT * LDD;
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
    // h tile n in hh[m][n], gate tile n in gg[m][n], dgated tile n in
    // dd[m][n]: the same rows and columns
    float hh[MT][NT1][4], gg[MT][NT1][4], dd[MT][NT1][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT1; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[m][n][e] = gg[m][n][e] = dd[m][n][e] = 0.0f;

    // GEMM1: [h | gate] = Xn Wp[chunk rows]^T, k = c, KP a slab
    for (int p = 0; p < S::NP; ++p, ++s) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();  // slab s (and G) landed for all; slab s - 1's slot is free
      load_bwd_step<CT>(ring, wp, wo, I, s + S::kStages - 1, nsteps);
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
    // dgated = G Wo[:, chunk], k = c, KC rows of Wo a slab, read transposed
    for (int w = 0; w < S::NW; ++w, ++s) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();
      load_bwd_step<CT>(ring, wp, wo, I, s + S::kStages - 1, nsteps);
      const bf16* slab = ring + (s % S::kStages) * S::kSlot;
#pragma unroll
      for (int kk = 0; kk < S::KC / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a<LDX>(a[m], grows + 16 * m * LDX, w * S::KC + kk * 16, lane);
        if constexpr (NT1 % 2 == 0) {
#pragma unroll
          for (int n = 0; n < NT1; n += 2) {
            uint32_t b[4];
            load_b_cols<S::LDW>(b, slab, kk * 16, grp * S::HW + n * 8, lane);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_16816(dd[m][n], a[m], b[0], b[1]);
              mma_16816(dd[m][n + 1], a[m], b[2], b[3]);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NT1; ++n) {
            uint32_t b[2];
            load_b_col8<S::LDW>(b, slab, kk * 16, grp * S::HW + n * 8, lane);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_16816(dd[m][n], a[m], b[0], b[1]);
          }
        }
      }
    }
    // the gate's backward in registers, f32: dh = dgated gelu(gate), dgate =
    // dgated h gelu'(gate), rounded to bf16 pairs of the dh2 chunk [dh | dgate]
#pragma unroll
    for (int n = 0; n < NT1; ++n) {
      const int col = grp * S::HW + n * 8 + 2 * tq;
      const float2 bh = *reinterpret_cast<const float2*>(bp + j0 + col);
      const float2 bg = *reinterpret_cast<const float2*>(bp + I + j0 + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float dh[4], dgate[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hv = hh[m][n][e] + (e & 1 ? bh.y : bh.x);
          float gelu, dgelu;
          gelu_erf_grad(gg[m][n][e] + (e & 1 ? bg.y : bg.x), gelu, dgelu);
          dh[e] = dd[m][n][e] * gelu;
          dgate[e] = dd[m][n][e] * hv * dgelu;
        }
        bf16* d = drows + (16 * m + gr) * LDD + col;
        *reinterpret_cast<uint32_t*>(d) = pack_bf16(dh[0], dh[1]);
        *reinterpret_cast<uint32_t*>(d + 8 * LDD) = pack_bf16(dh[2], dh[3]);
        *reinterpret_cast<uint32_t*>(d + kIC) = pack_bf16(dgate[0], dgate[1]);
        *reinterpret_cast<uint32_t*>(d + 8 * LDD + kIC) = pack_bf16(dgate[2], dgate[3]);
      }
    }
    // GEMM3: dxa += dh2 chunk . Wp[chunk rows], k = the chunk's 128 [h | g]
    // rows, KJ a slab, read transposed
    for (int q = 0; q < S::NJ; ++q, ++s) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();  // slab s landed; the dh2 chunk is written
      load_bwd_step<CT>(ring, wp, wo, I, s + S::kStages - 1, nsteps);
      const bf16* slab = ring + (s % S::kStages) * S::kSlot;
#pragma unroll
      for (int kk = 0; kk < S::KJ / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a<LDD>(a[m], drows + 16 * m * LDD, q * S::KJ + kk * 16, lane);
#pragma unroll
        for (int n = 0; n < NT2; n += 2) {
          uint32_t b[4];
          load_b_cols<LDX>(b, slab, kk * 16, grp * S::CW + n * 8, lane);
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
  __syncthreads();  // every warp is done with the ring: it takes the row sums now

  // epilogue: dxn = dxa gamma in place; per row the sums of dxn and of
  // dxn xhat over this warp's columns, then over the NG column groups
  float* part = reinterpret_cast<float*>(ring);  // [BM][NG][2]
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = rg * 16 * MT + 16 * m + gr + 8 * hf, row = row0 + r;
      const float mu = mu_s[r], rstd = rstd_s[r];
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = grp * S::CW + n * 8 + 2 * tq;
        const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
        float2 xv = make_float2(0.0f, 0.0f);
        if (row < T)
          xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * C + col));
        float& d0 = acc[m][n][2 * hf];
        float& d1 = acc[m][n][2 * hf + 1];
        d0 *= ga.x;
        d1 *= ga.y;
        s1 += d0 + d1;
        s2 += d0 * ((xv.x - mu) * rstd) + d1 * ((xv.y - mu) * rstd);
      }
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      if (tq == 0) {
        part[(r * NG + grp) * 2] = s1;
        part[(r * NG + grp) * 2 + 1] = s2;
      }
    }
  }
  __syncthreads();
  // dx = g + rstd (dxn - m1 - xhat m2), bf16 pairs, rows past T masked
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = rg * 16 * MT + 16 * m + gr + 8 * hf, row = row0 + r;
      if (row >= T) continue;
      float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        m1 += part[(r * NG + k) * 2];
        m2 += part[(r * NG + k) * 2 + 1];
      }
      m1 /= Cr;  // the padded columns' dxn is zero: the sums are the true ones
      m2 /= Cr;
      const float mu = mu_s[r], rstd = rstd_s[r];
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = grp * S::CW + n * 8 + 2 * tq;
        if (col >= Cr) continue;  // a padded column: never stored
        const long long idx = (long long)row * C + col;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + idx));
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Gs + r * LDX + col));
        const float xh0 = (xv.x - mu) * rstd, xh1 = (xv.y - mu) * rstd;
        *reinterpret_cast<uint32_t*>(dx + idx) =
            pack_bf16(gv.x + rstd * (acc[m][n][2 * hf] - m1 - xh0 * m2),
                      gv.y + rstd * (acc[m][n][2 * hf + 1] - m1 - xh1 * m2));
      }
    }
  }
}

template <int CT>
int launch_ff_bwd(const bf16* x, const bf16* g, const float* gamma, const float* beta,
                  const bf16* wp, const float* bp, const bf16* wo, bf16* dx, int T, int Cr,
                  int I, float eps, void* stream) {
  using S = FfBwdShape<CT>;
  if (T == 0) return 0;
  const dim3 grid((T + S::BM - 1) / S::BM);
  E2V_LAUNCH(ff_ln_bwd_kernel<CT>, grid, S::kThreads, S::kSmem, stream, x, g, gamma, beta, wp,
             bp, wo, dx, T, Cr, I, eps);
}

}  // namespace
}  // namespace e2v

// x, g, dx (T, C) bf16; gamma, beta (C) f32; wp (2I, C) bf16 (nn.Linear
// layout), bp (2I) f32; wo (C, I) bf16; x, g, wp and wo 16-byte aligned.
// C % 64 == 0, C <= 640, I % 64 == 0; Cr the true width of a zero-padded
// block, as for e2v_ff_ln. Returns the CUDA launch status.
extern "C" int e2v_ff_ln_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                             const void* wp, const void* bp, const void* wo, void* dx, int T,
                             int C, int Cr, int I, float eps, void* stream) {
  using namespace e2v;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* gg = static_cast<const bf16*>(g);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const bf16* p = static_cast<const bf16*>(wp);
  const float* pb = static_cast<const float*>(bp);
  const bf16* o = static_cast<const bf16*>(wo);
  bf16* y = static_cast<bf16*>(dx);
  if (C % 64 != 0 || I % kIC != 0 || Cr > C || Cr <= C - 64 || Cr % 2 != 0)
    return (int)cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: return launch_ff_bwd<1>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 2: return launch_ff_bwd<2>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 3: return launch_ff_bwd<3>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 4: return launch_ff_bwd<4>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 5: return launch_ff_bwd<5>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 6: return launch_ff_bwd<6>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 7: return launch_ff_bwd<7>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 8: return launch_ff_bwd<8>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 9: return launch_ff_bwd<9>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    case 10: return launch_ff_bwd<10>(xx, gg, ga, be, p, pb, o, y, T, Cr, I, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Token rows of a block of ff_ln_bwd at C (each block copies Wp twice and Wo
// once from L2), 0 for a C the kernel does not take.
extern "C" int e2v_ff_ln_bwd_block_rows(int C) {
  return C % 64 != 0 || C < 64 || C > 640 ? 0 : e2v::ff_bwd_block_rows(C / 64);
}
