// Building blocks of the feed-forward kernels ff_ln (ff_ln.cu) and
// ff_ln_bwd (ff_ln_bwd.cu), on top of flash_tiles.cuh: both walk the inner
// dimension I in 64-wide chunks and stream the weights, Wp (2I x C) and Wo
// (C x I) in nn.Linear layout, through one cp.async ring of slabs in shared
// memory, each slab copied once per block and read by every warp that needs
// it.
//
// Slabs of Wp hold the chunk's h rows j0 .. j0+63 and its g rows I+j0 ..
// I+j0+63 (load_b_hg reads both from one ldmatrix.x4, so a warp holds h and
// g of the same columns); the other slabs are plain row blocks of Wp or Wo
// (copy_block), read as B either way round: load_b_rows where the slab's
// rows are B's columns, load_b_cols / load_b_col8 (ldmatrix .trans) where
// they are B's k.
#pragma once

#include "flash_tiles.cuh"

namespace e2v {

constexpr int kIC = 64;             // inner-dimension chunk
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may have (227 KB)

// N bf16 values moved as one 2N-byte vector
template <int N>
struct alignas(2 * N) Bf16s {
  bf16 h[N];
};

// k-width of a Wp slab: the widest multiple of 16 up to 160 that divides C
__host__ __device__ constexpr int wp_slab_k(int c) {
  int k = 160;
  while (c % k != 0) k -= 16;
  return k;
}

// The widest k, a multiple of 16 that divides n and is at most cap, for
// which a slab of a * k + b bf16 values fits in slot values (16 at least)
__host__ __device__ constexpr int fit16(int n, int cap, int a, int b, int slot) {
  int k = cap < n ? cap : n;
  k -= k % 16;
  while (k > 16 && (n % k != 0 || a * k + b > slot)) k -= 16;
  return k;
}

// B fragments of h tile n0 .. n0+7 (r[0], r[1]) and of the g tile kIC rows
// further down (r[2], r[3]) of a Wp slab, over k = columns k0 .. k0+15
template <int LD>
__device__ __forceinline__ void load_b_hg(uint32_t (&r)[4], const bf16* slab, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(r, slab + ((lane >> 4) * kIC + n0 + (lane & 7)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragment of one n8 tile (columns n0 .. n0+7 of a row-major tile) over
// k = rows k0 .. k0+15, transposed on the way (load_b_cols for one tile)
template <int LD>
__device__ __forceinline__ void load_b_col8(uint32_t (&r)[2], const bf16* tile, int k0, int n0,
                                            int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(tile + (k0 + (lane & 15)) * LD + n0)));
}

// Wp slab of a chunk: its h rows j0 .. j0+kIC-1, then its g rows I+j0 ..,
// columns k0 .. k0+KP-1 of Wp (row stride C), into a slab of row stride LDP
template <int C, int KP, int LDP, int NTHR>
__device__ __forceinline__ void copy_wp_hg(bf16* slab, const bf16* __restrict__ wp, int I,
                                           int j0, int k0) {
  constexpr int kCPR = KP / 8;
  for (int e = threadIdx.x; e < 2 * kIC * kCPR; e += NTHR) {
    const int r = e / kCPR, c = (e % kCPR) * 8;
    const int wrow = r < kIC ? j0 + r : I + j0 + r - kIC;
    cp_async16(slab + r * LDP + c, wp + (long long)wrow * C + k0 + c, true);
  }
}

// rows row0 .. row0+ROWS-1 x columns col0 .. col0+COLS-1 of a row-major
// matrix (row stride ld) into a slab of row stride LDS
template <int ROWS, int COLS, int LDS, int NTHR>
__device__ __forceinline__ void copy_block(bf16* slab, const bf16* __restrict__ src, int ld,
                                           int row0, int col0) {
  constexpr int kCPR = COLS / 8;
  for (int e = threadIdx.x; e < ROWS * kCPR; e += NTHR) {
    const int r = e / kCPR, c = (e % kCPR) * 8;
    cp_async16(slab + r * LDS + c, src + (long long)(row0 + r) * ld + col0 + c, true);
  }
}

// Ring step s of nsteps: copy(slot, s) starts the copies of slab s into its
// slot (s mod STAGES of SLOT values each), committed as one group; past the
// last step an empty group keeps the count of groups even, so that
// cp_async_wait<STAGES - 2> before step s always means slab s has landed.
template <int STAGES, int SLOT, class Copy>
__device__ __forceinline__ void ring_step(bf16* ring, int s, int nsteps, Copy copy) {
  if (s < nsteps) copy(ring + (s % STAGES) * SLOT, s);
  cp_async_commit();
}

}  // namespace e2v
