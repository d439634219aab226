// How int8_dense (int8_dense.cu) cuts its work: plain C++, so that the CPU
// tests (tests/test_torch_kernel_plans.py) can compile it with the host's g++
// and check it at the shapes of the semantic MLP. The wrapper
// (ops/int8_dense.py plan) reads a call's plan and workspace size through the
// C entry e2v_int8_dense_plan; only the split (k_splits) has a Python mirror.
//
// A block owns kCols output columns and up to `width` rows of x, and walks
// its share of K in slabs of kSlabK; kCluster neighbouring column tiles form
// a cluster that shares each x slab. K is split over `splits` blocks of a
// column tile where the clusters alone leave the card's SMs idle. The split
// is planned from (Kp, Np) alone, never from M, so a row's bits do not
// depend on how many rows the call has: the splits' partial sums are added
// in split order by whichever block of the tile finishes last.
#pragma once

namespace e2v {
namespace int8_plan {

constexpr int kCols = 256;        // output columns a block: two warpgroups of 128
constexpr int kSlabK = 64;        // K a slab: a 128-byte swizzle row of bf16 x
constexpr int kCluster = 4;       // blocks of a cluster, neighbours along N
constexpr int kStages = 4;        // slabs in the ring
constexpr int kPlanSMs = 132;     // an H100 SXM's SMs: the plan is the same on every card
constexpr int kMaxSplits = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have (227 KB)
constexpr int kWidths[] = {8, 104};  // x rows a block (the wgmma N): one row, a 100-row chunk
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
constexpr int kMaxWidth = kWidths[kNumWidths - 1];

struct Plan {
  int slabs;       // K slabs: Kp / kSlabK rounded up
  int tiles;       // column blocks: Np / kCols rounded up to whole clusters
  int splits;      // blocks along K of a column tile
  int width;       // x rows a block
  int row_blocks;  // blocks along M
  long long smem;  // dynamic shared memory of a block, its 1024-byte alignment slack included
};

constexpr int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Blocks along K: where the clusters of column tiles fill fewer than the
// card's cluster slots, enough splits to fill them, at most one a slab and
// kMaxSplits.
constexpr int splits_of(int kp, int np) {
  const int slabs = cdiv(kp, kSlabK);
  const int clusters = cdiv(cdiv(np, kCols), kCluster);
  const int slots = kPlanSMs / kCluster;
  if (clusters >= slots) return 1;
  int s = slots / clusters;
  if (s > slabs) s = slabs;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

// x rows a block: the smallest instantiated width that holds M rows, the
// widest for M above it (then several row blocks)
constexpr int width_of(int m) {
  for (int i = 0; i < kNumWidths; ++i)
    if (kWidths[i] >= m) return kWidths[i];
  return kMaxWidth;
}

// the first slab of split i (split i takes slabs [split_begin(i), split_begin(i + 1)))
constexpr int split_begin(int slabs, int splits, int i) {
  return (int)((long long)slabs * i / splits);
}

// the ring of a block; after the products it holds the block's sums (width
// rows of kSumStride f32), for which it always has room
constexpr int kSumStride = kCols + 8;
constexpr long long smem_of(int width) {
  return 1024 + (long long)kStages * (kCols * kSlabK + width * kSlabK * 2);
}

inline Plan plan(int m, int kp, int np) {
  Plan p;
  p.slabs = cdiv(kp, kSlabK);
  p.tiles = cdiv(cdiv(np, kCols), kCluster) * kCluster;
  p.splits = splits_of(kp, np);
  p.width = width_of(m);
  p.row_blocks = cdiv(m, p.width);
  p.smem = smem_of(p.width);
  return p;
}

// The call's workspace, in this order, each part 256-byte aligned: two
// counters a column tile (arrivals, then partials written: tiles x
// row_blocks x 2 int32, zeroed by the first pass), x rounded to bf16 (M x
// Kp), and with splits > 1 the partial sums (splits x M x Np f32).
constexpr long long align256(long long n) { return (n + 255) / 256 * 256; }
inline long long counters_bytes(const Plan& p) {
  return align256((long long)p.tiles * p.row_blocks * 2 * 4);
}
inline long long xb_bytes(int m, int kp) { return align256((long long)m * kp * 2); }
inline long long workspace_bytes(const Plan& p, int m, int kp, int np) {
  return counters_bytes(p) + xb_bytes(m, kp) +
         (p.splits > 1 ? (long long)p.splits * m * np * 4 : 0);
}

// Bytes of bf16 x the blocks read from L2 in a call: the kCluster column
// blocks of a cluster share each slab, so each cluster reads x's (m, kp) once
// over its splits (rows past m are TMA zero fill, not read)
inline long long x_l2_read_bytes(const Plan& p, int m, int kp) {
  return (long long)(p.tiles / kCluster) * m * kp * 2;
}

}  // namespace int8_plan
}  // namespace e2v
