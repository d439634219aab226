// How the temporal attention kernels (temporal_attention.cuh) cut their work:
// plain C++, so that the CPU tests (tests/test_torch_kernel_plans.py) can
// compile it with the host's g++ and check it at every shape of the grid the
// kernels run; ops/temporal.py units_of mirrors units_of for the names of
// the instantiations.
//
// Two routes, picked from the shape alone:
// - staged (F <= kStagedMaxFrames, heads dividing 32, head_dim a multiple of
//   32 / heads): a token's row is cut into units of whole heads, a warp a
//   unit; runs of R units are staged by bulk copies into a ring of kStages
//   stages, the F x F products kept in registers. The model's shapes (H = 8,
//   D = 40 / 80 / 160, F = 6) take it.
// - any (every other shape): a warp a (token, head); its NT F D operand
//   values copied into shared memory, lane f computes row f of the
//   probabilities (and of dl) there, then the lanes share the outputs.
#pragma once

namespace e2v {
namespace temporal_plan {

constexpr int kUnitBytes = 640;       // a unit's bytes where the heads allow it
constexpr int kStagedMaxFrames = 8;   // frames the staged route instantiates (1..8)
constexpr int kWarps = 8;             // warps of a block, at most, on both routes
constexpr int kStages = 2;            // the staged route's ring of runs
constexpr int kSmem = 220 * 1024;     // shared memory of a block, at most
constexpr int kIters = 5;             // steps a lane takes through a 640-byte unit

enum Route { kRefused = 0, kStaged = 1, kAny = 2 };

// What a C entry returns for a call whose plan is kRefused (no CUDA status
// is negative; ops/_build.py check raises a ValueError naming the kernel).
constexpr int kDoesNotFit = -1;

struct Plan {
  int route;
  // staged: units a token's row is cut into, values of a unit, lanes a head,
  // values a lane moves a step, steps a lane takes, units of a run
  int units, W, lph, vec, iters, R;
  // any: values a row of the warp's operand copy takes (D padded to an odd
  // number of 4-byte words), bytes of that copy and of all the warp's shared
  // memory, warps
  int row, in_bytes, warp_bytes, nw;
};

inline long long round16(long long n) { return (n + 15) / 16 * 16; }

// Units a token's row of H*D values is cut into on the staged route: the
// largest power of two s such that a unit holds whole heads (s divides H), a
// multiple of 32 values (s divides H*D / 32, so every lane holds the same
// count) and at least kUnitBytes.
inline int units_of(int heads, int hd, int elem) {
  int s = 1;
  while (heads % (2 * s) == 0 && (hd / 32) % (2 * s) == 0 &&
         (long long)hd * elem / (2 * s) >= kUnitBytes)
    s *= 2;
  return s;
}

// The plan of one call: heads of head_dim values, F frames, elem-byte values,
// the backward (q, k, v, dout in; dq, dk, dv out) or the forward (q, k, v in;
// out out). kRefused: a (token, head) does not fit a block's shared memory.
inline Plan plan(int heads, int head_dim, int frames, int elem, bool backward) {
  Plan p = {};
  const int nt = backward ? 4 : 3;  // tensors read
  const int hd = heads * head_dim;
  if (frames <= kStagedMaxFrames && heads <= 32 && 32 % heads == 0 &&
      head_dim % (32 / heads) == 0) {
    p.units = units_of(heads, hd, elem);
    p.W = hd / p.units;
    p.lph = 32 * p.units / heads;
    const int per_lane = p.W / 32;
    p.vec = elem == 2 && per_lane % 2 == 0 ? 2 : 1;
    p.iters = per_lane / p.vec;
    const long long fit = kSmem / ((long long)kStages * nt * frames * p.W * elem);
    p.R = fit < kWarps ? (int)fit : kWarps;
    if (p.R >= 1) {
      p.route = kStaged;
      return p;
    }
  }
  // bf16: D rounded up to 2 mod 4 values; f32: to an odd count
  const int row = elem == 2 ? (head_dim + 1) / 4 * 4 + 2 : head_dim | 1;
  const long long in_bytes = round16((long long)nt * frames * row * elem);
  const long long warp_bytes =
      in_bytes + round16((backward ? 2LL : 1LL) * frames * (frames + 1) * 4);
  const long long fit = kSmem / warp_bytes;
  if (fit >= 1) {
    p.route = kAny;
    p.row = row;
    p.in_bytes = (int)in_bytes;
    p.warp_bytes = (int)warp_bytes;
    p.nw = fit < kWarps ? (int)fit : kWarps;
  }
  return p;
}

}  // namespace temporal_plan
}  // namespace e2v
