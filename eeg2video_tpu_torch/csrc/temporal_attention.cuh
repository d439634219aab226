// temporal_attention_fwd / temporal_attention_bwd: multi-head attention over
// the frame axis at each spatial token (F x F per token and head).
//
// Replaces (JAX package, eeg2video_tpu/ops/temporal.py):
//   _temporal_fwd_kernel (:81) and _temporal_bwd_kernel (:95).
//
// Per (batch, token, head), with q_f, k_g, v_g the D-vectors of frame f, g:
//   p[f][g] = softmax_g(scale q_f . k_g),   out_f = sum_g p[f][g] v_g
// and, for the backward (p recomputed, nothing saved but q, k, v):
//   dp[f][g] = dout_f . v_g,   dl[f][g] = p[f][g] (dp[f][g] - sum_g p dp) scale
//   dq_f = sum_g dl[f][g] k_g,  dk_g = sum_f dl[f][g] q_f,  dv_g = sum_f p[f][g] dout_f
//
// Operands are read where the projections wrote them: (B, F, L, H*D) with
// rows of H*D contiguous values, no rearrangement to (B*L, F, C). The TPU
// body reduces over head lanes with one-hot GEMMs on the MXU. Everything here
// is f32; only the outputs are rounded (the TPU body rounds q*k*scale and p
// to the input dtype before its GEMMs).
// What bounds it on the H100: memory. Every operand is read once from HBM and
// every output written once: 4 tensors forward, 7 backward.
//
// The staged route (temporal_plan.cuh; the model's shapes): the work is cut
// into units, a unit being a 640-byte piece of one token's row that holds
// whole heads (bf16: D = 40, 80, 160 at H = 8 give 1, 2 and 4 units a token;
// f32 twice as many). In one frame of one tensor, consecutive units are
// consecutive bytes, so a run of R units (one warp each) is one contiguous
// slice of every (tensor, frame): a persistent block brings a run's NT F
// slices (NT = 3 tensors forward, 4 backward) into shared memory with NT F
// bulk copies (cp.async.bulk on an mbarrier), into a ring of two stages, so
// the next run's bytes are in flight while this one computes. A warp works on
// its unit in shared memory: lph lanes a head, VEC values a step (one
// 640-byte unit gives every lane 5 steps of 4 bytes, and the heads' words
// fall into 32 distinct banks), the F x F dots completed by xor-shuffles
// within the head's lanes and kept in registers. It writes its outputs over
// q (forward: out; backward: dq, dk, dv over q, k, v), each lane only over
// its own values once it has read them, and stores the unit's F (3F) slices
// by the bulk-copy engine (cp.async.bulk shared -> global) while the other
// warps still compute. Every operand byte is read from HBM once and every
// output byte written once; every sum runs in a fixed order within one warp,
// so a token's bits depend neither on L nor on where its run starts. The
// two directions are kernels of their own that share the dots and the
// softmax (one body for both, with the same arithmetic and bits, ran the
// backward 1-3% slower). Tried and not kept for the backward (PERF.md §6): the block storing the run
// after a barrier with 16-byte stores, and a two-stage ring for each warp
// with 640-byte copies and no block barrier (each about 10% slower).
//
// The any route (every other head count, head dim and frame count; the
// alignment of a head does not matter): a warp owns one (token, head) at a
// time. Its lanes copy the head's NT F D values into the warp's shared
// memory (rows padded to an odd number of words); the lanes share the F x F
// dots over D (a pair a lane), lane f turns row f into probabilities (and dl),
// all kept in shared memory, not registers, so F is a runtime count; then
// the lanes share the (frame, value) outputs and store them. Each sum runs
// in one order too.
//
// The element type is a template parameter: bf16 (e2v_temporal_attention_*)
// and f32 (e2v_temporal_attention_*_f32, the f32 counterpart the JAX package
// also runs: its dispatch tests no dtype, temporal.py:310). Inside, both are
// the same f32 arithmetic; only the loads and stores differ.
#pragma once

#include "hopper.cuh"
#include "temporal_plan.cuh"

namespace e2v {
namespace {

using temporal_plan::kIters;
using temporal_plan::kStages;
using temporal_plan::kWarps;
constexpr int kThreads = kWarps * 32;

// the element type of its size in bytes (2: bf16, 4: f32), a template
// argument that names the instantiation in the build log (a trait, so that
// the mangled parameter type carries no integer literal of its own)
template <int ELEM>
struct ElemOf;
template <>
struct ElemOf<2> {
  using type = bf16;
};
template <>
struct ElemOf<4> {
  using type = float;
};

template <typename T>
struct TemporalArgs {
  const T* in[4];    // q, k, v and (backward) dout
  T* out[3];         // out (forward), or dq, dk, dv (backward)
  long long sb, sf;  // batch and frame strides of every tensor, in elements
  int B, F, L, heads, D, hd;
  float scale;
  temporal_plan::Plan p;
  int units;         // staged: units of a batch element's frame, L * p.units
  int runs_per_b, runs;
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float (&x)[VEC]) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// sum over the lph lanes that share a head (lph is a power of two)
__device__ __forceinline__ float head_sum(float v, int lph) {
  for (int o = lph >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int F>
__device__ __forceinline__ void softmax_rows(float (&p)[F][F], float scale) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < F; ++g) {
      p[f][g] *= scale;
      mx = fmaxf(mx, p[f][g]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int g = 0; g < F; ++g) {
      p[f][g] = expf(p[f][g] - mx);
      sum += p[f][g];
    }
    const float inv = 1.0f / sum;
#pragma unroll
    for (int g = 0; g < F; ++g) p[f][g] *= inv;
  }
}

// dots[f][g] = sum over the head's D of a_f . b_g, a and b this lane's first
// value of frame 0 of two tensors in shared memory, frames fs apart
template <int F, int VEC, typename T>
__device__ __forceinline__ void unit_dots(const T* a, const T* b, int fs, int step, int iters,
                                          int lph, float (&dots)[F][F]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int g = 0; g < F; ++g) dots[f][g] = 0.0f;
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    float av[F][VEC], bv[F][VEC];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      load_vec<VEC>(a + f * fs + i * step, av[f]);
      load_vec<VEC>(b + f * fs + i * step, bv[f]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int g = 0; g < F; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) dots[f][g] += av[f][e] * bv[g][e];
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int g = 0; g < F; ++g) dots[f][g] = head_sum(dots[f][g], lph);
}

// --- the staged route --------------------------------------------------------

// The forward. Shared memory of a stage: [tensor q, k, v][frame][R units][W
// values]; after the compute, tensor 0 holds out. ITERS = 0: p.iters steps.
template <int F, int VEC, int ITERS, int ELEM>
__global__ void __launch_bounds__(kThreads, 1)
    temporal_fwd_kernel(const TemporalArgs<typename ElemOf<ELEM>::type> a) {
  using T = typename ElemOf<ELEM>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kStages];  // a run's slices landed in the stage
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int W = a.p.W, R = a.p.R, lph = a.p.lph;
  const int fs = R * W;          // values of one (tensor, frame) slice of a stage
  const int stage = 3 * F * fs;  // values of a stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the run's first value of frame 0 in every tensor, and its unit count
  auto run_at = [&](int run, int& n) {
    const int b = run / a.runs_per_b, u0 = (run % a.runs_per_b) * R;
    n = min(R, a.units - u0);
    return b * a.sb + (long long)u0 * W;
  };
  // by thread 0: the run's 3F slices into stage st
  auto load = [&](int run, int st) {
    int n;
    const long long base = run_at(run, n);
    const uint32_t bytes = n * W * (int)sizeof(T);
    mbar_expect(&full[st], 3 * F * bytes);
    T* dst = ring + st * stage;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      for (int f = 0; f < F; ++f)
        bulk_load(dst + (t * F + f) * fs, a.in[t] + base + f * a.sf, bytes, &full[st]);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int grid = gridDim.x;
  if (tid == 0 && (int)blockIdx.x < a.runs) load(blockIdx.x, 0);

  // this lane's first value of a unit: head lane / lph, step j = lane % lph
  const int off = (lane / lph) * a.D + VEC * (lane % lph);
  const int step = VEC * lph;
  const int iters = ITERS > 0 ? ITERS : a.p.iters;
  int it = 0;
  for (int run = blockIdx.x; run < a.runs; run += grid, ++it) {
    const int st = it % kStages;
    // the other stage was stored out and fenced by every thread last run
    if (tid == 0 && run + grid < a.runs) load(run + grid, (it + 1) % kStages);
    int n;
    const long long base = run_at(run, n);
    mbar_wait(&full[st], (it / kStages) & 1);
    if (warp < n) {
      T* unit = ring + st * stage + warp * W;
      T *uq = unit + off, *uk = uq + F * fs, *uv = uq + 2 * F * fs;
      float p[F][F];
      unit_dots<F, VEC>(uq, uk, fs, step, iters, lph, p);
      softmax_rows<F>(p, a.scale);
      // out_f over q_f: every lane of the head has read q (the shuffles
      // above), and each lane reads v and writes q only at its own values
#pragma unroll
      for (int i = 0; i < iters; ++i) {
        const int o = i * step;
        float vv[F][VEC];
#pragma unroll
        for (int g = 0; g < F; ++g) load_vec<VEC>(uv + g * fs + o, vv[g]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float ov[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ov[e] = 0.0f;
#pragma unroll
            for (int g = 0; g < F; ++g) ov[e] += p[f][g] * vv[g][e];
          }
          store_vec<VEC>(uq + f * fs + o, ov);
        }
      }
      // the unit's out by the bulk-copy engine while the other warps
      // compute: lanes 0 .. F - 1 store one frame's slice each, 640
      // contiguous bytes at the model's widths
      fence_proxy_async();  // the values above are read by the async proxy
      __syncwarp();
      if (lane < F) {
        bulk_store(a.out[0] + base + lane * a.sf + warp * W, unit + lane * fs,
                   W * (int)sizeof(T));
        bulk_commit();
        bulk_wait_read();  // the stage may be refilled after the barrier below
      }
    }
    // this thread's accesses to the stage come before the next bulk copy into it
    fence_proxy_async();
    __syncthreads();
  }
  if (lane < F) bulk_wait();  // the last stores are done before the block ends
}

// The staged backward's arguments.
template <typename T>
struct TemporalBwdArgs {
  const T *q, *k, *v, *dout;
  T *dq, *dk, *dv;
  long long sb, sf;  // batch and frame strides of every tensor, in elements
  int units;         // units of a batch element's frame: L * (units a token)
  int W;             // values of a unit
  int D, lph, iters; // head_dim, lanes a head, VEC-steps a lane
  int R;             // units of a run
  int runs_per_b, runs;
  float scale;
};

// The backward, a kernel of its own (a body shared with the forward, with
// the same arithmetic and bits, ran 1-3% slower). Shared memory of a stage:
// [tensor q, k, v, dout][frame][R units][W values]; after the compute,
// tensors 0-2 hold dq, dk, dv. ITERS = 0: a.iters steps.
template <int F, int VEC, int ITERS, int ELEM>
__global__ void __launch_bounds__(kThreads, 1)
    temporal_bwd_kernel(const TemporalBwdArgs<typename ElemOf<ELEM>::type> a) {
  using T = typename ElemOf<ELEM>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kStages];  // a run's slices landed in the stage
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int fs = a.R * a.W;       // values of one (tensor, frame) slice of a stage
  const int stage = 4 * F * fs;   // values of a stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the run's first value of frame 0 in every tensor, and its unit count
  auto run_at = [&](int run, int& n) {
    const int b = run / a.runs_per_b, u0 = (run % a.runs_per_b) * a.R;
    n = min(a.R, a.units - u0);
    return b * a.sb + (long long)u0 * a.W;
  };
  // by thread 0: the run's 4F slices into stage st
  auto load = [&](int run, int st) {
    int n;
    const long long base = run_at(run, n);
    const uint32_t bytes = n * a.W * (int)sizeof(T);
    mbar_expect(&full[st], 4 * F * bytes);
    const T* src[4] = {a.q, a.k, a.v, a.dout};
    T* dst = ring + st * stage;
    for (int t = 0; t < 4; ++t)
      for (int f = 0; f < F; ++f)
        bulk_load(dst + (t * F + f) * fs, src[t] + base + f * a.sf, bytes, &full[st]);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int grid = gridDim.x;
  if (tid == 0 && (int)blockIdx.x < a.runs) load(blockIdx.x, 0);

  // this lane's first value of a unit: head lane / lph, step j = lane % lph
  const int off = (lane / a.lph) * a.D + VEC * (lane % a.lph);
  const int step = VEC * a.lph;
  const int iters = ITERS > 0 ? ITERS : a.iters;
  int it = 0;
  for (int run = blockIdx.x; run < a.runs; run += grid, ++it) {
    const int st = it % kStages;
    // the other stage was stored out and fenced by every thread last run
    if (tid == 0 && run + grid < a.runs) load(run + grid, (it + 1) % kStages);
    int n;
    const long long base = run_at(run, n);
    mbar_wait(&full[st], (it / kStages) & 1);
    if (warp < n) {
      T* unit = ring + st * stage + warp * a.W;
      T *uq = unit + off, *uk = uq + F * fs, *uv = uq + 2 * F * fs, *udo = uq + 3 * F * fs;
      float p[F][F], dl[F][F];
      unit_dots<F, VEC>(uq, uk, fs, step, iters, a.lph, p);
      softmax_rows<F>(p, a.scale);
      unit_dots<F, VEC>(udo, uv, fs, step, iters, a.lph, dl);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float r = 0.0f;
#pragma unroll
        for (int g = 0; g < F; ++g) r += p[f][g] * dl[f][g];
#pragma unroll
        for (int g = 0; g < F; ++g) dl[f][g] = p[f][g] * (dl[f][g] - r) * a.scale;
      }
      // every lane of the head has read the values the dots needed (the
      // shuffles above), and from here on each lane reads and writes only
      // its own values
#pragma unroll
      for (int i = 0; i < iters; ++i) {
        const int o = i * step;
        float qv[F][VEC], kv[F][VEC], dov[F][VEC];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          load_vec<VEC>(uq + f * fs + o, qv[f]);
          load_vec<VEC>(uk + f * fs + o, kv[f]);
          load_vec<VEC>(udo + f * fs + o, dov[f]);
        }
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float dqv[VEC], dkv[VEC], dvv[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            dqv[e] = dkv[e] = dvv[e] = 0.0f;
#pragma unroll
            for (int g = 0; g < F; ++g) {
              dqv[e] += dl[f][g] * kv[g][e];  // row f of dl
              dkv[e] += dl[g][f] * qv[g][e];  // column f of dl
              dvv[e] += p[g][f] * dov[g][e];  // column f of p
            }
          }
          store_vec<VEC>(uq + f * fs + o, dqv);
          store_vec<VEC>(uk + f * fs + o, dkv);
          store_vec<VEC>(uv + f * fs + o, dvv);
        }
      }
      // the unit's dq, dk, dv out by the bulk-copy engine while the other
      // warps compute: lanes 0 .. 3F - 1 store one (tensor, frame) slice
      // each, 640 contiguous bytes at the model's widths
      fence_proxy_async();  // the values above are read by the async proxy
      __syncwarp();
      if (lane < 3 * F) {
        const int t = lane / F, f = lane % F;
        T* dst = (t == 0 ? a.dq : t == 1 ? a.dk : a.dv) + base + f * a.sf + warp * a.W;
        bulk_store(dst, unit + lane * fs, a.W * (int)sizeof(T));
        bulk_commit();
        bulk_wait_read();  // the stage may be refilled after the barrier below
      }
    }
    // this thread's accesses to the stage come before the next bulk copy into it
    fence_proxy_async();
    __syncthreads();
  }
  if (lane < 3 * F) bulk_wait();  // the last stores are done before the block ends
}

// --- the any route -------------------------------------------------------------

// sum over d < D of x[d] y[d]
template <typename T>
__device__ __forceinline__ float row_dot(const T* x, const T* y, int D) {
  float s = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) s += to_f(x[d]) * to_f(y[d]);
  return s;
}

// A warp's shared memory: [tensor q, k, v (, dout)][frame][p.row values, D
// of them used: rows an odd number of 4-byte words apart, so that the lanes
// reading one value of 32 rows fall on 32 banks], then P (F rows of F + 1
// floats, the last unused) and, backward, DL likewise.
template <int ELEM, bool BWD>
__device__ __forceinline__ void any_body(const TemporalArgs<typename ElemOf<ELEM>::type>& a) {
  using T = typename ElemOf<ELEM>::type;
  constexpr int NT = BWD ? 4 : 3;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = a.F, D = a.D, rs = a.p.row, ps = F + 1, nw = a.p.nw;
  unsigned char* mine = smem_raw + (size_t)warp * a.p.warp_bytes;
  T* in = reinterpret_cast<T*>(mine);
  float* P = reinterpret_cast<float*>(mine + a.p.in_bytes);
  float* DL = P + F * ps;
  const T *sq = in, *sk = in + F * rs, *sv = in + 2 * F * rs, *sdo = in + 3 * F * rs;
  const long long tasks = (long long)a.B * a.L * a.heads;
  for (long long task = (long long)blockIdx.x * nw + warp; task < tasks;
       task += (long long)gridDim.x * nw) {
    const long long bl = task / a.heads;  // (batch, token)
    const long long base =
        (bl / a.L) * a.sb + (bl % a.L) * a.hd + (long long)(task % a.heads) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      for (int i = lane; i < F * D; i += 32) {
        const int f = i / D, d = i % D;
        in[(t * F + f) * rs + d] = a.in[t][base + (long long)f * a.sf + d];
      }
    __syncwarp();
    // the scores (and dp) of every (f, g) pair, a pair a lane at a time
    for (int fg = lane; fg < F * F; fg += 32) {
      const int f = fg / F, g = fg % F;
      P[f * ps + g] = row_dot(sq + f * rs, sk + g * rs, D) * a.scale;
      if constexpr (BWD) DL[f * ps + g] = row_dot(sdo + f * rs, sv + g * rs, D);
    }
    __syncwarp();
    // lane f turns row f into probabilities (and dl)
    for (int f = lane; f < F; f += 32) {
      float* pr = P + f * ps;
      float mx = -INFINITY;
      for (int g = 0; g < F; ++g) mx = fmaxf(mx, pr[g]);
      float sum = 0.0f;
      for (int g = 0; g < F; ++g) {
        pr[g] = expf(pr[g] - mx);
        sum += pr[g];
      }
      const float inv = 1.0f / sum;
      for (int g = 0; g < F; ++g) pr[g] *= inv;
      if constexpr (BWD) {
        float* dr = DL + f * ps;
        float r = 0.0f;
        for (int g = 0; g < F; ++g) r += pr[g] * dr[g];
        for (int g = 0; g < F; ++g) dr[g] = pr[g] * (dr[g] - r) * a.scale;
      }
    }
    __syncwarp();
    for (int i = lane; i < F * D; i += 32) {
      const int f = i / D, d = i % D;
      const long long o = base + (long long)f * a.sf + d;
      if constexpr (BWD) {
        float dq = 0.0f, dk = 0.0f, dv = 0.0f;
        for (int g = 0; g < F; ++g) {
          dq += DL[f * ps + g] * to_f(sk[g * rs + d]);  // row f of dl
          dk += DL[g * ps + f] * to_f(sq[g * rs + d]);  // column f of dl
          dv += P[g * ps + f] * to_f(sdo[g * rs + d]);  // column f of p
        }
        a.out[0][o] = from_f<T>(dq);
        a.out[1][o] = from_f<T>(dk);
        a.out[2][o] = from_f<T>(dv);
      } else {
        float acc = 0.0f;
        for (int g = 0; g < F; ++g) acc += P[f * ps + g] * to_f(sv[g * rs + d]);
        a.out[0][o] = from_f<T>(acc);
      }
    }
    __syncwarp();  // the warp's shared memory is read before the next copy
  }
}

template <int ELEM>
__global__ void __launch_bounds__(kThreads)
    temporal_fwd_any_kernel(const TemporalArgs<typename ElemOf<ELEM>::type> a) {
  any_body<ELEM, false>(a);
}

template <int ELEM>
__global__ void __launch_bounds__(kThreads)
    temporal_bwd_any_kernel(const TemporalArgs<typename ElemOf<ELEM>::type> a) {
  any_body<ELEM, true>(a);
}

// --- host side ---------------------------------------------------------------

// a persistent grid of `threads`-thread blocks with `smem` bytes each: as
// many as fit the card at once, at most `items`
template <typename Args>
int launch_persistent(void (*kernel)(const Args), const Args& a, int threads, size_t smem,
                      long long items, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return (int)err;
  const long long fit = (long long)sms * (per_sm > 1 ? per_sm : 1);
  kernel<<<(int)(items < fit ? items : fit), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int F, int VEC, int ITERS, int ELEM, bool BWD>
inline auto staged_kernel() {
  if constexpr (BWD)
    return &temporal_bwd_kernel<F, VEC, ITERS, ELEM>;
  else
    return &temporal_fwd_kernel<F, VEC, ITERS, ELEM>;
}

template <int F, int ELEM, bool BWD>
int launch_staged(const TemporalArgs<typename ElemOf<ELEM>::type>& a, size_t smem,
                  cudaStream_t s) {
  // the model's widths (D = 40, 80, 160 at H = 8) take 5 steps a lane; f32
  // takes 4-byte steps (VEC = 1) only
  const bool five = a.p.iters == kIters;
  auto kernel = five ? staged_kernel<F, 1, kIters, ELEM, BWD>()
                     : staged_kernel<F, 1, 0, ELEM, BWD>();
  if constexpr (ELEM == 2) {
    if (a.p.vec == 2)
      kernel = five ? staged_kernel<F, 2, kIters, ELEM, BWD>()
                    : staged_kernel<F, 2, 0, ELEM, BWD>();
  }
  if constexpr (BWD) {
    TemporalBwdArgs<typename ElemOf<ELEM>::type> b = {};
    b.q = a.in[0];
    b.k = a.in[1];
    b.v = a.in[2];
    b.dout = a.in[3];
    b.dq = a.out[0];
    b.dk = a.out[1];
    b.dv = a.out[2];
    b.sb = a.sb;
    b.sf = a.sf;
    b.units = a.units;
    b.W = a.p.W;
    b.D = a.D;
    b.lph = a.p.lph;
    b.iters = a.p.iters;
    b.R = a.p.R;
    b.runs_per_b = a.runs_per_b;
    b.runs = a.runs;
    b.scale = a.scale;
    return launch_persistent(kernel, b, kThreads, smem, a.runs, s);
  } else {
    return launch_persistent(kernel, a, a.p.R * 32, smem, a.runs, s);
  }
}

// One call of either direction on (B, F, L, heads * D) tensors sharing the
// element strides sb and sf: in = q, k, v (, dout), out = out or dq, dk, dv.
// Returns the CUDA launch status, or temporal_plan::kDoesNotFit where a
// (token, head) does not fit a block's shared memory.
template <int ELEM, bool BWD>
int temporal_run(const void* const* in, void* const* out, long long sb, long long sf, int B,
                 int F, int L, int heads, int D, float scale, void* stream) {
  using T = typename ElemOf<ELEM>::type;
  constexpr int NT = BWD ? 4 : 3, NO = BWD ? 3 : 1;
  if (B < 0 || L < 0 || F < 1 || heads < 1 || D < 1) return (int)cudaErrorInvalidValue;
  TemporalArgs<T> a = {};
  a.p = temporal_plan::plan(heads, D, F, ELEM, BWD);
  if (a.p.route == temporal_plan::kRefused) return temporal_plan::kDoesNotFit;
  if (B == 0 || L == 0) return 0;
  for (int t = 0; t < NT; ++t) a.in[t] = static_cast<const T*>(in[t]);
  for (int t = 0; t < NO; ++t) a.out[t] = static_cast<T*>(out[t]);
  a.sb = sb;
  a.sf = sf;
  a.B = B;
  a.F = F;
  a.L = L;
  a.heads = heads;
  a.D = D;
  a.hd = heads * D;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.p.route == temporal_plan::kStaged) {
    a.units = L * a.p.units;
    a.runs_per_b = (a.units + a.p.R - 1) / a.p.R;
    a.runs = B * a.runs_per_b;
    const size_t smem = (size_t)kStages * a.p.R * NT * F * a.p.W * ELEM;
    switch (F) {
      case 1: return launch_staged<1, ELEM, BWD>(a, smem, s);
      case 2: return launch_staged<2, ELEM, BWD>(a, smem, s);
      case 3: return launch_staged<3, ELEM, BWD>(a, smem, s);
      case 4: return launch_staged<4, ELEM, BWD>(a, smem, s);
      case 5: return launch_staged<5, ELEM, BWD>(a, smem, s);
      case 6: return launch_staged<6, ELEM, BWD>(a, smem, s);
      case 7: return launch_staged<7, ELEM, BWD>(a, smem, s);
      default: return launch_staged<8, ELEM, BWD>(a, smem, s);
    }
  }
  const long long tasks = (long long)B * L * heads;
  void (*kernel)(const TemporalArgs<T>);
  if constexpr (BWD)
    kernel = temporal_bwd_any_kernel<ELEM>;
  else
    kernel = temporal_fwd_any_kernel<ELEM>;
  return launch_persistent(kernel, a, a.p.nw * 32, (size_t)a.p.nw * a.p.warp_bytes,
                           (tasks + a.p.nw - 1) / a.p.nw, s);
}

}  // namespace
}  // namespace e2v
