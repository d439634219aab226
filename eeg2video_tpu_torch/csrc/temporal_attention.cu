// temporal_attention_fwd / temporal_attention_bwd: multi-head attention over
// the frame axis at each spatial token (F x F per token and head, F <= 8).
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
// Forward (the first version): one warp owns one token with all its heads:
// 32 / H lanes share a head, lane j of a head holds elements
// VEC * (j + (32 / H) * i) of its D-vector, the F*F dot products are
// accumulated while the operands stream through registers and are completed
// by xor-shuffles within the head's lanes.
//
// Backward (redesigned for Hopper): the work is cut into units, a unit being
// a 640-byte piece of one token's row that holds whole heads (bf16: D = 40,
// 80, 160 at H = 8 give 1, 2 and 4 units a token; f32 twice as many;
// temporal_bwd_units below and ops/temporal.py bwd_plan). In one frame of one
// tensor, consecutive units are consecutive bytes, so a run of R units (one
// warp each) is one contiguous slice of every (tensor, frame): a persistent
// block brings a run's 4F slices of q, k, v and dout into shared memory with
// 4F bulk copies (cp.async.bulk on an mbarrier), into a ring of two stages,
// so the next run's bytes are in flight while this one computes. A warp
// works on its unit in shared memory with the forward's lane split (lph
// lanes a head, VEC values a step; one 640-byte unit gives every lane 5
// steps of 4 bytes, and the heads' words fall into 32 distinct banks),
// writes dq, dk, dv over q, k, v of its unit (each lane only over its own
// values, once it has read them), and stores the unit's 3F slices by the
// bulk-copy engine (cp.async.bulk shared -> global) while the other warps
// still compute. Every operand byte is read from HBM once and every output
// byte written once; every sum runs in a fixed order within one warp, so a
// token's bits depend neither on L nor on where its run starts.
// Tried and not kept (PERF.md §6): the block storing the run after a
// barrier with 16-byte stores, and a two-stage ring for each warp with
// 640-byte copies and no block barrier (each about 10% slower than this
// design at the level-0 train shape on an H100).
// The element type is a template parameter: bf16 (e2v_temporal_attention_*)
// and f32 (e2v_temporal_attention_*_f32, the f32 counterpart the JAX package
// also runs: its dispatch tests no dtype, temporal.py:310). Inside, both are
// the same f32 arithmetic; only the loads and stores differ.
#include "hopper.cuh"

namespace e2v {
namespace {

constexpr int kWarps = 4;  // tokens per block
constexpr int kThreads = kWarps * 32;

template <typename T>
struct TemporalArgs {
  const T *q, *k, *v;
  T *out;
  long long sb, sf;  // batch and frame strides of every tensor, in elements
  int L, hd, lph, iters;  // lanes per head, elements-of-VEC per lane
  float scale;
};

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

// dots[f][g] = sum over the head's D of a_f . b_g
template <int F, int VEC, typename T>
__device__ __forceinline__ void frame_dots(const T* a, const T* b, long long sf,
                                           int step, int iters, int lph,
                                           float (&dots)[F][F]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int g = 0; g < F; ++g) dots[f][g] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float av[F][VEC], bv[F][VEC];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      load_vec<VEC>(a + f * sf + i * step, av[f]);
      load_vec<VEC>(b + f * sf + i * step, bv[f]);
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

// element offset of this lane's first value within a (token) row
template <typename T>
__device__ __forceinline__ long long lane_offset(const TemporalArgs<T>& a, int vec) {
  const int lane = threadIdx.x & 31;
  const int head = lane / a.lph, j = lane % a.lph;
  return (long long)head * (a.hd / (32 / a.lph)) + vec * j;
}

template <int F, int VEC, typename T>
__global__ void __launch_bounds__(kThreads) temporal_fwd_kernel(const TemporalArgs<T> a) {
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= a.L) return;
  const long long base = blockIdx.y * a.sb + (long long)l * a.hd + lane_offset(a, VEC);
  const int step = VEC * a.lph;
  float p[F][F];
  frame_dots<F, VEC>(a.q + base, a.k + base, a.sf, step, a.iters, a.lph, p);
  softmax_rows<F>(p, a.scale);
  for (int i = 0; i < a.iters; ++i) {
    float vv[F][VEC];
#pragma unroll
    for (int g = 0; g < F; ++g) load_vec<VEC>(a.v + base + g * a.sf + i * step, vv[g]);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o[e] = 0.0f;
#pragma unroll
        for (int g = 0; g < F; ++g) o[e] += p[f][g] * vv[g][e];
      }
      store_vec<VEC>(a.out + base + f * a.sf + i * step, o);
    }
  }
}

template <int F, int VEC, typename T>
int launch_temporal(const TemporalArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid((a.L + kWarps - 1) / kWarps, B);
  temporal_fwd_kernel<F, VEC, T><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC, typename T>
int dispatch_frames(const TemporalArgs<T>& a, int B, int F, cudaStream_t s) {
  switch (F) {
    case 1: return launch_temporal<1, VEC, T>(a, B, s);
    case 2: return launch_temporal<2, VEC, T>(a, B, s);
    case 3: return launch_temporal<3, VEC, T>(a, B, s);
    case 4: return launch_temporal<4, VEC, T>(a, B, s);
    case 5: return launch_temporal<5, VEC, T>(a, B, s);
    case 6: return launch_temporal<6, VEC, T>(a, B, s);
    case 7: return launch_temporal<7, VEC, T>(a, B, s);
    case 8: return launch_temporal<8, VEC, T>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int temporal_fwd(TemporalArgs<T> a, int B, int F, int L, int heads, int head_dim, void* stream) {
  // 32 / heads lanes share a head; each holds head_dim / (32 / heads) values
  if (heads < 1 || heads > 32 || 32 % heads != 0) return (int)cudaErrorInvalidValue;
  a.lph = 32 / heads;
  if (head_dim % a.lph != 0) return (int)cudaErrorInvalidValue;
  a.L = L;
  a.hd = heads * head_dim;
  const int per_lane = head_dim / a.lph;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_lane % 2 == 0) {
    a.iters = per_lane / 2;
    return dispatch_frames<2, T>(a, B, F, s);
  }
  a.iters = per_lane;
  return dispatch_frames<1, T>(a, B, F, s);
}

// --- backward ----------------------------------------------------------------

constexpr int kUnitBytes = 640;         // a unit's bytes where the heads allow it
constexpr int kBwdWarps = 8;            // the most units a run holds: one warp each
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdStages = 2;           // the ring of runs
constexpr int kBwdIters = 5;            // steps a lane takes through a 640-byte unit
constexpr int kBwdSmem = 220 * 1024;    // shared memory of a block's stages, at most

// Units a token's row is cut into: the largest power of two s such that a
// unit holds whole heads (s divides H), a multiple of 32 values (s divides
// H*D / 32, so every lane holds the same count) and at least kUnitBytes.
// ops/temporal.py bwd_plan computes the same.
inline int temporal_bwd_units(int heads, int hd, int elem_bytes) {
  int s = 1;
  while (heads % (2 * s) == 0 && (hd / 32) % (2 * s) == 0 &&
         hd * elem_bytes / (2 * s) >= kUnitBytes)
    s *= 2;
  return s;
}

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

// Shared memory of a stage: [tensor q, k, v, dout][frame][R units][W values];
// after the compute, tensors 0-2 hold dq, dk, dv. ITERS = 0: a.iters steps.
template <int F, int VEC, int ITERS, int ELEM>
__global__ void __launch_bounds__(kBwdThreads, 1)
    temporal_bwd_kernel(const TemporalBwdArgs<typename ElemOf<ELEM>::type> a) {
  using T = typename ElemOf<ELEM>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kBwdStages];  // a run's slices landed in the stage
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
    for (int i = 0; i < kBwdStages; ++i) mbar_init(&full[i]);
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
    const int st = it % kBwdStages;
    // the other stage was stored out and fenced by every thread last run
    if (tid == 0 && run + grid < a.runs) load(run + grid, (it + 1) % kBwdStages);
    int n;
    const long long base = run_at(run, n);
    mbar_wait(&full[st], (it / kBwdStages) & 1);
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

template <int F, typename T>
int launch_temporal_bwd(const TemporalBwdArgs<T>& a, int vec, size_t smem, cudaStream_t s) {
  // the model's widths (D = 40, 80, 160 at H = 8) take 5 steps a lane; f32
  // takes 4-byte steps (VEC = 1) only
  constexpr int E = sizeof(T);
  void (*kernel)(const TemporalBwdArgs<T>) = a.iters == kBwdIters
                                                 ? temporal_bwd_kernel<F, 1, kBwdIters, E>
                                                 : temporal_bwd_kernel<F, 1, 0, E>;
  if constexpr (E == 2) {
    if (vec == 2)
      kernel = a.iters == kBwdIters ? temporal_bwd_kernel<F, 2, kBwdIters, E>
                                    : temporal_bwd_kernel<F, 2, 0, E>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  const int grid = min(a.runs, max(1, sms * per_sm));
  kernel<<<grid, kBwdThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int temporal_bwd(TemporalBwdArgs<T> a, int B, int F, int L, int heads, int head_dim,
                 void* stream) {
  if (heads < 1 || heads > 32 || 32 % heads != 0 || head_dim % (32 / heads) != 0 || F < 1 ||
      F > 8 || B < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  const int hd = heads * head_dim;
  const int units = temporal_bwd_units(heads, hd, (int)sizeof(T));
  a.W = hd / units;
  a.D = head_dim;
  a.lph = 32 * units / heads;
  const int per_lane = a.W / 32;
  const int vec = sizeof(T) == 2 && per_lane % 2 == 0 ? 2 : 1;
  a.iters = per_lane / vec;
  a.units = L * units;
  // units a run: as many as two stages of shared memory hold, at most one a warp
  const size_t unit_bytes = (size_t)4 * F * a.W * sizeof(T);
  const size_t fit = kBwdSmem / (kBwdStages * unit_bytes);
  a.R = fit < (size_t)kBwdWarps ? (int)fit : kBwdWarps;
  if (a.R < 1) return (int)cudaErrorInvalidValue;  // ops/temporal.py refuses these by name
  a.runs_per_b = (a.units + a.R - 1) / a.R;
  a.runs = B * a.runs_per_b;
  const size_t smem = kBwdStages * a.R * unit_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_temporal_bwd<1, T>(a, vec, smem, s);
    case 2: return launch_temporal_bwd<2, T>(a, vec, smem, s);
    case 3: return launch_temporal_bwd<3, T>(a, vec, smem, s);
    case 4: return launch_temporal_bwd<4, T>(a, vec, smem, s);
    case 5: return launch_temporal_bwd<5, T>(a, vec, smem, s);
    case 6: return launch_temporal_bwd<6, T>(a, vec, smem, s);
    case 7: return launch_temporal_bwd<7, T>(a, vec, smem, s);
    default: return launch_temporal_bwd<8, T>(a, vec, smem, s);
  }
}

template <typename T>
int temporal_bwd_entry(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, long long sb, long long sf, int B, int F, int L,
                       int heads, int head_dim, float scale, void* stream) {
  TemporalBwdArgs<T> a = {};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.dout = static_cast<const T*>(dout);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.sb = sb;
  a.sf = sf;
  a.scale = scale;
  return temporal_bwd(a, B, F, L, heads, head_dim, stream);
}

}  // namespace
}  // namespace e2v

// q, k, v, out (B, F, L, heads * head_dim) bf16 sharing the element strides
// sb (batch) and sf (frame), rows contiguous. 32 % heads == 0,
// head_dim % (32 / heads) == 0, F <= 8. Returns the CUDA launch status.
extern "C" int e2v_temporal_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                          long long sb, long long sf, int B, int F, int L,
                                          int heads, int head_dim, float scale, void* stream) {
  using namespace e2v;
  TemporalArgs<bf16> a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.sb = sb;
  a.sf = sf;
  a.scale = scale;
  return temporal_fwd(a, B, F, L, heads, head_dim, stream);
}

// As above, plus dout in and dq, dk, dv out, all with the same strides; every
// pointer 16-byte aligned, and a unit's 4F slices (ops/temporal.py bwd_plan)
// must fit two stages of shared memory.
extern "C" int e2v_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          long long sb, long long sf, int B, int F, int L,
                                          int heads, int head_dim, float scale, void* stream) {
  return e2v::temporal_bwd_entry<e2v::bf16>(q, k, v, dout, dq, dk, dv, sb, sf, B, F, L, heads,
                                            head_dim, scale, stream);
}

// The f32 counterparts: the same arguments, f32 tensors.
extern "C" int e2v_temporal_attention_fwd_f32(const void* q, const void* k, const void* v,
                                              void* out, long long sb, long long sf, int B,
                                              int F, int L, int heads, int head_dim,
                                              float scale, void* stream) {
  using namespace e2v;
  TemporalArgs<float> a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.sb = sb;
  a.sf = sf;
  a.scale = scale;
  return temporal_fwd(a, B, F, L, heads, head_dim, stream);
}

extern "C" int e2v_temporal_attention_bwd_f32(const void* q, const void* k, const void* v,
                                              const void* dout, void* dq, void* dk, void* dv,
                                              long long sb, long long sf, int B, int F, int L,
                                              int heads, int head_dim, float scale,
                                              void* stream) {
  return e2v::temporal_bwd_entry<float>(q, k, v, dout, dq, dk, dv, sb, sf, B, F, L, heads,
                                        head_dim, scale, stream);
}
