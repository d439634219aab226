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
// body reduces over head lanes with one-hot GEMMs on the MXU; here one warp
// owns one token with all its heads: 32 / H lanes share a head, lane j of a
// head holds elements VEC * (j + (32 / H) * i) of its D-vector, the F*F dot
// products are accumulated while the operands stream through registers and
// are completed by xor-shuffles within the head's lanes. Everything is f32;
// only the outputs are rounded (the TPU body rounds q*k*scale and p to the
// input dtype before its GEMMs).
// What bounds it on the H100: memory. Every operand is read once from HBM
// (the second walk over q, k, dout in the backward hits L1/L2) and every
// output written once: 4 tensors forward, 7 backward.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kWarps = 4;  // tokens per block
constexpr int kThreads = kWarps * 32;

struct TemporalArgs {
  const bf16 *q, *k, *v, *dout;
  bf16 *out, *dq, *dk, *dv;
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

// sum over the lph lanes that share a head (lph is a power of two)
__device__ __forceinline__ float head_sum(float v, int lph) {
  for (int o = lph >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dots[f][g] = sum over the head's D of a_f . b_g
template <int F, int VEC>
__device__ __forceinline__ void frame_dots(const bf16* a, const bf16* b, long long sf,
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
__device__ __forceinline__ long long lane_offset(const TemporalArgs& a, int vec) {
  const int lane = threadIdx.x & 31;
  const int head = lane / a.lph, j = lane % a.lph;
  return (long long)head * (a.hd / (32 / a.lph)) + vec * j;
}

template <int F, int VEC>
__global__ void __launch_bounds__(kThreads) temporal_fwd_kernel(const TemporalArgs a) {
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

template <int F, int VEC>
__global__ void __launch_bounds__(kThreads) temporal_bwd_kernel(const TemporalArgs a) {
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= a.L) return;
  const long long base = blockIdx.y * a.sb + (long long)l * a.hd + lane_offset(a, VEC);
  const int step = VEC * a.lph;
  float p[F][F], dl[F][F];
  frame_dots<F, VEC>(a.q + base, a.k + base, a.sf, step, a.iters, a.lph, p);
  softmax_rows<F>(p, a.scale);
  frame_dots<F, VEC>(a.dout + base, a.v + base, a.sf, step, a.iters, a.lph, dl);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float r = 0.0f;
#pragma unroll
    for (int g = 0; g < F; ++g) r += p[f][g] * dl[f][g];
#pragma unroll
    for (int g = 0; g < F; ++g) dl[f][g] = p[f][g] * (dl[f][g] - r) * a.scale;
  }
  for (int i = 0; i < a.iters; ++i) {
    const long long off = base + i * step;
    float qv[F][VEC], kv[F][VEC], dov[F][VEC];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      load_vec<VEC>(a.q + off + f * a.sf, qv[f]);
      load_vec<VEC>(a.k + off + f * a.sf, kv[f]);
      load_vec<VEC>(a.dout + off + f * a.sf, dov[f]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float dqv[VEC], dkv[VEC], dvv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        dqv[e] = dkv[e] = dvv[e] = 0.0f;
#pragma unroll
        for (int g = 0; g < F; ++g) {
          dqv[e] += dl[f][g] * kv[g][e];   // row f of dl
          dkv[e] += dl[g][f] * qv[g][e];   // column f of dl
          dvv[e] += p[g][f] * dov[g][e];   // column f of p
        }
      }
      store_vec<VEC>(a.dq + off + f * a.sf, dqv);
      store_vec<VEC>(a.dk + off + f * a.sf, dkv);
      store_vec<VEC>(a.dv + off + f * a.sf, dvv);
    }
  }
}

template <int F, int VEC>
int launch_temporal(const TemporalArgs& a, int B, bool backward, cudaStream_t stream) {
  const dim3 grid((a.L + kWarps - 1) / kWarps, B);
  if (backward)
    temporal_bwd_kernel<F, VEC><<<grid, kThreads, 0, stream>>>(a);
  else
    temporal_fwd_kernel<F, VEC><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch_frames(const TemporalArgs& a, int B, int F, bool backward, cudaStream_t s) {
  switch (F) {
    case 1: return launch_temporal<1, VEC>(a, B, backward, s);
    case 2: return launch_temporal<2, VEC>(a, B, backward, s);
    case 3: return launch_temporal<3, VEC>(a, B, backward, s);
    case 4: return launch_temporal<4, VEC>(a, B, backward, s);
    case 5: return launch_temporal<5, VEC>(a, B, backward, s);
    case 6: return launch_temporal<6, VEC>(a, B, backward, s);
    case 7: return launch_temporal<7, VEC>(a, B, backward, s);
    case 8: return launch_temporal<8, VEC>(a, B, backward, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int temporal(TemporalArgs a, int B, int F, int L, int heads, int head_dim, bool backward,
             void* stream) {
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
    return dispatch_frames<2>(a, B, F, backward, s);
  }
  a.iters = per_lane;
  return dispatch_frames<1>(a, B, F, backward, s);
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
  TemporalArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.sb = sb;
  a.sf = sf;
  a.scale = scale;
  return temporal(a, B, F, L, heads, head_dim, false, stream);
}

// As above, plus dout in and dq, dk, dv out, all with the same strides.
extern "C" int e2v_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          long long sb, long long sf, int B, int F, int L,
                                          int heads, int head_dim, float scale, void* stream) {
  using namespace e2v;
  TemporalArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sb = sb;
  a.sf = sf;
  a.scale = scale;
  return temporal(a, B, F, L, heads, head_dim, true, stream);
}
