// Zero-phase IIR filtering (filtfilt) of many rows: sos_filtfilt.
//
// Replaces no Pallas kernel. The JAX package runs the recursion as one
// lax.scan over time that advances every row and every section a step
// (eeg2video_tpu/dsp/bandpass.py:177 _sos_scan, :215 _filtfilt_sos_jit; the
// transfer-function form :155 _lfilter_scan, :207 _filtfilt_tf_jit). One
// launch does the whole filtfilt of x (R, T), f32 or f64:
//   - the odd extension of padlen samples at both ends, read from x by index
//     (no padded copy);
//   - the forward pass from zi * ext[0] over the N = T + 2 padlen samples,
//     into a workspace (R, N) the wrapper allocates;
//   - the backward pass from zi * y_fwd[N - 1], from the end of the workspace
//     down to sample padlen, written cropped into out (R, T).
// Two forms: a cascade of S biquads in direct form II transposed, each step
// in _sos_scan's order of operations (:182-192), or one section of order K in
// _lfilter_scan's (:160-166). Every product and sum is rounded on its own
// (__fmul_rn, __dadd_rn, ...: no contraction into FMAs), as the plain version
// (ops/iir.py) computes it eagerly, so the two agree to the bit.
//
// What bounds it: the recursion. Each sample of a row depends on the one
// before through every section, so a row is one thread's sequential loop, and
// its time is 2 N steps times the dependent chain of a step; the bytes (x
// read, the workspace written and read back, out written) take a fraction of
// that. The design keeps the chain the only wait: a warp owns 32 rows (a lane
// a row, its state in registers); 32-step tiles of its rows go through shared
// memory, so that every global load and store is a coalesced run of one row,
// and the next tile lands by cp.async in a second buffer while the lanes run
// the current one (tiles that hold padding are computed by the lanes). Loads
// staged in registers instead left each tile waiting on 32 round trips to L2.
// Rows are independent, so a row's bits do not depend on R.
#include <cuda_runtime.h>

namespace e2v {
namespace {

constexpr int kTile = 32;  // steps a tile; a warp's rows

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// sizeof(T) bytes device -> shared, asynchronous; zero-filled when !valid
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the newest committed group of this thread have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One step of the filter on input u with state z; returns the output.
// coef[j] holds b0..bK, a1..aK of section j.
template <typename T, int S, int K, bool kTF>
__device__ __forceinline__ T filter_step(T u, T (&z)[S][K], const T (&coef)[S][2 * K + 1]) {
  T y = u;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const T yj = add_rn(mul_rn(coef[j][0], y), z[j][0]);
    if (kTF) {
      // z_i = (z_{i+1} + b_{i+1} u) - a_{i+1} y; the last: b_K u - a_K y
#pragma unroll
      for (int i = 0; i + 1 < K; ++i)
        z[j][i] = sub_rn(add_rn(z[j][i + 1], mul_rn(coef[j][i + 1], y)),
                         mul_rn(coef[j][K + 1 + i], yj));
      z[j][K - 1] = sub_rn(mul_rn(coef[j][K], y), mul_rn(coef[j][2 * K], yj));
    } else {
      // biquad: z0 = (b1 u - a1 y) + z1, z1 = b2 u - a2 y
      z[j][0] = add_rn(sub_rn(mul_rn(coef[j][1], y), mul_rn(coef[j][3], yj)), z[j][1]);
      z[j][1] = sub_rn(mul_rn(coef[j][2], y), mul_rn(coef[j][4], yj));
    }
    y = yj;
  }
  return y;
}

// Sample n of the odd extension of row xr (length t_len), n in [0, N).
template <typename T>
__device__ __forceinline__ T odd_ext(const T* __restrict__ xr, long long n, long long t_len,
                                     int padlen) {
  if (n < padlen) return sub_rn(T(2) * xr[0], xr[padlen - n]);
  const long long m = n - padlen;
  if (m < t_len) return xr[m];
  return sub_rn(T(2) * xr[t_len - 1], xr[2 * t_len - 2 - m]);
}

template <typename T, int S, int K, bool kTF>
__global__ void __launch_bounds__(kTile) sos_filtfilt_kernel(
    const T* __restrict__ x, T* __restrict__ out, T* __restrict__ ws,
    const T* __restrict__ coef_g, const T* __restrict__ zi_g, int rows, long long t_len,
    int padlen) {
  // two buffers of [row of the warp][step]: lane-major reads conflict-free
  __shared__ T tile[2][kTile][kTile + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const long long n_ext = t_len + 2LL * padlen;
  const long long n_tiles = (n_ext + kTile - 1) / kTile;

  T coef[S][2 * K + 1], z[S][K];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int i = 0; i < 2 * K + 1; ++i) coef[j][i] = coef_g[j * (2 * K + 1) + i];

  // tile k of the extension into tile[b]: by cp.async where it lies inside x,
  // computed where it holds padding; one committed group a call
  auto stage_ext = [&](int b, long long k) {
    const long long n = k * kTile + lane;
    const bool inside = k * kTile >= padlen && (k + 1) * kTile <= padlen + t_len;
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int r = row0 + i;
      const bool valid = r < rows && n < n_ext;
      if (inside)
        cp_async(&tile[b][i][lane], x + (long long)(valid ? r : 0) * t_len + (n - padlen), valid);
      else
        tile[b][i][lane] = valid ? odd_ext(x + (long long)r * t_len, n, t_len, padlen) : T(0);
    }
    cp_async_commit();
  };
  auto stage_ws = [&](int b, long long k) {
    const long long n = k * kTile + lane;
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int r = row0 + i;
      const bool valid = r < rows && n < n_ext;
      cp_async(&tile[b][i][lane], ws + (long long)(valid ? r : 0) * n_ext + (valid ? n : 0), valid);
    }
    cp_async_commit();
  };

  // forward: state zi * ext[0]
  const T e0 = odd_ext(x + (long long)(row0 + lane < rows ? row0 + lane : 0) * t_len, 0, t_len,
                       padlen);
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) z[j][i] = mul_rn(zi_g[j * K + i], e0);
  stage_ext(0, 0);
  T y_last = T(0);
  for (long long k = 0; k < n_tiles; ++k) {
    const int b = (int)(k & 1);
    if (k + 1 < n_tiles) stage_ext(b ^ 1, k + 1);  // in flight while the lanes step
    else cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    const int steps = (int)min((long long)kTile, n_ext - k * kTile);
#pragma unroll 8
    for (int s = 0; s < steps; ++s) {
      y_last = filter_step<T, S, K, kTF>(tile[b][lane][s], z, coef);
      tile[b][lane][s] = y_last;
    }
    __syncwarp();
    const long long n = k * kTile + lane;
    if (n < n_ext) {
#pragma unroll 4
      for (int i = 0; i < kTile; ++i)
        if (row0 + i < rows) ws[(long long)(row0 + i) * n_ext + n] = tile[b][i][lane];
    }
    __syncwarp();
  }

  // backward: state zi * y_fwd[N - 1], from sample N - 1 down to padlen.
  // Each lane reads back the workspace columns it wrote itself.
  __threadfence_block();
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) z[j][i] = mul_rn(zi_g[j * K + i], y_last);
  const long long k_first = padlen / kTile;
  stage_ws(0, n_tiles - 1);
  for (long long k = n_tiles - 1, j = 0; k >= k_first; --k, ++j) {
    const int b = (int)(j & 1);
    if (k > k_first) stage_ws(b ^ 1, k - 1);
    else cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    const int hi = (int)min((long long)kTile, n_ext - k * kTile) - 1;
    const int lo = (int)max(0LL, (long long)padlen - k * kTile);
#pragma unroll 8
    for (int s = hi; s >= lo; --s)
      tile[b][lane][s] = filter_step<T, S, K, kTF>(tile[b][lane][s], z, coef);
    __syncwarp();
    const long long n = k * kTile + lane;  // extended index; out holds [padlen, padlen + T)
    if (n >= padlen && n < padlen + t_len) {
#pragma unroll 4
      for (int i = 0; i < kTile; ++i)
        if (row0 + i < rows) out[(long long)(row0 + i) * t_len + (n - padlen)] = tile[b][i][lane];
    }
    __syncwarp();
  }
}

template <typename T, int S, int K, bool kTF>
int launch(const void* x, void* out, void* ws, const void* coef, const void* zi, int rows,
           long long t_len, int padlen, cudaStream_t stream) {
  const int blocks = (rows + kTile - 1) / kTile;
  sos_filtfilt_kernel<T, S, K, kTF><<<blocks, kTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(ws),
      static_cast<const T*>(coef), static_cast<const T*>(zi), rows, t_len, padlen);
  return (int)cudaGetLastError();
}

constexpr int kMaxSections = 8;  // biquads of the cascade form (ops/iir.py MAX_SECTIONS)
constexpr int kMaxOrder = 16;    // order of the transfer-function form (ops/iir.py MAX_ORDER)

template <typename T, int S = 1>
int launch_sos(int sections, const void* x, void* out, void* ws, const void* coef,
               const void* zi, int rows, long long t_len, int padlen, cudaStream_t stream) {
  if (sections == S) return launch<T, S, 2, false>(x, out, ws, coef, zi, rows, t_len, padlen, stream);
  if constexpr (S < kMaxSections)
    return launch_sos<T, S + 1>(sections, x, out, ws, coef, zi, rows, t_len, padlen, stream);
  return (int)cudaErrorInvalidValue;
}

// Even orders only: a Butterworth bandpass of order N has 2 N; the wrapper
// runs an odd order K as K + 1 with a zero last coefficient and state, which
// changes no value (the plain version adds the same zero to the last state).
template <typename T, int K = 2>
int launch_tf(int order, const void* x, void* out, void* ws, const void* coef, const void* zi,
              int rows, long long t_len, int padlen, cudaStream_t stream) {
  if (order == K) return launch<T, 1, K, true>(x, out, ws, coef, zi, rows, t_len, padlen, stream);
  if constexpr (K < kMaxOrder)
    return launch_tf<T, K + 2>(order, x, out, ws, coef, zi, rows, t_len, padlen, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* x, void* out, void* ws, const void* coef, const void* zi, int rows,
             long long t_len, int padlen, int sections, int order, int tf, cudaStream_t stream) {
  if (tf) {
    if (sections != 1) return (int)cudaErrorInvalidValue;
    return launch_tf<T>(order, x, out, ws, coef, zi, rows, t_len, padlen, stream);
  }
  if (order != 2) return (int)cudaErrorInvalidValue;
  return launch_sos<T>(sections, x, out, ws, coef, zi, rows, t_len, padlen, stream);
}

}  // namespace
}  // namespace e2v

// x (rows, t_len) -> out (rows, t_len), ws (rows, t_len + 2 padlen); coef
// (sections, 2 order + 1) = [b0..b_order, a1..a_order] a section, zi
// (sections, order); all f32, or all f64 when f64 != 0. tf: one section of
// even order 2..16 in the transfer-function form; else 1..8 biquads (order 2).
extern "C" int e2v_sos_filtfilt(const void* x, void* out, void* ws, const void* coef,
                                const void* zi, int rows, long long t_len, int padlen,
                                int sections, int order, int tf, int f64, void* stream) {
  using namespace e2v;
  if (rows < 1 || padlen < 0 || t_len <= padlen) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? dispatch<double>(x, out, ws, coef, zi, rows, t_len, padlen, sections, order, tf, s)
             : dispatch<float>(x, out, ws, coef, zi, rows, t_len, padlen, sections, order, tf, s);
}
