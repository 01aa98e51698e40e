// Pieces shared by the SSD scan's forward (ssd_scan.cu) and its gradient
// (ssd_scan_bwd.cu): the launch geometry, the bf16 hi + lo split of fp32
// operands, the per-head cumsum of -dt A, and the staging of dt and of one
// head's chunk of xh (or of its gradient) in shared memory.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
// heads per block in the forward's passes (a) and (c) and in the gradient's
// chunk, dx, dB and dC passes
constexpr int HG = 8;
constexpr int BATCH = 8;   // global loads a thread keeps in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// y[0], y[1] = a, b
__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

// (x0, x1) = hi + lo, each a bf16 pair: hi the rounded value, lo the
// rounded remainder, about 17 significant bits together
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one warp: cum = inclusive cumsum of -dt * a over CP (a multiple of 32)
__device__ __forceinline__ void warp_cumsum(float* cum, const float* dts,
                                            float a, int CP) {
  const int lane = threadIdx.x & 31;
  const int per = CP / 32, s0 = lane * per;
  float own = 0.0f;
  for (int s = s0; s < s0 + per; ++s) own += -(dts[s] * a);
  float inc = own;
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += up;
  }
  float run = inc - own;
  for (int s = s0; s < s0 + per; ++s) {
    run += -(dts[s] * a);
    cum[s] = run;
  }
}

// put(i, get(i)) for i = tid, tid + THREADS, ... < n, with BATCH global
// loads of a thread in flight before it uses them
template <typename V, typename Get, typename Put>
__device__ __forceinline__ void batched(int n, Get get, Put put) {
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * THREADS) {
    V v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * THREADS < n) v[u] = get(i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * THREADS < n) put(i0 + u * THREADS, v[u]);
  }
}

// dts[hh][s] = dt of step s of the chunk for head h0 + hh (0 past T and
// past C), for hh < nh and s < CP
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int b,
                                        int t0, int T_len, int H, int h0,
                                        int nh, int C, int CP) {
  batched<float>(
      nh * CP,
      [=](int i) {
        const int s = i % CP, t = t0 + s;
        return (s < C && t < T_len)
                   ? dt[((size_t)b * T_len + t) * H + h0 + i / CP]
                   : 0.f;
      },
      [=](int i, float v) { dts[i] = v; });
}

// One head's chunk of xh, (CP, XW) in shared memory, zero past C, T and
// hd: bf16 is copied as it is (cp.async, 16 B a thread, into `hi`); fp32
// is split into bf16 hi and lo parts.
template <typename T>
__device__ __forceinline__ void stage_x(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                        int xw, const T* xh, int b, int t0,
                                        int T_len, int H, int h, int hd,
                                        int C, int CP, int XW) {
  const T* base = xh + ((size_t)b * T_len * H + h) * hd;
  const size_t st = (size_t)H * hd;  // elements between steps
  if constexpr (!std::is_same<T, float>::value) {
    const int per = XW / 8;
    for (int i = threadIdx.x; i < CP * per; i += THREADS) {
      const int s = i / per, d = (i % per) * 8, t = t0 + s;
      const bool ok = s < C && t < T_len && d < hd;
      cp_async16(hi + s * xw + d, ok ? base + t * st + d : base, ok);
    }
    cp_async_commit();
  } else {
    const int per = XW / 2;
    for (int i = threadIdx.x; i < CP * per; i += THREADS) {
      const int s = i / per, d = (i % per) * 2, t = t0 + s;
      const bool ok = s < C && t < T_len && d < hd;
      float2 v = make_float2(0.f, 0.f);
      if (ok) v = *reinterpret_cast<const float2*>(base + t * st + d);
      uint32_t h2, l2;
      split(v.x, v.y, h2, l2);
      *reinterpret_cast<uint32_t*>(hi + s * xw + d) = h2;
      *reinterpret_cast<uint32_t*>(lo + s * xw + d) = l2;
    }
  }
}

}  // namespace
