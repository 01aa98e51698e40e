// Fused head projection + per-row scoring statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel `margin_head` (src/repro/kernels/margin_head.py,
// body `_kernel`): for hidden (T, D) and W (D, V) it emits, per row,
// margin = v1 - v2, entropy = lse - sum(x e^x)/sum(e^x), max_logprob =
// v1 - lse and top1 = argmax (the first index among equal maxima), without
// ever writing the (T, V) logits to device memory.
//
// What bounds it: it reads T*D + D*V inputs and writes 4*T outputs, and
// does 2*T*D*V flops.  On the LM scoring path (T = 8 requests, D = 2560,
// V = 32000, fp32) that is reading W, 328 MB, about 0.1 ms at 3.35 TB/s;
// the flops take a fifth of that on the CUDA cores, so no tensor cores are
// needed.  On the campaign path (T = 2048, D = 64, V = 10) both are under
// a microsecond and the launch is the cost.
//
// Design: V is split across blocks so that the whole card streams W.
//   margin_head_slice_kernel, a 2-D grid of (groups of R rows) x (slices
//   of SC columns): each block reads its (D, SC) part of W exactly once,
//   for all R rows.  A warp reads one W row of the slice per load
//   instruction (4 columns a lane: one 16-byte load in fp32, 8 bytes in
//   bf16, converted on load), and keeps U such loads in flight before it
//   uses them; the 8 warps split D, so that 16 warps an SM keep about 64
//   KB of W in flight.  The R hidden rows come through shared memory,
//   transposed, DC values of D at a time, and are read as two broadcast
//   float4 per D value.  Each lane keeps R x 4 partial logits in fp32
//   registers (FMAs in increasing d); the 8 warps' partials are then
//   summed through shared memory in warp order, so every logit is summed
//   in one fixed order, the same for every column: equal columns give
//   equal logits.  One warp per row folds the slice's logits into an
//   online state (m, s, u, v1, v2, i1), a lane over its 4 columns in
//   increasing order with a strict `>` (first index), then the lanes
//   merged with shuffles, equal v1 going to the smaller index: the TPU
//   kernel's first-index rule (`c1 > v1_old`).  When one slice covers V
//   (the campaign's V = 10) this launch writes the four outputs; else it
//   writes the slice's state to a scratch after the outputs.
//   margin_head_merge_kernel, one warp per row: each lane folds a
//   contiguous run of slices in increasing order, then the lanes are
//   merged pairwise with shuffles (a fixed tree), and lane 0 writes the
//   outputs.
// No atomics: the result is the same from run to run.  A column count
// off a multiple of 4, or W not aligned for vector loads, takes scalar
// loads (lane + 32 j) with the same summation order.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;        // hidden rows per block
constexpr int SC = 128;     // W columns per slice, 4 per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 8;        // W rows a warp has in flight
constexpr int DC = 512;     // D values of hidden staged at once
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(DC % (WARPS * U) == 0, "a chunk is whole warp steps");
static_assert(DC * R <= WARPS * R * SC, "hidden fits the reduction buffer");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four neighbouring W values, 16-byte (fp32) or 8-byte (bf16) aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

struct State {
  float m, s, u, v1, v2;
  int i1;
};

__device__ __forceinline__ State empty_state() {
  return State{NEG_INF, 0.0f, 0.0f, NEG_INF, NEG_INF, INT_MAX};
}

// Fold one logit into a lane's online state.
__device__ __forceinline__ void push(State& st, float x, int col) {
  if (x > st.m) {
    const float c = expf(st.m - x);
    st.s = st.s * c + 1.0f;
    st.u = st.u * c + x;
    st.m = x;
  } else {
    const float e = expf(x - st.m);
    st.s += e;
    st.u = fmaf(x, e, st.u);
  }
  if (x > st.v1) {
    st.v2 = st.v1;
    st.v1 = x;
    st.i1 = col;
  } else if (x > st.v2) {
    st.v2 = x;
  }
}

// Merge state b into a.  Symmetric to the bit (products rounded before
// the sum, so no FMA contraction favours one side; equal v1 go to the
// smaller column), so both lanes of a shuffle pair hold the same result.
__device__ __forceinline__ void merge(State& a, const State& b) {
  const float m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - m), cb = expf(b.m - m);
  a.s = __fmul_rn(a.s, ca) + __fmul_rn(b.s, cb);
  a.u = __fmul_rn(a.u, ca) + __fmul_rn(b.u, cb);
  a.m = m;
  const float v2 = fmaxf(fminf(a.v1, b.v1), fmaxf(a.v2, b.v2));
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1)) a.i1 = b.i1;
  a.v1 = fmaxf(a.v1, b.v1);
  a.v2 = v2;
}

__device__ __forceinline__ void merge_lanes(State& st) {
  for (int off = 16; off > 0; off >>= 1) {
    State o;
    o.m = __shfl_xor_sync(FULL, st.m, off);
    o.s = __shfl_xor_sync(FULL, st.s, off);
    o.u = __shfl_xor_sync(FULL, st.u, off);
    o.v1 = __shfl_xor_sync(FULL, st.v1, off);
    o.v2 = __shfl_xor_sync(FULL, st.v2, off);
    o.i1 = __shfl_xor_sync(FULL, st.i1, off);
    merge(st, o);
  }
}

// out: margin, entropy, max_logprob (fp32) and top1 (int32), n_rows each
__device__ __forceinline__ void finish(const State& st, float* out,
                                       int n_rows, int row) {
  const float s = fmaxf(st.s, 1e-30f);
  const float lse = st.m + logf(s);
  out[row] = st.v1 - st.v2;
  out[n_rows + row] = lse - st.u / s;
  out[2 * n_rows + row] = st.v1 - lse;
  reinterpret_cast<int*>(out)[3 * n_rows + row] = st.i1;
}

// The scratch after the outputs: field f of (row, slice) at
// part[(f * n_rows + row) * ns + slice], i1 stored as its bits.
__device__ __forceinline__ void put_state(float* part, const State& st,
                                          int n_rows, int ns, int row,
                                          int slice) {
  const size_t at = (size_t)row * ns + slice, step = (size_t)n_rows * ns;
  part[at] = st.m;
  part[at + step] = st.s;
  part[at + 2 * step] = st.u;
  part[at + 3 * step] = st.v1;
  part[at + 4 * step] = st.v2;
  part[at + 5 * step] = __int_as_float(st.i1);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
margin_head_slice_kernel(const T* __restrict__ h, const T* __restrict__ w,
                         float* __restrict__ out, int n_rows, int D, int V,
                         int ns) {
  // (DC, R) transposed hidden during the D walk, then the (WARPS, R, SC)
  // partial logits
  __shared__ __align__(16) float smem[WARPS * R * SC];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * R;
  const int slice = blockIdx.y, v0 = slice * SC;
  // this lane's columns: 4 neighbours (VEC) or lane + 32 j
  const int c0 = VEC ? v0 + lane * 4 : v0 + lane;
  const bool vec_ok = VEC && c0 < V;   // V % 4 == 0: the 4 stand together

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    const int dcp = (dc + U - 1) / U * U;   // what the warp steps read
    __syncthreads();  // the previous chunk consumed
    for (int i = tid; i < R * dcp; i += THREADS) {
      const int r = i / dcp, d = i % dcp;
      smem[d * R + r] = (row0 + r < n_rows && d < dc)
                            ? to_f32(h[(size_t)(row0 + r) * D + d0 + d])
                            : 0.0f;
    }
    __syncthreads();
    for (int dd = warp * U; dd < dc; dd += WARPS * U) {
      float4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* src = w + (size_t)(d0 + dd + u) * V + c0;
        wv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (dd + u < dc) {
          if (VEC) {
            if (vec_ok) wv[u] = load4(src);
          } else {
            if (c0 < V) wv[u].x = to_f32(src[0]);
            if (c0 + 32 < V) wv[u].y = to_f32(src[32]);
            if (c0 + 64 < V) wv[u].z = to_f32(src[64]);
            if (c0 + 96 < V) wv[u].w = to_f32(src[96]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* hr = reinterpret_cast<const float4*>(&smem[(dd + u) * R]);
        const float4 ha = hr[0], hb = hr[1];
        const float hv[R] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const float wj[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(hv[r], wj[j], acc[r][j]);
      }
    }
  }

  // the warps' partial logits, summed in warp order
  __syncthreads();  // hidden consumed
  float* red = smem;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = red + (warp * R + r) * SC;
    if (VEC) {
      *reinterpret_cast<float4*>(dst + lane * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[lane + 32 * j] = acc[r][j];
    }
  }
  __syncthreads();

  const int r = warp, row = row0 + r;   // one warp per row
  float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const float4 p =
        *reinterpret_cast<const float4*>(&red[(k * R + r) * SC + lane * 4]);
    x[0] += p.x;
    x[1] += p.y;
    x[2] += p.z;
    x[3] += p.w;
  }
  State st = empty_state();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = v0 + lane * 4 + j;
    if (col < V) push(st, x[j], col);
  }
  merge_lanes(st);
  if (lane == 0 && row < n_rows) {
    if (ns == 1)
      finish(st, out, n_rows, row);
    else
      put_state(out + 4 * (size_t)n_rows, st, n_rows, ns, row, slice);
  }
}

__global__ void __launch_bounds__(THREADS)
margin_head_merge_kernel(float* __restrict__ out, int n_rows, int ns) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n_rows) return;  // the whole warp
  const float* part = out + 4 * (size_t)n_rows;
  const size_t step = (size_t)n_rows * ns;
  const int per = (ns + 31) / 32;
  const int lo = min(lane * per, ns), hi = min(lo + per, ns);
  State st = empty_state();
  for (int s = lo; s < hi; ++s) {
    const size_t at = (size_t)row * ns + s;
    const State b{part[at], part[at + step], part[at + 2 * step],
                  part[at + 3 * step], part[at + 4 * step],
                  __float_as_int(part[at + 5 * step])};
    merge(st, b);
  }
  merge_lanes(st);
  if (lane == 0) finish(st, out, n_rows, row);
}

template <typename T>
int launch(const void* h, const void* w, void* out, int n_rows, int D, int V,
           void* stream) {
  const int ns = (V + SC - 1) / SC;
  const dim3 grid((n_rows + R - 1) / R, ns);
  const cudaStream_t s = (cudaStream_t)stream;
  // 4 neighbouring columns per vector load: V a multiple of 4 and W
  // aligned to 4 elements
  const bool vec = V % 4 == 0 && (uintptr_t)w % (4 * sizeof(T)) == 0;
  if (vec)
    margin_head_slice_kernel<T, true><<<grid, THREADS, 0, s>>>(
        (const T*)h, (const T*)w, (float*)out, n_rows, D, V, ns);
  else
    margin_head_slice_kernel<T, false><<<grid, THREADS, 0, s>>>(
        (const T*)h, (const T*)w, (float*)out, n_rows, D, V, ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ns == 1) return (int)err;
  margin_head_merge_kernel<<<(n_rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      (float*)out, n_rows, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// the columns of a slice: out holds 4 * n_rows values (margin, entropy,
// max_logprob fp32, top1 int32), then, when V spans more than one slice, a
// scratch of 6 * n_rows * ceil(V / slice) floats
extern "C" int margin_head_slice_cols() { return SC; }

extern "C" int margin_head_f32(const void* h, const void* w, void* out,
                               int n_rows, int D, int V, void* stream) {
  return launch<float>(h, w, out, n_rows, D, V, stream);
}

extern "C" int margin_head_bf16(const void* h, const void* w, void* out,
                                int n_rows, int D, int V, void* stream) {
  return launch<__nv_bfloat16>(h, w, out, n_rows, D, V, stream);
}
