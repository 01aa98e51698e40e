// Fused head projection + per-row scoring statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel `margin_head` (src/repro/kernels/margin_head.py,
// body `_kernel`): for hidden (T, D) and W (D, V) it emits, per row,
// margin = v1 - v2, entropy = lse - sum(x e^x)/sum(e^x), max_logprob =
// v1 - lse and top1 = argmax (the first index among equal maxima), without
// ever writing the (T, V) logits to device memory.
//
// What bounds it: it reads T*D + D*V inputs and writes 4*T outputs, and
// does 2*T*D*V flops.  On the main path (T = 2048, D = 64, V = 10) that is
// well under a microsecond of either bytes or operations on an H100, so
// the launch itself is the cost.  On the LM scoring path (T = 8 requests,
// D = 2560, V = 32000, fp32) the bound is reading W, 328 MB, about 0.1 ms;
// but 8 rows make one block, so one SM streams all of W and the kernel runs
// far above its bound.  Splitting V across blocks is left to a later
// change.
//
// Design.  The TPU grid carries the online state across a sequential V
// axis; here one warp owns one row and walks V inside the block, one tile
// of BV columns at a time.  Any D is taken: within a tile the block walks D
// in chunks of DC, staging the (ROWS, DC) slice of `hidden` and the (DC, BV)
// slice of W in shared memory (fp32, converted on load from bf16 when the
// inputs are bf16), so shared memory stays at (ROWS + BV) * DC floats
// whatever D is.  Each lane owns the columns lane and lane + 32 of a tile
// and keeps their partial logits in registers across the D chunks, adding
// with fp32 FMAs in a fixed order (d = 0 .. D-1; no tensor cores, so no
// TF32).  At the end of the tile it folds them, in increasing column
// order, into its own online state (m, s, u, v1, v2, i1) with a strict `>`,
// which keeps the first index.  Warp shuffles then merge the 32 lane
// states; on equal v1 the smaller index wins, the first-occurrence rule of
// the TPU kernel.  `hidden` is read again for every tile; it is small
// (ROWS * D per block) and stays in L2.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;            // warps per block, one row each
constexpr int BV = 64;             // W columns per tile, two per lane
constexpr int DC = 128;            // D values staged per chunk
constexpr int THREADS = ROWS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct State {
  float m, s, u, v1, v2;
  int i1;
};

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

// Merge another lane's state into `a` (commutative: ties go to the
// smaller column index).
__device__ __forceinline__ void merge(State& a, const State& b) {
  const float m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - m), cb = expf(b.m - m);
  a.s = a.s * ca + b.s * cb;
  a.u = a.u * ca + b.u * cb;
  a.m = m;
  const float v2 = fmaxf(fminf(a.v1, b.v1), fmaxf(a.v2, b.v2));
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1)) a.i1 = b.i1;
  a.v1 = fmaxf(a.v1, b.v1);
  a.v2 = v2;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
margin_head_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   float* __restrict__ margin, float* __restrict__ entropy,
                   float* __restrict__ max_logprob, int* __restrict__ top1,
                   int n_rows, int D, int V) {
  __shared__ float hs[ROWS * DC];   // (ROWS, DC) slice of hidden
  __shared__ float ws[DC * BV];     // (DC, BV) slice of W
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + warp;
  State st{NEG_INF, 0.0f, 0.0f, NEG_INF, NEG_INF, INT_MAX};
  const float* hrow = hs + warp * DC;

  for (int v0 = 0; v0 < V; v0 += BV) {
    float acc0 = 0.0f, acc1 = 0.0f;  // logits of columns v0 + lane, + 32
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0);
      __syncthreads();  // the previous chunk consumed
      for (int i = threadIdx.x; i < ROWS * DC; i += THREADS) {
        const int r = row0 + i / DC, d = i % DC;
        hs[i] = (r < n_rows && d < dc)
                    ? to_f32(h[(size_t)r * D + d0 + d]) : 0.0f;
      }
      for (int i = threadIdx.x; i < DC * BV; i += THREADS) {
        const int d = i / BV, col = v0 + i % BV;
        ws[i] = (d < dc && col < V) ? to_f32(w[(size_t)(d0 + d) * V + col])
                                    : 0.0f;
      }
      __syncthreads();
      for (int d = 0; d < dc; ++d) {
        const float x = hrow[d];
        acc0 = fmaf(x, ws[d * BV + lane], acc0);
        acc1 = fmaf(x, ws[d * BV + lane + 32], acc1);
      }
    }
    if (v0 + lane < V) push(st, acc0, v0 + lane);
    if (v0 + lane + 32 < V) push(st, acc1, v0 + lane + 32);
  }

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
  if (lane == 0 && row < n_rows) {
    const float s = fmaxf(st.s, 1e-30f);
    const float lse = st.m + logf(s);
    margin[row] = st.v1 - st.v2;
    entropy[row] = lse - st.u / s;
    max_logprob[row] = st.v1 - lse;
    top1[row] = st.i1;
  }
}

template <typename T>
int launch(const void* h, const void* w, void* margin, void* entropy,
           void* max_logprob, void* top1, int n_rows, int D, int V,
           void* stream) {
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  margin_head_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)h, (const T*)w, (float*)margin, (float*)entropy,
      (float*)max_logprob, (int*)top1, n_rows, D, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int margin_head_f32(const void* h, const void* w, void* margin,
                               void* entropy, void* max_logprob, void* top1,
                               int n_rows, int D, int V, void* stream) {
  return launch<float>(h, w, margin, entropy, max_logprob, top1, n_rows, D,
                       V, stream);
}

extern "C" int margin_head_bf16(const void* h, const void* w, void* margin,
                                void* entropy, void* max_logprob, void* top1,
                                int n_rows, int D, int V, void* stream) {
  return launch<__nv_bfloat16>(h, w, margin, entropy, max_logprob, top1,
                               n_rows, D, V, stream);
}
