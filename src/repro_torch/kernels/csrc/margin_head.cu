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
// the launch itself is the cost.  For a large V the product makes it
// compute-bound.
//
// Design.  The TPU grid carries the online state across a sequential V
// axis; here one warp owns one row and walks V inside the block.  The
// block stages its ROWS rows of `hidden` and a (D, BV) tile of W in shared
// memory (fp32, converted on load from bf16 when the inputs are bf16).
// Each lane takes the columns lane, lane + 32, ... of each tile in
// increasing order, computes the logit with fp32 FMAs in a fixed order
// (d = 0 .. D-1; no tensor cores, so no TF32), and folds it into its own
// online state (m, s, u, v1, v2, i1) with a strict `>`, which keeps the
// first index.  Warp shuffles then merge the 32 lane states; on equal v1
// the smaller index wins, the first-occurrence rule of the TPU kernel.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;            // warps per block, one row each
constexpr int BV = 64;             // W columns staged per tile
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
  extern __shared__ float smem[];
  float* hs = smem;              // (ROWS, D)
  float* ws = smem + ROWS * D;   // (D, BV)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + warp;

  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = row0 + i / D;
    hs[i] = r < n_rows ? to_f32(h[(size_t)r * D + i % D]) : 0.0f;
  }
  State st{NEG_INF, 0.0f, 0.0f, NEG_INF, NEG_INF, INT_MAX};
  const float* hrow = hs + warp * D;

  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // hs staged / the previous W tile consumed
    for (int i = threadIdx.x; i < D * BV; i += THREADS) {
      const int d = i / BV, col = v0 + i % BV;
      ws[i] = col < V ? to_f32(w[(size_t)d * V + col]) : 0.0f;
    }
    __syncthreads();
    for (int j = lane; j < BV && v0 + j < V; j += 32) {
      float x = 0.0f;
      for (int d = 0; d < D; ++d) x = fmaf(hrow[d], ws[d * BV + j], x);
      push(st, x, v0 + j);
    }
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
  const size_t smem = sizeof(float) * (size_t)(ROWS + BV) * D;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        margin_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  margin_head_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
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

// The largest D the kernel takes: (ROWS + BV) * D fp32 values of shared
// memory must fit the 227 KB a block can use.
extern "C" int margin_head_max_d() {
  return (227 * 1024) / (int)(sizeof(float) * (ROWS + BV));
}
