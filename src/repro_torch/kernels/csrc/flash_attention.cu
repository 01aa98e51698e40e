// Flash attention (causal and/or sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_kernel`): for q (B, H, Tq, hd) and k, v
// (B, Hk, Tk, hd) with H % Hk == 0 it returns softmax(q k^T * scale) v per
// (b, h), query head h reading kv head h / (H / Hk), with the TPU kernel's
// masks and arithmetic: q * scale rounded to the input dtype, scores and the
// online-softmax state (m, l, o) in fp32, a masked score is -1e30 (not
// -inf), p rounded to v's dtype before the PV product, l clamped at 1e-30,
// the output in q's dtype.  `window` applies with or without `causal`, as
// in the TPU kernel.  The (Tq, Tk) scores never reach device memory.
//
// What bounds it: it reads q, k, v once and writes o once, and does about
// 4 * hd flops per visible (query, key) pair.  On zamba2-2.7b's serving path
// (B 8, H 32, T 2048, hd 80, causal, bf16) that is 336 MB against 0.17
// TFLOP: the operations bound it (0.17 ms at the bf16 tensor-core peak,
// against 0.10 ms for the bytes).
//
// Design.  The TPU grid carries (m, l, o) across a sequential Tk axis; here
// one block owns 64 query rows of one (b, h), one thread per row, and walks
// the key tiles inside the block.  Each thread keeps its scaled query row
// and its fp32 output row in registers (the head dim is a template
// parameter, so both are register arrays).  A tile of BK keys and values is
// staged in shared memory in fp32; every thread reads the same key at the
// same time, so the reads are broadcasts, four floats at a time.  Keys are
// folded into the online softmax eight at a time.  Tiles that the causal or
// window mask hides from every row of the block are never loaded, which
// halves the causal work.  This is a simple kernel: fp32 FMAs on the CUDA
// cores, no tensor cores, so it runs far above the tensor-core bound.
//
// A row with no visible key at all (possible only with a window and no
// causal mask) is not defined alike by the two reference functions: each
// averages the values of the masked keys it happens to visit, as this
// kernel does over the tiles it visits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 64;  // keys per staged tile: 40 KB of fp32 K and V at hd 80
constexpr int KS = 8;   // keys folded into the softmax at a time
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and read back: the reference does this arithmetic in the
// input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {  // in elements; hd has stride 1
  long long b, h, t;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so, int H,
                       int Hk, int Tq, int Tk, float scale, int causal,
                       int window) {
  __shared__ __align__(16) float ks[BK * HD];
  __shared__ __align__(16) float vs[BK * HD];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + threadIdx.x;
  const bool q_ok = qi < Tq;

  float qr[HD], acc[HD];
  const T* qrow = q + b * sq.b + h * sq.h + (long long)qi * sq.t;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = q_ok ? round_to<T>(to_f32(qrow[d]) * scale) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  // the keys some row of this block can see
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int t0 = k_lo; t0 < k_hi; t0 += BK) {
    const int nk = min(BK, k_hi - t0);
    __syncthreads();  // the previous tile consumed
    for (int i = threadIdx.x; i < BK * HD; i += BQ) {
      const int j = i / HD, d = i % HD;
      const bool ok = j < nk;
      ks[i] = ok ? to_f32(kb[(long long)(t0 + j) * sk.t + d]) : 0.0f;
      vs[i] = ok ? to_f32(vb[(long long)(t0 + j) * sv.t + d]) : 0.0f;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += KS) {
      float s[KS];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        const int j = j0 + jj, kp = t0 + j;
        const float* kr = ks + j * HD;
        float x = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          x = fmaf(qr[d], k4.x, x);
          x = fmaf(qr[d + 1], k4.y, x);
          x = fmaf(qr[d + 2], k4.z, x);
          x = fmaf(qr[d + 3], k4.w, x);
        }
        bool vis = j < nk && q_ok;
        if (causal) vis = vis && qi >= kp;
        if (window > 0) vis = vis && (qi - kp) < window;
        s[jj] = vis ? x : NEG_INF;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        s[jj] = expf(s[jj] - mx);
        psum += s[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        const float p = round_to<T>(s[jj]);
        const float* vr = vs + (j0 + jj) * HD;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, v4.x, acc[d]);
          acc[d + 1] = fmaf(p, v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, v4.w, acc[d + 3]);
        }
      }
      m = mx;
    }
  }

  if (q_ok) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
              int Hk, int Tq, int Tk, float scale, int causal, int window,
              cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, H, Hk,
      Tq, Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int Hk, int Tq, int Tk, int hd,
           float scale, int causal, int window, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(HD)                                                       \
  case HD:                                                                \
    return launch_hd<T, HD>(q, k, v, o, sq, sk, sv, so, B, H, Hk, Tq, Tk, \
                            scale, causal, window, s);
  switch (hd) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(80)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v and o in that order
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int Hk, int Tq, int Tk, int hd, float scale,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, strides, B, H, Hk, Tq, Tk, hd, scale,
                       causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int B, int H,
                                    int Hk, int Tq, int Tk, int hd,
                                    float scale, int causal, int window,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, B, H, Hk, Tq, Tk, hd,
                               scale, causal, window, stream);
}
