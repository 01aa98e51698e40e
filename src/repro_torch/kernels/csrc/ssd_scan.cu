// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py, body
// `_kernel`).  For xh (B, T, H, hd), dt (B, T, H), A (H,), Bm and Cm
// (B, T, N) and a chunk length C it returns y (B, T, H, hd) in xh's dtype
// and the final state h (B, H, hd, N) in fp32.  Per chunk, with
// l_t = cumsum_t(-dt_t * A) and xd_t = x_t * dt_t:
//   y_t = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) xd_s + exp(l_t) C_t . h
//   h  <- exp(l_last) h + sum_s exp(l_last - l_s) xd_s (x) B_s
// with the lower triangle masked before the exp, all in fp32, as the TPU
// kernel does.  T is padded to a chunk multiple with dt = 0 (and x, B,
// C = 0) inside the kernel, which is exact: unit decay, no state update.
//
// What bounds it: it reads xh, dt, Bm, Cm once and writes y and h once;
// the work is 2 C^2 N flops per (batch, chunk) for C.B^T and C^2 hd +
// 4 C hd N per (batch, chunk, head).  On zamba2-2.7b's serving path (B 8,
// T 2048, H 80, hd 64, N 64, C 128, xh bf16) that is 0.36 GB against 0.03
// TFLOP: the bytes bound it (0.11 ms, against 0.03 ms at the bf16
// tensor-core peak).
//
// Design.  The TPU grid runs the chunks of a batch row in order and keeps
// the state in VMEM scratch; here one block owns one (batch, head) and
// loops over the chunks itself, so the (hd, N) state stays in shared memory
// for the whole sequence.  Per chunk the block stages B, C (rows padded to
// N + 1 floats, so threads reading consecutive rows hit distinct banks),
// xd and the cumulative log decay; a warp scan builds the cumsum.  The
// (C, C) intra-chunk weight matrix C.B^T * exp(l_t - l_s) does not fit
// beside the rest for C = 128, N = 128 (about 256 KB with everything at
// once), so it is built TT rows at a time and consumed at once: shared
// memory stays at (2 C (N + 1) + C hd + TT C + hd (N + 1) + 2 C) floats,
// 130 KB for zamba2 and 210 KB at the test grid's largest case.  The
// state update follows the chunk's output, each thread owning a slice of
// the state.  fp32 FMAs on the CUDA cores; C.B^T is recomputed per head
// (B and C are shared across heads), which a faster kernel would share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TT = 32;  // rows of the intra-chunk weight matrix at a time
constexpr unsigned FULL = 0xffffffffu;

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

size_t smem_floats(int C, int N, int hd) {
  return (size_t)2 * C * (N + 1) + (size_t)C * hd + (size_t)TT * C +
         (size_t)hd * (N + 1) + 2 * (size_t)C;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ hfin, int T_len, int H, int hd, int N,
                int C) {
  extern __shared__ float sm[];
  const int NP = N + 1;
  float* Bs = sm;              // (C, NP)   B rows of the chunk
  float* Cs = Bs + C * NP;     // (C, NP)   C rows of the chunk
  float* xd = Cs + C * NP;     // (C, hd)   x * dt
  float* G = xd + C * hd;      // (TT, C)   intra-chunk weights of TT rows
  float* hs = G + TT * C;      // (hd, NP)  the state h[d][n]
  float* cum = hs + hd * NP;   // (C,)      inclusive cumsum of -dt * A
  float* dts = cum + C;        // (C,)      dt, then exp(l_last - l_s)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];
  for (int i = tid; i < hd * NP; i += THREADS) hs[i] = 0.0f;
  const int nc = (T_len + C - 1) / C;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    __syncthreads();  // the previous chunk consumed
    for (int i = tid; i < C; i += THREADS) {
      const int t = t0 + i;
      dts[i] = t < T_len ? dt[((size_t)b * T_len + t) * H + h] : 0.0f;
    }
    for (int i = tid; i < C * N; i += THREADS) {
      const int s = i / N, n = i % N, t = t0 + s;
      const bool ok = t < T_len;
      const size_t g = ((size_t)b * T_len + t) * N + n;
      Bs[s * NP + n] = ok ? Bm[g] : 0.0f;
      Cs[s * NP + n] = ok ? Cm[g] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < C * hd; i += THREADS) {
      const int s = i / hd, d = i % hd, t = t0 + s;
      xd[i] = t < T_len
                  ? to_f32(xh[(((size_t)b * T_len + t) * H + h) * hd + d]) *
                        dts[s]
                  : 0.0f;
    }
    if (tid < 32) {  // cum = inclusive cumsum of -dt * A: a warp scan
      const int per = (C + 31) / 32, s0 = tid * per, s1 = min(s0 + per, C);
      float own = 0.0f;
      for (int s = s0; s < s1; ++s) own += -(dts[s] * a);
      float inc = own;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(FULL, inc, off);
        if (tid >= off) inc += up;
      }
      float run = inc - own;
      for (int s = s0; s < s1; ++s) {
        run += -(dts[s] * a);
        cum[s] = run;
      }
    }
    __syncthreads();

    for (int r0 = 0; r0 < C; r0 += TT) {
      // G[tt][s] = (C_t . B_s) exp(l_t - l_s) for s <= t, else 0
      for (int i = tid; i < TT * C; i += THREADS) {
        const int tt = i / C, s = i % C, t = r0 + tt;
        float g = 0.0f;
        if (t < C && s <= t) {
          float dot = 0.0f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(Cs[t * NP + n], Bs[s * NP + n], dot);
          g = dot * expf(cum[t] - cum[s]);
        }
        G[i] = g;
      }
      __syncthreads();
      // y_t = sum_{s<=t} G[t][s] xd_s + exp(l_t) C_t . h
      for (int i = tid; i < TT * hd; i += THREADS) {
        const int tt = i / hd, d = i % hd, t = r0 + tt;
        if (t >= C) continue;
        float yi = 0.0f;
        for (int s = 0; s <= t; ++s) yi = fmaf(G[tt * C + s], xd[s * hd + d], yi);
        float yo = 0.0f;
        for (int n = 0; n < N; ++n)
          yo = fmaf(Cs[t * NP + n], hs[d * NP + n], yo);
        const int tg = t0 + t;
        if (tg < T_len)
          y[(((size_t)b * T_len + tg) * H + h) * hd + d] =
              from_f32<T>(yi + yo * expf(cum[t]));
      }
      __syncthreads();
    }

    // h <- exp(l_last) h + sum_s exp(l_last - l_s) xd_s (x) B_s
    const float last = cum[C - 1];
    for (int i = tid; i < C; i += THREADS) dts[i] = expf(last - cum[i]);
    __syncthreads();
    const float gamma = expf(last);
    for (int i = tid; i < hd * N; i += THREADS) {
      const int d = i / N, n = i % N;
      float acc = 0.0f;
      for (int s = 0; s < C; ++s)
        acc = fmaf(xd[s * hd + d] * dts[s], Bs[s * NP + n], acc);
      hs[d * NP + n] = gamma * hs[d * NP + n] + acc;
    }
  }

  __syncthreads();
  for (int i = tid; i < hd * N; i += THREADS) {
    const int d = i / N, n = i % N;
    hfin[(((size_t)b * H + h) * hd + d) * N + n] = hs[d * NP + n];
  }
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hfin, int B, int T_len, int H,
           int hd, int N, int C, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(C, N, hd);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)xh, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (T*)y, (float*)hfin, T_len, H, hd, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_f32(const void* xh, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* hfin, int B, int T, int H, int hd, int N,
                            int C, void* stream) {
  return launch<float>(xh, dt, A, Bm, Cm, y, hfin, B, T, H, hd, N, C, stream);
}

extern "C" int ssd_scan_bf16(const void* xh, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* hfin, int B, int T, int H, int hd, int N,
                             int C, void* stream) {
  return launch<__nv_bfloat16>(xh, dt, A, Bm, Cm, y, hfin, B, T, H, hd, N, C,
                               stream);
}
