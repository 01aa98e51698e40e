// Tiled pairwise squared euclidean distances, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pairwise_sqdist` (src/repro/kernels/
// pairwise_dist.py, body `_kernel`): for x (N, D) and c (M, D) it writes
// the (N, M) fp32 matrix max(||x||^2 - 2 x.c + ||c||^2, 0), the same
// expansion and clamp, so it agrees exactly with the plain version on
// integer-valued inputs.  Only the true (N, M) is written, so no padded
// column is ever observed.
//
// What bounds it: 2*N*M*D flops against 4*(N*D + M*D + N*M) bytes.  On the
// k-center anchor path (N = 65,536, M >= 512, D = 64) the flops take about
// 1.4x as long as the bytes at the card's fp32 (non-tensor-core) rate, so
// it is bound by operations; the output write is most of the bytes.
//
// Design.  A 2-D grid of 64 x 64 output tiles, 256 threads each; a thread
// owns a 4 x 4 block of outputs.  The block walks D in chunks of 16,
// staging the x- and c-tile chunks transposed in shared memory ((k, row)
// layout: conflict-free stores, float4 reads), and accumulates the dot
// products with fp32 FMAs in increasing k (no tensor cores, so no TF32).
// The row and column squared norms are summed from the same staged chunks
// by threads 0-63 and 64-127, so x and c are read from device memory once
// per tile.  Each thread's 4 adjacent columns go out as one float4 store
// where the row allows it.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // x rows per tile
constexpr int BN = 64;   // c rows (output columns) per tile
constexpr int BK = 16;   // D chunk
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pairwise_sqdist_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       float* __restrict__ out, int N, int M, int D) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float cs[BK][BN];
  __shared__ float x2s[BM];
  __shared__ float c2s[BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  float acc[4][4] = {};
  float norm = 0.0f;  // threads 0-63: ||x_row||^2; 64-127: ||c_col||^2
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int r = i % BM, k = i / BM;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < N && gk < D) ? x[(size_t)gr * D + gk] : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i % BN, k = i / BN;
      const int gr = col0 + r, gk = k0 + k;
      cs[k][r] = (gr < M && gk < D) ? c[(size_t)gr * D + gk] : 0.0f;
    }
    __syncthreads();
    if (tid < BM) {
      for (int k = 0; k < BK; ++k) norm = fmaf(xs[k][tid], xs[k][tid], norm);
    } else if (tid < BM + BN) {
      const int r = tid - BM;
      for (int k = 0; k < BK; ++k) norm = fmaf(cs[k][r], cs[k][r], norm);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) {
    x2s[tid] = norm;
  } else if (tid < BM + BN) {
    c2s[tid - BM] = norm;
  }
  __syncthreads();

  const int cbase = col0 + tx * 4;
  const bool vec = (M % 4 == 0) && (cbase + 3 < M);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= N) break;
    const float x2 = x2s[ty * 4 + i];
    float d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = fmaxf(x2 - 2.0f * acc[i][j] + c2s[tx * 4 + j], 0.0f);
    float* dst = out + (size_t)r * M + cbase;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
      for (int j = 0; j < 4 && cbase + j < M; ++j) dst[j] = d[j];
    }
  }
}

}  // namespace

extern "C" int pairwise_sqdist_f32(const void* x, const void* c, void* out,
                                   int N, int M, int D, void* stream) {
  const dim3 grid((N + BM - 1) / BM, (M + BN - 1) / BN);
  pairwise_sqdist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (float*)out, N, M, D);
  return (int)cudaGetLastError();
}
