// Pairwise squared euclidean distances on tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `pairwise_sqdist` (src/repro/kernels/
// pairwise_dist.py, body `_kernel`): for x (N, D) and c (M, D) it writes
// the (N, M) fp32 matrix max(||x||^2 - 2 x.c + ||c||^2, 0), the same
// expansion and clamp.  Only the true (N, M) is written, so no padded
// column is ever observed.
//
// What bounds it: it reads 4 (N + M) D bytes and writes 4 N M, and x.c is
// 2 N M D flops.  On the k-center anchor path (N = 65,536, M = 2,048,
// D = 64) the bytes take 0.160 ms at 3.35 TB/s, most of them the 537 MB
// output; the six bf16 products below take 0.104 ms at the tensor-core
// peak, and fp32 FMAs alone would take 0.26 ms.  So the design puts the
// product on the tensor cores and makes the output write the work.
//
// Design.  A 2-D grid of 128 x 128 output tiles (column tiles fastest, so
// the blocks that share an x tile run together and read it from L2), 8
// warps of 32 x 64 outputs, two blocks an SM.  The block stages its x and
// c tiles, D in chunks of 64 (zero past D, so K is padded to a multiple of
// 16), and splits each fp32 element once, while staging, into three bf16
// parts in shared memory: hi = bf16(v), mid = bf16(v - hi) and
// lo = bf16(v - hi - mid), whose 3 x 8 significant bits hold all of fp32's
// 24 (both remainders are exact in fp32); the same pass sums the fp32
// squared norms (each row's 4-element pieces with FMAs, then its 16 pieces
// in a fixed shuffle tree, then the chunks in order).  x.c accumulates in
// fp32 through `mma.sync.m16n8k16` bf16 (`csrc/mma.cuh`, fragments by
// `ldmatrix`) as the six products whose parts' orders sum to at most 2:
// hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi.  Each is exact in
// fp32; the dropped mid.lo, lo.mid and lo.lo are below 2^-25 relative.
// Each k step sums the five corrections, smallest first, into a fresh
// fragment, hi.hi into the running sum, and then adds the corrections to
// it once, in fp32 on the CUDA cores: accumulated straight into the
// running sum, the corrections lost to the tensor cores' fp32 adds (which
// do not round to nearest) and the distances came out at 2-3.5x the
// plain version's error against float64; this way they are within 1.4x
// of it, and a second accumulator set (1.0x) would cost 222 registers and
// one block an SM.  Integers up to 256 are exact in hi with mid = lo = 0, and
// their products and sums stay exact in fp32 below 2^24, so
// integer-valued inputs agree exactly with the plain version.  The
// epilogue forms max(x2 - 2 g + c2, 0) from the fragments into a per-warp
// tile in shared memory (over the consumed operands), and writes it back
// as 16-byte streaming stores, a warp covering two full 256-byte output
// row pieces per instruction.  A block's staging, products and stores run
// one after another, and two blocks an SM (2 x 111.6 KB of shared memory)
// overlap them only in part: on the card the staging and the six products
// take longer than the write (PERF.md).  No atomics: the result is the
// same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 128;          // x rows per tile
constexpr int BN = 128;          // c rows (output columns) per tile
constexpr int KC = 64;           // D values staged per chunk
constexpr int KS = KC + 8;       // bf16 row stride: ldmatrix rows 16 B over
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WM = 32, WN = 64;  // a warp's outputs: 4 x 2 warps
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int OS = WN + 8;       // fp32 row stride of the epilogue tile
constexpr int GROUPS = BM * KC / 4 / THREADS;  // 4-float pieces a thread
constexpr int BATCH = 4;   // pieces a thread holds at once
static_assert(GROUPS % BATCH == 0, "whole batches");
constexpr int PARTS = 3;         // hi, mid, lo
constexpr size_t OPERAND_BYTES =
    PARTS * (BM + BN) * KS * sizeof(__nv_bfloat16);
constexpr size_t SMEM_BYTES = OPERAND_BYTES + (BM + BN) * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;
static_assert(BM == BN, "x and c tiles are staged alike");
static_assert(WARPS * WM * OS * sizeof(float) <= OPERAND_BYTES,
              "the epilogue tiles fit over the operands");

// rows row0.. of src (n_rows x D), D values from k0: pieces j0.. of the
// 4-float pieces this thread stages, zero past n_rows and D
template <bool VEC>
__device__ __forceinline__ void fetch(float4 (&v)[BATCH], const float* src,
                                      int n_rows, int row0, int D, int k0,
                                      int j0) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const int i = threadIdx.x + (j0 + j) * THREADS;
    const int r = row0 + i / (KC / 4), k = k0 + (i % (KC / 4)) * 4;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= n_rows) continue;
    const float* p = src + (size_t)r * D + k;
    if (VEC) {
      if (k < D) v[j] = *reinterpret_cast<const float4*>(p);
    } else {
      if (k < D) v[j].x = p[0];
      if (k + 1 < D) v[j].y = p[1];
      if (k + 2 < D) v[j].z = p[2];
      if (k + 3 < D) v[j].w = p[3];
    }
  }
}

// v's four values as bf16 part rows (two 32-bit pairs), and v minus them
__device__ __forceinline__ uint2 split(float4& v) {
  const __nv_bfloat162 p01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 p23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(p01), f23 = __bfloat1622float2(p23);
  v = make_float4(v.x - f01.x, v.y - f01.y, v.z - f23.x, v.w - f23.y);
  return make_uint2(bits(p01), bits(p23));
}

// the fetched pieces split into bf16 hi, mid and lo rows of the tile (part
// p at part + p * part_stride), and each row's squared norm added to
// norm[row]
__device__ __forceinline__ void stage(const float4 (&v)[BATCH],
                                      __nv_bfloat16* part, int part_stride,
                                      float* norm, int j0) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const int i = threadIdx.x + (j0 + j) * THREADS;
    const int r = i / (KC / 4), q = i % (KC / 4);
    float4 a = v[j];
    // the row's 16 pieces lie in 16 neighbouring lanes
    float n = a.x * a.x;
    n = fmaf(a.y, a.y, n);
    n = fmaf(a.z, a.z, n);
    n = fmaf(a.w, a.w, n);
    for (int off = 8; off > 0; off >>= 1) n += __shfl_xor_sync(FULL, n, off);
    if (q == 0) norm[r] += n;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      *reinterpret_cast<uint2*>(part + p * part_stride + r * KS + q * 4) =
          split(a);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_sqdist_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       float* __restrict__ out, int N, int M, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  // x's hi, mid and lo tiles, then c's
  constexpr int XP = BM * KS, CP = BN * KS;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cs = xs + PARTS * XP;
  float* x2s = reinterpret_cast<float*>(smem + OPERAND_BYTES);
  float* c2s = x2s + BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int wr = warp / 2, wc = warp % 2;   // the warp's 32 rows, 64 cols

  if (tid < BM) x2s[tid] = 0.f;
  else c2s[tid - BM] = 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous chunk consumed
    // BATCH pieces of each operand at a time, their loads issued
    // together: the accumulators hold 64 registers
#pragma unroll
    for (int j0 = 0; j0 < GROUPS; j0 += BATCH) {
      float4 xv[BATCH], cv[BATCH];
      fetch<VEC>(xv, x, N, row0, D, k0, j0);
      fetch<VEC>(cv, c, M, col0, D, k0, j0);
      stage(xv, xs, XP, x2s, j0);
      stage(cv, cs, CP, c2s, j0);
    }
    __syncthreads();
    const int ksteps = (min(KC, D - k0) + 15) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t ah[MT][4], am[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = (wr * WM + mt * 16 + lane % 16) * KS + ks * 16 +
                        (lane / 16) * 8;
        ldsm_x4(ah[mt], xs + off);
        ldsm_x4(am[mt], xs + XP + off);
        ldsm_x4(al[mt], xs + 2 * XP + off);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // n tiles 2 np and 2 np + 1, k halves 0-7 and 8-15
        const int off = (wc * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3))
                            * KS + ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bm[4], bl[4];
        ldsm_x4(bh, cs + off);
        ldsm_x4(bm, cs + CP + off);
        ldsm_x4(bl, cs + 2 * CP + off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // the five corrections, smallest first, into a fresh sum t;
            // hi.hi into the running sum, then t added once in fp32
            const uint32_t h0 = bh[2 * h], h1 = bh[2 * h + 1];
            const uint32_t m0 = bm[2 * h], m1 = bm[2 * h + 1];
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, am[mt], m0, m1);
            mma_bf16(t, ah[mt], bl[2 * h], bl[2 * h + 1]);
            mma_bf16(t, al[mt], h0, h1);
            mma_bf16(t, ah[mt], m0, m1);
            mma_bf16(t, am[mt], h0, h1);
            float (&a)[4] = acc[mt][2 * np + h];
            mma_bf16(a, ah[mt], h0, h1);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += t[e];
          }
        }
      }
    }
  }

  // epilogue: the warp's (32, 64) distances into its own tile over the
  // consumed operands, then out as 16-byte row pieces
  __syncthreads();
  float* o = reinterpret_cast<float*>(smem) + warp * WM * OS;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = mt * 16 + g;
    const float xa = x2s[wr * WM + r], xb = x2s[wr * WM + r + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int cc = nt * 8 + 2 * t;
      const float c0 = c2s[wc * WN + cc], c1 = c2s[wc * WN + cc + 1];
      const float* a = acc[mt][nt];
      *reinterpret_cast<float2*>(&o[r * OS + cc]) =
          make_float2(fmaxf(xa - 2.0f * a[0] + c0, 0.f),
                      fmaxf(xa - 2.0f * a[1] + c1, 0.f));
      *reinterpret_cast<float2*>(&o[(r + 8) * OS + cc]) =
          make_float2(fmaxf(xb - 2.0f * a[2] + c0, 0.f),
                      fmaxf(xb - 2.0f * a[3] + c1, 0.f));
    }
  }
  __syncwarp();
  const bool vec_out = M % 4 == 0;
#pragma unroll 4
  for (int i = 0; i < WM; i += 2) {
    const int r = i + lane / 16, cc = (lane % 16) * 4;
    const int gr = row0 + wr * WM + r, gc = col0 + wc * WN + cc;
    if (gr >= N || gc >= M) continue;
    const float4 v = *reinterpret_cast<const float4*>(&o[r * OS + cc]);
    float* dst = out + (size_t)gr * M + gc;
    if (vec_out && gc + 3 < M) {
      __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      dst[0] = v.x;
      if (gc + 1 < M) dst[1] = v.y;
      if (gc + 2 < M) dst[2] = v.z;
      if (gc + 3 < M) dst[3] = v.w;
    }
  }
}

template <bool VEC>
int launch(const float* x, const float* c, float* out, int N, int M, int D,
           cudaStream_t stream) {
  // the attribute is per kernel and per device: set once on each device
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(pairwise_sqdist_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const dim3 grid((M + BN - 1) / BN, (N + BM - 1) / BM);
  pairwise_sqdist_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, c, out, N, M, D);
  return (int)cudaGetLastError();
}

}  // namespace

// out must be 16-byte aligned (as a fresh allocation is)
extern "C" int pairwise_sqdist_f32(const void* x, const void* c, void* out,
                                   int N, int M, int D, void* stream) {
  // 16-byte row pieces: D a multiple of 4 and both inputs aligned
  const bool vec = D % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)c % 16 == 0;
  return vec ? launch<true>((const float*)x, (const float*)c, (float*)out, N,
                            M, D, (cudaStream_t)stream)
             : launch<false>((const float*)x, (const float*)c, (float*)out,
                             N, M, D, (cudaStream_t)stream);
}
