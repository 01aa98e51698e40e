// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py, body
// `_kernel`).  For xh (B, T, H, hd), dt (B, T, H), A (H,), Bm and Cm
// (B, T, N) and a chunk length C it returns y (B, T, H, hd) in xh's dtype
// and the final state h (B, H, hd, N) in fp32, from an incoming state h0
// (B, H, hd, N) fp32, or zeros (the TPU kernel's only start).  A sequence
// split into chunk-aligned blocks, each started from the last one's final
// state, gives the whole sequence's bits: the walk below is the same
// arithmetic either way.  Per chunk, with
// l_t = cumsum_t(-dt_t * A) and xd_t = x_t * dt_t:
//   y_t = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) xd_s + exp(l_t) C_t . h
//   h  <- exp(l_last) h + sum_s exp(l_last - l_s) xd_s (x) B_s
// with the lower triangle masked before the exp, all sums in fp32, as the
// TPU kernel does.  T is padded to a chunk multiple with dt = 0 (and x, B,
// C = 0) inside the kernel, which is exact: unit decay, no state update.
//
// What bounds it: it reads xh, dt, Bm, Cm once and writes y and h once;
// the work is 2 C^2 N flops per (batch, chunk) for C.B^T and C^2 hd +
// 4 C hd N per (batch, chunk, head).  On zamba2-2.7b's serving path (B 8,
// T 2048, H 80, hd 64, N 64, C 128, xh bf16) that is 0.36 GB against 0.03
// TFLOP: the bytes bound it (0.11 ms, against 0.03 ms at the bf16
// tensor-core peak).  Sums kept in fp32 on the CUDA cores would floor it at
// 32.5 GFLOP / 67 TFLOP/s, about 0.49 ms.
//
// Design: the SSD algorithm's own split, so that no block walks the chunks
// in order.  Three launches on one stream, all named ssd_scan_*:
//   (a) ssd_scan_chunk_kernel, one block per (batch, chunk, group of HG
//       heads): stages B_c once for the group, builds every head's cumsum
//       of -dt A at once (a warp scan per head), and writes each head's
//       chunk summary S_c = sum_s exp(l_last - l_s) xd_s (x) B_s and
//       l_last.
//   (b) ssd_scan_state_kernel, one thread per (batch, head, 4 state
//       elements): walks the nc summaries from h0 (or zeros),
//       h_c = exp(l_last,c) h_{c-1} +
//       S_c, overwriting each summary with the chunk's incoming state
//       h_{c-1}, and writes the final state.
//   (c) ssd_scan_output_kernel, one block per (batch, chunk, group of
//       heads): builds G = C_c B_c^T once for the whole group (B and C are
//       shared across heads), then per head
//       y = exp(l_t) C_t . h_{c-1} + [G exp(l_t - l_s) dt_s]_{s<=t} x,
//       rounded once to xh's dtype.
// That is B * nc * H / HG independent blocks in (a) and (c) in place of
// B * H blocks that each walk nc chunks.  The wrapper allocates the
// summaries/states (B, nc, H, hd, N) and l_last (B, nc, H) in fp32.
//
// The products run on tensor cores (`mma.sync.m16n8k16`, bf16 operands
// from `ldmatrix`, fp32 accumulators) with each fp32 operand split into a
// bf16 hi part and a bf16 lo part (the rounded remainder), about 17
// significant bits together; hi*hi + hi*lo + lo*hi keeps the products to
// about 2^-16 relative, far inside the checks' 2e-3.  bf16 xh is exact in
// bf16, so its products take two mma, and it is copied into shared memory
// as it is (cp.async, double-buffered across heads); fp32 xh is split like
// the rest.  dt is folded into the intra-chunk weights
// G exp(l_t - l_s) dt_s, which are formed in registers as A fragments,
// masked to s <= t before use and never stored; k stops at the tile's last
// row (the causal triangle), and each warp takes a short and a long row
// strip.  The next head's state is prefetched into registers and its x
// copied while this head computes, and the block's first loads are issued
// BATCH at a time, since at one block per SM no other block hides their
// latency.  Shared memory: (a) 112 KB (two blocks per SM) and (c) 170
// KB at zamba2's shape; 218 KB for (c) at the test grid's largest case
// (C 128, N 128, hd 64).  hd must be a multiple of 8 and N of 4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

// float4s of the next head's state a thread prefetches
constexpr int HPF = 2048 / THREADS;
constexpr int OUT_NT = 4;  // n8 tiles a warp's output tile spans

// one head's state (P floats, P a multiple of 4) into registers
__device__ __forceinline__ void fetch_h(float4 (&reg)[HPF], const float* src,
                                        int P) {
#pragma unroll
  for (int j = 0; j < HPF; ++j) {
    const int q = threadIdx.x + j * THREADS;
    if (q < P / 4) reg[j] = reinterpret_cast<const float4*>(src)[q];
  }
}

// shared-memory geometry: padded extents, and bf16 row strides 16 B over
// the row, so that the eight rows an ldmatrix reads fall in distinct banks
struct Geo {
  int CP, NP16, NP32, HP32;
  int bw, xw, cw, gs;  // strides: B' (a), x, C/B/h (c) in bf16; G in fp32
  __host__ __device__ Geo(int C, int N, int hd)
      : CP(round_up(C, 32)), NP16(round_up(N, 16)), NP32(round_up(N, 32)),
        HP32(round_up(hd, 32)), bw(NP32 + 8), xw(HP32 + 8), cw(NP16 + 8),
        gs(CP + 8) {}
  // bytes of one head's x: two buffers (bf16 raw, double-buffered; or fp32
  // split in hi and lo)
  __host__ __device__ size_t x_bytes() const {
    return 2 * (size_t)CP * xw * 2;
  }
  __host__ __device__ size_t vec_bytes(int n) const {  // n per-head vectors
    return (size_t)n * HG * CP * 4;
  }
  // (a): B fp32, B' hi/lo, x, dt and the weights
  __host__ __device__ size_t chunk_bytes() const {
    return (size_t)CP * NP32 * 4 + 2 * (size_t)CP * bw * 2 + x_bytes() +
           vec_bytes(2);
  }
  // (c): G fp32, C hi/lo, then B hi/lo or (x, h hi/lo), dt, l, exp(l)
  __host__ __device__ size_t shared_bytes() const {
    const size_t bhl = 2 * (size_t)CP * cw * 2;
    const size_t xh = x_bytes() + 2 * (size_t)HP32 * cw * 2;
    return bhl > xh ? bhl : xh;
  }
  __host__ __device__ size_t output_bytes() const {
    return (size_t)CP * gs * 4 + 2 * (size_t)CP * cw * 2 + shared_bytes() +
           vec_bytes(3);
  }
};

// (a) chunk summaries: S[b, c, h] = sum_s exp(l_last - l_s) xd_s (x) B_s,
// and l_last[b, c, h].  S^T = x^T B' with B'_s = dt_s exp(l_last - l_s) B_s
// split in bf16 hi + lo; x^T straight from bf16 xh (exact), or split too.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_chunk_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm, float* __restrict__ S,
                      float* __restrict__ last, int T_len, int H, int hd,
                      int N, int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(C, N, hd);
  const int CP = geo.CP;
  float* Bf = reinterpret_cast<float*>(smem);  // (CP, NP32) B_s[n]
  __nv_bfloat16* bh = reinterpret_cast<__nv_bfloat16*>(Bf + CP * geo.NP32);
  __nv_bfloat16* bl = bh + CP * geo.bw;  // (CP, bw) B' hi, lo
  __nv_bfloat16* xb = bl + CP * geo.bw;  // 2 x (CP, xw)
  float* dts = reinterpret_cast<float*>(xb + 2 * CP * geo.xw);  // (HG, CP)
  float* wts = dts + HG * CP;  // (HG, CP) dt_s exp(l_last - l_s)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;

  if (!F32)
    stage_x<T>(xb, nullptr, geo.xw, xh, b, t0, T_len, H, h0, hd, C, CP,
               geo.HP32);
  const int NP32 = geo.NP32;
  batched<float>(
      CP * NP32,
      [=](int i) {
        const int s = i / NP32, n = i % NP32, t = t0 + s;
        return (s < C && n < N && t < T_len)
                   ? Bm[((size_t)b * T_len + t) * N + n]
                   : 0.f;
      },
      [=](int i, float v) { Bf[i] = v; });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  __syncthreads();
  if (warp < nh) {  // one warp per head: l, then the weights and l_last
    float* cum = wts + warp * CP;
    warp_cumsum(cum, dts + warp * CP, A[h0 + warp], CP);
    __syncwarp();
    const float l_last = cum[C - 1];
    __syncwarp();
    for (int s = lane; s < CP; s += 32)
      cum[s] = dts[warp * CP + s] * __expf(l_last - cum[s]);
    if (lane == 0) last[((size_t)b * nc + c) * H + h0 + warp] = l_last;
  }

  const int nstrips = geo.HP32 / 16, ntiles = nstrips * (geo.NP32 / 32);
  for (int hh = 0; hh < nh; ++hh) {
    __syncthreads();  // wts ready; the previous head's B' consumed
    const float* w = wts + hh * CP;
    for (int i = tid; i < CP * geo.NP32 / 2; i += THREADS) {
      const int s = i / (geo.NP32 / 2), n = 2 * (i % (geo.NP32 / 2));
      uint32_t h2, l2;
      split(w[s] * Bf[s * geo.NP32 + n], w[s] * Bf[s * geo.NP32 + n + 1], h2,
            l2);
      *reinterpret_cast<uint32_t*>(bh + s * geo.bw + n) = h2;
      *reinterpret_cast<uint32_t*>(bl + s * geo.bw + n) = l2;
    }
    const __nv_bfloat16* xa = xb + (F32 ? 0 : (hh & 1) * CP * geo.xw);
    if (F32)
      stage_x<T>(xb, xb + CP * geo.xw, geo.xw, xh, b, t0, T_len, H, h0 + hh,
                 hd, C, CP, geo.HP32);
    else
      cp_async_wait<0>();
    __syncthreads();
    if (!F32 && hh + 1 < nh)  // the next head's x, into the other buffer
      stage_x<T>(xb + ((hh + 1) & 1) * CP * geo.xw, nullptr, geo.xw, xh, b,
                 t0, T_len, H, h0 + hh + 1, hd, C, CP, geo.HP32);
    float* Sh = S + (((size_t)b * nc + c) * H + h0 + hh) * hd * N;
    for (int k = warp; k < ntiles; k += WARPS) {
      const int d0 = 16 * (k % nstrips), n0 = 32 * (k / nstrips);
      float acc[4][4] = {};
      for (int k0 = 0; k0 < CP; k0 += 16) {
        // A = x^T (d rows, s k): ldmatrix.trans of x[s][d]
        const int ar = k0 + (lane & 7) + ((lane >> 4) << 3);
        const int ac = d0 + ((lane >> 3) & 1) * 8;
        uint32_t ahi[4], alo[4];
        ldsm_x4_t(ahi, xa + ar * geo.xw + ac);
        if (F32) ldsm_x4_t(alo, xa + CP * geo.xw + ar * geo.xw + ac);
        const int br = k0 + (lane & 15), bc = n0 + (lane >> 4) * 8;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b_hi[4], b_lo[4];
          ldsm_x4_t(b_hi, bh + br * geo.bw + bc + 16 * jp);
          ldsm_x4_t(b_lo, bl + br * geo.bw + bc + 16 * jp);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float(&a4)[4] = acc[2 * jp + u];
            if (F32) mma_bf16(a4, alo, b_hi[2 * u], b_hi[2 * u + 1]);
            mma_bf16(a4, ahi, b_lo[2 * u], b_lo[2 * u + 1]);
            mma_bf16(a4, ahi, b_hi[2 * u], b_hi[2 * u + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // N is even: n and n + 1 together
          const int d = d0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          if (d < hd && n < N)
            store2(Sh + (size_t)d * N + n, acc[j][2 * r], acc[j][2 * r + 1]);
        }
    }
  }
}

// (b) the inter-chunk walk, one thread per (b, h, 4 state elements), from
// the incoming state h0 (zeros where it is null); the summaries are read
// UNROLL chunks ahead of the walk
constexpr int UNROLL = 8;
__global__ void __launch_bounds__(256)
ssd_scan_state_kernel(float4* __restrict__ S, const float* __restrict__ last,
                      const float4* __restrict__ h0,
                      float4* __restrict__ hfin, int B, int nc, int H,
                      int P4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * P4) return;
  const int p = (int)(i % P4);
  const int h = (int)((i / P4) % H);
  const int b = (int)(i / ((size_t)P4 * H));
  float4 st = h0 ? h0[((size_t)b * H + h) * P4 + p]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += UNROLL) {
    float4 sum[UNROLL];
    float gam[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const size_t bc = (size_t)b * nc + c0 + j;
      if (c0 + j < nc) {
        sum[j] = S[(bc * H + h) * P4 + p];
        gam[j] = last[bc * H + h];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (c0 + j < nc) {
        const size_t bc = (size_t)b * nc + c0 + j;
        S[(bc * H + h) * P4 + p] = st;  // the chunk's incoming state
        const float e = expf(gam[j]);
        st = make_float4(e * st.x + sum[j].x, e * st.y + sum[j].y,
                         e * st.z + sum[j].z, e * st.w + sum[j].w);
      }
    }
  }
  hfin[((size_t)b * H + h) * P4 + p] = st;
}

// (c) y = exp(l_t) C_t . h_in + [G * exp(l_t - l_s)]_{s<=t} xd, rounded
// once.  G = C B^T is built once for the group of heads; every product is
// bf16 hi + lo (three mma: hi hi, hi lo, lo hi), except that bf16 x is
// exact and takes two.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_output_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ Hin, T* __restrict__ y,
                       int T_len, int H, int hd, int N, int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(C, N, hd);
  const int CP = geo.CP, cw = geo.cw, xw = geo.xw;
  float* G = reinterpret_cast<float*>(smem);  // (CP, gs) C_t . B_s
  __nv_bfloat16* ch = reinterpret_cast<__nv_bfloat16*>(G + CP * geo.gs);
  __nv_bfloat16* cl = ch + CP * cw;        // (CP, cw) C hi, lo
  __nv_bfloat16* uni = cl + CP * cw;       // B hi, lo until G is built;
  __nv_bfloat16* bh = uni;                 // then x (2 x (CP, xw)) and
  __nv_bfloat16* bl = uni + CP * cw;       // h hi, lo (2 x (HP32, cw))
  __nv_bfloat16* xb = uni;
  __nv_bfloat16* hh_ = xb + 2 * CP * xw;
  __nv_bfloat16* hl_ = hh_ + geo.HP32 * cw;
  float* dts = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(uni) + geo.shared_bytes());
  float* cl2 = dts + HG * CP;  // (HG, CP) l_s log2(e)
  float* ec = cl2 + HG * CP;   // (HG, CP) exp(l_s)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;
  const int P = hd * N;

  const int npair = geo.NP16 / 2;  // column pairs: N is even
  batched<float4>(
      CP * npair,
      [=](int i) {
        const int s = i / npair, n = 2 * (i % npair), t = t0 + s;
        if (!(s < C && t < T_len && n < N)) return make_float4(0, 0, 0, 0);
        const size_t gi = ((size_t)b * T_len + t) * N + n;
        const float2 cv = *reinterpret_cast<const float2*>(Cm + gi);
        const float2 bv = *reinterpret_cast<const float2*>(Bm + gi);
        return make_float4(cv.x, cv.y, bv.x, bv.y);
      },
      [=](int i, float4 v) {
        const int at = (i / npair) * cw + 2 * (i % npair);
        uint32_t h2, l2;
        split(v.x, v.y, h2, l2);
        *reinterpret_cast<uint32_t*>(ch + at) = h2;
        *reinterpret_cast<uint32_t*>(cl + at) = l2;
        split(v.z, v.w, h2, l2);
        *reinterpret_cast<uint32_t*>(bh + at) = h2;
        *reinterpret_cast<uint32_t*>(bl + at) = l2;
      });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  // the first head's state, into registers (hd N is a multiple of 4)
  auto h_src = [&](int hh) {
    return Hin + (((size_t)b * nc + c) * H + h0 + hh) * P;
  };
  float4 hreg[HPF];
  fetch_h(hreg, h_src(0), P);
  __syncthreads();

  // G = C B^T on the lower triangle of 16 x 16 tiles (the rest is never
  // read: the weights select s <= t before they use G)
  const int nstrips = CP / 16;
  for (int k = warp; k < nstrips * nstrips; k += WARPS) {
    const int r0 = 16 * (k % nstrips), s0 = 16 * (k / nstrips);
    if (s0 > r0) continue;
    float acc[2][4] = {};
    for (int k0 = 0; k0 < geo.NP16; k0 += 16) {
      const int ar = r0 + (lane & 15), ac = k0 + (lane >> 4) * 8;
      const int br = s0 + (lane & 7) + ((lane >> 4) << 3),
                bc = k0 + ((lane >> 3) & 1) * 8;
      uint32_t a_hi[4], a_lo[4], b_hi[4], b_lo[4];
      ldsm_x4(a_hi, ch + ar * cw + ac);
      ldsm_x4(a_lo, cl + ar * cw + ac);
      ldsm_x4(b_hi, bh + br * cw + bc);
      ldsm_x4(b_lo, bl + br * cw + bc);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_bf16(acc[u], a_lo, b_hi[2 * u], b_hi[2 * u + 1]);
        mma_bf16(acc[u], a_hi, b_lo[2 * u], b_lo[2 * u + 1]);
        mma_bf16(acc[u], a_hi, b_hi[2 * u], b_hi[2 * u + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        G[(r0 + g + (e >> 1) * 8) * geo.gs + s0 + 8 * u + 2 * tq + (e & 1)] =
            acc[u][e];
  }
  if (warp < nh) {  // one warp per head: l log2(e) and exp(l)
    float* cum = cl2 + warp * CP;
    warp_cumsum(cum, dts + warp * CP, A[h0 + warp], CP);
    __syncwarp();
    for (int s = lane; s < CP; s += 32) {
      ec[warp * CP + s] = expf(cum[s]);
      cum[s] *= LOG2E;
    }
  }
  __syncthreads();  // B hi/lo consumed: the space holds x and h from here
  for (int i = tid; i < 2 * geo.HP32 * cw / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(hh_)[i] = 0u;  // pads of h stay 0
  if (!F32)
    stage_x<T>(xb, nullptr, xw, xh, b, t0, T_len, H, h0, hd, C, CP, geo.HP32);
  __syncthreads();

  // tiles of 16 rows x 32 columns, taken in pairs of row strips (i,
  // nstrips - 1 - i) by one warp, which balances the causal triangle
  const int ncb = geo.HP32 / (8 * OUT_NT), npairs = (nstrips + 1) / 2;
  for (int hh = 0; hh < nh; ++hh) {
    // the state, split, from the registers; x (fp32) split, or (bf16)
    // copied already
    const int h = h0 + hh;
#pragma unroll
    for (int j = 0; j < HPF; ++j) {
      const int q = tid + j * THREADS;
      if (q < P / 4) {
        const int d = 4 * q / N, n = 4 * q % N;
        uint32_t h2, l2;
        split(hreg[j].x, hreg[j].y, h2, l2);
        *reinterpret_cast<uint32_t*>(hh_ + d * cw + n) = h2;
        *reinterpret_cast<uint32_t*>(hl_ + d * cw + n) = l2;
        split(hreg[j].z, hreg[j].w, h2, l2);
        *reinterpret_cast<uint32_t*>(hh_ + d * cw + n + 2) = h2;
        *reinterpret_cast<uint32_t*>(hl_ + d * cw + n + 2) = l2;
      }
    }
    for (int q = tid + HPF * THREADS; q < P / 4; q += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(h_src(hh))[q];
      const int d = 4 * q / N, n = 4 * q % N;
      uint32_t h2, l2;
      split(v.x, v.y, h2, l2);
      *reinterpret_cast<uint32_t*>(hh_ + d * cw + n) = h2;
      *reinterpret_cast<uint32_t*>(hl_ + d * cw + n) = l2;
      split(v.z, v.w, h2, l2);
      *reinterpret_cast<uint32_t*>(hh_ + d * cw + n + 2) = h2;
      *reinterpret_cast<uint32_t*>(hl_ + d * cw + n + 2) = l2;
    }
    const __nv_bfloat16* xa = xb + (F32 ? 0 : (hh & 1) * CP * xw);
    if (F32)
      stage_x<T>(xb, xb + CP * xw, xw, xh, b, t0, T_len, H, h, hd, C, CP,
                 geo.HP32);
    else
      cp_async_wait<0>();
    __syncthreads();
    if (hh + 1 < nh) {  // the next head's x and state, in flight
      if (!F32)
        stage_x<T>(xb + ((hh + 1) & 1) * CP * xw, nullptr, xw, xh, b, t0,
                   T_len, H, h + 1, hd, C, CP, geo.HP32);
      fetch_h(hreg, h_src(hh + 1), P);
    }
    const float* dw = dts + hh * CP;
    const float* lw = cl2 + hh * CP;
    const float* ew = ec + hh * CP;
    for (int k = warp; k < npairs * ncb; k += WARPS) {
      const int d0 = 8 * OUT_NT * (k / npairs), pi = k % npairs;
      for (int half = 0; half < 2; ++half) {
        if (half && pi == nstrips - 1 - pi) break;
        const int r0 = 16 * (half ? nstrips - 1 - pi : pi);
        float acc[OUT_NT][4] = {};
        // exp(l_t) C_t . h: k over N
        for (int k0 = 0; k0 < geo.NP16; k0 += 16) {
          const int ar = r0 + (lane & 15), ac = k0 + (lane >> 4) * 8;
          uint32_t a_hi[4], a_lo[4];
          ldsm_x4(a_hi, ch + ar * cw + ac);
          ldsm_x4(a_lo, cl + ar * cw + ac);
          const int br = d0 + (lane & 7) + ((lane >> 4) << 3),
                    bc = k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int jp = 0; jp < OUT_NT / 2; ++jp) {
            uint32_t b_hi[4], b_lo[4];
            ldsm_x4(b_hi, hh_ + (br + 16 * jp) * cw + bc);
            ldsm_x4(b_lo, hl_ + (br + 16 * jp) * cw + bc);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float(&a4)[4] = acc[2 * jp + u];
              mma_bf16(a4, a_lo, b_hi[2 * u], b_hi[2 * u + 1]);
              mma_bf16(a4, a_hi, b_lo[2 * u], b_lo[2 * u + 1]);
              mma_bf16(a4, a_hi, b_hi[2 * u], b_hi[2 * u + 1]);
            }
          }
        }
        const int ta = r0 + g, tb = ta + 8;  // this thread's two rows
        const float ea = ew[ta], eb = ew[tb];
#pragma unroll
        for (int j = 0; j < OUT_NT; ++j) {
          acc[j][0] *= ea;
          acc[j][1] *= ea;
          acc[j][2] *= eb;
          acc[j][3] *= eb;
        }
        // + [G exp(l_t - l_s) dt_s]_{s<=t} x: k over the chunk up to the
        // strip's last row
        const float la = lw[ta], lb = lw[tb];
        for (int k0 = 0; k0 < r0 + 16; k0 += 16) {
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // a0..a3: (row, column pair)
            const int t = (q & 1) ? tb : ta;
            const int s = k0 + 2 * tq + (q >> 1) * 8;
            const float lt = (q & 1) ? lb : la;
            const float2 gv = *reinterpret_cast<const float2*>(G + t * geo.gs + s);
            const float2 lv = *reinterpret_cast<const float2*>(lw + s);
            const float2 dv = *reinterpret_cast<const float2*>(dw + s);
            const float w0 = s <= t ? gv.x * ex2(lt - lv.x) * dv.x : 0.f;
            const float w1 = s + 1 <= t ? gv.y * ex2(lt - lv.y) * dv.y : 0.f;
            split(w0, w1, a_hi[q], a_lo[q]);
          }
          const int br = k0 + (lane & 15), bc = d0 + (lane >> 4) * 8;
#pragma unroll
          for (int jp = 0; jp < OUT_NT / 2; ++jp) {
            uint32_t x_hi[4], x_lo[4];
            ldsm_x4_t(x_hi, xa + br * xw + bc + 16 * jp);
            if (F32) ldsm_x4_t(x_lo, xa + CP * xw + br * xw + bc + 16 * jp);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float(&a4)[4] = acc[2 * jp + u];
              if (F32) mma_bf16(a4, a_hi, x_lo[2 * u], x_lo[2 * u + 1]);
              mma_bf16(a4, a_lo, x_hi[2 * u], x_hi[2 * u + 1]);
              mma_bf16(a4, a_hi, x_hi[2 * u], x_hi[2 * u + 1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < OUT_NT; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // hd is even: d and d + 1 together
            const int s = r0 + g + 8 * r, t = t0 + s;
            const int d = d0 + 8 * j + 2 * tq;
            if (s < C && t < T_len && d < hd)
              store2(y + (((size_t)b * T_len + t) * H + h) * hd + d,
                     acc[j][2 * r], acc[j][2 * r + 1]);
          }
      }
    }
    __syncthreads();  // x, h consumed
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int max_smem) {
  if (bytes > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hfin, void* states,
           void* last, int B, int T_len, int H, int hd, int N, int C,
           void* stream) {
  // 16-byte pieces of x rows, float2 pairs of B and C, float4s of h
  if (hd % 8 || N % 4) return (int)cudaErrorInvalidValue;
  const Geo geo(C, N, hd);
  const size_t smem_a = geo.chunk_bytes(), smem_c = geo.output_bytes();
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_scan_chunk_kernel<T>, smem_a, max_smem)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_scan_output_kernel<T>, smem_c, max_smem)) !=
          cudaSuccess)
    return (int)err;
  const int nc = (T_len + C - 1) / C;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((H + HG - 1) / HG, nc, B);
  ssd_scan_chunk_kernel<T><<<grid, THREADS, smem_a, s>>>(
      (const T*)xh, (const float*)dt, (const float*)A, (const float*)Bm,
      (float*)states, (float*)last, T_len, H, hd, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_state = (size_t)B * H * hd * N / 4;
  ssd_scan_state_kernel<<<(unsigned)((n_state + 255) / 256), 256, 0, s>>>(
      (float4*)states, (const float*)last, (const float4*)h0, (float4*)hfin,
      B, nc, H, hd * N / 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_output_kernel<T><<<grid, THREADS, smem_c, s>>>(
      (const T*)xh, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)states, (T*)y, T_len, H, hd, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// h0: the incoming state (B, H, hd, N) fp32, or null for zeros; states:
// (B, nc, H, hd, N) fp32 scratch, left holding each chunk's incoming state
// (h0 for the first); last: (B, nc, H) fp32 scratch.  hd % 8 == 0, N % 4
// == 0, xh and h0 16-byte aligned.
extern "C" int ssd_scan_f32(const void* xh, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0,
                            void* y, void* hfin, void* states, void* last,
                            int B, int T, int H, int hd, int N, int C,
                            void* stream) {
  return launch<float>(xh, dt, A, Bm, Cm, h0, y, hfin, states, last, B, T, H,
                       hd, N, C, stream);
}

extern "C" int ssd_scan_bf16(const void* xh, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* h0,
                             void* y, void* hfin, void* states, void* last,
                             int B, int T, int H, int hd, int N, int C,
                             void* stream) {
  return launch<__nv_bfloat16>(xh, dt, A, Bm, Cm, h0, y, hfin, states, last,
                               B, T, H, hd, N, C, stream);
}
