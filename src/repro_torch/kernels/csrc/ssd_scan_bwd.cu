// The gradient of the Mamba2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan.py) has no backward, and the reference
// differentiates its jnp `ssd_chunked` (src/repro/models/mamba2.py).  It is
// the gradient of the forward's function, which training an ssm or hybrid
// model on the card needs.  Per (batch, chunk, head), with l_t =
// cumsum_t(-dt_t A) within the chunk, L = l_{C-1}, xd = x dt and
// G_ts = C_t . B_s, the forward computes
//   y_t = sum_{s<=t} G_ts exp(l_t - l_s) xd_s + exp(l_t) h C_t
//   h'  = exp(L) h + sum_s exp(L - l_s) xd_s (x) B_s
// with h the chunk's incoming state (hd, N) and h' its outgoing one.  With
// g the gradient arriving at h' (the final state's gradient for the last
// chunk) and dy the output's, the backward is
//   U        = sum_t exp(l_t) dy_t (x) C_t          (dh's term from y)
//   g_prev   = exp(L) g + U                         (walked from the end)
//   dS_ts    = (dy_t . x_s) dt_s exp(l_t - l_s)     [s <= t]
//   dxd_s    = sum_{t>=s} G_ts exp(l_t - l_s) dy_t + exp(L - l_s) g B_s
//   dC_t     = sum_s dS_ts B_s + exp(l_t) h^T dy_t
//   dB_s     = sum_t dS_ts C_t + dt_s exp(L - l_s) g^T x_s
//   dl_t     = sum_s Z_ts - sum_s Z_st + Q_t - exp(L - l_t) R_t, Z = dS o G,
//              Q_t = C_t . exp(l_t) h^T dy_t, R_s = dt_s x_s . g B_s,
//              and dl_{C-1} += sum_s exp(L - l_s) R_s + exp(L) <g, h>
//   dla      = the reverse cumsum of dl within the chunk
//   dx = dxd dt, ddt = -A dla + dxd . x, dA = -sum dt dla.
// T is padded to a chunk multiple with dt = 0 as in the forward, which is
// exact here too: padded positions carry no data and get no gradient, and
// dl_{C-1} reaches the valid positions through the reverse cumsum.
//
// What bounds it: it reads xh, dy, dt, B, C and the forward's per-chunk
// incoming states once and writes dxh, ddt, dB, dC once: at mamba2-1.3b's
// training shape (B 8, T 2048, H 64, hd 64, N 128, C 128, bf16) about 0.7
// GB, 0.21 ms at 3.35 TB/s, against about 0.12 TFLOP of products (0.12 ms
// at the bf16 tensor-core peak).
//
// Design: the forward's split in reverse, seven launches on one stream, all
// named ssd_bwd_*, none with atomics, so that two calls give the same bits:
//   gram   one block per (batch, chunk): G = C B^T in fp32 into a (B, nc,
//          CP, CP) scratch (B and C are shared across heads).
//   chunk  one block per (batch, chunk, group of HG heads): each head's l,
//          L (into `last`) and U = dy^T (exp(l) C) into the (B, nc, H, hd,
//          N) walk buffer.
//   state  one thread per (batch, head, 4 state elements): walks the chunks
//          from the last, g = dh_final; each chunk's U is replaced by the g
//          arriving at its outgoing state, then g <- exp(L) g + U; the g
//          left after the first chunk is the incoming state's gradient dh0
//          (written where the caller wants it: a sequence split into
//          blocks chains it into the previous block's dh_final).
//   dx     one block per (batch, chunk, group of heads): dxd as (B g^T)
//          exp(L - l) plus W^T dy, W's fragments formed in registers from G
//          (read from the scratch, L2-resident) and masked to s <= t; dx,
//          and per row R and dxd . x.
//   dc     likewise: dC over the group's heads, exp(l) dy h plus dS B with
//          dS = dy x^T formed in registers tile by tile; per row Q and the
//          row sums of Z.
//   db     likewise: dB, dt exp(L - l) x g plus dS^T C; the column sums of Z.
//   final  one warp per (batch, chunk, head): dl, its reverse cumsum, ddt
//          and the head's share of dA; exp(L) <g, h> read from the buffers.
// dc and db sum their group's heads in the block's own slice of a (groups,
// B, nc C, N) fp32 scratch, a head at a time in order; the wrapper sums the
// groups and dA's (B, nc, H) shares in a fixed order.  Every product runs
// on tensor cores (`mma.sync.m16n8k16`, operands from `ldmatrix` or formed
// in registers) with fp32 operands split into bf16 hi + lo as in the
// forward (three mma: hi hi, hi lo, lo hi; bf16 x and dy are exact and take
// two), sums in fp32.  Shared memory per block, with xh in bf16 (fp32) at C
// 128, N 128, hd 64: gram 136 KB, chunk 158 KB (176), dx 130 KB (148), dc
// and db 148 KB (184); `ssd_scan_bwd_smem` gives them for any shape.  hd
// must be a multiple of 8 and N of 4.
//
// bf16 xh at hd 64, C 128 and N 64 or 128 (what training sends: mamba2's N
// 128, zamba2's 64) replaces dx, dc and db by two warp-specialized launches
// on Hopper's `wgmma` with TMA-fed tiles (csrc/sm90.cuh): two consumer
// warpgroups of 64 rows each and a producer warpgroup, whose first thread
// keeps a two-stage ring of each head's x and dy tiles in flight (TMA,
// 128-byte swizzle, mbarriers) and whose warps 1-3 split the head's fp32
// states into bf16 hi + lo tiles in shared memory (the states are never
// rewritten whole; four pieces' loads in flight a thread) and write its dt
// and l.  setmaxnreg gives the consumers 208 registers and the producer
// 88: the splitting loop spilled at 56 and both passes ran 10-20% slower,
// and the three must fit the launch's 3 x 168.  gram then writes G^T = B
// C^T and B and C split into bf16 hi and lo planes once a call (16.8 MB at
// mamba2's shape), which both launches load by TMA:
//   dx     B resident (both planes, all of N), G^T's tiles of the
//          warpgroup's rows in registers, loaded once a block; per head
//          (B g^T) in three products, W^T dy with W^T formed in registers
//          (two: dy is exact), dx, R and D.
//   dcdb   one block per 64 columns of N: B and C resident for them; per
//          head dS = dy x^T and dS^T = x dy^T formed once a tile (dS twice
//          a call at N 128, once per column block), masked, scaled and
//          split in registers as the A operands of dC += dS B and dB +=
//          dS^T C; the heads summed in the accumulators, written once.  Q
//          comes from C_t . exp(l_t) (dy h)_t, dC's first share; Z's row
//          and column sums from the fp32 dS and dS^T tiles before their
//          split, times G (its strict lower triangle copied from the gram
//          scratch into shared memory once a block), as the mma.sync route
//          and the split plain version take them (dl's Z terms are a small
//          difference of large sums, which products of bf16 hi + lo
//          operands do not resolve): the rows by the first column block,
//          the columns by the last.
// Shared memory: dx 195 KB at N 128 (131 at 64), dcdb 227 KB; no atomics,
// the same bits twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssd_common.cuh"

namespace {

constexpr int NB = 4;  // n8 tiles of a warp's output tile: 16 x 32
constexpr int UNROLL = 8;  // chunks the walk reads ahead
// per-row terms the gradient passes leave for the final one
// (TERM_Q1: Q's share from the wgmma route's second column block of N)
enum { TERM_R, TERM_D, TERM_Q, TERM_ROWZ, TERM_COLZ, TERM_Q1, NTERMS };

// shared-memory geometry: the chunk, N and hd padded to 32; bf16 row
// strides 16 B over the row, so that an ldmatrix's eight rows fall in
// distinct banks
struct BGeo {
  int CP, NP, HP, nw, xw;
  __host__ __device__ BGeo(int C, int N, int hd)
      : CP(round_up(C, 32)), NP(round_up(N, 32)), HP(round_up(hd, 32)),
        nw(NP + 8), xw(HP + 8) {}
  // a split (hi, lo) bf16 array of `rows` rows of N
  __host__ __device__ size_t split_n(int rows) const {
    return 2 * (size_t)rows * nw * 2;
  }
  // one head's chunk of xh or dy: bf16 as it is, or fp32 split
  __host__ __device__ size_t x_bytes(bool f32) const {
    return (f32 ? 2 : 1) * (size_t)CP * xw * 2;
  }
  __host__ __device__ size_t vecs(int n) const { return (size_t)n * CP * 4; }
  __host__ __device__ size_t gram_bytes() const { return 2 * split_n(CP); }
  __host__ __device__ size_t chunk_bytes(bool f32) const {
    return (size_t)CP * NP * 4 + split_n(CP) + x_bytes(f32) + vecs(2 * HG);
  }
  __host__ __device__ size_t dx_bytes(bool f32) const {
    return split_n(CP) + split_n(HP) + x_bytes(f32) +
           vecs(2 * HG + 2 * (HP / 32));
  }
  __host__ __device__ size_t dbc_bytes(bool f32) const {
    return split_n(CP) + split_n(HP) + 2 * x_bytes(f32) +
           vecs(2 * HG + NP / 32 + 1);
  }
};

// hands out consecutive pieces of shared memory (each a multiple of 16 B)
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(size_t bytes) {
    T* r = reinterpret_cast<T*>(p);
    p += bytes;
    return r;
  }
};

// a bf16 matrix in shared memory: hi, and lo unless the values are exact in
// bf16 (lo null); ld its row stride
struct Op {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;
  int ld;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the A operand (16 x 16 at rows m0, columns k) of a matrix stored [m][k]
// (ROW) or [k][m]
template <bool ROW>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* p, int ld, int m0,
                                       int k) {
  const int lane = threadIdx.x & 31;
  if (ROW)
    ldsm_x4(a, p + (m0 + (lane & 15)) * ld + k + (lane >> 4) * 8);
  else
    ldsm_x4_t(a, p + (k + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                     ((lane >> 3) & 1) * 8);
}

// the B operands of two n8 tiles (columns n..n+15, rows k..k+15) of a matrix
// stored [k][n] (ROW) or [n][k]: b[0], b[1] the first tile, b[2], b[3] the
// second
template <bool ROW>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* p, int ld, int n,
                                       int k) {
  const int lane = threadIdx.x & 31;
  if (ROW)
    ldsm_x4_t(b, p + (k + (lane & 15)) * ld + n + (lane >> 4) * 8);
  else
    ldsm_x4(b, p + (n + (lane & 7) + ((lane >> 4) << 3)) * ld + k +
                   ((lane >> 3) & 1) * 8);
}

// acc[j] += a * B[k..k+16][n0 + 8 j..]: a 16 x 16 A operand in registers
// (hi, and lo where asplit), B in shared memory stored [k][n] (BROW) or
// [n][k]; the small products first
template <int NT, bool BROW>
__device__ __forceinline__ void mma_a(float (&acc)[NT][4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], bool asplit,
                                      const Op& B, int n0, int k) {
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    uint32_t bh[4], bl[4];
    frag_b<BROW>(bh, B.hi, B.ld, n0 + 16 * jp, k);
    if (B.lo) frag_b<BROW>(bl, B.lo, B.ld, n0 + 16 * jp, k);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float(&c)[4] = acc[2 * jp + u];
      if (asplit) mma_bf16(c, al, bh[2 * u], bh[2 * u + 1]);
      if (B.lo) mma_bf16(c, ah, bl[2 * u], bl[2 * u + 1]);
      mma_bf16(c, ah, bh[2 * u], bh[2 * u + 1]);
    }
  }
}

// acc[j] += A[m0..m0+16][k0..k1] * B[k0..k1][n0 + 8 j..], both in shared
// memory
template <int NT, bool AROW, bool BROW>
__device__ __forceinline__ void mma_ss(float (&acc)[NT][4], const Op& A,
                                       int m0, const Op& B, int n0, int k0,
                                       int k1) {
  for (int k = k0; k < k1; k += 16) {
    uint32_t ah[4], al[4] = {};
    frag_a<AROW>(ah, A.hi, A.ld, m0, k);
    if (A.lo) frag_a<AROW>(al, A.lo, A.ld, m0, k);
    mma_a<NT, BROW>(acc, ah, al, A.lo != nullptr, B, n0, k);
  }
}

// a 16 x 16 tile of fp32 accumulators (two n8 halves) as a split A operand
__device__ __forceinline__ void to_a(const float (&f)[2][4], uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  split(f[0][0], f[0][1], hi[0], lo[0]);
  split(f[0][2], f[0][3], hi[1], lo[1]);
  split(f[1][0], f[1][1], hi[2], lo[2]);
  split(f[1][2], f[1][3], hi[3], lo[3]);
}

// the sum over the four lanes of a quad (a row of an mma tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// one warp: v[s] <- sum_{u >= s} v[u] over CP (a multiple of 32)
__device__ __forceinline__ void warp_rev_cumsum(float* v, int CP) {
  const int lane = threadIdx.x & 31;
  const int per = CP / 32, s0 = lane * per;
  float own = 0.0f;
  for (int s = s0; s < s0 + per; ++s) own += v[s];
  float inc = own;
  for (int off = 1; off < 32; off <<= 1) {
    const float dn = __shfl_down_sync(FULL, inc, off);
    if (lane + off < 32) inc += dn;
  }
  float run = inc - own;
  for (int s = s0 + per - 1; s >= s0; --s) {
    run += v[s];
    v[s] = run;
  }
}

// rows x cols (padded, even) fp32 values into split bf16 at [r][c], stride
// ld: row(r) points at row r's values, or is null for a row of zeros;
// columns from ncols on are zeros
template <typename Row>
__device__ __forceinline__ void stage_split(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int ld,
                                            int rows, int cols, int ncols,
                                            Row row) {
  const int np = cols / 2;
  batched<float2>(
      rows * np,
      [=](int i) {
        const float* p = row(i / np);
        const int n = 2 * (i % np);
        return (p && n < ncols) ? *reinterpret_cast<const float2*>(p + n)
                                : make_float2(0.f, 0.f);
      },
      [=](int i, float2 v) {
        const int at = (i / np) * ld + 2 * (i % np);
        uint32_t h2, l2;
        split(v.x, v.y, h2, l2);
        *reinterpret_cast<uint32_t*>(hi + at) = h2;
        *reinterpret_cast<uint32_t*>(lo + at) = l2;
      });
}

// tiles of 16 rows x 32 columns over nstrips row strips and ncb column
// blocks, a warp taking strips i and nstrips - 1 - i of one column block,
// which balances the causal triangle; f(r0, cb) is called by a whole warp
template <typename F>
__device__ __forceinline__ void strip_tiles(int nstrips, int ncb, F f) {
  const int warp = threadIdx.x >> 5, npairs = (nstrips + 1) / 2;
  for (int k = warp; k < npairs * ncb; k += WARPS) {
    const int cb = k / npairs, pi = k % npairs;
    f(16 * pi, cb);
    if (nstrips - 1 - pi != pi) f(16 * (nstrips - 1 - pi), cb);
  }
}

// each head of the block's group: l log2(e) from dt (one warp a head)
__device__ __forceinline__ void head_logs(float* l2s, const float* dts,
                                          const float* A, int h0, int nh,
                                          int CP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nh) {
    float* cum = l2s + warp * CP;
    warp_cumsum(cum, dts + warp * CP, A[h0 + warp], CP);
    __syncwarp();
    for (int s = lane; s < CP; s += 32) cum[s] *= LOG2E;
  }
}

// gram: G[b, c] = C_c B_c^T, (CP, CP) fp32, zero past the chunk and T.
// With `planes` (the wgmma route) it writes G^T = B_c C_c^T instead, and B
// and C split into bf16 hi and lo planes (4, B, nc, CP, N): B hi, B lo,
// C hi, C lo, the tiles the wgmma passes load by TMA.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ G, __nv_bfloat16* __restrict__ planes,
                    int T_len, int N, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BGeo geo(C, N, 8);
  const int CP = geo.CP, nw = geo.nw;
  Carve cv{smem};
  __nv_bfloat16* ch = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* cl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* bh = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* bl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y, c = blockIdx.x, t0 = c * C;
  auto rows = [=](const float* M) {
    return [=](int s) -> const float* {
      const int t = t0 + s;
      return (s < C && t < T_len) ? M + ((size_t)b * T_len + t) * N : nullptr;
    };
  };
  // rows of G (C; B for G^T) in ch, cl; its columns in bh, bl
  stage_split(ch, cl, nw, CP, geo.NP, N, rows(planes ? Bm : Cm));
  stage_split(bh, bl, nw, CP, geo.NP, N, rows(planes ? Cm : Bm));
  __syncthreads();
  if (planes) {
    const size_t plane = (size_t)gridDim.y * gridDim.x * CP * N;
    const size_t at = ((size_t)b * gridDim.x + c) * CP * N;
    const int per = N / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < 4 * CP * per; i += THREADS) {
      const int p = i / (CP * per), r = (i / per) % CP, n = 8 * (i % per);
      const __nv_bfloat16* src = p == 0 ? ch : p == 1 ? cl : p == 2 ? bh : bl;
      *reinterpret_cast<uint4*>(planes + p * plane + at + (size_t)r * N + n) =
          *reinterpret_cast<const uint4*>(src + r * nw + n);
    }
  }
  float* Gc = G + ((size_t)b * gridDim.x + c) * CP * CP;
  const Op Cs{ch, cl, nw}, Bs{bh, bl, nw};
  const int ntr = CP / 16;
  for (int k = warp; k < ntr * (CP / 32); k += WARPS) {
    const int r0 = 16 * (k % ntr), s0 = 32 * (k / ntr);
    float acc[NB][4] = {};
    mma_ss<NB, true, false>(acc, Cs, r0, Bs, s0, 0, geo.NP);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store2(Gc + (size_t)(r0 + g + 8 * r) * CP + s0 + 8 * j + 2 * tq,
               acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// chunk: each head's l_last, and U = sum_t exp(l_t) dy_t (x) C_t into the
// walk buffer (B, nc, H, hd, N)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Cm, float* __restrict__ U,
                     float* __restrict__ last, int T_len, int H, int hd,
                     int N, int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BGeo geo(C, N, hd);
  const int CP = geo.CP, NP = geo.NP, nw = geo.nw, xw = geo.xw;
  Carve cv{smem};
  float* Cf = cv.take<float>((size_t)CP * NP * 4);  // (CP, NP) C_t[n]
  __nv_bfloat16* ch = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* cl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* yb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  float* dts = cv.take<float>(geo.vecs(HG));
  float* el = cv.take<float>(geo.vecs(HG));  // (HG, CP) exp(l_t)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;

  batched<float>(
      CP * NP,
      [=](int i) {
        const int s = i / NP, n = i % NP, t = t0 + s;
        return (s < C && n < N && t < T_len)
                   ? Cm[((size_t)b * T_len + t) * N + n]
                   : 0.f;
      },
      [=](int i, float v) { Cf[i] = v; });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  __syncthreads();
  if (warp < nh) {
    float* cum = el + warp * CP;
    warp_cumsum(cum, dts + warp * CP, A[h0 + warp], CP);
    __syncwarp();
    const float l_last = cum[C - 1];
    __syncwarp();
    for (int s = lane; s < CP; s += 32) cum[s] = expf(cum[s]);
    if (lane == 0) last[((size_t)b * nc + c) * H + h0 + warp] = l_last;
  }

  const Op Y{yb, F32 ? yb + CP * xw : nullptr, xw}, Cs{ch, cl, nw};
  const int nd = geo.HP / 16;
  for (int hh = 0; hh < nh; ++hh) {
    __syncthreads();  // exp(l) ready; the previous head's C' and dy consumed
    const float* w = el + hh * CP;
    for (int i = tid; i < CP * NP / 2; i += THREADS) {
      const int s = i / (NP / 2), n = 2 * (i % (NP / 2));
      uint32_t h2, l2;
      split(w[s] * Cf[s * NP + n], w[s] * Cf[s * NP + n + 1], h2, l2);
      *reinterpret_cast<uint32_t*>(ch + s * nw + n) = h2;
      *reinterpret_cast<uint32_t*>(cl + s * nw + n) = l2;
    }
    stage_x<T>(yb, yb + CP * xw, xw, dy, b, t0, T_len, H, h0 + hh, hd, C, CP,
               geo.HP);
    if (!F32) cp_async_wait<0>();
    __syncthreads();
    float* Uh = U + (((size_t)b * nc + c) * H + h0 + hh) * hd * N;
    for (int k = warp; k < nd * (NP / 32); k += WARPS) {
      const int d0 = 16 * (k % nd), n0 = 32 * (k / nd);
      float acc[NB][4] = {};
      // U^T's rows d: A = dy^T (dy stored [t][d]), B = exp(l) C [t][n]
      mma_ss<NB, false, true>(acc, Y, d0, Cs, n0, 0, CP);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int d = d0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          if (d < hd && n < N)
            store2(Uh + (size_t)d * N + n, acc[j][2 * r], acc[j][2 * r + 1]);
        }
    }
  }
}

// state: the reverse walk, one thread per (b, h, 4 state elements); each
// chunk's U is read UNROLL chunks ahead and replaced by the gradient
// arriving at the chunk's outgoing state; what is left after chunk 0 is
// the incoming state's gradient, written to dh0 where it is wanted
__global__ void __launch_bounds__(256)
ssd_bwd_state_kernel(float4* __restrict__ U, const float* __restrict__ last,
                     const float4* __restrict__ dhfin,
                     float4* __restrict__ dh0, int B, int nc, int H,
                     int P4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * P4) return;
  const int p = (int)(i % P4);
  const int h = (int)((i / P4) % H);
  const int b = (int)(i / ((size_t)P4 * H));
  float4 gs = dhfin ? dhfin[((size_t)b * H + h) * P4 + p]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c1 = nc - 1; c1 >= 0; c1 -= UNROLL) {
    float4 u[UNROLL];
    float gam[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const size_t bc = (size_t)b * nc + c1 - j;
      if (c1 - j >= 0) {
        u[j] = U[(bc * H + h) * P4 + p];
        gam[j] = last[bc * H + h];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (c1 - j >= 0) {
        const size_t bc = (size_t)b * nc + c1 - j;
        U[(bc * H + h) * P4 + p] = gs;
        const float e = expf(gam[j]);
        gs = make_float4(e * gs.x + u[j].x, e * gs.y + u[j].y,
                         e * gs.z + u[j].z, e * gs.w + u[j].w);
      }
    }
  }
  if (dh0) dh0[((size_t)b * H + h) * P4 + p] = gs;
}

// dx: dxd = exp(L - l_s) (B g^T)_s + sum_{t>=s} W_ts dy_t, dx = dxd dt;
// per row R_s = dt_s x_s . (g B_s) and D_s = dxd_s . x_s into `terms`
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx_kernel(const T* __restrict__ xh, const T* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm,
                  const float* __restrict__ Gm,
                  const float* __restrict__ Gout, T* __restrict__ dx,
                  float* __restrict__ terms, int T_len, int H, int hd, int N,
                  int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BGeo geo(C, N, hd);
  const int CP = geo.CP, nw = geo.nw, xw = geo.xw, ncb = geo.HP / 32;
  Carve cv{smem};
  __nv_bfloat16* bh = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* bl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* gh = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* gl = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* yb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  float* dts = cv.take<float>(geo.vecs(HG));
  float* l2s = cv.take<float>(geo.vecs(HG));
  float* rR = cv.take<float>(geo.vecs(ncb));  // (ncb, CP) partial R / dt
  float* rD = cv.take<float>(geo.vecs(ncb));  // (ncb, CP) partial D
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;

  stage_split(bh, bl, nw, CP, geo.NP, N, [=](int s) -> const float* {
    const int t = t0 + s;
    return (s < C && t < T_len) ? Bm + ((size_t)b * T_len + t) * N : nullptr;
  });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  __syncthreads();
  head_logs(l2s, dts, A, h0, nh, CP);
  const float* Gc = Gm + ((size_t)b * nc + c) * CP * CP;
  const Op Bs{bh, bl, nw}, Gs{gh, gl, nw},
      Y{yb, F32 ? yb + CP * xw : nullptr, xw};
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // l ready; the previous head's g, dy and rows consumed
    const float* gsrc = Gout + (((size_t)b * nc + c) * H + h) * hd * N;
    stage_split(gh, gl, nw, geo.HP, geo.NP, N, [=](int d) -> const float* {
      return d < hd ? gsrc + (size_t)d * N : nullptr;
    });
    stage_x<T>(yb, yb + CP * xw, xw, dy, b, t0, T_len, H, h, hd, C, CP,
               geo.HP);
    if (!F32) cp_async_wait<0>();
    __syncthreads();
    const float* dw = dts + hh * CP;
    const float* lw = l2s + hh * CP;
    const float lL = lw[C - 1];
    strip_tiles(CP / 16, ncb, [&](int r0, int cb) {
      const int d0 = 32 * cb, sa = r0 + g, sb = sa + 8;
      float gb[NB][4] = {};  // (B g^T)[s][d]: B [s][n], g [d][n]
      mma_ss<NB, true, false>(gb, Bs, r0, Gs, d0, 0, geo.NP);
      const float ea = ex2(lL - lw[sa]), eb = ex2(lL - lw[sb]);
      float acc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = gb[j][e] * (e < 2 ? ea : eb);
      // + W^T dy, k over t >= the strip's first row
      for (int k = r0; k < CP; k += 16) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a0..a3: (row s, column pair t)
          const int s = (q & 1) ? sb : sa;
          const int t = k + 2 * tq + (q >> 1) * 8;
          const float ls = lw[s];
          const float w0 =
              t >= s ? __ldg(Gc + (size_t)t * CP + s) * ex2(lw[t] - ls) : 0.f;
          const float w1 = t + 1 >= s ? __ldg(Gc + (size_t)(t + 1) * CP + s) *
                                            ex2(lw[t + 1] - ls)
                                      : 0.f;
          split(w0, w1, ah[q], al[q]);
        }
        mma_a<NB, true>(acc, ah, al, true, Y, d0, k);
      }
      float rs[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = r0 + g + 8 * r, t = t0 + s, d = d0 + 8 * j + 2 * tq;
          if (s < C && t < T_len && d < hd) {
            const size_t at = (((size_t)b * T_len + t) * H + h) * hd + d;
            const float2 xv = load2(xh + at);
            const float a0 = acc[j][2 * r], a1 = acc[j][2 * r + 1];
            store2(dx + at, a0 * dw[s], a1 * dw[s]);
            rs[r] += xv.x * gb[j][2 * r] + xv.y * gb[j][2 * r + 1];
            ds[r] += xv.x * a0 + xv.y * a1;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] = quad_sum(rs[r]);
        ds[r] = quad_sum(ds[r]);
        if (tq == 0) {
          rR[cb * CP + r0 + g + 8 * r] = rs[r];
          rD[cb * CP + r0 + g + 8 * r] = ds[r];
        }
      }
    });
    __syncthreads();
    float* tb = terms + (((size_t)b * nc + c) * H + h) * NTERMS * CP;
    for (int s = tid; s < CP; s += THREADS) {
      float r = 0.f, d = 0.f;
      for (int cb = 0; cb < ncb; ++cb) {
        r += rR[cb * CP + s];
        d += rD[cb * CP + s];
      }
      tb[TERM_R * CP + s] = dw[s] * r;
      tb[TERM_D * CP + s] = d;
    }
  }
}

// dc: dC_t = sum over the group's heads of exp(l_t) (dy h)_t + sum_{s<=t}
// dS_ts B_s, into the block's slice of the (groups, B, nc C, N) scratch; per
// row Q_t and the row sums of Z = dS o G into `terms`
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dc_kernel(const T* __restrict__ xh, const T* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm,
                  const float* __restrict__ Cm,
                  const float* __restrict__ Gm,
                  const float* __restrict__ Hin, float* __restrict__ dCp,
                  float* __restrict__ terms, int T_len, int H, int hd, int N,
                  int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BGeo geo(C, N, hd);
  const int CP = geo.CP, nw = geo.nw, xw = geo.xw, ncb = geo.NP / 32;
  Carve cv{smem};
  __nv_bfloat16* bh = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* bl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* sh = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* sl = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* yb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  __nv_bfloat16* xb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  float* dts = cv.take<float>(geo.vecs(HG));
  float* l2s = cv.take<float>(geo.vecs(HG));
  float* rq = cv.take<float>(geo.vecs(ncb));  // (ncb, CP) partial Q
  float* rz = cv.take<float>(geo.vecs(1));    // row sums of Z
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;

  stage_split(bh, bl, nw, CP, geo.NP, N, [=](int s) -> const float* {
    const int t = t0 + s;
    return (s < C && t < T_len) ? Bm + ((size_t)b * T_len + t) * N : nullptr;
  });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  __syncthreads();
  head_logs(l2s, dts, A, h0, nh, CP);
  const float* Gc = Gm + ((size_t)b * nc + c) * CP * CP;
  float* dCb =
      dCp + (((size_t)blockIdx.x * gridDim.z + b) * nc + c) * (size_t)C * N;
  const Op Bs{bh, bl, nw}, Hs{sh, sl, nw},
      Y{yb, F32 ? yb + CP * xw : nullptr, xw},
      X{xb, F32 ? xb + CP * xw : nullptr, xw};
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // l ready; the previous head's h, dy, x, rows consumed
    const float* hsrc = Hin + (((size_t)b * nc + c) * H + h) * hd * N;
    stage_split(sh, sl, nw, geo.HP, geo.NP, N, [=](int d) -> const float* {
      return d < hd ? hsrc + (size_t)d * N : nullptr;
    });
    stage_x<T>(yb, yb + CP * xw, xw, dy, b, t0, T_len, H, h, hd, C, CP,
               geo.HP);
    stage_x<T>(xb, xb + CP * xw, xw, xh, b, t0, T_len, H, h, hd, C, CP,
               geo.HP);
    if (!F32) cp_async_wait<0>();
    __syncthreads();
    const float* dw = dts + hh * CP;
    const float* lw = l2s + hh * CP;
    strip_tiles(CP / 16, ncb, [&](int r0, int cb) {
      const int n0 = 32 * cb;
      float acc[NB][4] = {};  // exp(l_t) (dy h)[t][n]: dy [t][d], h [d][n]
      mma_ss<NB, true, true>(acc, Y, r0, Hs, n0, 0, geo.HP);
      float qs[2] = {0.f, 0.f}, zr[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r0 + g + 8 * r, tt = t0 + t;
        const float e = ex2(lw[t]);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = n0 + 8 * j + 2 * tq;
          acc[j][2 * r] *= e;
          acc[j][2 * r + 1] *= e;
          if (t < C && tt < T_len && n < N) {
            const float2 cvl = load2(Cm + ((size_t)b * T_len + tt) * N + n);
            qs[r] += cvl.x * acc[j][2 * r] + cvl.y * acc[j][2 * r + 1];
          }
        }
      }
      // + dS B, k over s up to the strip's last row
      for (int k = 0; k <= r0; k += 16) {
        float sv[2][4] = {};  // dy x^T: x stored [s][d]
        mma_ss<2, true, false>(sv, Y, r0, X, k, 0, geo.HP);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g + 8 * (e >> 1);
            const int s = k + 8 * j + 2 * tq + (e & 1);
            const float v =
                s <= t ? sv[j][e] * dw[s] * ex2(lw[t] - lw[s]) : 0.f;
            sv[j][e] = v;
            if (cb == 0) zr[e >> 1] += v * __ldg(Gc + (size_t)t * CP + s);
          }
        uint32_t ah[4], al[4];
        to_a(sv, ah, al);
        mma_a<NB, true>(acc, ah, al, true, Bs, n0, k);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          if (t < C && n < N) {
            float* p = dCb + (size_t)t * N + n;
            const float2 o = hh ? *reinterpret_cast<float2*>(p)
                                : make_float2(0.f, 0.f);
            store2(p, o.x + acc[j][2 * r], o.y + acc[j][2 * r + 1]);
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qs[r] = quad_sum(qs[r]);
        if (tq == 0) rq[cb * CP + r0 + g + 8 * r] = qs[r];
        if (cb == 0) {
          zr[r] = quad_sum(zr[r]);
          if (tq == 0) rz[r0 + g + 8 * r] = zr[r];
        }
      }
    });
    __syncthreads();
    float* tb = terms + (((size_t)b * nc + c) * H + h) * NTERMS * CP;
    for (int s = tid; s < CP; s += THREADS) {
      float q = 0.f;
      for (int cb = 0; cb < ncb; ++cb) q += rq[cb * CP + s];
      tb[TERM_Q * CP + s] = q;
      tb[TERM_Q1 * CP + s] = 0.f;
      tb[TERM_ROWZ * CP + s] = rz[s];
    }
  }
}

// db: dB_s = sum over the group's heads of dt_s exp(L - l_s) (x g)_s +
// sum_{t>=s} dS_ts C_t, into the block's slice of the scratch; the column
// sums of Z into `terms`
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_db_kernel(const T* __restrict__ xh, const T* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Cm,
                  const float* __restrict__ Gm,
                  const float* __restrict__ Gout, float* __restrict__ dBp,
                  float* __restrict__ terms, int T_len, int H, int hd, int N,
                  int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BGeo geo(C, N, hd);
  const int CP = geo.CP, nw = geo.nw, xw = geo.xw, ncb = geo.NP / 32;
  Carve cv{smem};
  __nv_bfloat16* ch = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* cl = cv.take<__nv_bfloat16>(geo.split_n(CP) / 2);
  __nv_bfloat16* gh = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* gl = cv.take<__nv_bfloat16>(geo.split_n(geo.HP) / 2);
  __nv_bfloat16* yb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  __nv_bfloat16* xb = cv.take<__nv_bfloat16>(geo.x_bytes(F32));
  float* dts = cv.take<float>(geo.vecs(HG));
  float* l2s = cv.take<float>(geo.vecs(HG));
  float* rz = cv.take<float>(geo.vecs(1));  // column sums of Z
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG);
  const int t0 = c * C;

  stage_split(ch, cl, nw, CP, geo.NP, N, [=](int s) -> const float* {
    const int t = t0 + s;
    return (s < C && t < T_len) ? Cm + ((size_t)b * T_len + t) * N : nullptr;
  });
  load_dt(dts, dt, b, t0, T_len, H, h0, nh, C, CP);
  __syncthreads();
  head_logs(l2s, dts, A, h0, nh, CP);
  const float* Gc = Gm + ((size_t)b * nc + c) * CP * CP;
  float* dBb =
      dBp + (((size_t)blockIdx.x * gridDim.z + b) * nc + c) * (size_t)C * N;
  const Op Cs{ch, cl, nw}, Gs{gh, gl, nw},
      Y{yb, F32 ? yb + CP * xw : nullptr, xw},
      X{xb, F32 ? xb + CP * xw : nullptr, xw};
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // l ready; the previous head's g, dy, x, rows consumed
    const float* gsrc = Gout + (((size_t)b * nc + c) * H + h) * hd * N;
    stage_split(gh, gl, nw, geo.HP, geo.NP, N, [=](int d) -> const float* {
      return d < hd ? gsrc + (size_t)d * N : nullptr;
    });
    stage_x<T>(yb, yb + CP * xw, xw, dy, b, t0, T_len, H, h, hd, C, CP,
               geo.HP);
    stage_x<T>(xb, xb + CP * xw, xw, xh, b, t0, T_len, H, h, hd, C, CP,
               geo.HP);
    if (!F32) cp_async_wait<0>();
    __syncthreads();
    const float* dw = dts + hh * CP;
    const float* lw = l2s + hh * CP;
    const float lL = lw[C - 1];
    strip_tiles(CP / 16, ncb, [&](int r0, int cb) {
      const int n0 = 32 * cb;
      float acc[NB][4] = {};  // (x g)[s][n]: x [s][d], g [d][n]
      mma_ss<NB, true, true>(acc, X, r0, Gs, n0, 0, geo.HP);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = r0 + g + 8 * r;
        const float e = dw[s] * ex2(lL - lw[s]);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          acc[j][2 * r] *= e;
          acc[j][2 * r + 1] *= e;
        }
      }
      float zc[2] = {0.f, 0.f};
      // + dS^T C, k over t from the strip's first row
      for (int k = r0; k < geo.CP; k += 16) {
        float sv[2][4] = {};  // x dy^T: dy stored [t][d]
        mma_ss<2, true, false>(sv, X, r0, Y, k, 0, geo.HP);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = r0 + g + 8 * (e >> 1);
            const int t = k + 8 * j + 2 * tq + (e & 1);
            const float v =
                t >= s ? sv[j][e] * dw[s] * ex2(lw[t] - lw[s]) : 0.f;
            sv[j][e] = v;
            if (cb == 0) zc[e >> 1] += v * __ldg(Gc + (size_t)t * CP + s);
          }
        uint32_t ah[4], al[4];
        to_a(sv, ah, al);
        mma_a<NB, true>(acc, ah, al, true, Cs, n0, k);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = r0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          if (s < C && n < N) {
            float* p = dBb + (size_t)s * N + n;
            const float2 o = hh ? *reinterpret_cast<float2*>(p)
                                : make_float2(0.f, 0.f);
            store2(p, o.x + acc[j][2 * r], o.y + acc[j][2 * r + 1]);
          }
        }
      if (cb == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          zc[r] = quad_sum(zc[r]);
          if (tq == 0) rz[r0 + g + 8 * r] = zc[r];
        }
      }
    });
    __syncthreads();
    float* tb = terms + (((size_t)b * nc + c) * H + h) * NTERMS * CP;
    for (int s = tid; s < CP; s += THREADS) tb[TERM_COLZ * CP + s] = rz[s];
  }
}

// final: one warp per (b, c, h): dl from the passes' terms and exp(L) <g, h>,
// its reverse cumsum dla, ddt = -A dla + D and the chunk's share of dA
__global__ void __launch_bounds__(THREADS)
ssd_bwd_final_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ Hin,
                     const float* __restrict__ Gout,
                     const float* __restrict__ terms, float* __restrict__ ddt,
                     float* __restrict__ dAp, int T_len, int H, int hd,
                     int N, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CP = round_up(C, 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, c = blockIdx.x, nc = gridDim.x, t0 = c * C;
  float* dts = reinterpret_cast<float*>(smem) + warp * 2 * CP;
  float* v = dts + CP;
  const int P4 = hd * N / 4;
  for (int h = warp; h < H; h += WARPS) {
    for (int s = lane; s < CP; s += 32) {
      const int t = t0 + s;
      dts[s] = (s < C && t < T_len) ? dt[((size_t)b * T_len + t) * H + h]
                                    : 0.f;
    }
    __syncwarp();
    warp_cumsum(v, dts, A[h], CP);
    __syncwarp();
    const float L = v[C - 1];
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const float4* gp = reinterpret_cast<const float4*>(Gout + bch * hd * N);
    const float4* hp = reinterpret_cast<const float4*>(Hin + bch * hd * N);
    float dec = 0.f;
    for (int q = lane; q < P4; q += 32) {
      const float4 a = gp[q], e = hp[q];
      dec += a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
    }
    dec = warp_sum(dec);
    const float* tb = terms + bch * NTERMS * CP;
    float sr = 0.f;
    __syncwarp();  // L read before v is overwritten
    for (int s = lane; s < CP; s += 32) {
      const float er = expf(L - v[s]) * tb[TERM_R * CP + s];
      sr += er;
      v[s] = tb[TERM_ROWZ * CP + s] - tb[TERM_COLZ * CP + s] +
             tb[TERM_Q * CP + s] + tb[TERM_Q1 * CP + s] - er;
    }
    sr = warp_sum(sr);
    __syncwarp();
    if (lane == 0) v[C - 1] += sr + expf(L) * dec;
    __syncwarp();
    warp_rev_cumsum(v, CP);
    __syncwarp();
    float da = 0.f;
    for (int s = lane; s < CP; s += 32) {
      const int t = t0 + s;
      if (s < C && t < T_len)
        ddt[((size_t)b * T_len + t) * H + h] =
            -A[h] * v[s] + tb[TERM_D * CP + s];
      da -= dts[s] * v[s];
    }
    da = warp_sum(da);
    if (lane == 0) dAp[bch] = da;
    __syncwarp();  // dts and v consumed before the next head
  }
}

// ---------------------------------------------------------------------------
// bf16 xh at hd 64, C 128, N 64 or 128 (what training sends): dx, and dC
// with dB in one launch, on wgmma with TMA-fed tiles (sm90.cuh)
// ---------------------------------------------------------------------------

constexpr int WG = 128;             // threads of a warpgroup
constexpr int WG_BLOCK = 3 * WG;    // two consumer warpgroups, one producer
constexpr int WHD = 64;             // the route's head dim
constexpr int WCH = 128;            // the route's chunk
constexpr int TILE = WCH * 64 * 2;  // bytes of a 128 x 64 bf16 tile
constexpr int PANEL = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 tile
constexpr int SPLITTERS = 3 * 32;   // producer threads that split fp32 states
constexpr int VEC = 1024;           // a stage's dt and l log2(e), 2 x 128 fp32

constexpr bool wgmma_route(bool f32, int hd, int N, int C) {
  return !f32 && hd == WHD && C == WCH && (N == 64 || N == 128);
}

// Shared memory (byte offsets; every tile on 1024 bytes, 128-byte swizzle).
// dcdb: B hi, B lo, C hi, C lo (128 rows, the block's 64 columns of N),
// then a ring of two stages, each a head's x and dy (128 x 64), its
// incoming state h and outgoing gradient g split hi and lo (64 x 64, the
// block's columns), its dt and l; the barriers; G_ts for s < t.
struct DcdbSmem {
  static constexpr int BC = 0, RING = 4 * TILE;
  static constexpr int X = 0, DY = TILE, HH = 2 * TILE, HL = HH + PANEL,
                       GH = HL + PANEL, GL = GH + PANEL, V = GL + PANEL;
  static constexpr int STAGE = V + VEC;
  static constexpr int BAR = RING + 2 * STAGE;
  static constexpr int GZ = BAR + 64;  // G's strict lower triangle, fp32
  static constexpr size_t BYTES = GZ + WCH * (WCH - 1) / 2 * 4 + 1024;
};
// dx: B hi, B lo (128 rows, all NP columns), then a ring of two stages,
// each a head's x and dy and its g split hi and lo (64 x NP), its dt and l.
template <int NP>
struct DxSmem {
  static constexpr int PN = NP / 64;  // 64-column panels of N
  static constexpr int BH = 0, BL = PN * TILE, RING = 2 * PN * TILE;
  static constexpr int X = 0, DY = TILE, GH = 2 * TILE, GL = GH + PN * PANEL,
                       V = GL + PN * PANEL;
  static constexpr int STAGE = V + VEC;
  static constexpr int BAR = RING + 2 * STAGE;
  static constexpr size_t BYTES = BAR + 8 * 5 + 1024;
};

// the byte offset of (row r, column col) in a 64-column swizzled panel
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
}
__device__ __forceinline__ float2 bf_pair(const unsigned char* tile, int r,
                                          int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + swz(r, col)));
}

// 8 fp32 values (a, e) of row r, columns 8 c16.. of a panel -> its hi and
// lo tiles (one 16-byte piece each)
__device__ __forceinline__ void split_piece(unsigned char* hi,
                                            unsigned char* lo, float4 a,
                                            float4 e, int r, int c16) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(a.x, a.y, h0, l0);
  split(a.z, a.w, h1, l1);
  split(e.x, e.y, h2, l2);
  split(e.z, e.w, h3, l3);
  const int off = swz(r, 8 * c16);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h0, h1, h2, h3);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l0, l1, l2, l3);
}

// pieces u, u + SPLITTERS, ... < n of 8 fp32 values each (`src(i)`) split
// into bf16 hi and lo tiles (`put(i, a, e)`): four pieces' loads in flight
// before any is split
template <typename Src, typename Put>
__device__ __forceinline__ void split_pieces(int n, int u, Src src, Put put) {
  for (int i0 = u; i0 < n; i0 += 4 * SPLITTERS) {
    float4 v[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * SPLITTERS;
      if (i < n) {
        const float* p = src(i);
        v[k][0] = __ldg(reinterpret_cast<const float4*>(p));
        v[k][1] = __ldg(reinterpret_cast<const float4*>(p + 4));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k * SPLITTERS < n) put(i0 + k * SPLITTERS, v[k][0], v[k][1]);
  }
}

// one warp: the head's dt (0 past T) and l log2(e) into a stage's vectors
__device__ __forceinline__ void head_vecs(float* v, const float* dt,
                                          const float* A, int b, int t0,
                                          int T_len, int H, int h) {
  const int lane = threadIdx.x & 31;
  float* l2 = v + WCH;
  for (int s = lane; s < WCH; s += 32) {
    const int t = t0 + s;
    v[s] = t < T_len ? dt[((size_t)b * T_len + t) * H + h] : 0.f;
  }
  __syncwarp();
  warp_cumsum(l2, v, A[h], WCH);
  __syncwarp();
  for (int s = lane; s < WCH; s += 32) l2[s] *= LOG2E;
}

// The producer warpgroup of both passes: its first thread loads the
// resident B / C planes once (`planes`: which of the four, `panels` of 64
// columns from column c0 each) and then each head's x and dy tiles by TMA;
// warps 1-3 split the head's fp32 states (`split(st, h)`) and warp 1 writes
// its dt and l; all of them arrive on the stage's `full` barrier.
template <typename Split>
__device__ __forceinline__ void produce(
    unsigned char* smem, int ring, int stage, int v_off, uint64_t* bc_full,
    uint64_t* full, uint64_t* empty, const CUtensorMap* tm_x,
    const CUtensorMap* tm_dy, const CUtensorMap* tm_bc, int planes,
    int panels, int c0, int bc_row, const float* dt, const float* A, int b,
    int t0, int T_len, int H, int h0, int nh, Split split) {
  sm90::regs_dec<88>();
  if (threadIdx.x == 2 * WG) {
    sm90::mbar_expect_tx(bc_full, planes * panels * TILE);
    for (int p = 0; p < planes; ++p)
      for (int q = 0; q < panels; ++q)
        sm90::tma_load_4d(smem + (p * panels + q) * TILE, tm_bc, bc_full,
                          c0 + 64 * q, 0, bc_row, p);
    for (int it = 0; it < nh; ++it) {
      const int s = it & 1;
      sm90::mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
      unsigned char* st = smem + ring + s * stage;
      sm90::mbar_expect_tx(&full[s], 2 * TILE);
      sm90::tma_load_4d(st, tm_x, &full[s], 0, t0, h0 + it, b);
      sm90::tma_load_4d(st + TILE, tm_dy, &full[s], 0, t0, h0 + it, b);
    }
  } else if (threadIdx.x >= 2 * WG + 32) {
    for (int it = 0; it < nh; ++it) {
      const int s = it & 1;
      sm90::mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
      unsigned char* st = smem + ring + s * stage;
      split(st, h0 + it, (int)threadIdx.x - (2 * WG + 32));
      if (threadIdx.x < 2 * WG + 64)
        head_vecs(reinterpret_cast<float*>(st + v_off), dt, A, b, t0, T_len,
                  H, h0 + it);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[s]);
    }
  }
}

__device__ __forceinline__ void init_bars(uint64_t* bc_full, uint64_t* full,
                                          uint64_t* empty) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(bc_full, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full[s], 1 + SPLITTERS);
      sm90::mbar_init(&empty[s], 2 * WG);
    }
    sm90::fence_init();
  }
  __syncthreads();
}

// accumulator entry i of a 64 x 64 wgmma tile, thread t of the warpgroup:
// row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) & 1), column 8 (i / 4) +
// 2 (t % 4) + (i & 1) (sm90.cuh)
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i & 1);
}
__device__ __forceinline__ bool frag_hi(int i) { return (i / 2) & 1; }

// dx on wgmma: one block per (batch, chunk, group of HG heads), warpgroup w
// the rows s in [64 w, 64 w + 64).  Per head: (B g^T) over N in three
// products (B and g split hi + lo), R_s = dt_s x_s . (g B_s), then dxd =
// exp(L - l_s) (B g^T) + W^T dy with W^T_st = G^T_st exp(l_t - l_s) for
// t >= s formed in registers from G^T (loaded once a block) and split hi +
// lo against dy, exact (two products); dx = dxd dt and D_s = dxd_s . x_s
// into `terms`.
template <int NP>
__global__ void __launch_bounds__(WG_BLOCK, 1)
ssd_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_dy,
                        const __grid_constant__ CUtensorMap tm_bc,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ GT,
                        const float* __restrict__ Gout,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ terms, int T_len, int H) {
  using L = DxSmem<NP>;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  uint64_t* bc_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bc_full + 1;
  uint64_t* empty = full + 2;
  const int c = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int h0 = blockIdx.x * HG, nh = min(H - h0, HG), t0 = c * WCH;
  init_bars(bc_full, full, empty);
  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    produce(smem, L::RING, L::STAGE, L::V, bc_full, full, empty, &tm_x,
            &tm_dy, &tm_bc, 2, L::PN, 0, b * nc + c, dt, A, b, t0, T_len, H,
            h0, nh, [&](unsigned char* st, int h, int u) {
              const float* g = Gout + (((size_t)b * nc + c) * H + h) * WHD * NP;
              split_pieces(
                  WHD * NP / 8, u, [&](int i) { return g + 8 * i; },
                  [&](int i, float4 a, float4 e) {
                    const int r = i / (NP / 8), cc = i % (NP / 8);
                    split_piece(st + L::GH + (cc / 8) * PANEL,
                                st + L::GL + (cc / 8) * PANEL, a, e, r,
                                cc % 8);
                  });
            });
    return;
  }
  sm90::regs_inc<208>();
  const int t = threadIdx.x % WG, warp = t / 32, q4 = t % 4;
  const int R0 = 64 * wg, ra = R0 + 16 * warp + (t % 32) / 4, rb = ra + 8;
  const bf* Bh = reinterpret_cast<const bf*>(smem + L::BH);
  const bf* Bl = reinterpret_cast<const bf*>(smem + L::BL);
  // G^T's tiles of this warpgroup's rows s and the key tiles t >= them
  float gt[2][32];
  const float* gtc = GT + ((size_t)b * nc + c) * WCH * WCH;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int j = wg + jj, r = frag_hi(i) ? rb : ra;
      float2 v = make_float2(0.f, 0.f);
      if (j < 2)
        v = *reinterpret_cast<const float2*>(gtc + (size_t)r * WCH + 64 * j +
                                             frag_col(i));
      gt[jj][i] = v.x;
      gt[jj][i + 1] = v.y;
    }
  sm90::mbar_wait(bc_full, 0);
  for (int it = 0; it < nh; ++it) {
    const int s = it & 1, h = h0 + it;
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    const bf* X = reinterpret_cast<const bf*>(st + L::X);
    const bf* DY = reinterpret_cast<const bf*>(st + L::DY);
    const bf* GH = reinterpret_cast<const bf*>(st + L::GH);
    const bf* GL = reinterpret_cast<const bf*>(st + L::GL);
    const float* dts = reinterpret_cast<const float*>(st + L::V);
    const float* l2 = dts + WCH;
    sm90::mbar_wait(&full[s], (it >> 1) & 1);
    float acc[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      sm90::wgmma_ss_n64(acc, sm90::desc_k(Bh + R0 * 64, WCH, kk),
                         sm90::desc_k(GH, 64, kk), kk);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      sm90::wgmma_ss_n64(acc, sm90::desc_k(Bh + R0 * 64, WCH, kk),
                         sm90::desc_k(GL, 64, kk), 1);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      sm90::wgmma_ss_n64(acc, sm90::desc_k(Bl + R0 * 64, WCH, kk),
                         sm90::desc_k(GH, 64, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    const float la = l2[ra], lb = l2[rb], lL = l2[WCH - 1];
    const float ea = ex2(lL - la), eb = ex2(lL - lb);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 xv = bf_pair(st + L::X, frag_hi(i) ? rb : ra, frag_col(i));
      rs[frag_hi(i)] += xv.x * acc[i] + xv.y * acc[i + 1];
      const float e = frag_hi(i) ? eb : ea;
      acc[i] *= e;
      acc[i + 1] *= e;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = wg + jj;
      if (j >= 2) break;
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kk + 2 * q, r = frag_hi(i) ? rb : ra;
          const int tj = 64 * j + frag_col(i);
          const float lr = frag_hi(i) ? lb : la;
          const float w0 =
              (j > wg || tj >= r) ? gt[jj][i] * ex2(l2[tj] - lr) : 0.f;
          const float w1 = (j > wg || tj + 1 >= r)
                               ? gt[jj][i + 1] * ex2(l2[tj + 1] - lr)
                               : 0.f;
          split(w0, w1, wh[kk][q], wl[kk][q]);
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(acc, wh[kk], sm90::desc_mn(DY + 64 * j * 64,
                                                        WCH, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(acc, wl[kk], sm90::desc_mn(DY + 64 * j * 64,
                                                        WCH, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(acc);
    float ds[2] = {0.f, 0.f};
    const float dta = dts[ra], dtb = dts[rb];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = frag_hi(i) ? rb : ra, col = frag_col(i);
      const float2 xv = bf_pair(st + L::X, r, col);
      ds[frag_hi(i)] += xv.x * acc[i] + xv.y * acc[i + 1];
      const float d = frag_hi(i) ? dtb : dta;
      if (t0 + r < T_len)
        store2(dx + (((size_t)b * T_len + t0 + r) * H + h) * WHD + col,
               acc[i] * d, acc[i + 1] * d);
    }
    float* tb = terms + (((size_t)b * nc + c) * H + h) * NTERMS * WCH;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float r = quad_sum(rs[e]) * (e ? dtb : dta);
      const float d = quad_sum(ds[e]);
      if (q4 == 0) {
        const int row = e ? rb : ra;
        tb[TERM_R * WCH + row] = r;
        tb[TERM_D * WCH + row] = d;
      }
    }
    sm90::mbar_arrive(&empty[s]);
  }
}

// dC and dB on wgmma: one block per (64 columns of N, batch, chunk, group of
// HG heads), warpgroup w the rows [64 w, 64 w + 64) of both.  Per head,
// its share of dC, exp(l_t) (dy h)_t + sum_{s<=t} dS_ts B_s, in a
// temporary (h split hi + lo against dy, exact: two products; dS = dy x^T,
// masked and scaled in registers, split hi + lo against B: three), Q_t
// from its first part's row dot with C_t into `terms`; then added into
// dC's accumulator.  dB's share,
// dt_s exp(L - l_s) (x g)_s into the accumulator through a temporary, and
// sum_{t>=s} dS_ts C_t with dS^T = x dy^T straight into it.  dS and dS^T
// are formed once a head and tile; Z_ts = dS_ts G_ts summed over s from the
// fp32 dS tiles (the first column block of N) and over t from the dS^T
// tiles (the last), s < t, into `terms`.  The heads are
// summed in the accumulators in head order, written once into the block's
// slice of the (groups, B, nc C, N) scratches.  ptxas serializes this kernel's products
// (its note C7514: the temporary is scaled while the next product runs);
// retiring every product first removed the note and ran 7% slower.
__global__ void __launch_bounds__(WG_BLOCK, 1)
ssd_bwd_dcdb_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_dy,
                          const __grid_constant__ CUtensorMap tm_bc,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Hin,
                          const float* __restrict__ Gout,
                          const float* __restrict__ GT,
                          float* __restrict__ dBp, float* __restrict__ dCp,
                          float* __restrict__ terms, int T_len, int H,
                          int N) {
  using L = DcdbSmem;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  uint64_t* bc_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bc_full + 1;
  uint64_t* empty = full + 2;
  const int nnb = N / 64, nb = blockIdx.x % nnb, grp = blockIdx.x / nnb;
  const int c = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int h0 = grp * HG, nh = min(H - h0, HG), t0 = c * WCH;
  init_bars(bc_full, full, empty);
  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    produce(smem, L::RING, L::STAGE, L::V, bc_full, full, empty, &tm_x,
            &tm_dy, &tm_bc, 4, 1, 64 * nb, b * nc + c, dt, A, b, t0, T_len,
            H, h0, nh, [&](unsigned char* st, int h, int u) {
              const size_t at =
                  (((size_t)b * nc + c) * H + h) * WHD * N + 64 * nb;
              split_pieces(
                  2 * WHD * 8, u,
                  [&](int i) {
                    return (i >= WHD * 8 ? Gout : Hin) + at +
                           (size_t)((i / 8) % WHD) * N + 8 * (i % 8);
                  },
                  [&](int i, float4 a, float4 e) {
                    const bool m = i >= WHD * 8;
                    split_piece(st + (m ? L::GH : L::HH),
                                st + (m ? L::GL : L::HL), a, e,
                                (i / 8) % WHD, i % 8);
                  });
            });
    return;
  }
  sm90::regs_inc<208>();
  const int t = threadIdx.x % WG, warp = t / 32, q4 = t % 4;
  const int R0 = 64 * wg, ra = R0 + 16 * warp + (t % 32) / 4, rb = ra + 8;
  const bf* Bh = reinterpret_cast<const bf*>(smem + L::BC);
  const bf* Bl = reinterpret_cast<const bf*>(smem + L::BC + TILE);
  const bf* Ch = reinterpret_cast<const bf*>(smem + L::BC + 2 * TILE);
  const bf* Cl = reinterpret_cast<const bf*>(smem + L::BC + 3 * TILE);
  // Z's row sums taken by the first column block, its column sums by the
  // last, from G_ts for s < t in shared memory, packed by rows (t (t - 1) /
  // 2 + s) from G^T (row s holds G_ts for every t) once a block.  Z's
  // diagonal is left out of both sums: dl takes only their difference.
  const bool zrow = nb == 0, zcol = nb == nnb - 1;
  float* gz = reinterpret_cast<float*>(smem + L::GZ);
  {
    const float4* g4 = reinterpret_cast<const float4*>(
        GT + ((size_t)b * nc + c) * WCH * WCH);
    float4 v[WCH * WCH / 4 / (2 * WG)];
#pragma unroll
    for (int k = 0; k < WCH * WCH / 4 / (2 * WG); ++k)
      v[k] = __ldg(g4 + threadIdx.x + 2 * WG * k);
#pragma unroll
    for (int k = 0; k < WCH * WCH / 4 / (2 * WG); ++k) {
      const int e = threadIdx.x + 2 * WG * k, sr = e / (WCH / 4);
      const float vk[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tq = 4 * (e % (WCH / 4)) + q;
        if (sr < tq) gz[tq * (tq - 1) / 2 + sr] = vk[q];
      }
    }
    // the two consumer warpgroups only (the producer runs on)
    asm volatile("bar.sync 1, %0;" ::"n"(2 * WG) : "memory");
  }
  float dCs[32], dBs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dCs[i] = dBs[i] = 0.f;
  sm90::mbar_wait(bc_full, 0);
  for (int it = 0; it < nh; ++it) {
    const int s = it & 1, h = h0 + it;
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    const bf* X = reinterpret_cast<const bf*>(st + L::X);
    const bf* DY = reinterpret_cast<const bf*>(st + L::DY);
    const float* dts = reinterpret_cast<const float*>(st + L::V);
    const float* l2 = dts + WCH;
    sm90::mbar_wait(&full[s], (it >> 1) & 1);
    const float la = l2[ra], lb = l2[rb], lL = l2[WCH - 1];
    float* tb = terms + (((size_t)b * nc + c) * H + h) * NTERMS * WCH;
    float tmp[32], sv[32], zs[2] = {0.f, 0.f};
    uint32_t ah[4][4], al[4][4];
    // dC's share: exp(l_t) (dy h)_t, then + dS B tile by tile (s <= t)
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64_t(tmp, sm90::desc_k(DY + R0 * 64, WCH, kk),
                           sm90::desc_mn(reinterpret_cast<const bf*>(
                                             st + L::HH), 64, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64_t(tmp, sm90::desc_k(DY + R0 * 64, WCH, kk),
                           sm90::desc_mn(reinterpret_cast<const bf*>(
                                             st + L::HL), 64, kk), 1);
    sm90::wgmma_commit();
    for (int j = 0; j <= wg; ++j) {
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_n64(sv, sm90::desc_k(DY + R0 * 64, WCH, kk),
                           sm90::desc_k(X + 64 * j * 64, WCH, kk), kk);
      sm90::wgmma_commit();
      if (j == 0) {
        sm90::wgmma_wait<1>();
        sm90::fence_regs(tmp);
        const float ea = ex2(la), eb = ex2(lb);
#pragma unroll
        for (int i = 0; i < 32; ++i) tmp[i] *= frag_hi(i) ? eb : ea;
        // Q over this block's columns: C_t . exp(l_t) (dy h)_t
        float zq[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = frag_hi(i) ? rb : ra, col = frag_col(i);
          const float2 h2 = bf_pair(smem + L::BC + 2 * TILE, r, col);
          const float2 l2c = bf_pair(smem + L::BC + 3 * TILE, r, col);
          zq[frag_hi(i)] +=
              (h2.x + l2c.x) * tmp[i] + (h2.y + l2c.y) * tmp[i + 1];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = quad_sum(zq[e]);
          if (q4 == 0) {
            const int row = e ? rb : ra;
            tb[(nb ? TERM_Q1 : TERM_Q) * WCH + row] = z;
            if (nnb == 1) tb[TERM_Q1 * WCH + row] = 0.f;
          }
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sv);
      // dS_ts = (dy_t . x_s) dt_s exp(l_t - l_s), s <= t; Z's row sum
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int sj = 64 * j + frag_col(i), r = frag_hi(i) ? rb : ra;
        const bool in = j < wg || sj <= r;
        sv[i] = in ? sv[i] * dts[sj] * ex2((frag_hi(i) ? lb : la) - l2[sj])
                   : 0.f;
        if (zrow && sj < r) zs[frag_hi(i)] += sv[i] * gz[r * (r - 1) / 2 + sj];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(sv[8 * kk + 2 * q], sv[8 * kk + 2 * q + 1], ah[kk][q],
                al[kk][q]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(tmp, ah[kk],
                             sm90::desc_mn(Bh + 64 * j * 64, WCH, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(tmp, ah[kk],
                             sm90::desc_mn(Bl + 64 * j * 64, WCH, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(tmp, al[kk],
                             sm90::desc_mn(Bh + 64 * j * 64, WCH, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    if (zrow) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = quad_sum(zs[e]);
        if (q4 == 0) tb[TERM_ROWZ * WCH + (e ? rb : ra)] = z;
        zs[e] = 0.f;
      }
    }
    sm90::fence_regs(tmp);
    sm90::fence_regs(dCs);
#pragma unroll
    for (int i = 0; i < 32; ++i) dCs[i] += tmp[i];
    // dB's share: dt_s exp(L - l_s) (x g)_s, then + dS^T C tile by tile
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64_t(tmp, sm90::desc_k(X + R0 * 64, WCH, kk),
                           sm90::desc_mn(reinterpret_cast<const bf*>(
                                             st + L::GH), 64, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64_t(tmp, sm90::desc_k(X + R0 * 64, WCH, kk),
                           sm90::desc_mn(reinterpret_cast<const bf*>(
                                             st + L::GL), 64, kk), 1);
    sm90::wgmma_commit();
    for (int j = wg; j < 2; ++j) {
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_n64(sv, sm90::desc_k(X + R0 * 64, WCH, kk),
                           sm90::desc_k(DY + 64 * j * 64, WCH, kk), kk);
      sm90::wgmma_commit();
      if (j == wg) {
        sm90::wgmma_wait<1>();
        sm90::fence_regs(tmp);
        sm90::fence_regs(dBs);
        const float fa = dts[ra] * ex2(lL - la), fb = dts[rb] * ex2(lL - lb);
#pragma unroll
        for (int i = 0; i < 32; ++i) dBs[i] += tmp[i] * (frag_hi(i) ? fb : fa);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sv);
      // dS^T_st = (x_s . dy_t) dt_s exp(l_t - l_s), t >= s; Z's column
      // sum
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int tj = 64 * j + frag_col(i), r = frag_hi(i) ? rb : ra;
        const bool in = j > wg || tj >= r;
        sv[i] = in ? sv[i] * dts[r] * ex2(l2[tj] - (frag_hi(i) ? lb : la))
                   : 0.f;
        if (zcol && r < tj)
          zs[frag_hi(i)] += sv[i] * gz[tj * (tj - 1) / 2 + r];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(sv[8 * kk + 2 * q], sv[8 * kk + 2 * q + 1], ah[kk][q],
                al[kk][q]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(dBs, ah[kk],
                             sm90::desc_mn(Ch + 64 * j * 64, WCH, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(dBs, ah[kk],
                             sm90::desc_mn(Cl + 64 * j * 64, WCH, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n64_t(dBs, al[kk],
                             sm90::desc_mn(Ch + 64 * j * 64, WCH, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    if (zcol) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = quad_sum(zs[e]);
        if (q4 == 0) tb[TERM_COLZ * WCH + (e ? rb : ra)] = z;
      }
    }
    sm90::mbar_arrive(&empty[s]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dCs);
  sm90::fence_regs(dBs);
  const size_t slice =
      (((size_t)grp * gridDim.z + b) * nc + c) * (size_t)WCH * N + 64 * nb;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const size_t at =
        slice + (size_t)(frag_hi(i) ? rb : ra) * N + frag_col(i);
    store2(dCp + at, dCs[i], dCs[i + 1]);
    store2(dBp + at, dBs[i], dBs[i + 1]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int max_smem) {
  if (bytes > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the wgmma route's dx and merged dC / dB launches, after gram (which left
// G^T and the B / C planes), chunk and state
int launch_wgmma(const void* xh, const void* dt, const void* A,
                 const void* dy, void* dx, void* dBp, void* dCp,
                 const void* hin, const void* gram, const void* gout,
                 void* terms, int B, int T_len, int H, int N, int nc,
                 int max_smem, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t s_dx = N == 64 ? DxSmem<64>::BYTES : DxSmem<128>::BYTES;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_dx_wgmma_kernel<64>, DxSmem<64>::BYTES,
                        max_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dx_wgmma_kernel<128>, DxSmem<128>::BYTES,
                        max_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dcdb_wgmma_kernel, DcdbSmem::BYTES,
                        max_smem)) != cudaSuccess)
    return (int)err;
  // byte strides: x and dy (hd, T, H, B); the planes (N, CP, B nc, 4)
  const long long e = sizeof(bf);
  const bf* planes = reinterpret_cast<const bf*>(
      (const float*)gram + (size_t)B * nc * WCH * WCH);
  CUtensorMap m_x, m_dy, m_bc;
  if ((err = sm90::tile_map(&m_x, xh, WHD, T_len, H, B, (long long)H * WHD * e,
                            WHD * e, (long long)T_len * H * WHD * e, WCH)) !=
          cudaSuccess ||
      (err = sm90::tile_map(&m_dy, dy, WHD, T_len, H, B,
                            (long long)H * WHD * e, WHD * e,
                            (long long)T_len * H * WHD * e, WCH)) !=
          cudaSuccess ||
      (err = sm90::tile_map(&m_bc, planes, N, WCH, (long long)B * nc, 4,
                            N * e, (long long)WCH * N * e,
                            (long long)B * nc * WCH * N * e, WCH)) !=
          cudaSuccess)
    return (int)err;
  const int groups = (H + HG - 1) / HG;
  const dim3 grid(groups, nc, B);
  if (N == 64)
    ssd_bwd_dx_wgmma_kernel<64><<<grid, WG_BLOCK, s_dx, s>>>(
        m_x, m_dy, m_bc, (const float*)dt, (const float*)A,
        (const float*)gram, (const float*)gout, (bf*)dx, (float*)terms,
        T_len, H);
  else
    ssd_bwd_dx_wgmma_kernel<128><<<grid, WG_BLOCK, s_dx, s>>>(
        m_x, m_dy, m_bc, (const float*)dt, (const float*)A,
        (const float*)gram, (const float*)gout, (bf*)dx, (float*)terms,
        T_len, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dcdb_wgmma_kernel<<<dim3(groups * (N / 64), nc, B), WG_BLOCK,
                              DcdbSmem::BYTES, s>>>(
      m_x, m_dy, m_bc, (const float*)dt, (const float*)A, (const float*)hin,
      (const float*)gout, (const float*)gram, (float*)dBp, (float*)dCp,
      (float*)terms, T_len, H, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xh, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* hin, const void* dy,
           const void* dhfin, void* dh0, void* dx, void* ddt, void* dAp,
           void* dBp, void* dCp, void* gram, void* gout, void* terms,
           void* last, int B, int T_len, int H, int hd, int N, int C,
           void* stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  // 16-byte pieces of x and dy rows, float2 pairs of B and C, float4s of
  // the states
  if (hd % 8 || N % 4) return (int)cudaErrorInvalidValue;
  const bool wg = wgmma_route(F32, hd, N, C);
  const BGeo geo(C, N, hd);
  const size_t s_gram = geo.gram_bytes(), s_chunk = geo.chunk_bytes(F32),
               s_dx = geo.dx_bytes(F32), s_dbc = geo.dbc_bytes(F32),
               s_final = 2 * (size_t)WARPS * geo.CP * 4;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_gram_kernel, s_gram, max_smem)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_bwd_chunk_kernel<T>, s_chunk, max_smem)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_bwd_final_kernel, s_final, max_smem)) !=
          cudaSuccess)
    return (int)err;
  if (!wg &&
      ((err = allow_smem(ssd_bwd_dx_kernel<T>, s_dx, max_smem)) !=
           cudaSuccess ||
       (err = allow_smem(ssd_bwd_dc_kernel<T>, s_dbc, max_smem)) !=
           cudaSuccess ||
       (err = allow_smem(ssd_bwd_db_kernel<T>, s_dbc, max_smem)) !=
           cudaSuccess))
    return (int)err;
  const int nc = (T_len + C - 1) / C;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((H + HG - 1) / HG, nc, B);
  __nv_bfloat16* planes =
      wg ? reinterpret_cast<__nv_bfloat16*>((float*)gram +
                                            (size_t)B * nc * WCH * WCH)
         : nullptr;
  ssd_bwd_gram_kernel<<<dim3(nc, B), THREADS, s_gram, s>>>(
      (const float*)Bm, (const float*)Cm, (float*)gram, planes, T_len, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<T><<<grid, THREADS, s_chunk, s>>>(
      (const T*)dy, (const float*)dt, (const float*)A, (const float*)Cm,
      (float*)gout, (float*)last, T_len, H, hd, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_state = (size_t)B * H * hd * N / 4;
  ssd_bwd_state_kernel<<<(unsigned)((n_state + 255) / 256), 256, 0, s>>>(
      (float4*)gout, (const float*)last, (const float4*)dhfin, (float4*)dh0,
      B, nc, H, hd * N / 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!F32) {
    if (wg) {
      const int r = launch_wgmma(xh, dt, A, dy, dx, dBp, dCp, hin, gram,
                                 gout, terms, B, T_len, H, N, nc, max_smem,
                                 s);
      if (r != 0) return r;
    }
  }
  if (!wg) {
    ssd_bwd_dx_kernel<T><<<grid, THREADS, s_dx, s>>>(
        (const T*)xh, (const T*)dy, (const float*)dt, (const float*)A,
        (const float*)Bm, (const float*)gram, (const float*)gout, (T*)dx,
        (float*)terms, T_len, H, hd, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dc_kernel<T><<<grid, THREADS, s_dbc, s>>>(
        (const T*)xh, (const T*)dy, (const float*)dt, (const float*)A,
        (const float*)Bm, (const float*)Cm, (const float*)gram,
        (const float*)hin, (float*)dCp, (float*)terms, T_len, H, hd, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_db_kernel<T><<<grid, THREADS, s_dbc, s>>>(
        (const T*)xh, (const T*)dy, (const float*)dt, (const float*)A,
        (const float*)Cm, (const float*)gram, (const float*)gout,
        (float*)dBp, (float*)terms, T_len, H, hd, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_bwd_final_kernel<<<dim3(nc, B), THREADS, s_final, s>>>(
      (const float*)dt, (const float*)A, (const float*)hin,
      (const float*)gout, (const float*)terms, (float*)ddt, (float*)dAp,
      T_len, H, hd, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// hin: the forward's per-chunk incoming states (B, nc, H, hd, N) fp32 (the
// first chunk's is the forward's h0, which the dt and A terms and dC read);
// dhfin: the final state's gradient (B, H, hd, N) fp32, or null for zeros;
// dh0: where the incoming state's gradient (B, H, hd, N) fp32 goes, or null
// where it is not wanted.
// Outputs: dx in xh's dtype, ddt (B, T, H), dAp (B, nc, H) the chunks'
// shares of dA, dBp and dCp (groups of HG heads, B, nc C, N) the groups'
// shares of dB and dC, all fp32.  Scratch, fp32: gram (B, nc, CP, CP), for
// bf16 xh followed by room for 4 (B, nc, CP, N) bf16 planes (the wgmma
// route's split B and C), gout (B, nc, H, hd, N), terms (B, nc, H, 6, CP),
// last (B, nc, H), with CP the chunk rounded up to 32.  hd % 8 == 0, N % 4
// == 0, every pointer 16-byte aligned.
extern "C" int ssd_scan_bwd_f32(
    const void* xh, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* hin, const void* dy, const void* dhfin,
    void* dh0, void* dx, void* ddt, void* dAp, void* dBp, void* dCp,
    void* gram, void* gout, void* terms, void* last, int B, int T, int H,
    int hd, int N, int C, void* stream) {
  return launch<float>(xh, dt, A, Bm, Cm, hin, dy, dhfin, dh0, dx, ddt, dAp,
                       dBp, dCp, gram, gout, terms, last, B, T, H, hd, N, C,
                       stream);
}

extern "C" int ssd_scan_bwd_bf16(
    const void* xh, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* hin, const void* dy, const void* dhfin,
    void* dh0, void* dx, void* ddt, void* dAp, void* dBp, void* dCp,
    void* gram, void* gout, void* terms, void* last, int B, int T, int H,
    int hd, int N, int C, void* stream) {
  return launch<__nv_bfloat16>(xh, dt, A, Bm, Cm, hin, dy, dhfin, dh0, dx,
                               ddt, dAp, dBp, dCp, gram, gout, terms, last, B,
                               T, H, hd, N, C, stream);
}

// the dynamic shared memory of each launch at (C, N, hd), xh in fp32 or
// not, into out[0..5]: gram, chunk, dx, dc, db, final (bytes); on the
// wgmma route (returns 1) dc is the merged dC and dB launch and db 0
extern "C" int ssd_scan_bwd_smem(int C, int N, int hd, int f32,
                                 unsigned long long* out) {
  const BGeo geo(C, N, hd);
  const bool wg = wgmma_route(f32, hd, N, C);
  out[0] = geo.gram_bytes();
  out[1] = geo.chunk_bytes(f32);
  out[2] = !wg ? geo.dx_bytes(f32)
               : N == 64 ? DxSmem<64>::BYTES : DxSmem<128>::BYTES;
  out[3] = wg ? DcdbSmem::BYTES : geo.dbc_bytes(f32);
  out[4] = wg ? 0 : geo.dbc_bytes(f32);
  out[5] = 2 * (size_t)WARPS * geo.CP * 4;
  return wg;
}
