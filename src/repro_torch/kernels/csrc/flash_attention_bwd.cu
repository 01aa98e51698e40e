// Flash attention backward (causal and/or sliding window, GQA) for Hopper
// (sm_90a).
//
// The gradient of the forward in flash_attention.cu, which replaces the TPU
// kernel `flash_attention` (src/repro/kernels/flash_attention.py, `_kernel`).
// The TPU kernel has no backward: the reference trains through its jnp
// attention (src/repro/models/layers.py, `blockwise_attention`, which
// recomputes each chunk in the VJP), while the port's models route
// attention through the forward kernel, so on the card training needs this
// one.  For q (B, H, Tq, hd), k, v (B, Hk, Tk, hd), the forward's output o
// and its per-row log-sum-exp lse (B, H, Tq) fp32, and dO = dL/do, it writes
// dQ, dK and dV of o = softmax(qs k^T + mask) v, qs = q * scale rounded to
// the input dtype as the forward rounds it, with the forward's masks
// (causal, window with or without causal, keys past Tk) and GQA (query head
// h reads kv head h / (H / Hk)), in the shifted frame of csrc/attn_mask.cuh
// (query row i at position q_offset + i, keys below kv_start hidden, whose
// dK and dV are zeros).  P is recomputed from lse, never stored:
// P = exp(qs k^T - lse), masked entries 0.
//
// Three launches on one stream, no float atomics, so the result does not
// depend on the order blocks run in (a resumed training run repeats an
// uninterrupted one):
//   1. delta: D = rowsum(dO o) per query row, fp32 scratch (on the wgmma
//      route also qs and lse, see below);
//   2. dK, dV: a block per key tile of one (b, kv head) walks every query
//      tile that can see it, for each of the H / Hk query heads of its
//      group, in a fixed order:
//        dV += P^T dO,  dS = P (dO v^T - D),  dK += dS^T qs;
//   3. dQ: a block per query tile of one (b, h) walks the key tiles it can
//      see: dQ += dS k, and dQ * scale at the end (the derivative of qs).
// Each pass recomputes S = qs k^T and dO v^T for its tiles (the second
// recomputation is the price of writing dQ without atomics).
//
// What bounds it: the work is about 2.5 times the forward's operations
// (five products against two: S recomputed, dO v^T, dV, dK, dQ), 10 hd
// flops per visible (query, key) pair, against the bytes of q, k, v, o,
// dO read once and dQ, dK, dV written once.  At qwen2-1.5b's training shape
// (B 8, H 12 over 2 kv heads, T 2,048, hd 128, causal, bf16) that is 0.26
// TFLOP against 0.16 GB: the operations bound it (0.26 ms at the bf16
// tensor-core peak).
//
// Design, bf16 at hd 64, 80, 128 and 256 (every shape training gives it:
// qwen2's hd 128, whisper's 64, zamba2's 80, gemma3's 256):
// warp-specialized blocks on Hopper's `wgmma` with tiles fed by TMA
// (csrc/sm90.cuh).  A block is two consumer warpgroups of 64 rows each (hd
// 256: below) and one producer warpgroup, whose first thread
// keeps a ring of stages in flight (TMA boxes of 64 x 64 bf16 with 128-byte
// swizzle, completed on mbarriers; setmaxnreg gives the consumers 240
// registers and the producer 24).  hd 80 runs at the width of two whole
// panels (128): the tensor maps zero-fill the columns past hd, which add
// exact zeros to S and dP, products of depth hd take ceil(hd / 16) k16
// slices, and the padded columns of dK, dV and dQ are never stored.  A prep
// launch writes qs = q * scale in bf16 and 64-row tiles of lse (times log2
// e) and D, so every operand is a TMA load.  The dK/dV block owns 128 keys,
// loads its K and V once, and streams the query tiles (qs, dO, lse, D) of
// every query head of its group; each consumer computes S^T = K qs^T and
// dP^T = V dO^T with both operands in shared memory, so P^T and dS^T land in
// its registers in the layout of the A operand of dV += P^T dO and dK +=
// dS^T qs, whose B operands dO and qs are the same tiles read through
// wgmma's transpose bit.  The dQ block owns 128 queries and streams the key
// tiles.  Blocks and warpgroup blocks of 64 x 64 that the mask hides are
// skipped; only those it cuts are masked.  P and dS are rounded to bf16 as
// product operands (the forward rounds P so too); everything else
// accumulates in fp32.  Within a stage each warpgroup computes P while dP's
// product runs and dS while dV's runs (wgmma.wait_group 1), into registers
// of their own, and retires all its products before the next stage; the
// other warpgroup fills the tensor cores meanwhile.  What still separates it
// from its bound: that wait at the end of each stage (carrying a product
// across it made ptxas serialize every wgmma, its note C7515, and cost
// 1.2x), the second recomputation of S and dP, and the exp and mask work,
// which at hd 64 costs as much as the products.  The code generated for these
// loops is fragile: the same arithmetic with P's mask written as a
// conditional expression and no wait after the loop ran 1.6x slower with no
// note from ptxas (tools/time_attention_bwd.py times a change against the
// last build).
//
// bf16 at hd 256 (gemma3's), the same three launches on `wgmma` with the
// work split otherwise (Wg256, fa_bwd_*_wgmma256_kernel).  A 64-row tile is
// 32 KB there (four panels), and a consumer holding dK and dV of 64 keys
// at the full width would need 256 fp32 accumulator registers a thread,
// over setmaxnreg's 240.  So the dK/dV block owns 64 keys and gives each
// consumer one gradient at the full width (n256, 128 registers): warpgroup
// 0 computes S^T and P^T, hands P^T across in fp32 through shared memory
// (an mbarrier pair), and accumulates dV += P^T dO; warpgroup 1 computes
// dP^T, takes P^T, forms dS^T = P^T (dP^T - D) and accumulates dK += dS^T
// qs.  Its shared memory: K and V (64 KB), two stages of (qs, dO, lse, D)
// (129 KB), P (16 KB).  The dQ block owns 64 queries of each of two query
// heads of one kv group, a warpgroup each at the full width, so the two
// share every K and V tile, which come apart through a ring of three 32 KB
// slots (V released after dP, K after dQ); its shared memory: qs and dO of
// both heads (128 KB) and the ring (96 KB).  Where H / Hk is odd the last
// pair has one head and its second warpgroup idles.  At hd^-0.5 = 1/16 the
// passes read q itself (q * scale is exact in bf16, and a power of two
// commutes with every fp32 rounding) and take S and dK times the scale, so
// the prep launch writes no qs.  Measured slower on an H100 at gemma3's
// global training layer (tools/time_attention_bwd.py, in turns; PERF.md
// has the times): both consumers computing S^T and dP^T, each keeping half
// of the columns (11 products of 64 x 64 x 256 a tile pair where the bound
// counts 5); the two scores exchanged both ways behind named barriers (the
// warpgroups then wait on each other every stage); dQ split over 32 keys
// a warpgroup with two partials summed.  An mbarrier wait between two
// wgmma groups of a warpgroup made ptxas serialize every wgmma (its note
// C7520, 12% of the dQ pass), so K and V are both waited for before the
// products.
//
// bf16 at hd 16 and 32: the FlashAttention-2 backward on `mma.sync`
// (m16n8k16 bf16 -> fp32, fed by `ldmatrix` from bf16 tiles in shared
// memory, rows padded by 16 B), 4 warps a block and 16 rows a warp, the
// same products as above with P^T and dS^T in the warp's registers.
//
// fp32 inputs (and bf16 at hd 8) take the fp32-FMA kernels:
// tiles of 32 query rows and 32 keys (16 at hd 256) staged in shared
// memory in fp32, 256 threads a block, each thread a 2 x 2 block of a
// 32 x 32 score tile (rows r, r + 16, columns c, c + 16) read as 16-byte
// pieces along hd from rows padded by 16 bytes (the eight rows a
// quarter-warp reads fall in distinct banks), and hd / 4 * 32 / 256
// 16-byte pieces of each accumulated gradient row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attn_mask.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // threads a block of the fp32 kernels

struct Strides {  // in elements; hd has stride 1
  long long b, h, t;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Per head dim: BT query rows and keys a tile, fp32 rows of LD floats in
// shared memory (hd + 4: 16-byte aligned, neighbouring rows 4 banks apart),
// and the 16-byte pieces of a row each thread accumulates.
template <int HD>
struct BwdTile {
  static constexpr int BT = HD >= 256 ? 16 : 32;
  static constexpr int M = BT / 16;        // score rows (and columns) a thread
  static constexpr int LD = HD + 4;
  static constexpr int PLD = BT + 1;       // P and dS rows
  static constexpr int NG = HD / 4;        // 16-byte pieces of a row
  static constexpr int NPT = (BT * NG + NT - 1) / NT;  // pieces a thread
  static_assert(HD % 4 == 0, "rows are whole 16-byte pieces");
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)4 * BT * LD + 2 * BT * PLD + 2 * BT);
};

// rows [row0, row0 + BT) of a (T, HD) slab in the input dtype -> fp32 rows
// of LD in shared memory, rows at or past `limit` as zeros; `scale` > 0
// scales and rounds to the input dtype (qs, as the forward makes it)
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long st, int row0, int limit,
                                          float scale) {
  using TL = BwdTile<HD>;
  for (int i = threadIdx.x; i < TL::BT * HD; i += NT) {
    const int r = i / HD, d = i % HD, t = row0 + r;
    float x = 0.f;
    if (t < limit) {
      x = to_f(src[(long long)t * st + d]);
      if (scale > 0.f) x = to_f(from_f<T>(x * scale));
    }
    dst[r * TL::LD + d] = x;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The score tile of the staged query rows (qs, dO, lse, D) against the
// staged keys (k, v): P = exp(qs k^T - lse) and dS = P (dO v^T - D), both
// zero where the mask hides the pair, into ps and dss (BT x PLD).
template <int HD>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, float* ps, float* dss, int q0,
    int k0, int Tq, int Tk, AttnMask mk) {
  using TL = BwdTile<HD>;
  constexpr int M = TL::M, LD = TL::LD;
  const int ri = threadIdx.x / 16, cj = threadIdx.x % 16;
  float s[M][M], dp[M][M];
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int c = 0; c < M; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qa[M], oa[M], kc[M], vc[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(qs + (ri + 16 * a) * LD + d);
      oa[a] = *reinterpret_cast<const float4*>(dos + (ri + 16 * a) * LD + d);
      kc[a] = *reinterpret_cast<const float4*>(ks + (cj + 16 * a) * LD + d);
      vc[a] = *reinterpret_cast<const float4*>(vs + (cj + 16 * a) * LD + d);
    }
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        s[a][c] = dot4(qa[a], kc[c], s[a][c]);
        dp[a][c] = dot4(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int i = ri + 16 * a, j = cj + 16 * c;
      const int qi = q0 + i, kp = k0 + j;
      const bool vis = mk.visible(qi, kp, qi < Tq && kp < Tk);
      const float p = vis ? __expf(s[a][c] - lse_s[i]) : 0.f;
      ps[i * TL::PLD + j] = p;
      dss[i * TL::PLD + j] = p * (dp[a][c] - d_s[i]);
    }
}

// shared memory: qs, dO, k, v (BT x LD each), P, dS (BT x PLD), lse, D
struct Smem {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse, *d;
};

template <int HD>
__device__ __forceinline__ Smem carve(float* base) {
  using TL = BwdTile<HD>;
  Smem m;
  m.qs = base;
  m.dos = m.qs + TL::BT * TL::LD;
  m.ks = m.dos + TL::BT * TL::LD;
  m.vs = m.ks + TL::BT * TL::LD;
  m.ps = m.vs + TL::BT * TL::LD;
  m.dss = m.ps + TL::BT * TL::PLD;
  m.lse = m.dss + TL::BT * TL::PLD;
  m.d = m.lse + TL::BT;
  return m;
}

// the query rows' qs, dO, lse and D of (b, h) from row q0
template <typename T, int HD>
__device__ __forceinline__ void load_queries(
    const Smem& m, const T* q, const T* dout, const float* lse,
    const float* delta, Strides sq, Strides sdo, int b, int h, int H,
    int q0, int Tq, float scale) {
  using TL = BwdTile<HD>;
  load_rows<T, HD>(m.qs, q + b * sq.b + h * sq.h, sq.t, q0, Tq, scale);
  load_rows<T, HD>(m.dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq, 0.f);
  const long long row = ((long long)b * H + h) * Tq;
  for (int i = threadIdx.x; i < TL::BT; i += NT) {
    const bool ok = q0 + i < Tq;
    m.lse[i] = ok ? lse[row + q0 + i] : 0.f;
    m.d[i] = ok ? delta[row + q0 + i] : 0.f;
  }
}

// 1. D = rowsum(dO o), one warp a row
template <typename T>
__global__ void __launch_bounds__(NT)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, Strides so, Strides sdo, int H,
                    int Tq, int hd) {
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (qi >= Tq) return;
  const T* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
  const T* drow = dout + b * sdo.b + h * sdo.h + (long long)qi * sdo.t;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * Tq + qi] = acc;
}

// 2. dK and dV of one key tile of (b, kv head)
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int H, int Hk,
                   int Tq, int Tk, float scale, AttnMask mask) {
  // a local copy: a reference to a kernel parameter would put it in
  // local memory
  const AttnMask mk = mask;
  using TL = BwdTile<HD>;
  constexpr int BT = TL::BT, NG = TL::NG, NPT = TL::NPT, LD = TL::LD;
  extern __shared__ __align__(16) float bwd_smem[];
  const Smem m = carve<HD>(bwd_smem);
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk, G = H / Hk;
  const int k0 = blockIdx.x * BT;
  load_rows<T, HD>(m.ks, k + b * sk.b + hk * sk.h, sk.t, k0, Tk, 0.f);
  load_rows<T, HD>(m.vs, v + b * sv.b + hk * sv.h, sv.t, k0, Tk, 0.f);

  float4 gk[NPT], gv[NPT];
#pragma unroll
  for (int u = 0; u < NPT; ++u)
    gk[u] = gv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the queries some key of this tile is visible to
  const int q_lo = mk.row_lo(k0);
  const int q_hi = mk.row_hi(k0 + BT - 1, Tq);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += BT) {
      __syncthreads();  // the previous query tile consumed
      load_queries<T, HD>(m, q, dout, lse, delta, sq, sdo, b, h, H, q0, Tq,
                          scale);
      __syncthreads();
      score_tile<HD>(m.qs, m.dos, m.ks, m.vs, m.lse, m.d, m.ps, m.dss, q0,
                     k0, Tq, Tk, mk);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < NPT; ++u) {
        const int piece = threadIdx.x + NT * u;
        if (piece >= BT * NG) break;
        const int j = piece / NG, d = 4 * (piece % NG);
        float4 av = gv[u], ak = gk[u];
        for (int i = 0; i < BT; ++i) {
          const float p = m.ps[i * TL::PLD + j], ds = m.dss[i * TL::PLD + j];
          const float4 o4 =
              *reinterpret_cast<const float4*>(m.dos + i * LD + d);
          const float4 q4 =
              *reinterpret_cast<const float4*>(m.qs + i * LD + d);
          av.x = fmaf(p, o4.x, av.x);
          av.y = fmaf(p, o4.y, av.y);
          av.z = fmaf(p, o4.z, av.z);
          av.w = fmaf(p, o4.w, av.w);
          ak.x = fmaf(ds, q4.x, ak.x);
          ak.y = fmaf(ds, q4.y, ak.y);
          ak.z = fmaf(ds, q4.z, ak.z);
          ak.w = fmaf(ds, q4.w, ak.w);
        }
        gv[u] = av;
        gk[u] = ak;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NPT; ++u) {
    const int piece = threadIdx.x + NT * u;
    if (piece >= BT * NG) break;
    const int j = piece / NG, d = 4 * (piece % NG), kp = k0 + j;
    if (kp >= Tk) continue;
    T* kr = dk + b * sdk.b + hk * sdk.h + (long long)kp * sdk.t + d;
    T* vr = dv + b * sdv.b + hk * sdv.h + (long long)kp * sdv.t + d;
    kr[0] = from_f<T>(gk[u].x);
    kr[1] = from_f<T>(gk[u].y);
    kr[2] = from_f<T>(gk[u].z);
    kr[3] = from_f<T>(gk[u].w);
    vr[0] = from_f<T>(gv[u].x);
    vr[1] = from_f<T>(gv[u].y);
    vr[2] = from_f<T>(gv[u].z);
    vr[3] = from_f<T>(gv[u].w);
  }
}

// 3. dQ of one query tile of (b, h)
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Strides sq, Strides sk, Strides sv, Strides sdo,
                 Strides sdq, int H, int Hk, int Tq, int Tk, float scale,
                 AttnMask mask) {
  // a local copy: a reference to a kernel parameter would put it in
  // local memory
  const AttnMask mk = mask;
  using TL = BwdTile<HD>;
  constexpr int BT = TL::BT, NG = TL::NG, NPT = TL::NPT, LD = TL::LD;
  extern __shared__ __align__(16) float bwd_smem[];
  const Smem m = carve<HD>(bwd_smem);
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hk);
  const int q0 = blockIdx.x * BT;
  load_queries<T, HD>(m, q, dout, lse, delta, sq, sdo, b, h, H, q0, Tq,
                      scale);
  float4 gq[NPT];
#pragma unroll
  for (int u = 0; u < NPT; ++u) gq[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the keys some row of this tile can see, as the forward walks them
  const int q_last = min(q0 + BT, Tq) - 1;
  const int k_hi = mk.key_hi(q_last, Tk);
  const int k_lo = mk.key_lo(q0);
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  for (int k0 = k_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();  // the previous key tile consumed
    load_rows<T, HD>(m.ks, kb, sk.t, k0, Tk, 0.f);
    load_rows<T, HD>(m.vs, vb, sv.t, k0, Tk, 0.f);
    __syncthreads();
    score_tile<HD>(m.qs, m.dos, m.ks, m.vs, m.lse, m.d, m.ps, m.dss, q0, k0,
                   Tq, Tk, mk);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NPT; ++u) {
      const int piece = threadIdx.x + NT * u;
      if (piece >= BT * NG) break;
      const int i = piece / NG, d = 4 * (piece % NG);
      float4 aq = gq[u];
      for (int j = 0; j < BT; ++j) {
        const float ds = m.dss[i * TL::PLD + j];
        const float4 k4 = *reinterpret_cast<const float4*>(m.ks + j * LD + d);
        aq.x = fmaf(ds, k4.x, aq.x);
        aq.y = fmaf(ds, k4.y, aq.y);
        aq.z = fmaf(ds, k4.z, aq.z);
        aq.w = fmaf(ds, k4.w, aq.w);
      }
      gq[u] = aq;
    }
  }
#pragma unroll
  for (int u = 0; u < NPT; ++u) {
    const int piece = threadIdx.x + NT * u;
    if (piece >= BT * NG) break;
    const int i = piece / NG, d = 4 * (piece % NG), qi = q0 + i;
    if (qi >= Tq) continue;
    T* qr = dq + b * sdq.b + h * sdq.h + (long long)qi * sdq.t + d;
    qr[0] = from_f<T>(gq[u].x * scale);
    qr[1] = from_f<T>(gq[u].y * scale);
    qr[2] = from_f<T>(gq[u].z * scale);
    qr[3] = from_f<T>(gq[u].w * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------

constexpr int MWARPS = 4;  // warps a block, 16 rows each

// Per head dim (16 and 32): the bf16 shared-memory row (16 B more, against
// bank conflicts in ldmatrix), 64 rows a block (keys in dK/dV, queries in
// dQ) and 64 in the inner tile each block walks (queries in dK/dV, keys
// in dQ).
template <int HD>
struct MmaTile {
  static constexpr int ROW = HD + 8;
  static constexpr int CH = HD / 8;          // 16-byte pieces of a row
  static constexpr int BM = 16 * MWARPS;     // rows a block owns
  static constexpr int BN = 64;              // inner tile
  static constexpr int NTD = HD / 8;         // n8 tiles over hd
  static constexpr int NTN = BN / 8;         // n8 tiles over the inner tile
  static_assert(HD % 16 == 0 && NTD % 2 == 0, "whole k16 steps, n16 pairs");
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)ROW * (2 * BM + 2 * BN) +
      sizeof(float) * 2 * (BM > BN ? BM : BN);
};

// rows [row0, row0 + n) of a (T, HD) bf16 slab into shared memory by
// cp.async, rows at or past `limit` zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int row0, int n,
                                           int limit) {
  constexpr int ROW = MmaTile<HD>::ROW, CH = MmaTile<HD>::CH;
  for (int i = threadIdx.x; i < n * CH; i += 32 * MWARPS) {
    const int r = i / CH, c = (i % CH) * 8, t = row0 + r;
    const bool ok = t < limit;
    cp_async16(dst + r * ROW + c, src + (long long)(ok ? t : 0) * st + c, ok);
  }
}

// q * scale rounded to bf16 in place, as the forward scales it
template <int HD>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* qs, int n,
                                           float scale) {
  constexpr int ROW = MmaTile<HD>::ROW;
  for (int i = threadIdx.x; i < n * HD; i += 32 * MWARPS) {
    __nv_bfloat16* p = qs + (i / HD) * ROW + i % HD;
    *p = __float2bfloat16(__bfloat162float(*p) * scale);
  }
}

// acc (16 x NT8*8, this warp's rows) = A (16 x HD, rows of `a` from row
// a_row) times the rows of `b` (NT8*8 x HD, from row 0) transposed: the
// forward's S = Q K^T
template <int HD, int NT8>
__device__ __forceinline__ void mma_abT(float (&acc)[NT8][4],
                                        const __nv_bfloat16* a, int a_row,
                                        const __nv_bfloat16* b) {
  constexpr int ROW = MmaTile<HD>::ROW;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* abase =
      a + (a_row + (lane & 15)) * ROW + (lane >> 4) * 8;
  const __nv_bfloat16* bbase =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ROW + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, abase + kk * 16);
#pragma unroll
    for (int jp = 0; jp < NT8 / 2; ++jp) {
      uint32_t bf[4];
      ldsm_x4(bf, bbase + jp * 16 * ROW + kk * 16);
      mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x HD) += X (16 x NT8*8, this warp's C fragments, rounded to bf16
// as A fragments) times the rows of `b` (NT8*8 x HD): the forward's P V
template <int HD, int NT8>
__device__ __forceinline__ void mma_xb(float (&acc)[HD / 8][4],
                                       const float (&x)[NT8][4],
                                       const __nv_bfloat16* b) {
  constexpr int ROW = MmaTile<HD>::ROW;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base = b + (lane & 15) * ROW + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT8 / 2; ++kk) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, base + kk * 16 * ROW + dp * 16);
      mma_bf16(acc[2 * dp], xa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], xa, bf[2], bf[3]);
    }
  }
}

// this warp's 16 x HD fp32 accumulator, times `mul`, to rows row0 + (0..15)
// of a bf16 slab, rows at or past `limit` skipped
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           __nv_bfloat16* dst, long long st,
                                           int row0, int limit, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= limit) continue;
    __nv_bfloat16* row = dst + (long long)r * st;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

// 2. dK and dV of 64 keys of (b, kv head), a warp's 16 keys each: S^T =
// K qs^T and dP^T = V dO^T for each inner tile of queries, so P^T and dS^T
// sit in the warp's registers as the A operands of dV += P^T dO and
// dK += dS^T qs (P and dS rounded to bf16 there, as the forward rounds P)
template <int HD>
__global__ void __launch_bounds__(32 * MWARPS)
fa_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdk,
                       Strides sdv, int H, int Hk, int Tq, int Tk,
                       float scale, AttnMask mask) {
  // a local copy: a reference to a kernel parameter would put it in
  // local memory
  const AttnMask mk = mask;
  using TL = MmaTile<HD>;
  constexpr int ROW = TL::ROW, BM = TL::BM, BN = TL::BN, NTN = TL::NTN;
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_mma_smem);
  __nv_bfloat16* vs = ks + BM * ROW;
  __nv_bfloat16* qs = vs + BM * ROW;
  __nv_bfloat16* dos = qs + BN * ROW;
  float* lse_s = reinterpret_cast<float*>(dos + BN * ROW);
  float* d_s = lse_s + BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk, G = H / Hk;
  const int k0 = blockIdx.x * BM;
  stage_rows<HD>(ks, k + b * sk.b + hk * sk.h, sk.t, k0, BM, Tk);
  stage_rows<HD>(vs, v + b * sv.b + hk * sv.h, sv.t, k0, BM, Tk);
  cp_async_commit();

  float gk[HD / 8][4], gv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    gk[j][0] = gk[j][1] = gk[j][2] = gk[j][3] = gv[j][0] = gv[j][1] =
        gv[j][2] = gv[j][3] = 0.f;
  // this thread's keys: kw + g and kw + g + 8
  const int kw = k0 + warp * 16 + g;
  // the queries some key of this block is visible to
  const int q_lo = mk.row_lo(k0);
  const int q_hi = mk.row_hi(k0 + BM - 1, Tq);
  for (int hg = 0; hg < G; ++hg) {
    const int h = hk * G + hg;
    const long long row = ((long long)b * H + h) * Tq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BN) {
      __syncthreads();  // the previous query tile consumed
      stage_rows<HD>(qs, q + b * sq.b + h * sq.h, sq.t, q0, BN, Tq);
      stage_rows<HD>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, BN, Tq);
      cp_async_commit();
      for (int i = threadIdx.x; i < BN; i += 32 * MWARPS) {
        const bool ok = q0 + i < Tq;
        lse_s[i] = ok ? lse[row + q0 + i] : 0.f;
        d_s[i] = ok ? delta[row + q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      scale_rows<HD>(qs, BN, scale);
      __syncthreads();
      float st[NTN][4], dpt[NTN][4];
      mma_abT<HD, NTN>(st, ks, warp * 16, qs);
      mma_abT<HD, NTN>(dpt, vs, warp * 16, dos);
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tq + (e & 1);
          const int qi = q0 + col, kp = kw + 8 * (e >> 1);
          const bool vis = mk.visible(qi, kp, qi < Tq && kp < Tk);
          const float p = vis ? __expf(st[j][e] - lse_s[col]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - d_s[col]);
        }
      mma_xb<HD, NTN>(gv, st, dos);
      mma_xb<HD, NTN>(gk, dpt, qs);
    }
  }
  cp_async_wait<0>();
  store_rows<HD>(gk, dk + b * sdk.b + hk * sdk.h, sdk.t, k0 + warp * 16, Tk,
                 1.f);
  store_rows<HD>(gv, dv + b * sdv.b + hk * sdv.h, sdv.t, k0 + warp * 16, Tk,
                 1.f);
}

// 3. dQ of 64 queries of (b, h), a warp's 16 each: S = qs K^T and dP =
// dO V^T a key tile at a time, then dQ += dS K (dS rounded to bf16 as the
// A operand), and dQ * scale at the end
template <int HD>
__global__ void __launch_bounds__(32 * MWARPS)
fa_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdq, int H, int Hk,
                     int Tq, int Tk, float scale, AttnMask mask) {
  // a local copy: a reference to a kernel parameter would put it in
  // local memory
  const AttnMask mk = mask;
  using TL = MmaTile<HD>;
  constexpr int ROW = TL::ROW, BM = TL::BM, BN = TL::BN, NTN = TL::NTN;
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_mma_smem);
  __nv_bfloat16* dos = qs + BM * ROW;
  __nv_bfloat16* ks = dos + BM * ROW;
  __nv_bfloat16* vs = ks + BN * ROW;
  float* lse_s = reinterpret_cast<float*>(vs + BN * ROW);
  float* d_s = lse_s + BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hk);
  const int q0 = blockIdx.x * BM;
  const long long row = ((long long)b * H + h) * Tq;
  stage_rows<HD>(qs, q + b * sq.b + h * sq.h, sq.t, q0, BM, Tq);
  stage_rows<HD>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, BM, Tq);
  cp_async_commit();
  for (int i = threadIdx.x; i < BM; i += 32 * MWARPS) {
    const bool ok = q0 + i < Tq;
    lse_s[i] = ok ? lse[row + q0 + i] : 0.f;
    d_s[i] = ok ? delta[row + q0 + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  scale_rows<HD>(qs, BM, scale);

  float gq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    gq[j][0] = gq[j][1] = gq[j][2] = gq[j][3] = 0.f;
  // this thread's rows: q0 + warp 16 + g and + 8
  const int r0 = warp * 16 + g;
  const float lse0 = lse_s[r0], lse1 = lse_s[r0 + 8];
  const float d0 = d_s[r0], d1 = d_s[r0 + 8];
  // the keys some row of this block can see, as the forward walks them
  const int q_last = min(q0 + BM, Tq) - 1;
  const int k_hi = mk.key_hi(q_last, Tk);
  const int k_lo = mk.key_lo(q0);
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  for (int kt0 = k_lo; kt0 < k_hi; kt0 += BN) {
    __syncthreads();  // the previous key tile consumed (and qs scaled)
    stage_rows<HD>(ks, kb, sk.t, kt0, BN, Tk);
    stage_rows<HD>(vs, vb, sv.t, kt0, BN, Tk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[NTN][4], dp[NTN][4];
    mma_abT<HD, NTN>(s, qs, warp * 16, ks);
    mma_abT<HD, NTN>(dp, dos, warp * 16, vs);
#pragma unroll
    for (int j = 0; j < NTN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + 8 * (e >> 1);
        const int kp = kt0 + j * 8 + 2 * tq + (e & 1);
        const bool vis = mk.visible(qi, kp, qi < Tq && kp < Tk);
        const float p =
            vis ? __expf(s[j][e] - ((e >> 1) ? lse1 : lse0)) : 0.f;
        s[j][e] = p * (dp[j][e] - ((e >> 1) ? d1 : d0));
      }
    mma_xb<HD, NTN>(gq, s, ks);
  }
  store_rows<HD>(gq, dq + b * sdq.b + h * sdq.h, sdq.t, q0 + warp * 16, Tq,
                 scale);
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 80 and 128: wgmma on TMA-fed tiles (sm90.cuh); hd 256
// below
// ---------------------------------------------------------------------------

constexpr int WG = 128;         // threads of a warpgroup
constexpr int WG_BLOCK = 3 * WG;  // two consumer warpgroups, one producer
constexpr int QT = 64;          // query rows of a ring stage and of a row tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout (byte offsets) of the two passes.  A tile of R rows
// is HDP / 64 panels of R x 64 bf16 (HDP: hd rounded up to whole panels,
// the columns past hd zero), each written by TMA with 128-byte swizzle
// (sm90.cuh); every tile starts on 1024 bytes.
template <int HD>
struct WgTile {
  static constexpr int HDP = (HD + 63) / 64 * 64;  // padded width
  static constexpr int KK = (HD + 15) / 16;  // k16 slices of depth hd
  static constexpr int T64 = 64 * HDP * 2;  // bytes of a 64-row tile
  static constexpr int STAGES = 2;  // ring depth of both passes
  // dK/dV: K and V of the block's 128 keys, then the ring of stages, each
  // a query tile's qs and dO (64 rows) and its lse and D (2 x 64 fp32)
  static constexpr int KV_K = 0, KV_V = 2 * T64, KV_RING = 4 * T64;
  static constexpr int KV_STAGE = 2 * T64 + 1024;
  static constexpr int KV_BAR = KV_RING + STAGES * KV_STAGE;
  // dQ: qs and dO of the block's 128 queries, then the ring of stages, each
  // a key tile's K and V (64 rows)
  static constexpr int Q_QS = 0, Q_DO = 2 * T64, Q_RING = 4 * T64;
  static constexpr int Q_STAGE = 2 * T64;
  static constexpr int Q_BAR = Q_RING + STAGES * Q_STAGE;
  // + the barriers (kv or q, full, empty) + slack to align the base
  static constexpr size_t KV_SMEM = KV_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr size_t Q_SMEM = Q_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(HD % 16 == 0 && HDP <= 128, "k16 slices, n128 at most");
};

// The wgmma passes' tests, in the unshifted frame on scalar mask settings,
// in the form they had before the shifted frame existed, and in the
// shifted frame through AttnMask (csrc/attn_mask.cuh: these loops' code
// is fragile; each pass is instantiated for both frames).
__device__ __forceinline__ bool visible(int qi, int kp, int Tq, int Tk,
                                        int causal, int window) {
  bool vis = qi < Tq && kp < Tk;
  if (causal) vis = vis && qi >= kp;
  if (window > 0) vis = vis && (qi - kp) < window;
  return vis;
}
__device__ __forceinline__ bool visible(int qi, int kp, int Tq, int Tk,
                                        const AttnMask& mk) {
  return mk.visible(qi, kp, qi < Tq && kp < Tk);
}

// some pair of queries [q0, q0 + 64) and keys [k0, k0 + 64) is visible
__device__ __forceinline__ bool block_any(int q0, int k0, int Tq, int Tk,
                                          int causal, int window) {
  return q0 < Tq && k0 < Tk && !(causal && q0 + 63 < k0) &&
         !(window > 0 && q0 - (k0 + 63) >= window);
}
__device__ __forceinline__ bool block_any(int q0, int k0, int Tq, int Tk,
                                          const AttnMask& mk) {
  return q0 < Tq && k0 < Tk && mk.any(q0, 64, k0, 64);
}
// some pair of that block is hidden (its P needs the mask)
__device__ __forceinline__ bool block_edge(int q0, int k0, int Tq, int Tk,
                                           int causal, int window) {
  return q0 + 64 > Tq || k0 + 64 > Tk || (causal && q0 < k0 + 63) ||
         (window > 0 && q0 + 63 - k0 >= window);
}
__device__ __forceinline__ bool block_edge(int q0, int k0, int Tq, int Tk,
                                           const AttnMask& mk) {
  return q0 + 64 > Tq || k0 + 64 > Tk || mk.cuts(q0, 64, k0, 64);
}

// 1. D = rowsum(dO o) and lse * log2(e) into 64-row tiles (B H, nqt, 2,
// 64) (zeros past Tq), and with QS qs = q * scale rounded to bf16 into a
// contiguous (B H, Tq, HD) scratch, as the forward scales q: one warp a row
template <int HD, bool QS>
__global__ void __launch_bounds__(NT)
fa_bwd_prep_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ qs, float* __restrict__ rows,
                   Strides sq, Strides so, Strides sdo, int H, int Tq,
                   int nqt, float scale) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (qi >= nqt * QT) return;
  float dsum = 0.f, l2 = 0.f;
  if (qi < Tq) {
    const __nv_bfloat16* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
    const __nv_bfloat16* drow =
        dout + b * sdo.b + h * sdo.h + (long long)qi * sdo.t;
    const __nv_bfloat16* qrow = q + b * sq.b + h * sq.h + (long long)qi * sq.t;
    __nv_bfloat16* srow = qs + ((long long)bh * Tq + qi) * HD;
    using bf2 = __nv_bfloat162;
#pragma unroll
    for (int d = 2 * lane; d < HD; d += 64) {
      const float2 of = __bfloat1622float2(*(const bf2*)(orow + d));
      const float2 df = __bfloat1622float2(*(const bf2*)(drow + d));
      dsum += of.x * df.x + of.y * df.y;
      if constexpr (QS) {
        const float2 qf = __bfloat1622float2(*(const bf2*)(qrow + d));
        *reinterpret_cast<__nv_bfloat162*>(srow + d) =
            __floats2bfloat162_rn(qf.x * scale, qf.y * scale);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    l2 = lse[(long long)bh * Tq + qi] * LOG2E;
  }
  if (lane == 0) {
    float* tile = rows + ((long long)bh * nqt + qi / QT) * 2 * QT;
    tile[qi % QT] = l2;
    tile[QT + qi % QT] = dsum;
  }
}

// 2. dK and dV of 128 keys of (b, kv head): warpgroups 0 and 1 own 64 keys
// each, warpgroup 2's first thread streams the query tiles of every query
// head of the group through a ring of STAGES stages (TMA, mbarriers).  Per
// stage each consumer computes S^T = K qs^T and dP^T = V dO^T (both
// operands from shared memory), P^T = exp(S^T - lse) and dS^T = P^T (dP^T
// - D) in registers, then dV += P^T dO and dK += dS^T qs with P^T and dS^T
// as bf16 register A operands and dO, qs read transposed.  SHIFT: the
// mask's frame (csrc/attn_mask.cuh).
template <int HD, bool SHIFT>
__global__ void __launch_bounds__(WG_BLOCK, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qs,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ rows,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Strides sdk,
                         Strides sdv, int H, int Hk, int Tq, int Tk, int nqt,
                         AttnMask mask) {
  // the unshifted frame's settings as scalars; the shifted frame's as a
  // local copy (a reference to a kernel parameter would put it in local
  // memory)
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
  using TL = WgTile<HD>;
  using bf = __nv_bfloat16;
  constexpr int HDP = TL::HDP, P = HDP / 64, STAGES = TL::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  bf* ks = reinterpret_cast<bf*>(smem + TL::KV_K);
  bf* vs = reinterpret_cast<bf*>(smem + TL::KV_V);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + TL::KV_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk, G = H / Hk;
  // key tiles in order of launch: under a causal mask the low ones see the
  // most queries and go first
  const int k0 = blockIdx.y * 128;
  // the queries some key of this block is visible to, in 64-row tiles
  // (the first on a tile's boundary: the row tiles of lse and D are read
  // whole)
  const int q_lo = SHIFT ? mk.row_lo(k0) / QT * QT : (causal ? k0 : 0);
  const int q_hi = SHIFT ? mk.row_hi(k0 + 127, Tq)
                         : (window > 0 ? min(Tq, k0 + 127 + window) : Tq);
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + QT - 1) / QT : 0;
  const int n_it = G * n_q;  // stages: head g outer, query tiles inner
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * WG);
    }
    sm90::fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(kv_full, 4 * TL::T64);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (p * 128 + half * 64) * 64;
          sm90::tma_load_4d(ks + off, &tm_k, kv_full, 64 * p, k0 + 64 * half,
                            hk, b);
          sm90::tma_load_4d(vs + off, &tm_v, kv_full, 64 * p, k0 + 64 * half,
                            hk, b);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int g = it / n_q, q0 = q_lo + (it % n_q) * QT, h = hk * G + g;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + TL::KV_RING + s * TL::KV_STAGE;
        bf* qs_s = reinterpret_cast<bf*>(st);
        bf* do_s = qs_s + 64 * HDP;
        sm90::mbar_expect_tx(&full[s], 2 * TL::T64 + 2 * QT * 4);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sm90::tma_load_4d(qs_s + p * 64 * 64, &tm_qs, &full[s], 64 * p, q0,
                            h, b);
          sm90::tma_load_4d(do_s + p * 64 * 64, &tm_do, &full[s], 64 * p, q0,
                            h, b);
        }
        const long long tile = (long long)(b * H + h) * nqt + q0 / QT;
        sm90::bulk_load(st + 2 * TL::T64, rows + tile * 2 * QT, 2 * QT * 4,
                        &full[s]);
      }
    }
  } else {  // consumers
    sm90::regs_inc<240>();
    const int t = threadIdx.x % WG, warp = t / 32, g8 = (t % 32) / 4,
              q4 = t % 4;
    const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
    const bf* kw = ks + wg * 64 * 64;  // its rows within each 128-row panel
    const bf* vw = vs + wg * 64 * 64;
    float gk[HDP / 2], gv[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) gk[i] = gv[i] = 0.f;
    sm90::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int q0 = q_lo + (it % n_q) * QT;
      const unsigned char* st = smem + TL::KV_RING + s * TL::KV_STAGE;
      const bf* qs_s = reinterpret_cast<const bf*>(st);
      const bf* do_s = qs_s + 64 * HDP;
      const float* lse_s = reinterpret_cast<const float*>(st + 2 * TL::T64);
      const float* d_s = lse_s + QT;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      if (SHIFT ? !block_any(q0, kw0, Tq, Tk, mk)
                : !block_any(q0, kw0, Tq, Tk, causal, window)) {
        sm90::mbar_arrive(&empty[s]);
        continue;
      }
      const bool edge = SHIFT ? block_edge(q0, kw0, Tq, Tk, mk)
                              : block_edge(q0, kw0, Tq, Tk, causal, window);
      float sc[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(sc, sm90::desc_k(kw, 128, kk),
                           sm90::desc_k(qs_s, 64, kk), kk);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(dp, sm90::desc_k(vw, 128, kk),
                           sm90::desc_k(do_s, 64, kk), kk);
      sm90::wgmma_commit();
      // S^T retired; P^T while dP^T runs
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      float p[32];
      // row: key kw0 + 16 warp + g8 (+ 8); column: query q0 + 8 j + 2 q4
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * q4 + (i & 1);
        const int kp = kw0 + 16 * warp + g8 + 8 * ((i / 2) & 1);
        p[i] = exp2f(fmaf(sc[i], LOG2E, -lse_s[col]));
        if (edge && !(SHIFT ? visible(q0 + col, kp, Tq, Tk, mk)
                            : visible(q0 + col, kp, Tq, Tk, causal, window)))
          p[i] = 0.f;
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack2(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_t<HDP>(gv, pa[kk], sm90::desc_mn(do_s, 64, kk));
      sm90::wgmma_commit();
      // dP^T retired; dS^T while dV runs
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, col = 8 * (i / 4) + 2 * q4;
          da[kk][r] = sm90::pack2(p[i] * (dp[i] - d_s[col]),
                                  p[i + 1] * (dp[i + 1] - d_s[col + 1]));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_t<HDP>(gk, da[kk], sm90::desc_mn(qs_s, 64, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[s]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(gv);
    sm90::fence_regs(gk);
#pragma unroll
    for (int i = 0; i < HDP / 2; i += 2) {
      const int kp = kw0 + 16 * warp + g8 + 8 * ((i / 2) & 1);
      const int col = 8 * (i / 4) + 2 * q4;
      if (kp >= Tk || col >= HD) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + hk * sdk.h +
                                         (long long)kp * sdk.t + col) =
          __floats2bfloat162_rn(gk[i], gk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + hk * sdv.h +
                                         (long long)kp * sdv.t + col) =
          __floats2bfloat162_rn(gv[i], gv[i + 1]);
    }
  }
}

// 3. dQ of 128 queries of (b, h): warpgroups 0 and 1 own 64 queries each,
// warpgroup 2's first thread streams the visible key tiles (64 keys) of kv
// head h / (H / Hk).  Per stage: S = qs K^T and dP = dO V^T from shared
// memory, dS = P (dP - D) in registers, dQ += dS K with dS as the bf16 A
// operand and K read transposed; dQ * scale at the end.  SHIFT: the mask's
// frame.
template <int HD, bool SHIFT>
__global__ void __launch_bounds__(WG_BLOCK, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qs,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ rows,
                       __nv_bfloat16* __restrict__ dq, Strides sdq, int H,
                       int Hk, int Tq, int Tk, int nqt, float scale,
                       AttnMask mask) {
  // as in the dK/dV pass
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
  using TL = WgTile<HD>;
  using bf = __nv_bfloat16;
  constexpr int HDP = TL::HDP, P = HDP / 64, STAGES = TL::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  bf* qs = reinterpret_cast<bf*>(smem + TL::Q_QS);
  bf* dos = reinterpret_cast<bf*>(smem + TL::Q_DO);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + TL::Q_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hk);
  // query tiles in order of launch: under a causal mask the high ones see
  // the most keys and go first
  const int n_qt = (Tq + 127) / 128;
  const int q0 = 128 * (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y);
  // the keys some query of this block sees, in 64-key tiles
  const int k_hi = SHIFT ? mk.key_hi(min(q0 + 128, Tq) - 1, Tk)
                         : (causal ? min(Tk, min(q0 + 128, Tq)) : Tk);
  const int k_lo = SHIFT ? mk.key_lo(q0) / 64 * 64
                         : (window > 0 ? max(0, q0 - window + 1) / 64 * 64
                                       : 0);
  const int n_it = k_hi > k_lo ? (k_hi - k_lo + 63) / 64 : 0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * WG);
    }
    sm90::fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(q_full, 4 * TL::T64);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (p * 128 + half * 64) * 64;
          sm90::tma_load_4d(qs + off, &tm_qs, q_full, 64 * p, q0 + 64 * half,
                            h, b);
          sm90::tma_load_4d(dos + off, &tm_do, q_full, 64 * p,
                            q0 + 64 * half, h, b);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, kt0 = k_lo + 64 * it;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        bf* k_s = reinterpret_cast<bf*>(smem + TL::Q_RING + s * TL::Q_STAGE);
        bf* v_s = k_s + 64 * HDP;
        sm90::mbar_expect_tx(&full[s], 2 * TL::T64);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sm90::tma_load_4d(k_s + p * 64 * 64, &tm_k, &full[s], 64 * p, kt0,
                            hk, b);
          sm90::tma_load_4d(v_s + p * 64 * 64, &tm_v, &full[s], 64 * p, kt0,
                            hk, b);
        }
      }
    }
  } else {  // consumers
    sm90::regs_inc<240>();
    const int t = threadIdx.x % WG, warp = t / 32, g8 = (t % 32) / 4,
              q4 = t % 4;
    const int qw0 = q0 + 64 * wg;  // this warpgroup's first query
    const bf* qw = qs + wg * 64 * 64;  // its rows within each 128-row panel
    const bf* dw = dos + wg * 64 * 64;
    // this thread's rows: qw0 + 16 warp + g8 and + 8
    const int r0 = 16 * warp + g8;
    float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
    if (qw0 < Tq) {
      const float* tile = rows + ((long long)bh * nqt + qw0 / QT) * 2 * QT;
      l0 = tile[r0];
      l1 = tile[r0 + 8];
      d0 = tile[QT + r0];
      d1 = tile[QT + r0 + 8];
    }
    float gq[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) gq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, kt0 = k_lo + 64 * it;
      const bf* k_s =
          reinterpret_cast<const bf*>(smem + TL::Q_RING + s * TL::Q_STAGE);
      const bf* v_s = k_s + 64 * HDP;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      if (SHIFT ? !block_any(qw0, kt0, Tq, Tk, mk)
                : !block_any(qw0, kt0, Tq, Tk, causal, window)) {
        sm90::mbar_arrive(&empty[s]);
        continue;
      }
      const bool edge = SHIFT ? block_edge(qw0, kt0, Tq, Tk, mk)
                              : block_edge(qw0, kt0, Tq, Tk, causal, window);
      float sc[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(sc, sm90::desc_k(qw, 128, kk),
                           sm90::desc_k(k_s, 64, kk), kk);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(dp, sm90::desc_k(dw, 128, kk),
                           sm90::desc_k(v_s, 64, kk), kk);
      sm90::wgmma_commit();
      // S retired; P while dP runs
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      float p[32];
      // row: query qw0 + r0 (+ 8); column: key kt0 + 8 j + 2 q4
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i / 2) & 1;
        const int col = 8 * (i / 4) + 2 * q4 + (i & 1);
        p[i] = exp2f(fmaf(sc[i], LOG2E, -(hi ? l1 : l0)));
        const int qi = qw0 + r0 + 8 * hi, kp = kt0 + col;
        if (edge && !(SHIFT ? visible(qi, kp, Tq, Tk, mk)
                            : visible(qi, kp, Tq, Tk, causal, window)))
          p[i] = 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float d = ((i / 2) & 1) ? d1 : d0;
          da[kk][r] =
              sm90::pack2(p[i] * (dp[i] - d), p[i + 1] * (dp[i + 1] - d));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_t<HDP>(gq, da[kk], sm90::desc_mn(k_s, 64, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[s]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(gq);
#pragma unroll
    for (int i = 0; i < HDP / 2; i += 2) {
      const int qi = qw0 + r0 + 8 * ((i / 2) & 1);
      const int col = 8 * (i / 4) + 2 * q4;
      if (qi >= Tq || col >= HD) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + b * sdq.b + h * sdq.h +
                                         (long long)qi * sdq.t + col) =
          __floats2bfloat162_rn(gq[i] * scale, gq[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 256: wgmma on TMA-fed tiles, the work split as the top says
// ---------------------------------------------------------------------------

// Shared-memory layout (byte offsets) of the hd-256 passes: tiles as above,
// four 64-column panels, 32 KB a 64-row tile.
struct Wg256 {
  static constexpr int HD = 256, P = 4, KK = 16, T64 = 64 * HD * 2;
  // dK/dV: K and V of the block's 64 keys, a ring of two stages (a query
  // tile's qs and dO, its lse and D), then P of a stage (64 x 64 fp32,
  // accumulator fragments)
  static constexpr int KV_STAGES = 2, KV_K = 0, KV_V = T64, KV_RING = 2 * T64;
  static constexpr int KV_STAGE = 2 * T64 + 1024;
  static constexpr int KV_X = KV_RING + KV_STAGES * KV_STAGE;
  static constexpr int KV_BAR = KV_X + 64 * 64 * 4;
  // + the barriers: kv, full and empty a stage, P's full and empty
  static constexpr size_t KV_SMEM = KV_BAR + 8 * (3 + 2 * KV_STAGES) + 1024;
  // dQ: qs and dO of the block's 64 queries of two heads, then a ring of
  // three slots of a key tile's V or K (64 rows)
  static constexpr int Q_SLOTS = 3, Q_QS = 0, Q_DO = 2 * T64;
  static constexpr int Q_RING = 4 * T64;
  static constexpr int Q_BAR = Q_RING + Q_SLOTS * T64;
  // + the barriers: q, full and empty a slot
  static constexpr size_t Q_SMEM = Q_BAR + 8 * (1 + 2 * Q_SLOTS) + 1024;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448, "227 KB a block");
};

// 2'. dK and dV of 64 keys of (b, kv head) at hd 256: warpgroup 0
// accumulates dV and warpgroup 1 dK, each at the full width (n256, 128
// fp32 registers a thread); warpgroup 2's first thread streams the query
// tiles of every query head of the group as in the pass above.  A stage:
// warpgroup 0 computes S^T = K qs^T and P^T and hands P^T across in fp32
// (x_full, x_empty), then dV += P^T dO; warpgroup 1 computes dP^T = V
// dO^T, takes P^T, dS^T = P^T (dP^T - D), then dK += dS^T qs.  With
// `qscale` other than 1, tm_qs maps q itself: S and dK are taken times
// qscale.  SHIFT: the mask's frame.
template <bool SHIFT>
__global__ void __launch_bounds__(WG_BLOCK, 1)
fa_bwd_dkdv_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_qs,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ rows,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Strides sdk,
                            Strides sdv, int H, int Hk, int Tq, int Tk,
                            int nqt, float qscale, AttnMask mask) {
  // as in the pass above
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
  using TL = Wg256;
  using bf = __nv_bfloat16;
  constexpr int P = TL::P, STAGES = TL::KV_STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  bf* ks = reinterpret_cast<bf*>(smem + TL::KV_K);
  bf* vs = reinterpret_cast<bf*>(smem + TL::KV_V);
  float* xp = reinterpret_cast<float*>(smem + TL::KV_X);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + TL::KV_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* x_full = empty + STAGES;
  uint64_t* x_empty = x_full + 1;
  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk, G = H / Hk;
  const int k0 = blockIdx.y * 64;
  // the queries some key of this block is visible to, in 64-row tiles
  const int q_lo = SHIFT ? mk.row_lo(k0) / QT * QT : (causal ? k0 : 0);
  const int q_hi = SHIFT ? mk.row_hi(k0 + 63, Tq)
                         : (window > 0 ? min(Tq, k0 + 63 + window) : Tq);
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + QT - 1) / QT : 0;
  const int n_it = G * n_q;  // stages: head g outer, query tiles inner
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * WG);
    }
    sm90::mbar_init(x_full, WG);
    sm90::mbar_init(x_empty, WG);
    sm90::fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(kv_full, 2 * TL::T64);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sm90::tma_load_4d(ks + p * 64 * 64, &tm_k, kv_full, 64 * p, k0, hk, b);
        sm90::tma_load_4d(vs + p * 64 * 64, &tm_v, kv_full, 64 * p, k0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int g = it / n_q, q0 = q_lo + (it % n_q) * QT, h = hk * G + g;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + TL::KV_RING + s * TL::KV_STAGE;
        bf* qs_s = reinterpret_cast<bf*>(st);
        bf* do_s = qs_s + 64 * TL::HD;
        sm90::mbar_expect_tx(&full[s], 2 * TL::T64 + 2 * QT * 4);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sm90::tma_load_4d(qs_s + p * 64 * 64, &tm_qs, &full[s], 64 * p, q0,
                            h, b);
          sm90::tma_load_4d(do_s + p * 64 * 64, &tm_do, &full[s], 64 * p, q0,
                            h, b);
        }
        const long long tile = (long long)(b * H + h) * nqt + q0 / QT;
        sm90::bulk_load(st + 2 * TL::T64, rows + tile * 2 * QT, 2 * QT * 4,
                        &full[s]);
      }
    }
  } else {  // consumers: warpgroup 0 dV, warpgroup 1 dK
    sm90::regs_inc<240>();
    const int t = threadIdx.x % WG, warp = t / 32, g8 = (t % 32) / 4,
              q4 = t % 4;
    const float s2 = LOG2E * qscale;  // S = qscale K q^T, in log2 units
    float g[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) g[i] = 0.f;
    sm90::mbar_wait(kv_full, 0);
    int nx = 0;  // stages computed (both warpgroups skip the same ones)
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int q0 = q_lo + (it % n_q) * QT;
      const unsigned char* st = smem + TL::KV_RING + s * TL::KV_STAGE;
      const bf* qs_s = reinterpret_cast<const bf*>(st);
      const bf* do_s = qs_s + 64 * TL::HD;
      const float* lse_s = reinterpret_cast<const float*>(st + 2 * TL::T64);
      const float* d_s = lse_s + QT;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      if (SHIFT ? !block_any(q0, k0, Tq, Tk, mk)
                : !block_any(q0, k0, Tq, Tk, causal, window)) {
        sm90::mbar_arrive(&empty[s]);
        continue;
      }
      // S^T (warpgroup 0) or dP^T (1)
      float acc[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(acc, sm90::desc_k(wg == 0 ? ks : vs, 64, kk),
                           sm90::desc_k(wg == 0 ? qs_s : do_s, 64, kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      uint32_t a[4][4];  // P^T (warpgroup 0) or dS^T (1) as A fragments
      if (wg == 0) {
        const bool edge = SHIFT ? block_edge(q0, k0, Tq, Tk, mk)
                                : block_edge(q0, k0, Tq, Tk, causal, window);
        // row: key k0 + 16 warp + g8 (+ 8); column: query q0 + 8 j + 2 q4
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * q4 + (i & 1);
          const int kp = k0 + 16 * warp + g8 + 8 * ((i / 2) & 1);
          acc[i] = exp2f(fmaf(acc[i], s2, -lse_s[col]));
          if (edge && !(SHIFT ? visible(q0 + col, kp, Tq, Tk, mk)
                              : visible(q0 + col, kp, Tq, Tk, causal,
                                        window)))
            acc[i] = 0.f;
        }
        sm90::mbar_wait(x_empty, (nx & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) xp[i * WG + t] = acc[i];
        sm90::mbar_arrive(x_full);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[kk][r] = sm90::pack2(acc[8 * kk + 2 * r],
                                   acc[8 * kk + 2 * r + 1]);
      } else {
        sm90::mbar_wait(x_full, nx & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r, col = 8 * (i / 4) + 2 * q4;
            a[kk][r] = sm90::pack2(
                xp[i * WG + t] * (acc[i] - d_s[col]),
                xp[(i + 1) * WG + t] * (acc[i + 1] - d_s[col + 1]));
          }
        sm90::mbar_arrive(x_empty);
      }
      ++nx;
      // dV += P^T dO (warpgroup 0), dK += dS^T qs (1)
      const bf* b_s = wg == 0 ? do_s : qs_s;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n256_t(g, a[kk], sm90::desc_mn(b_s, 64, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[s]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(g);
    bf* out = wg == 0 ? dv : dk;
    const Strides so = wg == 0 ? sdv : sdk;
    const float mul = wg == 0 ? 1.f : qscale;  // dK = qscale dS^T q
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int kp = k0 + 16 * warp + g8 + 8 * ((i / 2) & 1);
      const int col = 8 * (i / 4) + 2 * q4;
      if (kp >= Tk) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + b * so.b + hk * so.h +
                                         (long long)kp * so.t + col) =
          __floats2bfloat162_rn(g[i] * mul, g[i + 1] * mul);
    }
  }
}

// 3'. dQ at hd 256 of 64 queries of two query heads of one kv group
// (blocks over (b, kv head hk, j), heads hk G + 2 j and + 1): warpgroup
// w takes head hk G + 2 j + w (none where G is odd and that is past the
// group), its 64 queries at the full width (n256, 128 fp32 registers a
// thread), and the two share their kv head's key tiles, which warpgroup
// 2's first thread streams V and K apart through a ring of three slots
// (each V released after dP, each K after dQ).  Per key tile: S = qs K^T
// and dP = dO V^T from shared memory, dS = P (dP - D) in registers, dQ +=
// dS K; dQ * scale at the end.  qscale, SHIFT: as in 2'.
template <bool SHIFT>
__global__ void __launch_bounds__(WG_BLOCK, 1)
fa_bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_qs,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ rows,
                          __nv_bfloat16* __restrict__ dq, Strides sdq, int H,
                          int Hk, int Tq, int Tk, int nqt, float scale,
                          float qscale, AttnMask mask) {
  // as in the pass above
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
  using TL = Wg256;
  using bf = __nv_bfloat16;
  constexpr int P = TL::P, SLOTS = TL::Q_SLOTS;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  bf* qs = reinterpret_cast<bf*>(smem + TL::Q_QS);
  bf* dos = reinterpret_cast<bf*>(smem + TL::Q_DO);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + TL::Q_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;
  const int G = H / Hk, npair = (G + 1) / 2;
  const int j = blockIdx.x % npair, hk = blockIdx.x / npair % Hk,
            b = blockIdx.x / npair / Hk;
  const int nh = min(2, G - 2 * j);  // the block's query heads
  // query tiles in order of launch: under a causal mask the high ones see
  // the most keys and go first
  const int n_qt = (Tq + 63) / 64;
  const int q0 = 64 * (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y);
  // the keys some query of this block sees, in 64-key tiles
  const int k_hi = SHIFT ? mk.key_hi(min(q0 + 64, Tq) - 1, Tk)
                         : (causal ? min(Tk, min(q0 + 64, Tq)) : Tk);
  const int k_lo = SHIFT ? mk.key_lo(q0) / 64 * 64
                         : (window > 0 ? max(0, q0 - window + 1) / 64 * 64
                                       : 0);
  const int n_it = k_hi > k_lo ? (k_hi - k_lo + 63) / 64 : 0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], nh * WG);
    }
    sm90::fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(q_full, nh * 2 * TL::T64);
      for (int w = 0; w < nh; ++w) {
        const int h = hk * G + 2 * j + w;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int off = (w * 4 + p) * 64 * 64;
          sm90::tma_load_4d(qs + off, &tm_qs, q_full, 64 * p, q0, h, b);
          sm90::tma_load_4d(dos + off, &tm_do, q_full, 64 * p, q0, h, b);
        }
      }
      // items 2 i and 2 i + 1: key tile i's V and K
      for (int n = 0; n < 2 * n_it; ++n) {
        const int s = n % SLOTS, kt0 = k_lo + 64 * (n / 2);
        sm90::mbar_wait(&empty[s], ((n / SLOTS) & 1) ^ 1);
        bf* slot = reinterpret_cast<bf*>(smem + TL::Q_RING + s * TL::T64);
        sm90::mbar_expect_tx(&full[s], TL::T64);
#pragma unroll
        for (int p = 0; p < P; ++p)
          sm90::tma_load_4d(slot + p * 64 * 64, (n & 1) ? &tm_k : &tm_v,
                            &full[s], 64 * p, kt0, hk, b);
      }
    }
  } else if (wg < nh) {  // consumers: warpgroup w, head hk G + 2 j + w
    sm90::regs_inc<240>();
    const int t = threadIdx.x % WG, warp = t / 32, g8 = (t % 32) / 4,
              q4 = t % 4;
    const int h = hk * G + 2 * j + wg;
    const bf* qw = qs + wg * 4 * 64 * 64;  // this head's tiles
    const bf* dw = dos + wg * 4 * 64 * 64;
    const float s2 = LOG2E * qscale;  // S = qscale q K^T, in log2 units
    // this thread's rows: q0 + 16 warp + g8 and + 8
    const int r0 = 16 * warp + g8;
    float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
    if (q0 < Tq) {
      const float* tile =
          rows + ((long long)(b * H + h) * nqt + q0 / QT) * 2 * QT;
      l0 = tile[r0];
      l1 = tile[r0 + 8];
      d0 = tile[QT + r0];
      d1 = tile[QT + r0 + 8];
    }
    float gq[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) gq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int nv = 2 * it, nk = nv + 1, kt0 = k_lo + 64 * it;
      const int sv = nv % SLOTS, sk = nk % SLOTS;
      const bf* v_s =
          reinterpret_cast<const bf*>(smem + TL::Q_RING + sv * TL::T64);
      const bf* k_s =
          reinterpret_cast<const bf*>(smem + TL::Q_RING + sk * TL::T64);
      // both before the products (a wait between two wgmma groups made
      // ptxas serialize every wgmma, its note C7520)
      sm90::mbar_wait(&full[sv], (nv / SLOTS) & 1);
      sm90::mbar_wait(&full[sk], (nk / SLOTS) & 1);
      if (SHIFT ? !block_any(q0, kt0, Tq, Tk, mk)
                : !block_any(q0, kt0, Tq, Tk, causal, window)) {
        sm90::mbar_arrive(&empty[sv]);
        sm90::mbar_arrive(&empty[sk]);
        continue;
      }
      const bool edge = SHIFT ? block_edge(q0, kt0, Tq, Tk, mk)
                              : block_edge(q0, kt0, Tq, Tk, causal, window);
      float sc[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(sc, sm90::desc_k(qw, 64, kk),
                           sm90::desc_k(k_s, 64, kk), kk);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n64(dp, sm90::desc_k(dw, 64, kk),
                           sm90::desc_k(v_s, 64, kk), kk);
      sm90::wgmma_commit();
      // S retired; P while dP runs
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      // row: query q0 + r0 (+ 8); column: key kt0 + 8 j + 2 q4
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i / 2) & 1;
        const int col = 8 * (i / 4) + 2 * q4 + (i & 1);
        sc[i] = exp2f(fmaf(sc[i], s2, -(hi ? l1 : l0)));
        const int qi = q0 + r0 + 8 * hi, kp = kt0 + col;
        if (edge && !(SHIFT ? visible(qi, kp, Tq, Tk, mk)
                            : visible(qi, kp, Tq, Tk, causal, window)))
          sc[i] = 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      sm90::mbar_arrive(&empty[sv]);  // V done with
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float d = ((i / 2) & 1) ? d1 : d0;
          da[kk][r] =
              sm90::pack2(sc[i] * (dp[i] - d), sc[i + 1] * (dp[i + 1] - d));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_n256_t(gq, da[kk], sm90::desc_mn(k_s, 64, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(&empty[sk]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(gq);
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int qi = q0 + r0 + 8 * ((i / 2) & 1);
      const int col = 8 * (i / 4) + 2 * q4;
      if (qi >= Tq) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + b * sdq.b + h * sdq.h +
                                         (long long)qi * sdq.t + col) =
          __floats2bfloat162_rn(gq[i] * scale, gq[i + 1] * scale);
    }
  }
}

// the dynamic shared-memory attribute, per kernel and per device, set once
template <typename K>
cudaError_t size_smem(K kernel, size_t bytes, bool* sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const long long* st, int B, int H, int Hk,
           int Tq, int Tk, float scale, AttnMask mk,
           cudaStream_t stream) {
  using TL = BwdTile<HD>;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  static bool sized_kv[MAX_DEVICES] = {}, sized_q[MAX_DEVICES] = {};
  cudaError_t err = size_smem(fa_bwd_dkdv_kernel<T, HD>, TL::SMEM, sized_kv);
  if (err != cudaSuccess) return (int)err;
  err = size_smem(fa_bwd_dq_kernel<T, HD>, TL::SMEM, sized_q);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_d((Tq + NT / 32 - 1) / (NT / 32), B * H);
  fa_bwd_delta_kernel<T><<<grid_d, NT, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, so, sdo, H, Tq, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((Tk + TL::BT - 1) / TL::BT, B * Hk);
  fa_bwd_dkdv_kernel<T, HD><<<grid_kv, NT, TL::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, sq, sk, sv, sdo, sdk, sdv, H, Hk, Tq, Tk, scale, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Tq + TL::BT - 1) / TL::BT, B * H);
  fa_bwd_dq_kernel<T, HD><<<grid_q, NT, TL::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, sq, sk, sv, sdo, sdq, H, Hk, Tq, Tk, scale, mk);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const long long* st, int B, int H,
               int Hk, int Tq, int Tk, float scale, AttnMask mk,
               cudaStream_t stream) {
  using TL = MmaTile<HD>;
  using bf = __nv_bfloat16;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  static bool sized_kv[MAX_DEVICES] = {}, sized_q[MAX_DEVICES] = {};
  cudaError_t err = size_smem(fa_bwd_dkdv_mma_kernel<HD>, TL::SMEM,
                              sized_kv);
  if (err != cudaSuccess) return (int)err;
  err = size_smem(fa_bwd_dq_mma_kernel<HD>, TL::SMEM, sized_q);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_d((Tq + NT / 32 - 1) / (NT / 32), B * H);
  fa_bwd_delta_kernel<bf><<<grid_d, NT, 0, stream>>>(
      (const bf*)o, (const bf*)dout, delta, so, sdo, H, Tq, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((Tk + TL::BM - 1) / TL::BM, B * Hk);
  fa_bwd_dkdv_mma_kernel<HD><<<grid_kv, 32 * MWARPS, TL::SMEM, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta,
      (bf*)dk, (bf*)dv, sq, sk, sv, sdo, sdk, sdv, H, Hk, Tq, Tk, scale, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Tq + TL::BM - 1) / TL::BM, B * H);
  fa_bwd_dq_mma_kernel<HD><<<grid_q, 32 * MWARPS, TL::SMEM, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta,
      (bf*)dq, sq, sk, sv, sdo, sdq, H, Hk, Tq, Tk, scale, mk);
  return (int)cudaGetLastError();
}

// bf16 at hd 64, 80, 128 and 256: the prep launch, then the dK/dV and dQ
// passes on wgmma, instantiated for the mask's frame.  `work` holds qs (B
// H Tq HD bf16, rows hd wide) and then the row tiles (B H, nqt, 2, 64)
// fp32.
template <int HD, bool SHIFT>
int launch_wgmma_in(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* work, void* dq,
                 void* dk, void* dv, const long long* st, int B, int H,
                 int Hk, int Tq, int Tk, float scale, AttnMask mk,
                 cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  constexpr bool W256 = HD == 256;
  static bool sized_kv[MAX_DEVICES] = {}, sized_q[MAX_DEVICES] = {};
  cudaError_t err;
  if constexpr (W256) {
    err = size_smem(fa_bwd_dkdv_wgmma256_kernel<SHIFT>, Wg256::KV_SMEM,
                    sized_kv);
    if (err != cudaSuccess) return (int)err;
    err = size_smem(fa_bwd_dq_wgmma256_kernel<SHIFT>, Wg256::Q_SMEM,
                    sized_q);
  } else {
    using TL = WgTile<HD>;
    err = size_smem(fa_bwd_dkdv_wgmma_kernel<HD, SHIFT>, TL::KV_SMEM,
                    sized_kv);
    if (err != cudaSuccess) return (int)err;
    err = size_smem(fa_bwd_dq_wgmma_kernel<HD, SHIFT>, TL::Q_SMEM, sized_q);
  }
  if (err != cudaSuccess) return (int)err;

  const int nqt = (Tq + QT - 1) / QT;
  bf* qs = (bf*)work;
  float* rows = (float*)(qs + (size_t)B * H * Tq * HD);
  // hd 256 at a power-of-two scale (hd^-0.5 = 1/16): q * scale is exact in
  // bf16 and the scale commutes with every fp32 rounding, so the passes
  // read q itself and take S and dK times `qscale` (the same bits, for |q|
  // >= 2^-122); otherwise the prep writes qs and `qscale` is 1
  int ex;
  const bool raw = W256 && std::frexp(scale, &ex) == 0.5f;
  const float qscale = raw ? scale : 1.f;
  const dim3 grid_p((nqt * QT + NT / 32 - 1) / (NT / 32), B * H);
  if (raw)
    fa_bwd_prep_kernel<HD, false><<<grid_p, NT, 0, stream>>>(
        (const bf*)q, (const bf*)o, (const bf*)dout, lse, qs, rows, sq, so,
        sdo, H, Tq, nqt, scale);
  else
    fa_bwd_prep_kernel<HD, true><<<grid_p, NT, 0, stream>>>(
        (const bf*)q, (const bf*)o, (const bf*)dout, lse, qs, rows, sq, so,
        sdo, H, Tq, nqt, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // byte strides of (t, head, b); qs is contiguous
  CUtensorMap m_qs, m_do, m_k, m_v;
  const long long e = sizeof(bf);
  if ((err = raw ? sm90::tile_map(&m_qs, q, HD, Tq, H, B, sq.t * e, sq.h * e,
                                  sq.b * e, 64)
                 : sm90::tile_map(&m_qs, qs, HD, Tq, H, B, HD * e,
                                  Tq * HD * e, (long long)H * Tq * HD * e,
                                  64)) != cudaSuccess ||
      (err = sm90::tile_map(&m_do, dout, HD, Tq, H, B, sdo.t * e, sdo.h * e,
                            sdo.b * e, 64)) != cudaSuccess ||
      (err = sm90::tile_map(&m_k, k, HD, Tk, Hk, B, sk.t * e, sk.h * e,
                            sk.b * e, 64)) != cudaSuccess ||
      (err = sm90::tile_map(&m_v, v, HD, Tk, Hk, B, sv.t * e, sv.h * e,
                            sv.b * e, 64)) != cudaSuccess)
    return (int)err;
  if constexpr (W256) {
    const dim3 grid_kv(B * Hk, (Tk + 63) / 64);
    fa_bwd_dkdv_wgmma256_kernel<SHIFT>
        <<<grid_kv, WG_BLOCK, Wg256::KV_SMEM, stream>>>(
        m_qs, m_do, m_k, m_v, rows, (bf*)dk, (bf*)dv, sdk, sdv, H, Hk, Tq,
        Tk, nqt, qscale, mk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // blocks over (b, kv head, pair of query heads), 64 queries each
    const dim3 grid_q(B * Hk * ((H / Hk + 1) / 2), (Tq + 63) / 64);
    fa_bwd_dq_wgmma256_kernel<SHIFT>
        <<<grid_q, WG_BLOCK, Wg256::Q_SMEM, stream>>>(
        m_qs, m_do, m_k, m_v, rows, (bf*)dq, sdq, H, Hk, Tq, Tk, nqt, scale,
        qscale, mk);
  } else {
    using TL = WgTile<HD>;
    const dim3 grid_kv(B * Hk, (Tk + 127) / 128);
    fa_bwd_dkdv_wgmma_kernel<HD, SHIFT>
        <<<grid_kv, WG_BLOCK, TL::KV_SMEM, stream>>>(
        m_qs, m_do, m_k, m_v, rows, (bf*)dk, (bf*)dv, sdk, sdv, H, Hk, Tq,
        Tk, nqt, mk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q(B * H, (Tq + 127) / 128);
    fa_bwd_dq_wgmma_kernel<HD, SHIFT>
        <<<grid_q, WG_BLOCK, TL::Q_SMEM, stream>>>(
        m_qs, m_do, m_k, m_v, rows, (bf*)dq, sdq, H, Hk, Tq, Tk, nqt, scale,
        mk);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* work, void* dq,
                 void* dk, void* dv, const long long* st, int B, int H,
                 int Hk, int Tq, int Tk, float scale, AttnMask mk,
                 cudaStream_t stream) {
  return shifted(mk)
             ? launch_wgmma_in<HD, true>(q, k, v, o, dout, lse, work, dq, dk,
                                         dv, st, B, H, Hk, Tq, Tk, scale, mk,
                                         stream)
             : launch_wgmma_in<HD, false>(q, k, v, o, dout, lse, work, dq, dk,
                                          dv, st, B, H, Hk, Tq, Tk, scale, mk,
                                          stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, const long long* st, int B, int H, int Hk,
             int Tq, int Tk, int hd, float scale, AttnMask mk,
             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_BWD_CASE(HD)                                                     \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,   \
                         H, Hk, Tq, Tk, scale, mk, s);
  switch (hd) {
    FA_BWD_CASE(8)
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(80)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}

}  // namespace

// strides: 24 element strides, (b, h, t) of q, k, v, o, dO, dQ, dK and dV in
// that order (hd contiguous in each); lse (B, H, Tq) fp32 from the forward;
// delta (B, H, Tq) fp32 scratch.  dQ, dK and dV are written whole.
// q_offset, kv_start: the forward's mask settings (csrc/attn_mask.cuh).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* st, int B, int H, int Hk, int Tq, int Tk,
    int hd, float scale, int causal, int window, int q_offset, int kv_start,
    void* stream) {
  const AttnMask mk{causal, window, q_offset, kv_start};
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                         Hk, Tq, Tk, hd, scale, mk, stream);
}

// bf16: the wgmma kernels at hd 64, 80, 128 and 256 (`delta` then points
// at their workspace: qs, B H Tq hd bf16, then B H ceil(Tq / 64) 128 fp32),
// the mma.sync ones at hd 16 and 32 (pointers of q, k, v, o and dO 16-byte
// aligned and their strides multiples of 8 elements, in both), the
// fp32-FMA one at hd 8
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* st, int B, int H, int Hk, int Tq, int Tk,
    int hd, float scale, int causal, int window, int q_offset, int kv_start,
    void* stream) {
  const AttnMask mk{causal, window, q_offset, kv_start};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch_mma<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                            H, Hk, Tq, Tk, scale, mk, s);
    case 32:
      return launch_mma<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                            H, Hk, Tq, Tk, scale, mk, s);
    case 64:
      return launch_wgmma<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                              B, H, Hk, Tq, Tk, scale, mk, s);
    case 80:
      return launch_wgmma<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                              B, H, Hk, Tq, Tk, scale, mk, s);
    case 128:
      return launch_wgmma<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                               B, H, Hk, Tq, Tk, scale, mk, s);
    case 256:
      return launch_wgmma<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                               B, H, Hk, Tq, Tk, scale, mk, s);
    default:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, st, B, H, Hk, Tq, Tk, hd, scale, mk,
                                     stream);
  }
}
