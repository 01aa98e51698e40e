// Flash attention (causal and/or sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_kernel`): for q (B, H, Tq, hd) and k, v
// (B, Hk, Tk, hd) with H % Hk == 0 it returns softmax(q k^T * scale) v per
// (b, h), query head h reading kv head h / (H / Hk), with the TPU kernel's
// masks and arithmetic: q * scale rounded to the input dtype, scores and the
// online-softmax state (m, l, o) in fp32, a masked score is -1e30 (not
// -inf), l summed from the unrounded fp32 p, p rounded to v's dtype before
// the PV product, l clamped at 1e-30, the output in q's dtype.  `window`
// applies with or without `causal`, as in the TPU kernel.  The (Tq, Tk)
// scores never reach device memory.
//
// What bounds it: it reads q, k, v once and writes o once, and does about
// 4 * hd flops per visible (query, key) pair.  On zamba2-2.7b's serving path
// (B 8, H 32, T 2048, hd 80, causal, bf16) that is 336 MB against 0.17
// TFLOP: the operations bound it (0.17 ms at the bf16 tensor-core peak,
// against 0.10 ms for the bytes).  So do the dense LMs' prefills: qwen2-1.5b
// (B 8, H 12 over 2 kv heads, T 2048, hd 128, causal) 0.10 TFLOP, 0.10 ms
// at the peak, against 0.035 ms for 117 MB; gemma3-4b (H 8 over 4, hd 256)
// 0.14 TFLOP on a global layer, three quarters of that on its local layers
// (window 1,024).
//
// Head dims built: 8, 16, 32 (the JAX package's test grid), 80 (zamba2),
// 128 (qwen2, qwen1.5, phi3) and 256 (gemma3).  Per head dim the bf16
// kernel takes 128 query rows a block and 64-key tiles up to hd 80, 64
// rows and 64 keys at hd 128, 64 rows and 32 keys at hd 256 (`Tile`); the
// fp32 kernel one thread a row and 64-key tiles up to hd 80, hd / 32
// threads a row and 4096 / hd keys a tile from hd 128 (`F32Tile`).
//
// Design of the bf16 kernel (`flash_attention_mma_kernel`), the serving
// path's: the FlashAttention-2 shape on tensor cores.  A block owns 128
// query rows of one (b, h) (64 from hd 128): 4 warps of 32 rows, each as
// two 16-row tiles (one from hd 128, where the O accumulator alone is 64
// or 128 registers a thread), and walks the key tiles of BK = 64 keys (32
// at hd 256) inside the block, carrying (m, l, o) in registers.
// S = Q K^T and O += P V are `mma.sync.m16n8k16` bf16 -> fp32, fed by
// `ldmatrix` from bf16 tiles in shared memory (rows padded by 16 B, so
// the eight rows an `ldmatrix` reads fall in distinct banks); each K and V
// fragment a warp loads feeds both of its row tiles (where it has two),
// which halves the shared-memory reads per flop against one tile a warp.
// Q is scaled and rounded to bf16 once in shared memory and its fragments
// are read again at each tile, which leaves the registers to the
// accumulators (two blocks an SM).  The S
// accumulators become P's A fragments in registers (rounded to bf16,
// which is exactly the reference's cast of p); l sums the fp32 p before
// that rounding.  K and V tiles are staged with `cp.async` (16 B a
// thread) in a ring of two stages, so the next tile loads while this one
// computes; rows past Tk are zero-filled by the copy.  hd 8 is
// zero-padded to the mma's k = 16 in shared memory, which is exact.
// Tiles that the causal or window mask hides from the whole block are
// never visited, and the mask is evaluated only on tiles that cross its
// edge.  The grid puts the query tile in its slow dimension and launches
// the causal tiles with the most keys first, so the short ones fill the
// tail across the 132 SMs.  What still separates it from the bound: the
// softmax's exp, max and rescale on the CUDA cores between the two
// products of each tile, and mma.sync in place of Hopper's wgmma.
//
// fp32 inputs keep the exact kernel (`flash_attention_kernel`): one thread
// per query row (hd / 32 neighbouring lanes from hd 128, each holding 32
// dims of q and o and summing its partial scores with shuffles, so that a
// row's registers never exceed 64 floats), fp32 FMAs on the CUDA cores,
// K/V tiles in static shared memory in fp32 (at most 40 KB).  TF32
// tensor cores would break the fp32 tolerance, and no serving path sends
// fp32; the dtype selects the kernel.
//
// A row with no visible key at all (possible only with a window and no
// causal mask) is not defined alike by the two reference functions: each
// averages the values of the masked keys it happens to visit, as both
// kernels do over the tiles they visit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {  // in elements; hd has stride 1
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// fp32: TPR threads per query row, fp32 FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block
constexpr int KS = 8;   // keys folded into the softmax at a time

// Per head dim: up to hd 80 one thread holds a whole row (q and the output
// accumulator in registers) and a staged tile is 64 keys; from hd 128 a row
// is split across TPR = hd / 32 neighbouring lanes, 32 dims each, whose
// partial scores are summed with shuffles, and the tile shrinks to keep K
// and V at 32 KB of static shared memory (40 KB at hd 80).
template <int HD>
struct F32Tile {
  static constexpr int TPR = HD >= 128 ? HD / 32 : 1;   // threads a row
  static constexpr int DPT = HD / TPR;                  // dims a thread
  static constexpr int BK = HD >= 128 ? 4096 / HD : 64; // keys a tile
  static constexpr int THREADS = BQ * TPR;
  static_assert(DPT % 4 == 0 && 32 % TPR == 0, "float4 pieces in a warp");
  static_assert(BK % KS == 0, "a tile is whole softmax steps");
};

template <int HD>
__global__ void __launch_bounds__(F32Tile<HD>::THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so, int H,
                       int Hk, int Tq, int Tk, float scale, int causal,
                       int window) {
  using FT = F32Tile<HD>;
  constexpr int TPR = FT::TPR, DPT = FT::DPT, BK = FT::BK;
  constexpr int NT = FT::THREADS, G4 = DPT / 4;
  __shared__ __align__(16) float ks[BK * HD];
  __shared__ __align__(16) float vs[BK * HD];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * BQ;
  // this thread's dims: the float4 pieces sub, sub + TPR, ... of its row,
  // so that the row's lanes read neighbouring 16 bytes of a K or V row
  const int sub = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool q_ok = qi < Tq;

  float qr[DPT], acc[DPT];
  const float* qrow = q + b * sq.b + h * sq.h + (long long)qi * sq.t;
#pragma unroll
  for (int i = 0; i < G4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qr[4 * i + c] = q_ok ? qrow[4 * (sub + TPR * i) + c] * scale : 0.0f;
      acc[4 * i + c] = 0.0f;
    }
  float m = NEG_INF, l = 0.0f;

  // the keys some row of this block can see
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  for (int t0 = k_lo; t0 < k_hi; t0 += BK) {
    const int nk = min(BK, k_hi - t0);
    __syncthreads();  // the previous tile consumed
    for (int i = threadIdx.x; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const bool ok = j < nk;
      ks[i] = ok ? kb[(long long)(t0 + j) * sk.t + d] : 0.0f;
      vs[i] = ok ? vb[(long long)(t0 + j) * sv.t + d] : 0.0f;
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
        for (int i = 0; i < G4; ++i) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(kr + 4 * (sub + TPR * i));
          x = fmaf(qr[4 * i], k4.x, x);
          x = fmaf(qr[4 * i + 1], k4.y, x);
          x = fmaf(qr[4 * i + 2], k4.z, x);
          x = fmaf(qr[4 * i + 3], k4.w, x);
        }
        // the row's partial scores, summed alike in each of its lanes
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
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
      for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        const float p = s[jj];
        const float* vr = vs + (j0 + jj) * HD;
#pragma unroll
        for (int i = 0; i < G4; ++i) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vr + 4 * (sub + TPR * i));
          acc[4 * i] = fmaf(p, v4.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, v4.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, v4.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, v4.w, acc[4 * i + 3]);
        }
      }
      m = mx;
    }
  }

  if (q_ok) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
#pragma unroll
    for (int i = 0; i < G4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[4 * (sub + TPR * i) + c] = acc[4 * i + c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async K/V ring
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;   // K/V tiles in flight
constexpr int WARPS = 4;    // warps a block

// Per head dim: the head dim padded to the mma's k = 16, the shared-memory
// row (16 B more, against bank conflicts in ldmatrix), and the tiles.  A
// warp's O accumulator is MT x hd/8 x 4 fp32 registers a thread and its S
// tile MT x BKV/8 x 4, under the 255-register cap of two blocks an SM:
// up to hd 80 a warp holds MT = 2 query tiles (128 rows a block) over
// 64-key tiles; at hd 128 one tile (64 rows a block; O 64 and S 32
// registers); at hd 256 one tile over 32-key tiles (O 128 and S 16
// registers), so that Q and two K/V stages stay at 99 KB of shared memory
// and two blocks still fit on an SM (85 KB at hd 128).
template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 15) / 16 * 16;
  static constexpr int ROW = HDP + 8;    // bf16 elements per smem row
  static constexpr int CHUNKS = HD / 8;  // 16-byte pieces of a global row
  static constexpr int MT = HD <= 80 ? 2 : 1;        // 16-row tiles a warp
  static constexpr int BKV = HD <= 128 ? 64 : 32;    // keys per tile
  static constexpr int MBQ = 16 * WARPS * MT;        // query rows a block
  static_assert(BKV % 16 == 0, "a key tile is whole mma k-steps");
};

template <int HD>
size_t mma_smem_bytes() {
  using TL = Tile<HD>;
  return sizeof(__nv_bfloat16) * (size_t)TL::ROW *
         (TL::MBQ + 2 * STAGES * TL::BKV);
}

// two blocks an SM: up to 255 registers a thread
template <int HD>
__global__ void __launch_bounds__(32 * WARPS, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, Strides sq,
                           Strides sk, Strides sv, Strides so, int H, int Hk,
                           int Tq, int Tk, float scale, int causal,
                           int window) {
  using TL = Tile<HD>;
  constexpr int ROW = TL::ROW, HDP = TL::HDP, CH = TL::CHUNKS;
  constexpr int MT = TL::MT, MMA_BK = TL::BKV, MBQ = TL::MBQ;
  constexpr int NTHR = 32 * WARPS;
  constexpr int KSTEPS = HDP / 16;  // k-steps of Q K^T
  constexpr int NTO = HD / 8;       // n8 tiles of the output
  constexpr int NTS = MMA_BK / 8;   // n8 tiles of S
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* ks = qs + MBQ * ROW;              // [STAGES][BK][ROW]
  __nv_bfloat16* vs = ks + STAGES * MMA_BK * ROW;  // [STAGES][BK][ROW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int nqt = gridDim.y;
  // causal: the tiles with the most keys first
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * MBQ;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  // the keys some row of this block can see
  const int q_last = min(q0 + MBQ, Tq) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + MMA_BK - 1) / MMA_BK : 0;

  // zero the pad columns (hd 8 -> 16) once: the copies never write them
  if (HDP != HD) {
    for (int r = tid; r < MBQ + 2 * STAGES * MMA_BK; r += NTHR)
      for (int c = HD; c < HDP; ++c) qs[r * ROW + c] = __float2bfloat16(0.f);
  }

  auto load_kv = [&](int tile, int stage) {
    const int t0 = k_lo + tile * MMA_BK;
    __nv_bfloat16* kd = ks + stage * MMA_BK * ROW;
    __nv_bfloat16* vd = vs + stage * MMA_BK * ROW;
    for (int i = tid; i < MMA_BK * CH; i += NTHR) {
      const int r = i / CH, c = (i % CH) * 8, t = t0 + r;
      const bool ok = t < Tk;
      const long long tt = ok ? t : 0;
      cp_async16(kd + r * ROW + c, kb + tt * sk.t + c, ok);
      cp_async16(vd + r * ROW + c, vb + tt * sv.t + c, ok);
    }
  };

  // Q, then the first K/V tile, in flight together
  for (int i = tid; i < MBQ * CH; i += NTHR) {
    const int r = i / CH, c = (i % CH) * 8, t = q0 + r;
    const bool ok = t < Tq;
    cp_async16(qs + r * ROW + c, qb + (long long)(ok ? t : 0) * sq.t + c, ok);
  }
  cp_async_commit();
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // q * scale rounded to bf16, as the reference scales in the input dtype
  for (int i = tid; i < MBQ * HD; i += NTHR) {
    __nv_bfloat16* p = qs + (i / HD) * ROW + i % HD;
    *p = __float2bfloat16(__bfloat162float(*p) * scale);
  }
  // this warp's Q fragments are read from shared memory at each tile,
  // which keeps 4 KSTEPS MT registers free for the accumulators
  const __nv_bfloat16* qbase =
      qs + (warp * 16 * MT + (lane & 15)) * ROW + (lane >> 4) * 8;

  float oacc[MT][NTO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NTO; ++j)
      oacc[mt][j][0] = oacc[mt][j][1] = oacc[mt][j][2] = oacc[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int g = lane >> 2, tq = lane & 3;
  // this thread's rows: row0 + 16 mt and row0 + 16 mt + 8
  const int row0 = q0 + warp * 16 * MT + g;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % STAGES;
    const int t0 = k_lo + it * MMA_BK;
    if (it + 1 < ntiles) load_kv(it + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * MMA_BK * ROW;
    const __nv_bfloat16* vt = vs + stage * MMA_BK * ROW;

    // S = Q K^T, 16 MT rows x 64 keys per warp; each K fragment serves
    // the warp's MT row tiles
    float s[MT][NTS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTS; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    {
      const __nv_bfloat16* base =
          kt + ((lane & 7) + ((lane >> 4) << 3)) * ROW + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(qa[mt], qbase + mt * 16 * ROW + kk * 16);
#pragma unroll
        for (int jp = 0; jp < NTS / 2; ++jp) {
          uint32_t kf[4];
          ldsm_x4(kf, base + jp * 16 * ROW + kk * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jp], qa[mt], kf[0], kf[1]);
            mma_bf16(s[mt][2 * jp + 1], qa[mt], kf[2], kf[3]);
          }
        }
      }
    }

    // the mask, only on tiles that cross its edge
    const bool edge = t0 + MMA_BK > Tk || (causal && t0 + MMA_BK - 1 > q0) ||
                      (window > 0 && q_last - t0 >= window);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NTS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + 16 * mt + (e >> 1) * 8;
            const int kp = t0 + j * 8 + 2 * tq + (e & 1);
            bool vis = kp < Tk;
            if (causal) vis = vis && qi >= kp;
            if (window > 0) vis = vis && (qi - kp) < window;
            if (!vis) s[mt][j][e] = NEG_INF;
          }
    }

    // online softmax for the thread's rows; l from the fp32 p
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[mt][i];
#pragma unroll
        for (int j = 0; j < NTS; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * i], s[mt][j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = __expf(m[mt][i] - mx);
        m[mt][i] = mx;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
          s[mt][j][2 * i] = __expf(s[mt][j][2 * i] - mx);
          s[mt][j][2 * i + 1] = __expf(s[mt][j][2 * i + 1] - mx);
          ps += s[mt][j][2 * i] + s[mt][j][2 * i + 1];
        }
        l[mt][i] = l[mt][i] * corr + ps;
#pragma unroll
        for (int j = 0; j < NTO; ++j) {
          oacc[mt][j][2 * i] *= corr;
          oacc[mt][j][2 * i + 1] *= corr;
        }
      }

    // O += P V: P's A fragments are the S accumulators rounded to bf16;
    // each V fragment serves the warp's MT row tiles
    {
      const __nv_bfloat16* base = vt + (lane & 15) * ROW + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < MMA_BK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NTO / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, base + kk * 16 * ROW + dp * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(oacc[mt][2 * dp], pa[mt], vf[0], vf[1]);
            mma_bf16(oacc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
          }
        }
        if (NTO % 2) {
          uint32_t vf[2];
          ldsm_x2_t(vf, base + kk * 16 * ROW + (NTO - 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(oacc[mt][NTO - 1], pa[mt], vf[0], vf[1]);
        }
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qi = row0 + 16 * mt + 8 * i;
      if (qi >= Tq) continue;
      const float inv = 1.0f / fmaxf(li, 1e-30f);
      __nv_bfloat16* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * tq) =
            __floats2bfloat162_rn(oacc[mt][j][2 * i] * inv,
                                  oacc[mt][j][2 * i + 1] * inv);
      }
    }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
               int Hk, int Tq, int Tk, float scale, int causal, int window,
               cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<HD><<<grid, F32Tile<HD>::THREADS, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, sk,
      sv, so, H, Hk, Tq, Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                int Hk, int Tq, int Tk, float scale, int causal, int window,
                cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  // the attribute is per kernel and per device: set once on each device
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const dim3 grid(B * H, (Tq + Tile<HD>::MBQ - 1) / Tile<HD>::MBQ);
  flash_attention_mma_kernel<HD><<<grid, 32 * WARPS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq, sk, sv, so, H, Hk, Tq,
      Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v and o in that order
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* st, int B, int H, int Hk,
                                   int Tq, int Tk, int hd, float scale,
                                   int causal, int window, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(HD)                                                          \
  case HD:                                                                   \
    return launch_f32<HD>(q, k, v, o, sq, sk, sv, so, B, H, Hk, Tq, Tk,      \
                          scale, causal, window, s);
  switch (hd) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(80)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// bf16 on tensor cores.  Pointers 16-byte aligned and strides multiples of
// 8 elements.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* st, int B, int H, int Hk,
                                    int Tq, int Tk, int hd, float scale,
                                    int causal, int window, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(HD)                                                          \
  case HD:                                                                   \
    return launch_bf16<HD>(q, k, v, o, sq, sk, sv, so, B, H, Hk, Tq, Tk,     \
                           scale, causal, window, s);
  switch (hd) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(80)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}
