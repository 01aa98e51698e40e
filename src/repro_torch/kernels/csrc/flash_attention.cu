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
// Head dims built: 8, 16, 32 (the JAX package's test grid), 64
// (whisper-tiny), 80 (zamba2), 128 (qwen2, qwen1.5, phi3, dbrx, internvl2)
// and 256 (gemma3).  The dtype and the head dim pick the kernel: bf16 at
// hd 64, 80 and 128 `flash_attention_wgmma_kernel`, bf16 at hd 8, 16, 32
// and 256 `flash_attention_mma_kernel`, fp32 `flash_attention_kernel`.
// Whisper's T 1,500 is off every tile: rows past Tq are loaded as zeros
// and never written, keys past Tk are zero-filled and masked.
//
// Design of the bf16 kernel at hd 64, 80 and 128 (`flash_attention_wgmma_
// kernel`, every served and trained LM's but gemma3's): warp-specialized
// blocks on Hopper's `wgmma` with tiles fed by TMA (csrc/sm90.cuh), the
// backward's layout (csrc/flash_attention_bwd.cu).  A block owns 128 query
// rows of one (b, h) as two consumer warpgroups of 64 rows; the first
// thread of a third, producer warpgroup loads Q once (boxes of 64 x 64
// bf16, 128-byte swizzle) and streams the key tiles of 128 keys through a
// ring of two stages, K and V on mbarriers of their own, so that S of a
// tile starts before its V has landed (setmaxnreg: 240 registers a
// consumer thread, 24 a producer one).  Each consumer scales its Q rows
// in shared memory to q * scale rounded to bf16 (no prep launch, which
// would read and write Q once more) and fences them for wgmma.  Per tile:
// S = qs K^T by `wgmma` m64n128 from shared memory (ceil(hd / 16) k16
// slices, both operands K-major) into 64 fp32 registers; the mask only on
// tiles that cross its edge; the online softmax with a row's max and sum
// over the quad of threads that holds it, p = 2^(s log2 e - m log2 e) by
// one FFMA and one EX2, l from the unrounded fp32 p; then O = O * exp(m_old
// - m_new) + P V by `wgmma` with P as the bf16 A operand straight from S's
// accumulators and V read through the transpose bit (n64 at hd 64, n128 at
// hd 80 and 128).  The tiles are software-pipelined: S of tile j and PV of
// tile j - 1 are issued together, the softmax of tile j runs while PV of
// j - 1 does, and O is rescaled after it, the plain online softmax's order
// (O + P_{j-1} V_{j-1}) c_j.  P's registers are written only once no
// product is in flight (written earlier, ptxas serialized every wgmma:
// its note C7513).  The two consumers take turns on the tensor cores
// (named barriers): one issues its products while the other's softmax
// runs.  hd 80 runs at the width of two panels: the tensor maps zero-fill
// the columns past hd, which add exact zeros to S, and the output's padded
// columns are never stored.  Key tiles sit on multiples of 128 keys and
// are walked in one order, with no split of the keys across blocks and no
// atomics, so a row's output depends only on its q, the keys and the mask
// settings: paged equals unpaged, a sequence split equals the whole
// sequence bit for bit.  Every tile of a block's range is visited by both
// consumers (bit-neutral for a row the mask hides it from: p is 0 after a
// visible key, and before one a row still at m = -1e30 takes p = 0).
// What still separates it from its bound: the exp and the rescale on the
// CUDA cores (at hd 64 as long as the products), the waits at each turn,
// the tail of a grid of one block an SM, and at hd 80 PV's padded columns
// (128 of 80).
//
// Design of the bf16 kernel at hd 8, 16, 32 and 256
// (`flash_attention_mma_kernel`): the FlashAttention-2 shape on tensor
// cores.  A block owns 128 query rows of one (b, h) (64 at hd 256): 4
// warps of 32 rows, each as two 16-row tiles (one at hd 256, where the O
// accumulator alone is 128 registers a thread), and walks the key tiles of
// BK = 64 keys (32 at hd 256) inside the block, carrying (m, l, o) in
// registers.
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
// edge.  Both tensor-core kernels put the query tile in the grid's slow
// dimension and launch the causal tiles with the most keys first, so the
// short ones fill the tail across the 132 SMs.  What still separates this
// one from the bound: the softmax's exp, max and rescale on the CUDA cores
// between the two products of each tile, and mma.sync in place of
// Hopper's wgmma (hd 256 is queued for the wgmma route).
//
// fp32 inputs keep the exact kernel (`flash_attention_kernel`): one thread
// per query row (hd / 32 neighbouring lanes from hd 128, each holding 32
// dims of q and o and summing its partial scores with shuffles, so that a
// row's registers never exceed 64 floats), fp32 FMAs on the CUDA cores,
// K/V tiles in static shared memory in fp32 (at most 40 KB).  TF32
// tensor cores would break the fp32 tolerance, and no serving path sends
// fp32; the dtype selects the kernel.
//
// The mask (csrc/attn_mask.cuh) is the reference's: query row i at
// position q_offset + i, keys below kv_start hidden, so a rank of a
// sequence split attends from its positions over the gathered keys and
// halo attention masks a missing halo; every kernel walks only the key
// tiles that some row of a block can see in that shifted frame.  The two
// bf16 kernels are instantiated for the shifted and the unshifted frame
// (SHIFT), the latter with its tests on scalar settings as they were
// before the shift existed (csrc/attn_mask.cuh), and each launch takes the
// one its settings need.
//
// A row with no visible key at all (possible only with a window and no
// causal mask, or with keys hidden by kv_start) is not defined alike by the
// two reference functions: each averages the values of the masked keys it
// happens to visit, as the fp32 and mma.sync kernels do over the tiles
// they visit (none: zeros, and an lse of about -1e30); the wgmma kernel
// gives such a row zeros and an lse of about -1e30 whatever it visits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mask.cuh"
#include "mma.cuh"
#include "sm90.cuh"

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
                       float* __restrict__ lse, Strides sq, Strides sk,
                       Strides sv, Strides so, int H, int Hk, int Tq, int Tk,
                       float scale, AttnMask mask) {
  // a local copy: a reference to a kernel parameter would put it in
  // local memory
  const AttnMask mk = mask;
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
  const int k_hi = mk.key_hi(q_last, Tk);
  const int k_lo = mk.key_lo(q0);
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
        const bool vis = mk.visible(qi, kp, j < nk && q_ok);
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
    if (lse != nullptr && sub == 0)
      lse[((long long)b * H + h) * Tq + qi] = m + logf(fmaxf(l, 1e-30f));
    float* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
#pragma unroll
    for (int i = 0; i < G4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[4 * (sub + TPR * i) + c] = acc[4 * i + c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 8, 16, 32 and 256: tensor cores (mma.sync m16n8k16),
// cp.async K/V ring
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;   // K/V tiles in flight
constexpr int WARPS = 4;    // warps a block

// Per head dim (8, 16, 32 and 256; 64, 80 and 128 take the wgmma kernel
// below): the head dim padded to the mma's k = 16, the shared-memory row
// (16 B more, against bank conflicts in ldmatrix), and the tiles.  A
// warp's O accumulator is MT x hd/8 x 4 fp32 registers a thread and its S
// tile MT x BKV/8 x 4, under the 255-register cap of two blocks an SM:
// up to hd 32 a warp holds MT = 2 query tiles (128 rows a block) over
// 64-key tiles; at hd 256 one tile (64 rows a block) over 32-key tiles (O
// 128 and S 16 registers), so that Q and two K/V stages stay at 99 KB of
// shared memory and two blocks still fit on an SM.
template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 15) / 16 * 16;
  static constexpr int ROW = HDP + 8;    // bf16 elements per smem row
  static constexpr int CHUNKS = HD / 8;  // 16-byte pieces of a global row
  static constexpr int MT = HD <= 32 ? 2 : 1;        // 16-row tiles a warp
  static constexpr int BKV = HD <= 32 ? 64 : 32;     // keys per tile
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
template <int HD, bool SHIFT>
__global__ void __launch_bounds__(32 * WARPS, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, Strides sq, Strides sk,
                           Strides sv, Strides so, int H, int Hk, int Tq,
                           int Tk, float scale, AttnMask mask) {
  // the unshifted frame's settings as scalars; the shifted frame's as a
  // local copy (a reference to a kernel parameter would put it in local
  // memory)
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
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
  // causal: the tiles with the most keys first (the last rows see the
  // most keys at any q_offset)
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * MBQ;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  // the keys some row of this block can see
  const int q_last = min(q0 + MBQ, Tq) - 1;
  const int k_hi = SHIFT ? mk.key_hi(q_last, Tk)
                         : (causal ? min(Tk, q_last + 1) : Tk);
  const int k_lo = SHIFT ? mk.key_lo(q0)
                         : (window > 0 ? max(0, q0 - window + 1) : 0);
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
    bool edge;
    if constexpr (SHIFT)
      edge = t0 + MMA_BK > Tk || mk.cuts(q0, q_last - q0 + 1, t0, MMA_BK);
    else
      edge = t0 + MMA_BK > Tk || (causal && t0 + MMA_BK - 1 > q0) ||
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
            if constexpr (SHIFT) {
              vis = mk.visible(qi, kp, vis);
            } else {
              if (causal) vis = vis && qi >= kp;
              if (window > 0) vis = vis && (qi - kp) < window;
            }
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
      if (lse != nullptr && tq == 0)
        lse[((long long)b * H + h) * Tq + qi] =
            m[mt][i] + logf(fmaxf(li, 1e-30f));
      __nv_bfloat16* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * tq) =
            __floats2bfloat162_rn(oacc[mt][j][2 * i] * inv,
                                  oacc[mt][j][2 * i + 1] * inv);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 80 and 128: wgmma on TMA-fed tiles (sm90.cuh)
// ---------------------------------------------------------------------------

constexpr int WG = 128;           // threads of a warpgroup
constexpr int WG_BLOCK = 3 * WG;  // two consumer warpgroups, one producer

// Per head dim: the width padded to whole 64-column panels (hd 80 -> 128,
// the columns past hd zero-filled by the tensor maps), the k16 slices of
// S's depth hd, and the shared-memory layout (byte offsets; every tile on
// 1024 bytes): Q of the block's 128 rows (each warpgroup's 64 rows as P
// panels of 64 x 64), then a ring of STAGES K tiles and one of V tiles
// (BK rows, P panels of BK x 64), then the barriers.
template <int HD>
struct WgTile {
  static constexpr int HDP = (HD + 63) / 64 * 64;
  static constexpr int P = HDP / 64;
  static constexpr int KK = (HD + 15) / 16;
  static constexpr int BM = 128;  // query rows a block
  static constexpr int BK = 128;  // keys a tile
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;  // a K or a V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // + q_full, full and empty of K and of V a stage, + slack to align
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(HD % 16 == 0 && HDP <= 128, "k16 slices, n128 at most");
};

// 2^x on the SFU (relative error about 2^-22, subnormals flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A block owns 128 query rows of one (b, h): warpgroups 0 and 1 own 64
// rows each, warpgroup 2's first thread loads Q once and streams the key
// tiles of kv head h / (H / Hk) (BK keys, on multiples of BK) through a
// ring of STAGES stages, K and V on barriers of their own.  Per tile each
// consumer computes S = qs K^T (both operands from shared memory), the
// online softmax in registers, and O = O * exp(m_old - m_new) + P V with P
// the bf16 A operand from registers and V read through the transpose bit,
// pipelined and in turns as the top says.  SHIFT: the mask's frame
// (csrc/attn_mask.cuh).
template <int HD, bool SHIFT>
__global__ void __launch_bounds__(WG_BLOCK, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, Strides so, int H,
                             int Hk, int Tq, int Tk, float scale,
                             AttnMask mask) {
  // the unshifted frame's settings as scalars; the shifted frame's as a
  // local copy (a reference to a kernel parameter would put it in local
  // memory)
  const int causal = mask.causal, window = mask.window;
  const AttnMask mk = mask;
  using TL = WgTile<HD>;
  using bf = __nv_bfloat16;
  constexpr int HDP = TL::HDP, P = TL::P, BK = TL::BK, STAGES = TL::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = sm90::align1k(wg_smem_raw);
  bf* qs = reinterpret_cast<bf*>(smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + TL::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hk);
  // causal: the tiles with the most keys first (the last rows see the
  // most keys at any q_offset)
  const int nqt = gridDim.y;
  const int q0 =
      TL::BM * (causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y);
  // the keys some row of this block can see, in tiles on multiples of BK
  // (so a row meets the same tiles whatever block it falls in)
  const int q_last = min(q0 + TL::BM, Tq) - 1;
  const int k_hi = SHIFT ? mk.key_hi(q_last, Tk)
                         : (causal ? min(Tk, q_last + 1) : Tk);
  const int k_lo = SHIFT ? mk.key_lo(q0)
                         : (window > 0 ? max(0, q0 - window + 1) : 0);
  const int kt0 = k_lo / BK;
  const int n_it = k_hi > k_lo ? (k_hi + BK - 1) / BK - kt0 : 0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&k_empty[s], 2 * WG);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], 2 * WG);
    }
    sm90::fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(q_full, TL::Q_BYTES);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int p = 0; p < P; ++p)
          sm90::tma_load_4d(qs + (w * P + p) * 64 * 64, &tm_q, q_full,
                            64 * p, q0 + 64 * w, h, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, t0 = (kt0 + it) * BK;
        const uint32_t ph = ((it / STAGES) & 1) ^ 1;
        bf* k_s = reinterpret_cast<bf*>(smem + TL::OFF_K + s * TL::KV_BYTES);
        bf* v_s = reinterpret_cast<bf*>(smem + TL::OFF_V + s * TL::KV_BYTES);
        sm90::mbar_wait(&k_empty[s], ph);
        sm90::mbar_expect_tx(&k_full[s], TL::KV_BYTES);
#pragma unroll
        for (int p = 0; p < P; ++p)
          sm90::tma_load_4d(k_s + p * BK * 64, &tm_k, &k_full[s], 64 * p, t0,
                            hk, b);
        sm90::mbar_wait(&v_empty[s], ph);
        sm90::mbar_expect_tx(&v_full[s], TL::KV_BYTES);
#pragma unroll
        for (int p = 0; p < P; ++p)
          sm90::tma_load_4d(v_s + p * BK * 64, &tm_v, &v_full[s], 64 * p, t0,
                            hk, b);
      }
    }
  } else {  // consumers
    sm90::regs_inc<240>();
    const int t = threadIdx.x % WG, warp = t / 32, g8 = (t % 32) / 4,
              q4 = t % 4;
    const int qw0 = q0 + 64 * wg;  // this warpgroup's first row
    bf* qw = qs + wg * P * 64 * 64;
    // this thread's rows: r0 and r0 + 8
    const int r0 = qw0 + 16 * warp + g8;
    sm90::mbar_wait(q_full, 0);
    // q * scale rounded to bf16 in place, as the reference scales in the
    // input dtype (elementwise: the swizzle does not matter), made visible
    // to wgmma before the warpgroup's first product
    {
      uint4* q16 = reinterpret_cast<uint4*>(qw);
      for (int i = t; i < P * 64 * 64 / 8; i += WG) {
        uint4 x = q16[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        q16[i] = x;
      }
      sm90::fence_proxy_async();
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    }
    float oacc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) oacc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    // S of a tile (BK / 2 fp32 a thread: sc[4 j + e] is row r0 + 8 (e /
    // 2), key t0 + 8 j + 2 q4 + e % 2), P of the previous one as the bf16
    // A operand of its PV product (sm90.cuh)
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    // S = qs K^T of tile `it` issued (ceil(hd / 16) slices); the slice-0
    // descriptors are made opaque to the compiler each tile, so that it
    // adds each slice's offset instead of holding every slice's descriptor
    // in registers across the loop
    auto issue_s = [&](int it) {
      const int st = it % STAGES;
      uint64_t dq = sm90::desc_k(qw, 64, 0);
      uint64_t dk = sm90::desc_k(
          reinterpret_cast<const bf*>(smem + TL::OFF_K + st * TL::KV_BYTES),
          BK, 0);
      asm volatile("" : "+l"(dq), "+l"(dk));
#pragma unroll
      for (int kk = 0; kk < TL::KK; ++kk)
        sm90::wgmma_ss_n128(sc, dq + sm90::k_offset(64, kk),
                            dk + sm90::k_offset(BK, kk), kk);
      sm90::wgmma_commit();
    };
    // O += P V of tile `it` issued (V of its stage read MN-major)
    auto issue_pv = [&](int it) {
      const int st = it % STAGES;
      uint64_t dv = sm90::desc_mn(
          reinterpret_cast<const bf*>(smem + TL::OFF_V + st * TL::KV_BYTES),
          BK, 0);
      asm volatile("" : "+l"(dv));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs_t<HDP>(oacc, pa[kk], dv + sm90::mn_offset(kk));
      sm90::wgmma_commit();
    };
    // the mask on tile `it` where it crosses the mask's edge, the online
    // softmax of the thread's two rows (a row's maxima over the quad of
    // threads that holds it; l from the fp32 p), and the rescale factors
    // of the rows' O
    auto softmax = [&](int it, float& c0, float& c1) {
      const int t0 = (kt0 + it) * BK;
      const bool edge =
          t0 + BK > Tk ||
          (SHIFT ? mk.cuts(qw0, 64, t0, BK)
                 : (causal && qw0 < t0 + BK - 1) ||
                       (window > 0 && qw0 + 63 - t0 >= window));
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int qi = r0 + 8 * ((i / 2) & 1);
          const int kp = t0 + 8 * (i / 4) + 2 * q4 + (i & 1);
          bool vis = kp < Tk;
          if constexpr (SHIFT) {
            vis = mk.visible(qi, kp, vis);
          } else {
            if (causal) vis = vis && qi >= kp;
            if (window > 0) vis = vis && (qi - kp) < window;
          }
          if (!vis) sc[i] = NEG_INF;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      c0 = __expf(m0 - mx0);
      c1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
      // p = 2^(s log2 e - m log2 e), one FFMA and one EX2 an entry; a row
      // with no visible key yet takes m log2 e = 0, so its masked entries
      // give p = 0
      const float ml0 = mx0 == NEG_INF ? 0.f : mx0 * 1.4426950408889634f;
      const float ml1 = mx1 == NEG_INF ? 0.f : mx1 * 1.4426950408889634f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], 1.4426950408889634f, -ml0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], 1.4426950408889634f, -ml0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], 1.4426950408889634f, -ml1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], 1.4426950408889634f, -ml1));
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
    };
    // P's A fragments: S's accumulators rounded to bf16
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    // The two consumers take turns on the tensor cores (named barriers 3
    // and 4, one a warpgroup): a warpgroup issues a turn's products once
    // the other has issued its own, so that one's softmax runs while the
    // other's products do.  Warpgroup 0 takes the first turn; each turn
    // hands the next to the other warpgroup, but warpgroup 1's last (no
    // turn of warpgroup 0 is left).  A tile's turn: S of the tile and PV
    // of the one before; one more turn for the last PV.
    auto turn_begin = [&]() {
      asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(2 * WG)
                   : "memory");
    };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1))
        asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - wg), "n"(2 * WG)
                     : "memory");
    };
    if (n_it > 0 && wg == 1) turn_end(false);
    if (qw0 >= Tq) {  // no row of this warpgroup: release every stage
      for (int it = 0; it <= n_it; ++it) {
        if (it < n_it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          sm90::mbar_wait(&k_full[st], ph);
          sm90::mbar_arrive(&k_empty[st]);
          sm90::mbar_wait(&v_full[st], ph);
          sm90::mbar_arrive(&v_empty[st]);
        }
        if (n_it > 0) {
          turn_begin();
          turn_end(it == n_it);
        }
      }
    } else if (n_it > 0) {
      // Software-pipelined over the tiles: the softmax of tile it runs
      // while the tensor cores compute PV of tile it - 1, and O is
      // rescaled after that product (O = (O + P_{it-1} V_{it-1}) c_it,
      // the order of the plain online softmax).  Every tile of the
      // block's range is visited (one the mask hides from all of this
      // warpgroup's rows changes no bit: its p is 0 whatever the row's m).
      float c0, c1;
      sm90::mbar_wait(&k_full[0], 0);
      turn_begin();
      sm90::wgmma_fence();
      issue_s(0);
      turn_end(false);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(&k_empty[0]);
      softmax(0, c0, c1);
      pack();
      for (int it = 1; it < n_it; ++it) {
        const int st = it % STAGES, pst = (it - 1) % STAGES;
        sm90::mbar_wait(&k_full[st], (it / STAGES) & 1);
        sm90::mbar_wait(&v_full[pst], ((it - 1) / STAGES) & 1);
        turn_begin();
        sm90::wgmma_fence();
        issue_s(it);
        issue_pv(it - 1);
        turn_end(false);
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);
        sm90::mbar_arrive(&k_empty[st]);
        softmax(it, c0, c1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(oacc);
        sm90::mbar_arrive(&v_empty[pst]);
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i) oacc[i] *= ((i / 2) & 1) ? c1 : c0;
        // P's registers are written only once no product is in flight (a
        // write while one runs made ptxas serialize every wgmma, C7513)
        pack();
      }
      const int pst = (n_it - 1) % STAGES;
      sm90::mbar_wait(&v_full[pst], ((n_it - 1) / STAGES) & 1);
      turn_begin();
      sm90::wgmma_fence();
      issue_pv(n_it - 1);
      turn_end(true);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(oacc);
      sm90::mbar_arrive(&v_empty[pst]);
    }
    // a row's sum over its quad; a row that saw no visible key (m still
    // -1e30) gives zeros and an lse of about -1e30
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qi = r0 + 8 * hi;
      if (qi >= Tq) continue;
      const float mi = hi ? m1 : m0, li = fmaxf(hi ? l1 : l0, 1e-30f);
      const float inv = mi > NEG_INF ? 1.0f / li : 0.f;
      if (lse != nullptr && q4 == 0)
        lse[((long long)b * H + h) * Tq + qi] = mi + logf(li);
      __nv_bfloat16* orow = o + b * so.b + h * so.h + (long long)qi * so.t;
      // columns 8 j + 2 q4 (+ 1) below hd; hd 80's padded ones never stored
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * q4) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * hi] * inv,
                                  oacc[4 * j + 2 * hi + 1] * inv);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int B, int H, int Hk, int Tq, int Tk, float scale,
               AttnMask mk, cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<HD><<<grid, F32Tile<HD>::THREADS, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, sq,
      sk, sv, so, H, Hk, Tq, Tk, scale, mk);
  return (int)cudaGetLastError();
}

template <int HD, bool SHIFT>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int B, int H, int Hk, int Tq, int Tk, float scale,
               AttnMask mk, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  // the attribute is per kernel and per device: set once on each device
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD, SHIFT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const dim3 grid(B * H, (Tq + Tile<HD>::MBQ - 1) / Tile<HD>::MBQ);
  flash_attention_mma_kernel<HD, SHIFT><<<grid, 32 * WARPS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, sq, sk, sv, so, H, Hk,
      Tq, Tk, scale, mk);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                int B, int H, int Hk, int Tq, int Tk, float scale,
                AttnMask mk, cudaStream_t stream) {
  return shifted(mk) ? launch_mma<HD, true>(q, k, v, o, lse, sq, sk, sv, so,
                                            B, H, Hk, Tq, Tk, scale, mk,
                                            stream)
                     : launch_mma<HD, false>(q, k, v, o, lse, sq, sk, sv, so,
                                             B, H, Hk, Tq, Tk, scale, mk,
                                             stream);
}

template <int HD, bool SHIFT>
int launch_wgmma_in(const void* q, const void* k, const void* v, void* o,
                    float* lse, Strides sq, Strides sk, Strides sv,
                    Strides so, int B, int H, int Hk, int Tq, int Tk,
                    float scale, AttnMask mk, cudaStream_t stream) {
  using TL = WgTile<HD>;
  // the attribute is per kernel and per device: set once on each device
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, SHIFT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TL::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  // byte strides of (t, head, b); a map needs T >= 1 (no key is loaded
  // where Tk is 0)
  CUtensorMap m_q, m_k, m_v;
  const long long e = sizeof(__nv_bfloat16), tk = Tk > 0 ? Tk : 1;
  if ((err = sm90::tile_map(&m_q, q, HD, Tq, H, B, sq.t * e, sq.h * e,
                            sq.b * e, 64)) != cudaSuccess ||
      (err = sm90::tile_map(&m_k, k, HD, tk, Hk, B, sk.t * e, sk.h * e,
                            sk.b * e, TL::BK)) != cudaSuccess ||
      (err = sm90::tile_map(&m_v, v, HD, tk, Hk, B, sv.t * e, sv.h * e,
                            sv.b * e, TL::BK)) != cudaSuccess)
    return (int)err;
  const dim3 grid(B * H, (Tq + TL::BM - 1) / TL::BM);
  flash_attention_wgmma_kernel<HD, SHIFT>
      <<<grid, WG_BLOCK, TL::SMEM, stream>>>(m_q, m_k, m_v,
                                             (__nv_bfloat16*)o, lse, so, H,
                                             Hk, Tq, Tk, scale, mk);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                 int B, int H, int Hk, int Tq, int Tk, float scale,
                 AttnMask mk, cudaStream_t stream) {
  return shifted(mk)
             ? launch_wgmma_in<HD, true>(q, k, v, o, lse, sq, sk, sv, so, B,
                                         H, Hk, Tq, Tk, scale, mk, stream)
             : launch_wgmma_in<HD, false>(q, k, v, o, lse, sq, sk, sv, so, B,
                                          H, Hk, Tq, Tk, scale, mk, stream);
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v and o in that order.
// q_offset: the position of query row 0; kv_start: the first visible key
// (both >= 0; csrc/attn_mask.cuh).
// lse: null, or (B, H, Tq) fp32 written with each row's log-sum-exp of its
// scaled scores (m + log l), which the backward (flash_attention_bwd.cu)
// recomputes P from; serving passes null and does the same work as without.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   const long long* st, int B, int H, int Hk,
                                   int Tq, int Tk, int hd, float scale,
                                   int causal, int window, int q_offset,
                                   int kv_start, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const cudaStream_t s = (cudaStream_t)stream;
  const AttnMask mk{causal, window, q_offset, kv_start};
#define FA_CASE(HD)                                                          \
  case HD:                                                                   \
    return launch_f32<HD>(q, k, v, o, lse, sq, sk, sv, so, B, H, Hk, Tq, Tk, \
                          scale, mk, s);
  switch (hd) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
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
                                    const void* v, void* o, float* lse,
                                    const long long* st, int B, int H, int Hk,
                                    int Tq, int Tk, int hd, float scale,
                                    int causal, int window, int q_offset,
                                    int kv_start, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const cudaStream_t s = (cudaStream_t)stream;
  const AttnMask mk{causal, window, q_offset, kv_start};
#define FA_CASE(HD, ROUTE)                                                   \
  case HD:                                                                   \
    return ROUTE<HD>(q, k, v, o, lse, sq, sk, sv, so, B, H, Hk, Tq, Tk,      \
                     scale, mk, s);
  switch (hd) {
    FA_CASE(8, launch_bf16)
    FA_CASE(16, launch_bf16)
    FA_CASE(32, launch_bf16)
    FA_CASE(64, launch_wgmma)
    FA_CASE(80, launch_wgmma)
    FA_CASE(128, launch_wgmma)
    FA_CASE(256, launch_bf16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}
