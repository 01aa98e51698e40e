// The attention mask shared by flash_attention.cu and flash_attention_bwd.cu:
// the reference's (src/repro/models/layers.py, `blockwise_attention`'s
// `q_offset` and `kv_start`) with the TPU kernel's window rule
// (src/repro/kernels/flash_attention.py: the window applies with or
// without `causal`).  Query row i sits at position q_offset + i; key j is
// visible iff j >= kv_start, q_offset + i >= j under `causal`, and
// q_offset + i - j < window where window > 0.  A sequence split over ranks
// gives each rank's queries their absolute positions (q_offset) against
// the gathered keys; halo attention masks a missing predecessor's halo
// (kv_start).  Rows and keys past Tq / Tk are the caller's to skip.
//
// The tensor-core routes (the bf16 forward, the wgmma backward) are
// instantiated twice: for a shifted frame (`shifted`), through these
// methods, and for the unshifted one, with the tests on the scalar settings
// `causal` and `window` in the form they had before the shift existed.
// Their generated code is fragile: the same values through an AttnMask
// (the methods, or its fields read from a local copy) ran the forward
// 4-11% and the wgmma passes 30-60% slower on an H100
// (tools/time_attention_{fwd,bwd}.py, in turns with the earlier sources).
#pragma once

namespace {

struct AttnMask {
  int causal, window, q_offset, kv_start;

  // key kp visible to query row qi, and `vis` (the caller's bounds)
  __device__ __forceinline__ bool visible(int qi, int kp, bool vis) const {
    const int qp = q_offset + qi;
    vis = vis && kp >= kv_start;
    if (causal) vis = vis && qp >= kp;
    if (window > 0) vis = vis && qp - kp < window;
    return vis;
  }
  // the keys [key_lo(q0), key_hi(q_last, Tk)) that some row of q0..q_last
  // can see (empty where key_lo >= key_hi)
  __device__ __forceinline__ int key_lo(int q0) const {
    return window > 0 ? max(kv_start, q_offset + q0 - window + 1) : kv_start;
  }
  __device__ __forceinline__ int key_hi(int q_last, int Tk) const {
    return causal ? min(Tk, q_offset + q_last + 1) : Tk;
  }
  // the rows [row_lo(k0), row_hi(k_last, Tq)) that some key of k0..k_last
  // is visible to (empty where every key is below kv_start)
  __device__ __forceinline__ int row_lo(int k0) const {
    return causal ? max(0, k0 - q_offset) : 0;
  }
  __device__ __forceinline__ int row_hi(int k_last, int Tq) const {
    if (k_last < kv_start) return 0;
    return window > 0 ? min(Tq, k_last + window - q_offset) : Tq;
  }
  // some pair of rows [q0, q0 + nq) and keys [k0, k0 + nk) is visible
  __device__ __forceinline__ bool any(int q0, int nq, int k0, int nk) const {
    const int qp0 = q_offset + q0, qp1 = qp0 + nq - 1, k1 = k0 + nk - 1;
    return k1 >= kv_start && !(causal && qp1 < k0) &&
           !(window > 0 && qp0 - k1 >= window);
  }
  // some pair of that block is hidden (the block needs the mask)
  __device__ __forceinline__ bool cuts(int q0, int nq, int k0, int nk) const {
    const int qp0 = q_offset + q0, qp1 = qp0 + nq - 1, k1 = k0 + nk - 1;
    return k0 < kv_start || (causal && qp0 < k1) ||
           (window > 0 && qp1 - k0 >= window);
  }
};

// whether the frame is shifted: the instantiation a launcher picks
__host__ __forceinline__ bool shifted(const AttnMask& mk) {
  return mk.q_offset != 0 || mk.kv_start != 0;
}

}  // namespace
