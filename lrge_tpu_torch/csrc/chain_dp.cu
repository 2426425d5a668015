// Chain DP with minimap2's max_chain_skip break, one warp per row.
//
// Replaces the Pallas TPU kernel lrge_tpu/ops/chain_pallas.py::chain_dp_skip
// (body _chain_kernel).  Semantics: see lrge_tpu_torch/ops/chain_kernel.py,
// whose chain_dp_skip_plain is the reference this kernel is held to.
//
// Layout: a row's predecessor ring (W newest anchors, position d = 0 is
// the newest) lives in the registers of one warp; lane l holds the S =
// max(1, W/32) consecutive positions d = l*S + s.  For W = 16 the upper
// lanes hold positions >= W, which never count as predecessors.  Per
// anchor the warp computes the candidate scores of all W predecessors,
// the marked set (OR-reduced one-hot votes, one 32-bit plane per 32
// positions), three dependent prefix scans over positions (running max,
// skip-counter sum, its running min) with __shfl_up_sync, and the cut,
// best score and nearest best position with __reduce_*_sync; then the
// ring shifts by one position (__shfl_up_sync carries the last slot of
// each lane to the next lane) and lane 0 takes the new anchor.
//
// Bound: latency of the ~30 dependent shuffle rounds per anchor; the
// bytes per row are tiny.  Anchors are loaded 32 at a time (one per
// lane, coalesced) and broadcast with one shuffle per step; results are
// staged in the lane that owns the slot and stored 32 at a time.  Each
// row walks only its own valid-anchor count and fills the rest with
// (NEG, 0).
//
// Float rounding follows the reference op for op (no FMA contraction:
// explicit _rn intrinsics, and the build passes -fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -1073741824;  // INT32_MIN / 2
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ float mg_log2(float x) {
  unsigned bits = __float_as_uint(x);
  float log2 = __fsub_rn(static_cast<float>((bits >> 23) & 255u), 128.0f);
  bits = (bits & ~(255u << 23)) + (127u << 23);
  float zf = __uint_as_float(bits);
  float t = __fmul_rn(__fadd_rn(__fmul_rn(-0.34484843f, zf), 2.02466578f), zf);
  return __fsub_rn(__fadd_rn(log2, t), 0.67487759f);
}

// Exclusive and inclusive warp scans of per-lane aggregates.
template <typename Op>
__device__ __forceinline__ int warp_excl_scan(int agg, int ident, int lane, Op op) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL, agg, o);
    if (lane >= o) agg = op(agg, t);
  }
  int excl = __shfl_up_sync(FULL, agg, 1);
  return lane == 0 ? ident : excl;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

template <int W>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
chain_dp_kernel(const int* __restrict__ key2, const int* __restrict__ rpos,
                const int* __restrict__ qpos, const int* __restrict__ valid,
                const int* __restrict__ nvalid, int B, int A, float pen_gap,
                int span, int max_gap, int bw, int max_skip,
                int* __restrict__ f_out, int* __restrict__ broke_out) {
  constexpr int S = W >= 32 ? W / 32 : 1;
  constexpr int P = W >= 32 ? W / 32 : 1;  // vote planes
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves together
  const size_t off = static_cast<size_t>(row) * A;
  int n = nvalid[row];
  n = n < 0 ? 0 : (n > A ? A : n);

  int rk[S], rr[S], rq[S], rf[S], rp[S];
  bool rok[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    rk[s] = IMAX; rr[s] = 0; rq[s] = 0; rf[s] = NEG; rp[s] = -1; rok[s] = false;
  }

  for (int base = 0; base < n; base += 32) {
    const int idx = base + lane;
    int lk = IMAX, lr = 0, lq = 0, lv = 0;
    if (idx < n) {
      lk = key2[off + idx]; lr = rpos[off + idx]; lq = qpos[off + idx]; lv = valid[off + idx];
    }
    int my_f = NEG, my_b = 0;
    const int m = min(32, n - base);
    for (int j = 0; j < m; ++j) {
      const int i = base + j;
      const int ck = __shfl_sync(FULL, lk, j);
      const int cr = __shfl_sync(FULL, lr, j);
      const int cq = __shfl_sync(FULL, lq, j);
      const bool cv = __shfl_sync(FULL, lv, j) != 0;

      // candidate scores against the ring
      int cand[S];
      bool okv[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int d = lane * S + s;
        const int dq = cq - rq[s];
        const int dr = cr - rr[s];
        const int dd = abs(dr - dq);
        const int dg = min(dq, dr);
        const bool ok = d < W && rok[s] && rk[s] == ck && dq > 0 && dq <= max_gap &&
                        dr > 0 && dr <= max_gap && dd <= bw;
        int c = NEG;
        if (ok) {
          int sc = min(dg, span);
          const float lin = __fmul_rn(pen_gap, static_cast<float>(dd));
          const float logp = dd >= 1 ? mg_log2(static_cast<float>(dd + 1)) : 0.0f;
          const int pen = static_cast<int>(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
          if (dd != 0 || dg > span) sc -= pen;
          c = sc + rf[s];
        }
        cand[s] = c;
        okv[s] = ok;
      }

      // marked[d]: some ok position d' stores the slot at position d as
      // its predecessor (p_rel = i-1-p[d'] == d)
      unsigned votes[P];
#pragma unroll
      for (int b = 0; b < P; ++b) {
        unsigned v = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int sh = (i - 1 - rp[s]) - 32 * b;
          if (okv[s] && sh >= 0 && sh < 32) v |= 1u << sh;
        }
        votes[b] = __reduce_or_sync(FULL, v);
      }

      // running max of cand (exclusive at each position), seeded with span
      int loc[S];
      loc[0] = cand[0];
#pragma unroll
      for (int s = 1; s < S; ++s) loc[s] = max(loc[s - 1], cand[s]);
      const int cx = warp_excl_scan(loc[S - 1], NEG, lane, MaxOp());
      int a[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int d = lane * S + s;
        const int prev = s == 0 ? cx : max(cx, loc[s - 1]);
        const bool improving = okv[s] && cand[s] > max(prev, span);
        const bool marked = (votes[(d >> 5) % P] >> (d & 31)) & 1u;
        a[s] = (okv[s] && marked && !improving) - (improving ? 1 : 0);
      }

      // Lindley skip counter: n_skip = S_t - min(0, min_{u<=t} S_u)
      int sc_[S];
      sc_[0] = a[0];
#pragma unroll
      for (int s = 1; s < S; ++s) sc_[s] = sc_[s - 1] + a[s];
      const int sx = warp_excl_scan(sc_[S - 1], 0, lane, AddOp());
#pragma unroll
      for (int s = 0; s < S; ++s) sc_[s] += sx;
      int mn[S];
      mn[0] = sc_[0];
#pragma unroll
      for (int s = 1; s < S; ++s) mn[s] = min(mn[s - 1], sc_[s]);
      const int mx = warp_excl_scan(mn[S - 1], IMAX, lane, MinOp());
      int cut = W;
#pragma unroll
      for (int s = S - 1; s >= 0; --s) {
        const int runmin = min(min(mx, mn[s]), 0);
        if (lane * S + s < W && sc_[s] - runmin > max_skip) cut = lane * S + s;
      }
      cut = __reduce_min_sync(FULL, cut);

      // best predecessor among examined positions (d <= cut); ties keep
      // the nearest (smallest d)
      int best = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (lane * S + s > cut) cand[s] = NEG;
        best = max(best, cand[s]);
      }
      best = __reduce_max_sync(FULL, best);
      int bd = W;
#pragma unroll
      for (int s = S - 1; s >= 0; --s)
        if (cand[s] == best) bd = lane * S + s;
      bd = __reduce_min_sync(FULL, bd);

      const bool has_pred = best > span;
      const int f_t = cv ? max(span, best) : NEG;
      const int p_t = (cv && has_pred) ? i - 1 - bd : -1;
      if (lane == j) {
        my_f = f_t;
        my_b = (cv && cut < W) ? 1 : 0;
      }

      // push the anchor onto the ring (newest first)
#define LRGE_PUSH(R, NEWV)                                  \
  {                                                         \
    const int carry = __shfl_up_sync(FULL, (int)R[S - 1], 1); \
    _Pragma("unroll") for (int s = S - 1; s > 0; --s) R[s] = R[s - 1]; \
    R[0] = lane == 0 ? (NEWV) : carry;                      \
  }
      LRGE_PUSH(rk, ck)
      LRGE_PUSH(rr, cr)
      LRGE_PUSH(rq, cq)
      LRGE_PUSH(rf, f_t)
      LRGE_PUSH(rp, p_t)
      LRGE_PUSH(rok, cv)
#undef LRGE_PUSH
    }
    if (idx < A) {
      f_out[off + idx] = my_f;
      broke_out[off + idx] = my_b;
    }
  }
  for (int idx = ((n + 31) / 32) * 32 + lane; idx < A; idx += 32) {
    f_out[off + idx] = NEG;
    broke_out[off + idx] = 0;
  }
}

template <int W>
void launch(const int* key2, const int* rpos, const int* qpos, const int* valid,
            const int* nvalid, int B, int A, float pen_gap, int span, int max_gap,
            int bw, int max_skip, int* f, int* broke, cudaStream_t stream) {
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  chain_dp_kernel<W><<<blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap, bw, max_skip, f,
      broke);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int chain_dp_skip_launch(const int* key2, const int* rpos, const int* qpos,
                                    const int* valid, const int* nvalid, int B, int A,
                                    float pen_gap, int span, int max_gap, int bw,
                                    int max_skip, int window, int* f, int* broke,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 16: launch<16>(key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap, bw, max_skip, f, broke, st); break;
    case 32: launch<32>(key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap, bw, max_skip, f, broke, st); break;
    case 64: launch<64>(key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap, bw, max_skip, f, broke, st); break;
    case 128: launch<128>(key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap, bw, max_skip, f, broke, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
