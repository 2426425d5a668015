// Chain DP with minimap2's max_chain_skip break, one warp per (rid, strand) run.
//
// Replaces the Pallas TPU kernel lrge_tpu/ops/chain_pallas.py::chain_dp_skip
// (body _chain_kernel).  Semantics: see lrge_tpu_torch/ops/chain_kernel.py,
// whose chain_dp_skip_plain is the reference this kernel is held to.
//
// Three variants share one walk (template parameter V):
// - BASE: constant span, outputs f and broke (the ONT main path).
// - EXT also carries the chain-extent state of the XLA scan's -F path
//   (lrge_tpu/ops/overlap_jax.py:661-788): three more rings with
//   per-anchor outputs cnt (chain anchor count), start (rpos << 16 | qpos
//   of the chain's first anchor) and rmf (running max f << 1 | valley
//   bit).
// - SPAN is the scan's with_spans step (overlap_jax.py:624-744, the
//   PacBio/HPC preset), which the reference ran only in XLA: qpos arrives
//   packed as qpos << 8 | span, the score takes the predecessor's span
//   (min(dg, psp) and the (dd != 0 || dg > psp) test), the running max's
//   seed, the floor of f and has_pred take the current anchor's.  It keeps
//   the cnt ring (output cnt, for the min_cnt gate); each predecessor's
//   span is unpacked from its ring qpos, so there is no span ring.
// Each anchor takes its carries from its chosen predecessor: the position
// bd is warp-uniform after the reduce, so every lane selects slot bd % S
// and one __shfl_sync per ring reads lane bd / S.
//
// Why runs are independent.  A row is sorted by (key2, rpos), key2 =
// rid * 2 + strand, so each key2 value is one contiguous run of slots.  A
// predecessor counts only when it is `ok`, and `ok` needs ring_key == ck
// (chain_pallas.py:149).  The marked set (chain_pallas.py:164) takes
// votes from ok positions only, and
// `improving` needs ok, so the skip counter moves only on positions of the
// anchor's own run; the best score and its position do too.  An anchor's
// f, broke, cnt, start and rmf therefore depend only on the earlier
// anchors of its own run, and the walk of a run may start from an empty
// ring (rok = false, rp = -1), which is what the row walk holds at a run
// boundary once the previous run's entries fail `ok` (whatever their
// span, under SPAN).  Slot indices stay absolute (p_t = i - 1 - bd), so
// the marked set's i - 1 - rp means what it means in the row walk.  Every ring entry of a run holds the run's
// key, so the walk keeps no key ring and drops the key compare.
//
// Layout: a run's predecessor ring (W newest anchors, position d = 0 is
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
// What bounds it.  The bytes are tiny (four int32 inputs and two, three
// or five outputs per anchor) and the arithmetic is ~75 integer/f32 operations
// per (anchor, in-run predecessor) pair, so the roofline bound is a few
// hundredths of a millisecond at the main shapes.  What the card waits on
// is the chain of ~25 dependent shuffle rounds per anchor: a warp's walk
// lasts (its anchors) x (one step's latency).  The row-per-warp design
// this replaces ran 512-1,024 warps, each as long as its row.  Here each
// launch runs two kernels.  find_runs_kernel gives each 32-slot chunk of
// a row one warp, which marks the chunk's run starts with one ballot over
// key2, writes the padding past the row's count ((NEG, 0), and 0 for the
// EXT and SPAN planes), and lists the chunk: in the long list when its
// last run reaches the chunk's end (every run longer than a chunk is
// one), in the short list when it starts other runs.  chain_dp_kernel, a persistent
// grid sized to the card's resident warps, then walks every long run to
// its end and after them every short-run chunk's runs, one item a claim.
// The long runs set the critical path and are fewer than the resident
// warps on the main path, so they all start in the first wave; a launch
// lasts about max(longest run x step latency, all anchors x step /
// resident warps).  The lists stay on the card (no host sync, no sort)
// and each slot is written once.

// Float rounding follows the reference op for op (no FMA contraction:
// explicit _rn intrinsics, and the build passes -fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -1073741824;  // INT32_MIN / 2
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;

// the variants (template parameter V); their order is the build report's
// (ops/chain_kernel.py::VARIANTS)
constexpr int BASE = 0, EXT = 1, SPAN = 2;

// resident blocks per SM asked of ptxas for the walk: W <= 32 fits 64
// warps an SM in its registers (32 a thread, with some spill; 6 blocks
// and 40 registers walked the main path's anchors slower on an H100),
// the deeper rings take fewer warps
template <int W>
struct MinBlocks {
  static constexpr int value = W <= 32 ? 8 : (W == 64 ? 4 : 2);
};

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

struct Args {
  const int* key2;
  const int* rpos;
  const int* qpos;
  const int* valid;
  const int* nvalid;
  int B, A;
  float pen_gap;
  int span, max_gap, bw, max_skip;
  int* f_out;
  int* broke_out;
  int* cnt_out;
  int* start_out;
  int* rmf_out;
};

// A run's predecessor ring: lane l holds positions d = l*S + s.  Under
// SPAN, rq holds the packed qpos << 8 | span.
template <int W, int V>
struct Ring {
  static constexpr int S = W >= 32 ? W / 32 : 1;
  static constexpr bool CNT = V != BASE, XT = V == EXT;
  int rr[S], rq[S], rf[S], rp[S];
  bool rok[S];
  // the chain count ring (EXT and SPAN); packed chain start and rmf (EXT)
  int rc[CNT ? S : 1], rs[XT ? S : 1], rm[XT ? S : 1];

  __device__ __forceinline__ Ring() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      rr[s] = 0; rq[s] = 0; rf[s] = NEG; rp[s] = -1; rok[s] = false;
      if constexpr (CNT) rc[s] = 0;
      if constexpr (XT) { rs[s] = 0; rm[s] = 0; }
    }
  }
};

// One lane's outputs for the slot it holds; the initial value is the
// padding's.
struct Out {
  int f = NEG, b = 0, c = 0, s = 0, r = 0;
};

template <int V>
__device__ __forceinline__ void store(const Args& a, size_t at, const Out& o) {
  a.f_out[at] = o.f;
  a.broke_out[at] = o.b;
  if constexpr (V != BASE) a.cnt_out[at] = o.c;
  if constexpr (V == EXT) {
    a.start_out[at] = o.s;
    a.rmf_out[at] = o.r;
  }
}

// Walk slots [base + j0, base + j1) of the 32-slot block whose slot
// base + lane is held in lane `lane` (lr, lq, lv), continuing ring R;
// slot base + j's outputs go to lane j's `o`.
template <int W, int V>
__device__ __forceinline__ void walk_block(Ring<W, V>& R, const Args& a, int base, int j0, int j1,
                                           int lr, int lq, int lv, int lane, Out& o) {
  constexpr int S = Ring<W, V>::S;
  constexpr int P = W >= 32 ? W / 32 : 1;  // vote planes
  const float pen_gap = a.pen_gap;
  const int span = a.span, max_gap = a.max_gap, bw = a.bw, max_skip = a.max_skip;
  for (int j = j0; j < j1; ++j) {
    const int i = base + j;  // absolute slot
    const int cr = __shfl_sync(FULL, lr, j);
    const int cq = __shfl_sync(FULL, lq, j);
    const bool cv = __shfl_sync(FULL, lv, j) != 0;
    // the current anchor's query position and span
    const int cqp = V == SPAN ? cq >> 8 : cq;
    const int cspan = V == SPAN ? cq & 255 : span;

    // candidate scores against the ring
    int cand[S];
    bool okv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = lane * S + s;
      // the predecessor's query position and span
      const int pq = V == SPAN ? R.rq[s] >> 8 : R.rq[s];
      const int psp = V == SPAN ? R.rq[s] & 255 : span;
      const int dq = cqp - pq;
      const int dr = cr - R.rr[s];
      const int dd = abs(dr - dq);
      const int dg = min(dq, dr);
      const bool ok = d < W && R.rok[s] && dq > 0 && dq <= max_gap &&
                      dr > 0 && dr <= max_gap && dd <= bw;
      int c = NEG;
      if (ok) {
        int sc = min(dg, psp);
        const float lin = __fmul_rn(pen_gap, static_cast<float>(dd));
        const float logp = dd >= 1 ? mg_log2(static_cast<float>(dd + 1)) : 0.0f;
        const int pen = static_cast<int>(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
        if (dd != 0 || dg > psp) sc -= pen;
        c = sc + R.rf[s];
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
        const int sh = (i - 1 - R.rp[s]) - 32 * b;
        if (okv[s] && sh >= 0 && sh < 32) v |= 1u << sh;
      }
      votes[b] = __reduce_or_sync(FULL, v);
    }

    // running max of cand (exclusive at each position), seeded with the
    // current anchor's span
    int loc[S];
    loc[0] = cand[0];
#pragma unroll
    for (int s = 1; s < S; ++s) loc[s] = max(loc[s - 1], cand[s]);
    const int cx = warp_excl_scan(loc[S - 1], NEG, lane, MaxOp());
    int av[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = lane * S + s;
      const int prev = s == 0 ? cx : max(cx, loc[s - 1]);
      const bool improving = okv[s] && cand[s] > max(prev, cspan);
      const bool marked = (votes[(d >> 5) % P] >> (d & 31)) & 1u;
      av[s] = (okv[s] && marked && !improving) - (improving ? 1 : 0);
    }

    // Lindley skip counter: n_skip = S_t - min(0, min_{u<=t} S_u)
    int sc_[S];
    sc_[0] = av[0];
#pragma unroll
    for (int s = 1; s < S; ++s) sc_[s] = sc_[s - 1] + av[s];
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

    const bool has_pred = best > cspan;
    const int f_t = cv ? max(cspan, best) : NEG;
    const int p_t = (cv && has_pred) ? i - 1 - bd : -1;
    int c_t = 0, s_t = 0, r_t = 0;
    if constexpr (V != BASE) {
      // the chosen predecessor's carries: slot bd % S of lane bd / S
      int gc = 0, gs = 0, gm = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s == bd % S) {
          gc = R.rc[s];
          if constexpr (V == EXT) { gs = R.rs[s]; gm = R.rm[s]; }
        }
      gc = __shfl_sync(FULL, gc, bd / S);
      if constexpr (V == EXT) {
        gs = __shfl_sync(FULL, gs, bd / S);
        gm = __shfl_sync(FULL, gm, bd / S);
      }
      if (cv && has_pred) {
        c_t = gc + 1;
        if constexpr (V == EXT) {
          const int prevmax = gm >> 1;
          const int valley = (gm & 1) | (prevmax - f_t > bw ? 1 : 0);
          s_t = gs;
          r_t = (max(prevmax, f_t) << 1) | valley;
        }
      } else if (cv) {
        // a chain starts here (int32 wrap as in the reference; the
        // -F gate keeps rpos < 2^15)
        c_t = 1;
        if constexpr (V == EXT) {
          s_t = static_cast<int>((static_cast<unsigned>(cr) << 16) | static_cast<unsigned>(cq));
          r_t = f_t << 1;
        }
      }
    }
    if (lane == j) {
      o.f = f_t;
      o.b = (cv && cut < W) ? 1 : 0;
      if constexpr (V != BASE) o.c = c_t;
      if constexpr (V == EXT) { o.s = s_t; o.r = r_t; }
    }

    // push the anchor onto the ring (newest first)
#define LRGE_PUSH(X, NEWV)                                          \
  {                                                                 \
    const int carry = __shfl_up_sync(FULL, (int)R.X[S - 1], 1);     \
    _Pragma("unroll") for (int s = S - 1; s > 0; --s) R.X[s] = R.X[s - 1]; \
    R.X[0] = lane == 0 ? (NEWV) : carry;                            \
  }
    LRGE_PUSH(rr, cr)
    LRGE_PUSH(rq, cq)
    LRGE_PUSH(rf, f_t)
    LRGE_PUSH(rp, p_t)
    LRGE_PUSH(rok, cv)
    if constexpr (V != BASE) LRGE_PUSH(rc, c_t)
    if constexpr (V == EXT) {
      LRGE_PUSH(rs, s_t)
      LRGE_PUSH(rm, r_t)
    }
#undef LRGE_PUSH
  }
}

// A chunk is slots [32k, 32k + 32) of one row; chunk c is row c / nck,
// k = c % nck.  A run starts at a slot below the row's count whose key2
// differs from the slot before (the boundary2 test of
// ops/overlap.py::_reduce_counts).  The chunk's last run is "long" when it
// reaches the chunk's end (every slot after its start is inside the row
// and starts no run): it may go on into later chunks, and every run that
// spans more than one chunk is one.  Its other runs are "short".
struct Chunk {
  size_t off;  // row * A
  int base, n, idx;
  bool in;     // slot base + lane is below the row's count
};

__device__ __forceinline__ Chunk chunk_at(const Args& a, int c, int lane) {
  const int nck = (a.A + 31) / 32;
  const int row = c / nck;
  Chunk ch;
  ch.off = static_cast<size_t>(row) * a.A;
  ch.base = 32 * (c - row * nck);
  const int n = a.nvalid[row];
  ch.n = n < 0 ? 0 : (n > a.A ? a.A : n);
  ch.idx = ch.base + lane;
  ch.in = ch.idx < ch.n;
  return ch;
}

// The run starts of chunk `ch` (a ballot), whose slots inside the row are
// `inside`; `last` is the last start (32 when none) and `reaches` says
// that its run is long.
struct Starts {
  unsigned starts, inside;
  int last;
  bool reaches;
};

__device__ __forceinline__ Starts starts_of(const Args& a, const Chunk& ch, int key, int lane) {
  int prev = __shfl_up_sync(FULL, key, 1);
  if (lane == 0 && ch.in && ch.base > 0) prev = a.key2[ch.off + ch.base - 1];
  Starts st;
  st.starts = __ballot_sync(FULL, ch.in && (ch.idx == 0 || key != prev));
  st.inside = __ballot_sync(FULL, ch.in);
  st.last = st.starts ? 31 - __clz(st.starts) : 32;
  st.reaches = st.last < 32 && (st.last == 31 || (st.inside >> (st.last + 1)) == (FULL >> (st.last + 1)));
  return st;
}

// Kernel 1: one warp per chunk.  Writes the padding (slots from the row's
// count to A) and appends the chunk to the long list (as c * 32 + the
// long run's start lane) and/or the short list (as c); one 64-bit atomic
// per block of 32 chunks takes both lists' places.
template <int V>
__global__ void __launch_bounds__(1024) find_runs_kernel(const Args a, unsigned long long* counts,
                                                          int* longs, int* shorts) {
  __shared__ int flags[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cells = a.B * ((a.A + 31) / 32);
  const int c = blockIdx.x * 32 + warp;
  int flag = 0;  // bit 0: long run, bits 1-5: its lane; bit 6: short runs
  if (c < cells) {
    const Chunk ch = chunk_at(a, c, lane);
    const int key = ch.in ? a.key2[ch.off + ch.idx] : IMAX;
    const Starts st = starts_of(a, ch, key, lane);
    const unsigned rest = st.reaches ? st.starts & ~(1u << st.last) : st.starts;
    flag = (st.reaches ? 1 | (st.last << 1) : 0) | (rest ? 64 : 0);
    if (!ch.in && ch.idx < a.A) store<V>(a, ch.off + ch.idx, Out());
  }
  if (lane == 0) flags[warp] = flag;
  __syncthreads();
  if (warp == 0) {
    const int f = flags[lane];
    const unsigned lm = __ballot_sync(FULL, f & 1), sm = __ballot_sync(FULL, f & 64);
    unsigned long long old = 0;
    if (lane == 0 && (lm | sm))
      old = atomicAdd(counts, (static_cast<unsigned long long>(__popc(lm)) << 32) | __popc(sm));
    old = __shfl_sync(FULL, old, 0);
    const unsigned below = (1u << lane) - 1u;
    const int cl = blockIdx.x * 32 + lane;
    if (f & 1) longs[static_cast<int>(old >> 32) + __popc(lm & below)] = cl * 32 + ((f >> 1) & 31);
    if (f & 64) shorts[static_cast<int>(old & 0xffffffffu) + __popc(sm & below)] = cl;
  }
}

// The long run of chunk c, from lane `last`, walked to its end.
template <int W, int V>
__device__ __forceinline__ void walk_long(const Args& a, int c, int last, int lane) {
  const Chunk ch = chunk_at(a, c, lane);
  int lr = 0, lq = 0, lv = 0;
  if (lane >= last) {
    lr = a.rpos[ch.off + ch.idx]; lq = a.qpos[ch.off + ch.idx]; lv = a.valid[ch.off + ch.idx];
  }
  const int rk = a.key2[ch.off + ch.base + 31];
  Ring<W, V> R;
  {
    Out o;
    walk_block<W, V>(R, a, ch.base, last, 32, lr, lq, lv, lane, o);
    if (lane >= last) store<V>(a, ch.off + ch.idx, o);
  }
  for (int b = ch.base + 32; b < ch.n; b += 32) {
    const int id = b + lane;
    int k2 = IMAX, r2 = 0, q2 = 0, v2 = 0;
    if (id < ch.n) {
      k2 = a.key2[ch.off + id]; r2 = a.rpos[ch.off + id]; q2 = a.qpos[ch.off + id]; v2 = a.valid[ch.off + id];
    }
    const unsigned run = __ballot_sync(FULL, id < ch.n && k2 == rk);
    const int m = run == FULL ? 32 : __ffs(~run) - 1;
    if (m == 0) break;
    Out o;
    walk_block<W, V>(R, a, b, 0, m, r2, q2, v2, lane, o);
    if (lane < m) store<V>(a, ch.off + id, o);
    if (m < 32) break;
  }
}

// The short runs of chunk c, each from an empty ring.
template <int W, int V>
__device__ __forceinline__ void walk_short(const Args& a, int c, int lane) {
  const Chunk ch = chunk_at(a, c, lane);
  int key = IMAX, lr = 0, lq = 0, lv = 0;
  if (ch.in) {
    key = a.key2[ch.off + ch.idx];
    lr = a.rpos[ch.off + ch.idx]; lq = a.qpos[ch.off + ch.idx]; lv = a.valid[ch.off + ch.idx];
  }
  const Starts st = starts_of(a, ch, key, lane);
  unsigned todo = st.reaches ? st.starts & ~(1u << st.last) : st.starts;
  const unsigned stops = st.starts | ~st.inside;  // a run ends before these
  const int first = __ffs(todo) - 1;
  const int lim = st.reaches ? st.last : 32;
  Out o;
  while (todo) {
    const int j0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const unsigned after = j0 == 31 ? 0u : stops >> (j0 + 1);
    Ring<W, V> R;
    walk_block<W, V>(R, a, ch.base, j0, after ? j0 + __ffs(after) : 32, lr, lq, lv, lane, o);
  }
  if (ch.in && lane >= first && lane < lim) store<V>(a, ch.off + ch.idx, o);
}

// Kernel 2: a persistent grid walks the long runs, then the short-run
// chunks.  The first wave is static and block-major (item e goes to warp
// e / gridDim.x of block e % gridDim.x), so the long runs spread over the
// SMs instead of crowding the first blocks to start; later items come
// from an atomic counter, fetched before the current item is walked so
// that the atomic's latency hides behind the walk.
template <int W, int V>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK, MinBlocks<W>::value)
chain_dp_kernel(const Args a, const unsigned long long* counts, const int* longs, const int* shorts,
                int* next) {
  const int lane = threadIdx.x & 31;
  const unsigned long long cnt = *counts;
  const int nl = static_cast<int>(cnt >> 32);
  const int items = nl + static_cast<int>(cnt & 0xffffffffu);
  const int total = gridDim.x * WARPS_PER_BLOCK;
  int e = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  while (e < items) {
    int nxt = 0;
    if (lane == 0) nxt = total + atomicAdd(next, 1);
    if (e < nl) {
      const int v = longs[e];
      walk_long<W, V>(a, v >> 5, v & 31, lane);
    } else {
      walk_short<W, V>(a, shorts[e - nl], lane);
    }
    e = __shfl_sync(FULL, nxt, 0);
  }
}

// The scratch `work` (int32, 4 + 2 * chunks, 8-byte aligned): the two
// lists' lengths (one 64-bit word), the claim counter, a pad word, then
// the long and the short list.
template <int W, int V>
int launch_w(const Args& a, int* work, cudaStream_t st) {
  constexpr int threads = 32 * WARPS_PER_BLOCK;
  // the current card's resident blocks of the walk, asked on every launch
  // (cheap next to the launch itself)
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_dp_kernel<W, V>, threads, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(work, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = a.B * ((a.A + 31) / 32);
  auto* counts = reinterpret_cast<unsigned long long*>(work);
  int* longs = work + 4;
  int* shorts = longs + cells;
  find_runs_kernel<V><<<(cells + 31) / 32, 1024, 0, st>>>(a, counts, longs, shorts);
  // persistent grid: every resident warp, or one warp per chunk when the
  // rows hold fewer (the list lengths are not known on the host)
  const int want = (cells + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  chain_dp_kernel<W, V><<<want < resident ? want : resident, threads, 0, st>>>(a, counts, longs, shorts,
                                                                                  work + 2);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch(const Args& a, int window, int* work, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 16: return launch_w<16, V>(a, work, st);
    case 32: return launch_w<32, V>(a, work, st);
    case 64: return launch_w<64, V>(a, work, st);
    case 128: return launch_w<128, V>(a, work, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The entry points return the first CUDA error of the launch (0 on
// success).  Rows are [B, A] int32, sorted by (key2, rpos) over
// [0, nvalid); `work` is int32 scratch of 4 + 2 * B * ceil(A / 32)
// entries, 8-byte aligned, that the launch initialises itself.
extern "C" int chain_dp_skip_launch(const int* key2, const int* rpos, const int* qpos,
                                    const int* valid, const int* nvalid, int* work,
                                    int B, int A, float pen_gap, int span,
                                    int max_gap, int bw, int max_skip, int window, int* f,
                                    int* broke, void* stream) {
  const Args a{key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap,
               bw, max_skip, f, broke, nullptr, nullptr, nullptr};
  return launch<BASE>(a, window, work, stream);
}

// The -F variant: also writes cnt, start and rmf ([B, A] int32 each).
extern "C" int chain_dp_skip_ext_launch(const int* key2, const int* rpos, const int* qpos,
                                        const int* valid, const int* nvalid, int* work,
                                        int B, int A, float pen_gap,
                                        int span, int max_gap, int bw, int max_skip,
                                        int window, int* f, int* broke, int* cnt, int* start,
                                        int* rmf, void* stream) {
  const Args a{key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap,
               bw, max_skip, f, broke, cnt, start, rmf};
  return launch<EXT>(a, window, work, stream);
}

// The PacBio/HPC variant: qpos is packed as qpos << 8 | span (span is
// unused); also writes cnt ([B, A] int32).
extern "C" int chain_dp_skip_span_launch(const int* key2, const int* rpos, const int* qpos,
                                         const int* valid, const int* nvalid, int* work,
                                         int B, int A, float pen_gap,
                                         int span, int max_gap, int bw, int max_skip,
                                         int window, int* f, int* broke, int* cnt, void* stream) {
  const Args a{key2, rpos, qpos, valid, nvalid, B, A, pen_gap, span, max_gap,
               bw, max_skip, f, broke, cnt, nullptr, nullptr};
  return launch<SPAN>(a, window, work, stream);
}
