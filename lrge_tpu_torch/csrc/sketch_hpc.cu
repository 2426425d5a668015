// The PacBio/HPC query sketch on the card, one thread block per read.
//
// Replaces no TPU kernel: the reference sketches these queries on the host
// (lrge_tpu/device_engine.py:377-393, the native sketcher) and copies the
// hash planes to the device.  This kernel takes the super-batch's base
// codes instead and writes the planes itself, inside the captured
// super-batch program, so that only one byte a base crosses to the card.
// Semantics: minimap2's mm_sketch loop as lrge_tpu_torch/native/
// lrge_native.cpp::sketch_one implements it, HPC on or off, for every
// input; lrge_tpu_torch/ops/sketch_torch.py::sketch_hpc_plain is the
// reference this kernel is held to, and its module note gives the
// per-slot form of the loop that both compute:
//
// - slot: a run of one base under HPC (its position the run's last base),
//   every base without it, every ambiguous base (code 4);
// - a valid slot's k-mer is the last k valid slots' bases (ambiguous
//   slots do not shift it, the read's start fills with 0); its span is
//   its end less the later of the end k valid slots back and the last
//   ambiguous base; a symmetric k-mer's slot is skipped;
// - window slots are the other valid slots and the ambiguous ones; l is
//   the count of non-symmetric valid slots since the last ambiguous base;
//   key = hash64(canonical k-mer) << 8 | span when l >= k and span < 256,
//   else INF;
// - held[s], the loop's minimum after window slot s, is the newest least
//   key of s - w + 1 .. s; slot t is emitted by the events of the slots
//   s = t .. t + w (displaced, evicted, a tie of a rescan's or the first
//   full window's minimum) or by the final push.
//
// Layout: one block of T = 512 threads walks its row in tiles of T
// positions, one position a thread, carrying across tiles what the loop
// carries: counts of valid, non-symmetric and window slots, the last
// ambiguous position, and rings in shared memory of the last 2T valid
// slots (base, end) and window slots (key; pos, l, strand; held minimum
// and its key; event flags).  Per tile: the tile's bases are staged in
// shared memory; block scans (warp shuffles, then the warps' totals) give
// each position its valid-slot index, the last ambiguous position, its
// non-symmetric count (so l) and its window-slot index; each valid slot
// builds its k-mer from the ring (k reads), each window slot its held
// minimum (w reads) and its events; then every window slot whose events
// are all known (t + w below the window slots seen, all of them at the
// row's end) is judged, and a last block scan packs the emitted slots to
// their output columns in order.  Columns past the count are padding
// (qhi -1, qlo 0, mps 0), written here, so nothing is cleared before.
//
// What bounds it: one byte read a base and 12 bytes written a minimizer
// column: a super-batch of the 16,384 bucket (128 rows) reads 2 MiB and
// writes 10 MiB, ~0.004 ms at the card's 3.35 TB/s; the arithmetic (a 64-bit hash a slot, k + 2w shared-memory reads) is
// smaller still.  The tiles of a row run in sequence, each ~20 block
// barriers, so a block takes about (L / T) tiles x the barriers' latency;
// the rows of a super-batch run side by side, one block each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 512;           // threads a block, positions a tile
constexpr int NWARP = T / 32;
constexpr int RING = 2 * T;      // ring entries (w < T / 2 keeps what a tile reads)
constexpr int RMASK = RING - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t INF = ~0ull;  // the loop's invalid entry; keys are < 2^58
constexpr int PB_SPLIT = 19;

// event flags of a window slot s
constexpr uint8_t DISPLACE = 1;    // displaces the held minimum (l >= w + k)
constexpr uint8_t EVICT_HELD = 2;  // evicts it (held == s - w, l >= w + k - 1)
constexpr uint8_t RESCAN = 4;      // the eviction's rescan found a real minimum
constexpr uint8_t FIRST = 8;       // the first full window (l == w + k - 1)

__device__ __forceinline__ uint64_t mm_hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Inclusive block scan of v; *total gets the block's aggregate.  Every
// thread of the block calls it; sh holds 32 ints.
template <typename Op>
__device__ __forceinline__ int block_scan(int v, int ident, Op op, int* sh, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = op(v, u);
  }
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int x = lane < NWARP ? sh[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = op(x, u);
    }
    sh[lane] = x;
  }
  __syncthreads();
  if (wid > 0) v = op(v, sh[wid - 1]);
  *total = sh[NWARP - 1];
  __syncthreads();  // sh is free again
  return v;
}

struct Smem {
  uint8_t code[T + 1];      // the tile's bases and the next one
  uint8_t vcode[RING];      // valid slots: base
  int vend[RING];           //   end position
  int nsum[T];              // the tile's inclusive non-symmetric counts
  uint64_t wkey[RING];      // window slots: key
  uint32_t wmeta[RING];     //   pos << 10 | min(l, w + k) << 1 | strand
  int held[RING];           //   held minimum after the slot
  uint64_t hkey[RING];      //   its key
  uint8_t flags[RING];      //   events
  int scan[32];
};

__global__ void __launch_bounds__(T) sketch_hpc_kernel(const uint8_t* __restrict__ codes,
                                                       const int* __restrict__ lengths, int L, int k,
                                                       int w, int hpc, int M, int* __restrict__ qhi,
                                                       int* __restrict__ qlo, int* __restrict__ mps,
                                                       int* __restrict__ mcount) {
  __shared__ Smem sm;
  const int row = blockIdx.x, tid = threadIdx.x;
  const uint8_t* c_row = codes + static_cast<size_t>(row) * L;
  int* qhi_row = qhi + static_cast<size_t>(row) * M;
  int* qlo_row = qlo + static_cast<size_t>(row) * M;
  int* mps_row = mps + static_cast<size_t>(row) * M;
  const int n = min(lengths[row], L);
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int lcap = w + k;  // l saturates here: the rules compare it with w + k - 1 and w + k
  // carries across tiles (uniform over the block)
  int nv = 0;         // valid slots so far
  int lastamb = -1;   // last ambiguous position so far
  int ns = 0;         // non-symmetric valid slots so far
  int ns_at_amb = 0;  // ns at the last ambiguous position
  int nw = 0;         // window slots so far
  int fin = 0;        // the first window slot not judged yet
  int mc = 0;         // minimizers emitted so far
  int total;
  for (int p0 = 0; p0 < n; p0 += T) {
    const int p = p0 + tid;
    sm.code[tid] = p < n ? c_row[p] : 4;
    if (tid == 0) sm.code[T] = p0 + T < n ? c_row[p0 + T] : 4;
    __syncthreads();
    // slots: every ambiguous base; a run's last base (HPC) or every base
    const int c = sm.code[tid];
    const bool inrow = p < n;
    const bool amb = inrow && c >= 4;
    const bool end = inrow && (!hpc || amb || p + 1 >= n || sm.code[tid + 1] != c);
    const bool vslot = end && !amb;
    const int j = nv + block_scan(vslot, 0, AddOp(), sm.scan, &total) - vslot;
    const int nv_next = nv + total;
    const int la = max(lastamb, block_scan(amb ? p : -1, -1, MaxOp(), sm.scan, &total));
    const int lastamb_next = max(lastamb, total);
    if (vslot) {
      sm.vcode[j & RMASK] = static_cast<uint8_t>(c);
      sm.vend[j & RMASK] = p;
    }
    __syncthreads();
    // each valid slot's k-mer over the last k valid slots, its span
    uint64_t k0 = 0, k1 = 0;
    int span = 0;
    if (vslot) {
      for (int d = 0; d < k && j - d >= 0; ++d) {
        const uint64_t cd = sm.vcode[(j - d) & RMASK];
        k0 |= cd << (2 * d);
        k1 |= (3ull ^ cd) << (2 * (k - 1 - d));
      }
      span = p - max(j >= k ? sm.vend[(j - k) & RMASK] : -1, la);
    }
    const bool nsv = vslot && k0 != k1;
    const int nsum = ns + block_scan(nsv, 0, AddOp(), sm.scan, &total);
    const int ns_next = ns + total;
    sm.nsum[tid] = nsum;
    __syncthreads();
    const int l = amb ? 0 : nsum - (la >= p0 ? sm.nsum[la - p0] : ns_at_amb);
    const int ns_at_amb_next = lastamb_next >= p0 ? sm.nsum[lastamb_next - p0] : ns_at_amb;
    // window slots: the non-symmetric valid ones and the ambiguous ones
    const bool ws = amb || nsv;
    const int s = nw + block_scan(ws, 0, AddOp(), sm.scan, &total) - ws;
    const int nw_next = nw + total;
    if (ws) {
      uint64_t key = INF;
      if (nsv && l >= k && span < 256)
        key = (mm_hash64(k0 < k1 ? k0 : k1, mask) << 8) | static_cast<uint64_t>(span);
      sm.wkey[s & RMASK] = key;
      sm.wmeta[s & RMASK] = (static_cast<uint32_t>(p) << 10) | (static_cast<uint32_t>(min(l, lcap)) << 1) |
                            static_cast<uint32_t>(k0 > k1);
    }
    __syncthreads();
    // the held minimum after each new window slot: the newest least key
    if (ws) {
      int h = s;
      uint64_t hk = sm.wkey[s & RMASK];
      for (int d = 1; d < w && s - d >= 0; ++d) {
        const uint64_t kd = sm.wkey[(s - d) & RMASK];
        if (kd < hk) hk = kd, h = s - d;
      }
      sm.held[s & RMASK] = h;
      sm.hkey[s & RMASK] = hk;
    }
    __syncthreads();
    // each new window slot's events, against the minimum held before it
    if (ws) {
      const int prev = s > 0 ? sm.held[(s - 1) & RMASK] : -1;
      const uint64_t pkey = s > 0 ? sm.hkey[(s - 1) & RMASK] : INF;
      const uint64_t key = sm.wkey[s & RMASK];
      const int ls = static_cast<int>((sm.wmeta[s & RMASK] >> 1) & 511u);
      uint8_t f = 0;
      if (pkey != INF && key <= pkey && ls >= w + k) f |= DISPLACE;
      const bool evict = prev >= 0 && prev == s - w && key > pkey && ls >= w + k - 1;
      if (evict && pkey != INF) f |= EVICT_HELD;
      if (evict && sm.hkey[s & RMASK] != INF) f |= RESCAN;
      if (pkey != INF && ls == w + k - 1) f |= FIRST;
      sm.flags[s & RMASK] = f;
    }
    nv = nv_next, lastamb = lastamb_next, ns = ns_next, ns_at_amb = ns_at_amb_next, nw = nw_next;
    __syncthreads();
    // judge every window slot whose events s <= t + w are all known
    const bool row_end = p0 + T >= n;
    const int stop = row_end ? nw : max(fin, nw - w);
    for (int base = fin; base < stop; base += T) {
      const int t = base + tid;
      bool emit = false;
      uint64_t kt = INF;
      if (t < stop) {
        kt = sm.wkey[t & RMASK];
        for (int d = 1; d <= w && t + d < nw; ++d) {
          const int sd = t + d;
          const uint8_t f = sm.flags[sd & RMASK];
          const int prev = sm.held[(sd - 1) & RMASK];
          if (prev == t && (f & (DISPLACE | EVICT_HELD))) emit = true;
          if (d < w && (f & FIRST) && sm.hkey[(sd - 1) & RMASK] == kt && prev != t) emit = true;
        }
        for (int d = 0; d < w && t + d < nw; ++d) {
          const int sd = t + d;
          if ((sm.flags[sd & RMASK] & RESCAN) && sm.hkey[sd & RMASK] == kt && sm.held[sd & RMASK] != t)
            emit = true;
        }
        // the final push: the minimum held after the last window slot
        if (row_end && t == sm.held[(nw - 1) & RMASK] && sm.hkey[(nw - 1) & RMASK] != INF) emit = true;
      }
      const int col = mc + block_scan(emit, 0, AddOp(), sm.scan, &total) - emit;
      if (emit && col < M) {
        const uint64_t h = kt >> 8;
        const uint32_t meta = sm.wmeta[t & RMASK];
        qhi_row[col] = static_cast<int>(h >> PB_SPLIT);
        qlo_row[col] = static_cast<int>(h & ((1ull << PB_SPLIT) - 1));
        mps_row[col] = static_cast<int>(((meta >> 10) << 9) | ((kt & 255u) << 1) | (meta & 1u));
      }
      mc += total;
    }
    fin = stop;
    __syncthreads();  // the next tile overwrites the rings' oldest entries
  }
  for (int col = min(mc, M) + tid; col < M; col += T) {
    qhi_row[col] = -1;
    qlo_row[col] = 0;
    mps_row[col] = 0;
  }
  if (tid == 0) mcount[row] = mc;
}

}  // namespace

// codes [R, L] uint8 (4 = ambiguous or padding), lengths [R] int32;
// writes qhi, qlo, mps [R, M] int32 and mcount [R] int32.  Needs
// 0 < w < T / 2, 0 < k <= 25 and L < 2^22 (the wrapper checks them).
extern "C" int sketch_hpc_launch(const uint8_t* codes, const int* lengths, int R, int L, int k, int w,
                                 int hpc, int M, int* qhi, int* qlo, int* mps, int* mcount, void* stream) {
  sketch_hpc_kernel<<<R, T, 0, static_cast<cudaStream_t>(stream)>>>(codes, lengths, L, k, w, hpc, M, qhi, qlo,
                                                                    mps, mcount);
  return static_cast<int>(cudaGetLastError());
}
