// Native host runtime for lrge_tpu_torch (a copy of
// lrge_tpu/native/lrge_native.cpp whose module is named _lrge_torch_native,
// so that both packages can load their own build in one process).
//
// The reference keeps its hot host paths in native code (minimap2 C via
// FFI, needletail parsing); this package does the same for the pieces
// that stay on the host:
//
//   * FASTA/FASTQ parsing + record splitting (the reference's
//     needletail equivalent, SURVEY.md C7),
//   * 2-bit base encoding,
//   * the chaining DP for exact-host-fallback rows (identical f32
//     semantics to minimap2's mm_chain_dp scoring, SURVEY.md C15).
//
// Exposed as a CPython extension (no pybind11 in this image); buffers
// cross the boundary via the buffer protocol so numpy arrays are
// zero-copy.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <deque>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// base encoding (matches ops/encode.py NT4 table)
// ---------------------------------------------------------------------

unsigned char NT4[256];

void init_nt4() {
  memset(NT4, 4, sizeof(NT4));
  NT4[(unsigned char)'A'] = 0;
  NT4[(unsigned char)'C'] = 1;
  NT4[(unsigned char)'G'] = 2;
  NT4[(unsigned char)'T'] = 3;
  NT4[(unsigned char)'a'] = 0;
  NT4[(unsigned char)'c'] = 1;
  NT4[(unsigned char)'g'] = 2;
  NT4[(unsigned char)'t'] = 3;
}

PyObject* py_encode_seq(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, buf.len);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  const unsigned char* src = (const unsigned char*)buf.buf;
  unsigned char* dst = (unsigned char*)PyBytes_AS_STRING(out);
  for (Py_ssize_t i = 0; i < buf.len; ++i) dst[i] = NT4[src[i]];
  PyBuffer_Release(&buf);
  return out;
}

// ---------------------------------------------------------------------
// FASTA/FASTQ parsing (decompressed buffer -> list[(id, seq)])
// ---------------------------------------------------------------------

const char* find_nl(const char* p, const char* end) {
  const char* nl = (const char*)memchr(p, '\n', end - p);
  return nl ? nl : end;
}

// strip trailing \r and return length
Py_ssize_t line_len(const char* start, const char* nl) {
  Py_ssize_t n = nl - start;
  if (n > 0 && start[n - 1] == '\r') --n;
  return n;
}

Py_ssize_t id_len(const char* start, Py_ssize_t n) {
  // truncate at first ASCII whitespace (space \t \n \f \r)
  for (Py_ssize_t i = 0; i < n; ++i) {
    char c = start[i];
    if (c == ' ' || c == '\t' || c == '\n' || c == '\f' || c == '\r') return i;
  }
  return n;
}

PyObject* parse_error(const char* msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return nullptr;
}

// Core FASTA/FASTQ parse over [start, end).  When ``is_final`` is false
// the buffer is a stream chunk: a record that MAY continue past the end
// (any line not newline-terminated, a missing trailer, or a FASTA
// record not followed by '>') is left unconsumed instead of raising,
// and ``*consumed`` reports how many bytes of complete records were
// parsed.  Structural errors that no amount of further input can fix
// (bad header start, quality/sequence length mismatch on a terminated
// quality line) raise regardless.  Returns a new list or nullptr.
PyObject* parse_fastx_impl(const char* start, const char* end, bool is_final,
                           Py_ssize_t* consumed) {
  const char* p = start;
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;
  auto fail = [&](const char* msg) -> PyObject* {
    Py_DECREF(out);
    return parse_error(msg);
  };
  *consumed = 0;
  if (p == end) return out;  // empty
  char mode = *p;
  if (mode != '>' && mode != '@')
    return fail("Unknown sequence format: expected '>' or '@'");
  std::vector<char> seqbuf;
  while (p < end) {
    const char* rec_start = p;
    if (*p != mode) return fail("Malformed record: bad header start");
    ++p;
    const char* nl = find_nl(p, end);
    if (nl == end && !is_final) break;  // header may continue
    const char* hdr = p;
    Py_ssize_t hn = line_len(hdr, nl);
    Py_ssize_t idn = id_len(hdr, hn);
    p = nl < end ? nl + 1 : end;
    PyObject* name = PyBytes_FromStringAndSize(hdr, idn);
    PyObject* seq = nullptr;
    if (mode == '>') {
      seqbuf.clear();
      bool terminated = false;
      while (p < end) {
        if (*p == '>') {
          terminated = true;
          break;
        }
        nl = find_nl(p, end);
        seqbuf.insert(seqbuf.end(), p, p + line_len(p, nl));
        p = nl < end ? nl + 1 : end;
      }
      if (!terminated && !is_final) {
        Py_XDECREF(name);
        break;  // more sequence lines may follow
      }
      seq = PyBytes_FromStringAndSize(seqbuf.data(), (Py_ssize_t)seqbuf.size());
    } else {
      nl = find_nl(p, end);
      if (nl == end && !is_final) {
        Py_XDECREF(name);
        break;
      }
      const char* s = p;
      Py_ssize_t sn = line_len(s, nl);
      p = nl < end ? nl + 1 : end;
      if (p >= end) {
        Py_XDECREF(name);
        if (!is_final) break;
        return fail("Malformed FASTQ record: expected '+' separator");
      }
      if (*p != '+') {
        Py_XDECREF(name);
        return fail("Malformed FASTQ record: expected '+' separator");
      }
      nl = find_nl(p, end);
      if (nl == end && !is_final) {
        Py_XDECREF(name);
        break;
      }
      p = nl < end ? nl + 1 : end;  // skip '+' line
      nl = find_nl(p, end);
      if (nl == end && !is_final) {
        Py_XDECREF(name);
        break;  // quality line may continue
      }
      Py_ssize_t qn = line_len(p, nl);
      if (qn != sn) {
        Py_XDECREF(name);
        return fail("Malformed FASTQ record: sequence/quality length mismatch");
      }
      p = nl < end ? nl + 1 : end;
      seq = PyBytes_FromStringAndSize(s, sn);
    }
    if (!name || !seq) {
      Py_XDECREF(name);
      Py_XDECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject* tup = PyTuple_Pack(2, name, seq);
    Py_DECREF(name);
    Py_DECREF(seq);
    if (!tup || PyList_Append(out, tup) != 0) {
      Py_XDECREF(tup);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(tup);
    *consumed = rec_start + (p - rec_start) - start;
  }
  return out;
}

PyObject* py_parse_fastx(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  Py_ssize_t consumed = 0;
  PyObject* out = parse_fastx_impl((const char*)buf.buf,
                                   (const char*)buf.buf + buf.len,
                                   /*is_final=*/true, &consumed);
  PyBuffer_Release(&buf);
  return out;
}

PyObject* py_parse_fastx_chunk(PyObject*, PyObject* args) {
  Py_buffer buf;
  int is_final = 0;
  if (!PyArg_ParseTuple(args, "y*p", &buf, &is_final)) return nullptr;
  Py_ssize_t consumed = 0;
  PyObject* recs = parse_fastx_impl((const char*)buf.buf,
                                    (const char*)buf.buf + buf.len,
                                    is_final != 0, &consumed);
  PyBuffer_Release(&buf);
  if (!recs) return nullptr;
  PyObject* out = Py_BuildValue("(Nn)", recs, consumed);
  return out;
}

// ---------------------------------------------------------------------
// minimizer sketching (exact port of ops/sketch.py sketch_scalar, the
// minimap2 sketch.c-semantics oracle; handles ambiguous bases and HPC)
// ---------------------------------------------------------------------

inline uint64_t mm_hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

struct MiniMM {
  uint64_t key;  // hash<<8 | span; UINT64_MAX = invalid
  int64_t pos;
  int32_t z;
};

constexpr uint64_t MM_INF = ~0ull;  // real keys are <= 46 bits

void sketch_one(const unsigned char* seq, int64_t n, int k, int w, bool hpc,
                std::vector<MiniMM>& out) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int shift1 = 2 * (k - 1);
  uint64_t kmer[2] = {0, 0};
  std::vector<MiniMM> buf(w, {MM_INF, -1, 0});
  std::deque<int> tq;  // last <=k HPC run lengths
  int64_t kmer_span = 0;
  MiniMM mn{MM_INF, -1, 0};
  int min_pos = 0;
  int64_t l = 0;
  int buf_pos = 0;
  auto same = [](const MiniMM& a, const MiniMM& b) {
    return a.pos == b.pos && a.z == b.z;
  };
  for (int64_t i = 0; i < n; ++i) {
    int c = NT4[seq[i]];
    MiniMM info{MM_INF, -1, 0};
    if (c < 4) {
      if (hpc) {
        int64_t skip_len = 1;
        if (i + 1 < n && NT4[seq[i + 1]] == c) {
          skip_len = 2;
          while (i + skip_len < n && NT4[seq[i + skip_len]] == c) ++skip_len;
          i += skip_len - 1;
        }
        tq.push_back((int)skip_len);
        kmer_span += skip_len;
        if ((int)tq.size() > k) {
          kmer_span -= tq.front();
          tq.pop_front();
        }
      } else {
        kmer_span = l + 1 < k ? l + 1 : k;
      }
      kmer[0] = ((kmer[0] << 2) | (uint64_t)c) & mask;
      kmer[1] = (kmer[1] >> 2) | ((uint64_t)(3 ^ c) << shift1);
      if (kmer[0] == kmer[1]) continue;  // symmetric k-mer: skip slot
      int z = kmer[0] < kmer[1] ? 0 : 1;
      ++l;
      if (l >= k && kmer_span < 256) {
        uint64_t key = (mm_hash64(kmer[z], mask) << 8) | (uint64_t)kmer_span;
        info = {key, i, z};
      }
    } else {
      l = 0;
      tq.clear();
      kmer_span = 0;
    }
    buf[buf_pos] = info;
    if (l == w + k - 1 && mn.key != MM_INF) {
      // first full window: emit ties of the current minimum (excluding
      // the held entry itself)
      for (int j = buf_pos + 1; j < w; ++j)
        if (mn.key == buf[j].key && !same(buf[j], mn)) out.push_back(buf[j]);
      for (int j = 0; j < buf_pos; ++j)
        if (mn.key == buf[j].key && !same(buf[j], mn)) out.push_back(buf[j]);
    }
    if (info.key <= mn.key) {
      if (l >= w + k && mn.key != MM_INF) out.push_back(mn);
      mn = info;
      min_pos = buf_pos;
    } else if (buf_pos == min_pos) {
      if (l >= w + k - 1 && mn.key != MM_INF) out.push_back(mn);
      mn = {MM_INF, -1, 0};
      // rescan includes the current slot at the end (range(buf_pos+1))
      for (int j = buf_pos + 1; j < w; ++j)
        if (mn.key >= buf[j].key) mn = buf[j], min_pos = j;
      for (int j = 0; j <= buf_pos; ++j)
        if (mn.key >= buf[j].key) mn = buf[j], min_pos = j;
      if (l >= w + k - 1 && mn.key != MM_INF) {
        for (int j = buf_pos + 1; j < w; ++j)
          if (mn.key == buf[j].key && !same(buf[j], mn)) out.push_back(buf[j]);
        for (int j = 0; j <= buf_pos; ++j)
          if (mn.key == buf[j].key && !same(buf[j], mn)) out.push_back(buf[j]);
      }
    }
    if (++buf_pos == w) buf_pos = 0;
  }
  if (mn.key != MM_INF) out.push_back(mn);
  // de-duplicate and sort by (pos, key, z) — matches the oracle's
  // sorted(set(out), key=(pos, key)) ordering
  std::sort(out.begin(), out.end(), [](const MiniMM& a, const MiniMM& b) {
    if (a.pos != b.pos) return a.pos < b.pos;
    if (a.key != b.key) return a.key < b.key;
    return a.z < b.z;
  });
  out.erase(std::unique(out.begin(), out.end(),
                        [](const MiniMM& a, const MiniMM& b) {
                          return a.pos == b.pos && a.key == b.key && a.z == b.z;
                        }),
            out.end());
}

// sketch_many(seqs: list[bytes], k, w, hpc, threads)
//   -> list[(key_u64_le_bytes, pos_i32_le_bytes, strand_u8_bytes)]
// Sequences are raw ASCII bases (not 2-bit codes).
PyObject* py_sketch_many(PyObject*, PyObject* args) {
  PyObject* seq_list;
  int k, w, hpc, threads;
  if (!PyArg_ParseTuple(args, "O!iiii", &PyList_Type, &seq_list, &k, &w, &hpc,
                        &threads))
    return nullptr;
  Py_ssize_t nreads = PyList_GET_SIZE(seq_list);
  std::vector<const unsigned char*> ptrs(nreads);
  std::vector<int64_t> lens(nreads);
  for (Py_ssize_t i = 0; i < nreads; ++i) {
    PyObject* o = PyList_GET_ITEM(seq_list, i);
    char* p;
    Py_ssize_t ln;
    if (PyBytes_AsStringAndSize(o, &p, &ln) != 0) return nullptr;
    ptrs[i] = (const unsigned char*)p;
    lens[i] = ln;
  }
  std::vector<std::vector<MiniMM>> results(nreads);
  if (threads < 1) threads = 1;
  Py_BEGIN_ALLOW_THREADS {
    int nt = std::min<int>(threads, std::max<int>(1, (int)nreads));
    std::vector<std::thread> pool;
    std::atomic<Py_ssize_t> next(0);
    for (int t = 0; t < nt; ++t)
      pool.emplace_back([&]() {
        for (;;) {
          Py_ssize_t i = next.fetch_add(1);
          if (i >= nreads) break;
          results[i].reserve(lens[i] / 2);
          sketch_one(ptrs[i], lens[i], k, w, hpc != 0, results[i]);
        }
      });
    for (auto& th : pool) th.join();
  }
  Py_END_ALLOW_THREADS
  PyObject* out = PyList_New(nreads);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < nreads; ++i) {
    Py_ssize_t m = (Py_ssize_t)results[i].size();
    PyObject* kb = PyBytes_FromStringAndSize(nullptr, m * 8);
    PyObject* pb = PyBytes_FromStringAndSize(nullptr, m * 4);
    PyObject* sb = PyBytes_FromStringAndSize(nullptr, m);
    if (!kb || !pb || !sb) {
      Py_XDECREF(kb);
      Py_XDECREF(pb);
      Py_XDECREF(sb);
      Py_DECREF(out);
      return nullptr;
    }
    uint64_t* kd = (uint64_t*)PyBytes_AS_STRING(kb);
    int32_t* pd = (int32_t*)PyBytes_AS_STRING(pb);
    unsigned char* sd = (unsigned char*)PyBytes_AS_STRING(sb);
    for (Py_ssize_t j = 0; j < m; ++j) {
      kd[j] = results[i][j].key;
      pd[j] = (int32_t)results[i][j].pos;
      sd[j] = (unsigned char)results[i][j].z;
    }
    PyObject* tup = PyTuple_Pack(3, kb, pb, sb);
    Py_DECREF(kb);
    Py_DECREF(pb);
    Py_DECREF(sb);
    if (!tup) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, tup);
  }
  return out;
}

// ---------------------------------------------------------------------
// chaining DP (mm_chain_dp scoring semantics, f32 exact)
// ---------------------------------------------------------------------

inline float mg_log2f(float x) {
  union {
    float f;
    uint32_t i;
  } z = {x};
  float log_2 = (float)((int)((z.i >> 23) & 255) - 128);
  z.i &= ~(255u << 23);
  z.i += 127u << 23;
  log_2 += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
  return log_2;
}

// mm_chain_dp inner loop (shared by py_chain_dp and count_many):
// fills F/P for n anchors sorted by (key2, rpos), stable in seed order.
// tmark must be size >= n and is reset here.
void chain_dp_raw(const int32_t* K, const int32_t* R, const int32_t* Q,
                  const int32_t* S, Py_ssize_t n, int max_gap, int bw,
                  int max_iter, int max_skip, float pen_gap, float pen_skip,
                  int64_t* F, int64_t* P, std::vector<Py_ssize_t>& tmark) {
  tmark.assign(n, -1);
  Py_ssize_t st = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    while (st < i && (K[st] != K[i] || R[i] > R[st] + max_gap)) ++st;
    Py_ssize_t lo = st;
    if (i - lo > max_iter) lo = i - max_iter;
    int64_t best = S[i];
    int64_t bestj = -1;
    int n_skip = 0;
    for (Py_ssize_t j = i - 1; j >= lo; --j) {
      if (K[j] != K[i]) continue;
      int64_t dq = (int64_t)Q[i] - Q[j];
      if (dq <= 0 || dq > max_gap) continue;
      int64_t dr = (int64_t)R[i] - R[j];
      if (dr == 0) continue;
      int64_t dd = dr > dq ? dr - dq : dq - dr;
      if (dd > bw) continue;
      int64_t dg = dq < dr ? dq : dr;
      int64_t sc = dg < S[j] ? dg : S[j];
      if (dd != 0 || dg > S[j]) {
        float lin = pen_gap * (float)dd + pen_skip * (float)dg;
        float logp = dd >= 1 ? mg_log2f((float)(dd + 1)) : 0.0f;
        sc -= (int64_t)(int)(lin + 0.5f * logp);
      }
      int64_t cand = sc + F[j];
      if (cand > best) {
        best = cand;
        bestj = j;
        if (n_skip > 0) --n_skip;
      } else if (tmark[j] == i) {
        if (++n_skip > max_skip) break;
      }
      if (P[j] >= 0) tmark[P[j]] = i;
    }
    F[i] = best;
    P[i] = bestj;
  }
}

// chain_dp(key2, rpos, qpos, span, n, max_gap, bw, max_iter, max_skip,
//          chn_pen_gap, chn_pen_skip, f_out, p_out)
// key2 groups (rid,strand); all i32 buffers except f/p which are i64.
// Models mm_chain_dp exactly, including the max_chain_skip early break
// (t-mark array + floored skip counter).
PyObject* py_chain_dp(PyObject*, PyObject* args) {
  Py_buffer key2, rpos, qpos, span, fbuf, pbuf;
  Py_ssize_t n;
  int max_gap, bw, max_iter, max_skip;
  float pen_gap, pen_skip;
  if (!PyArg_ParseTuple(args, "y*y*y*y*niiiiffy*y*", &key2, &rpos, &qpos, &span,
                        &n, &max_gap, &bw, &max_iter, &max_skip, &pen_gap,
                        &pen_skip, &fbuf, &pbuf))
    return nullptr;
  const int32_t* K = (const int32_t*)key2.buf;
  const int32_t* R = (const int32_t*)rpos.buf;
  const int32_t* Q = (const int32_t*)qpos.buf;
  const int32_t* S = (const int32_t*)span.buf;
  int64_t* F = (int64_t*)fbuf.buf;
  int64_t* P = (int64_t*)pbuf.buf;
  Py_BEGIN_ALLOW_THREADS {
    std::vector<Py_ssize_t> tmark;
    chain_dp_raw(K, R, Q, S, n, max_gap, bw, max_iter, max_skip, pen_gap,
                 pen_skip, F, P, tmark);
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&key2);
  PyBuffer_Release(&rpos);
  PyBuffer_Release(&qpos);
  PyBuffer_Release(&span);
  PyBuffer_Release(&fbuf);
  PyBuffer_Release(&pbuf);
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// whole-pipeline overlap counting: sketch -> index lookup -> anchor
// expansion + masks -> (rid,strand,rpos) stable sort -> chain DP ->
// per-rid best-score reduction.  GIL-free and threaded over queries —
// the exact semantics of OverlapEngine.count_overlaps' fast path
// (engine.py), which collect_anchors/chain_dp oracle-test against
// minimap2's loop.  Covers both preset families: constant-span (ONT)
// reduces via the per-rid best score, HPC (variable spans) via the
// exact mm_chain_backtrack peel with the min_cnt gate.
// ---------------------------------------------------------------------

struct CountScratch {
  std::vector<MiniMM> mz;
  std::vector<uint64_t> hsorted;
  std::vector<int32_t> a_rid, a_rpos, a_qpos, a_span, key2;
  std::vector<int32_t> order;
  std::vector<int64_t> F, P;
  std::vector<Py_ssize_t> tmark;
  // hpc reduce (backtrack) scratch
  std::vector<int32_t> bt_order;
  std::vector<unsigned char> bt_used;
  std::vector<int32_t> bt_rids;
};

// bucketed unique-hash dictionary (same layout as the device lookup):
// the top bucket_bits of the hash pick a bucket of adjacent distinct
// hashes in uhash; uoff gives each unique's posting range.  Contiguous
// probes replace the ~2*log2(N) cache-missing binary-search steps.
struct BucketDict {
  const uint64_t* uhash = nullptr;  // [U] sorted distinct hashes
  const int32_t* uoff = nullptr;    // [U+1] posting offsets
  const int32_t* boff = nullptr;    // [2^bits+1] bucket offsets
  int hash_bits = 0;
  int bucket_bits = 0;
  bool lookup(uint64_t h, Py_ssize_t* start, int64_t* occ) const {
    uint64_t b = h >> (hash_bits - bucket_bits);
    for (int32_t u = boff[b]; u < boff[b + 1]; ++u)
      if (uhash[u] == h) {
        *start = uoff[u];
        *occ = uoff[u + 1] - uoff[u];
        return true;
      }
    return false;
  }
};

void count_one(const unsigned char* seq, int64_t qlen, int32_t dualrank,
               int32_t selfrid, const uint64_t* keys, const int32_t* irid,
               const int32_t* ipos, const signed char* istrand,
               const int32_t* name_rank, Py_ssize_t npost, int64_t mid_occ,
               int k, int w, int max_gap, int bw, int max_iter, int max_skip,
               float pen_gap, float pen_skip, int min_score, float q_occ_frac,
               int no_dual, int no_diag, bool hpc, int min_cnt,
               const BucketDict* dict,
               CountScratch& s, int32_t* count_out,
               unsigned char* had_out, int32_t* pairs_out, int pmax) {
  *count_out = 0;
  *had_out = 0;
  s.mz.clear();
  sketch_one(seq, qlen, k, w, hpc, s.mz);
  Py_ssize_t m = (Py_ssize_t)s.mz.size();
  if (m == 0) return;
  // mm_seed_mz_flt (q_occ_frac): within-query occurrence counts
  bool use_qflt = q_occ_frac > 0.0f && mid_occ > 0 && m > mid_occ;
  if (use_qflt) {
    s.hsorted.resize(m);
    for (Py_ssize_t j = 0; j < m; ++j) s.hsorted[j] = s.mz[j].key >> 8;
    std::sort(s.hsorted.begin(), s.hsorted.end());
  }
  s.a_rid.clear();
  s.a_rpos.clear();
  s.a_qpos.clear();
  s.a_span.clear();
  for (Py_ssize_t j = 0; j < m; ++j) {
    uint64_t h = s.mz[j].key >> 8;
    int32_t span = (int32_t)(s.mz[j].key & 0xFF);
    if (use_qflt) {
      auto lohi = std::equal_range(s.hsorted.begin(), s.hsorted.end(), h);
      int64_t c = lohi.second - lohi.first;
      // float32 comparison order matches the numpy oracle
      if (c > mid_occ && (float)c > (float)m * q_occ_frac) continue;
    }
    Py_ssize_t start;
    int64_t occ;
    if (dict) {
      if (!dict->lookup(h, &start, &occ)) continue;  // miss
    } else {
      auto lohi = std::equal_range(keys, keys + npost, h);
      occ = lohi.second - lohi.first;
      start = lohi.first - keys;
    }
    if (occ == 0 || occ > mid_occ) continue;  // miss / repetitive (rep_len)
    int32_t qpos_j = (int32_t)s.mz[j].pos;
    int32_t z = s.mz[j].z;
    for (Py_ssize_t t = start; t < start + occ; ++t) {
      int32_t rid = irid[t];
      int32_t rel = (int32_t)(istrand[t] ^ (signed char)z) & 1;
      int32_t rpos = ipos[t];
      int32_t qp = rel == 0 ? qpos_j : (int32_t)(qlen - (qpos_j + 1 - span) - 1);
      if (no_dual && name_rank[rid] < dualrank) continue;
      if (no_diag && rid == selfrid && rel == 0 && rpos == qp) continue;
      s.a_rid.push_back(rid);
      s.a_rpos.push_back(rpos);
      s.a_qpos.push_back(qp);
      s.a_span.push_back(span | (rel << 24));  // rel rides high bits
    }
  }
  Py_ssize_t n = (Py_ssize_t)s.a_rid.size();
  if (n == 0) return;
  // stable sort by (rid, strand, rpos); ties keep seed order
  s.order.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i) s.order[i] = (int32_t)i;
  std::stable_sort(s.order.begin(), s.order.end(),
                   [&](int32_t a, int32_t b) {
                     if (s.a_rid[a] != s.a_rid[b]) return s.a_rid[a] < s.a_rid[b];
                     int32_t sa = s.a_span[a] >> 24, sb = s.a_span[b] >> 24;
                     if (sa != sb) return sa < sb;
                     return s.a_rpos[a] < s.a_rpos[b];
                   });
  s.key2.resize(n);
  std::vector<int32_t>&R = s.a_rpos, &Q = s.a_qpos;
  static thread_local std::vector<int32_t> rs, qs, ss, rids;
  rs.resize(n);
  qs.resize(n);
  ss.resize(n);
  rids.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    int32_t o = s.order[i];
    rids[i] = s.a_rid[o];
    s.key2[i] = s.a_rid[o] * 2 + (s.a_span[o] >> 24);
    rs[i] = R[o];
    qs[i] = Q[o];
    ss[i] = s.a_span[o] & 0xFFFFFF;
  }
  s.F.assign(n, 0);
  s.P.assign(n, -1);
  chain_dp_raw(s.key2.data(), rs.data(), qs.data(), ss.data(), n, max_gap, bw,
               max_iter, max_skip, pen_gap, pen_skip, s.F.data(), s.P.data(),
               s.tmark);
  int32_t count = 0;
  if (!hpc) {
    // per-rid best score; count rids whose best passes min_score
    // (constant spans: min_cnt is implied by min_chain_score, see
    // engine.py count_overlaps' correctness argument)
    Py_ssize_t i = 0;
    while (i < n) {
      int32_t rid = rids[i];
      int64_t best = s.F[i];
      Py_ssize_t j = i + 1;
      for (; j < n && rids[j] == rid; ++j)
        if (s.F[j] > best) best = s.F[j];
      if (best >= min_score) {
        if (pairs_out && count < pmax) pairs_out[count] = rid;
        ++count;
      }
      i = j;
    }
  } else {
    // variable spans (HPC): a same-target secondary chain can pass where
    // the best chain fails min_cnt, so peel chains exactly like
    // mm_chain_backtrack (mirror of chain.py backtrack(): candidates
    // with f >= min_sc, stable-sorted by f ascending, walked in reverse
    // so larger indices win ties; used anchors never revert) and count
    // distinct rids over passing chains.
    s.bt_order.clear();
    for (Py_ssize_t i = 0; i < n; ++i)
      if (s.F[i] >= min_score) s.bt_order.push_back((int32_t)i);
    std::stable_sort(s.bt_order.begin(), s.bt_order.end(),
                     [&](int32_t a, int32_t b) { return s.F[a] < s.F[b]; });
    s.bt_used.assign(n, 0);
    s.bt_rids.clear();
    for (auto it = s.bt_order.rbegin(); it != s.bt_order.rend(); ++it) {
      int32_t end = *it;
      if (s.bt_used[end]) continue;
      // mg_chain_bk_end: stop the walk at the peeled-score argmax once
      // a valley deeper than max_drop (= bw) is seen; probed anchors
      // stay used, anchors beyond the break stay free (chain split)
      int64_t fe = s.F[end];
      int64_t i = end, max_i = end, max_s = 0;
      while (true) {
        s.bt_used[i] = 1;
        i = s.P[i];
        int64_t sc_i = i < 0 ? fe : fe - s.F[i];
        if (sc_i > max_s) {
          max_s = sc_i;
          max_i = i;
        } else if (max_s - sc_i > bw) {
          break;
        }
        if (i < 0 || s.bt_used[i]) break;
      }
      int64_t cnt = 0;
      for (i = end; i != max_i; i = s.P[i]) {
        s.bt_used[i] = 1;
        ++cnt;
      }
      int64_t sc = max_i < 0 ? fe : fe - s.F[max_i];
      if (sc >= min_score && cnt >= min_cnt) s.bt_rids.push_back(rids[end]);
    }
    std::sort(s.bt_rids.begin(), s.bt_rids.end());
    s.bt_rids.erase(std::unique(s.bt_rids.begin(), s.bt_rids.end()),
                    s.bt_rids.end());
    count = (int32_t)s.bt_rids.size();
    if (pairs_out) {
      int lim = count < pmax ? count : pmax;
      for (int j = 0; j < lim; ++j) pairs_out[j] = s.bt_rids[j];
    }
  }
  *count_out = count;
  *had_out = count > 0 ? 1 : 0;
}

// count_many(seqs, dualrank_i32, selfrid_i32, keys_u64, rid_i32, pos_i32,
//            strand_i8, name_rank_i32, mid_occ, k, w, max_gap, bw,
//            max_iter, max_skip, pen_gap, pen_skip, min_score, q_occ_frac,
//            no_dual, no_diag, hpc, min_cnt, threads, counts_out_i32,
//            had_out_u8
//            [, pairs_out_i32, pmax, uhash_u64, uoff_i32, boff_i32,
//               hash_bits, bucket_bits])
// pairs_out (optional): [n*pmax] int32, -1-padded passing target rids
// per query in ascending-rid order; rows with count > pmax are
// truncated (detectable by the caller: count vs emitted rids).
// Pass pairs_out of length 0 with pmax 0 to skip pair emission while
// still supplying the optional bucketed dictionary (uhash/uoff/boff),
// which replaces the binary search over the postings keys.
PyObject* py_count_many(PyObject*, PyObject* args) {
  PyObject* seq_list;
  Py_buffer dualrank, selfrid, keys, irid, ipos, istrand, name_rank;
  long long mid_occ;
  int k, w, max_gap, bw, max_iter, max_skip, min_score, no_dual, no_diag,
      hpc, min_cnt, threads;
  float pen_gap, pen_skip, q_occ_frac;
  Py_buffer counts_out, had_out;
  Py_buffer pairs_out, uhash, uoff, boff;
  pairs_out.buf = uhash.buf = uoff.buf = boff.buf = nullptr;
  int pmax = 0, hash_bits = 0, bucket_bits = 0;
  if (!PyArg_ParseTuple(args,
                        "O!y*y*y*y*y*y*y*Liiiiiiffifiiiiiy*y*|y*iy*y*y*ii",
                        &PyList_Type, &seq_list, &dualrank, &selfrid, &keys,
                        &irid, &ipos, &istrand, &name_rank, &mid_occ, &k, &w,
                        &max_gap, &bw, &max_iter, &max_skip, &pen_gap,
                        &pen_skip, &min_score, &q_occ_frac, &no_dual, &no_diag,
                        &hpc, &min_cnt, &threads, &counts_out, &had_out,
                        &pairs_out, &pmax, &uhash, &uoff, &boff, &hash_bits,
                        &bucket_bits))
    return nullptr;
  Py_ssize_t nreads = PyList_GET_SIZE(seq_list);
  std::vector<const unsigned char*> ptrs(nreads);
  std::vector<int64_t> lens(nreads);
  bool bad = false;
  for (Py_ssize_t i = 0; i < nreads; ++i) {
    PyObject* o = PyList_GET_ITEM(seq_list, i);
    char* p;
    Py_ssize_t ln;
    if (PyBytes_AsStringAndSize(o, &p, &ln) != 0) {
      bad = true;
      break;
    }
    ptrs[i] = (const unsigned char*)p;
    lens[i] = ln;
  }
  if (!bad) {
    const int32_t* dr = (const int32_t*)dualrank.buf;
    const int32_t* sr = (const int32_t*)selfrid.buf;
    const uint64_t* K = (const uint64_t*)keys.buf;
    const int32_t* IR = (const int32_t*)irid.buf;
    const int32_t* IP = (const int32_t*)ipos.buf;
    const signed char* IS = (const signed char*)istrand.buf;
    const int32_t* NR = (const int32_t*)name_rank.buf;
    Py_ssize_t npost = keys.len / 8;
    int32_t* CO = (int32_t*)counts_out.buf;
    unsigned char* HO = (unsigned char*)had_out.buf;
    int32_t* PO = pairs_out.buf && pmax > 0 ? (int32_t*)pairs_out.buf : nullptr;
    if (PO) memset(PO, 0xFF, (size_t)nreads * pmax * 4);  // -1 padding
    BucketDict dict;
    const BucketDict* dictp = nullptr;
    if (uhash.buf && boff.buf && bucket_bits > 0 && hash_bits > bucket_bits) {
      dict.uhash = (const uint64_t*)uhash.buf;
      dict.uoff = (const int32_t*)uoff.buf;
      dict.boff = (const int32_t*)boff.buf;
      dict.hash_bits = hash_bits;
      dict.bucket_bits = bucket_bits;
      dictp = &dict;
    }
    if (threads < 1) threads = 1;
    Py_BEGIN_ALLOW_THREADS {
      int nt = std::min<int>(threads, std::max<int>(1, (int)nreads));
      std::vector<std::thread> pool;
      std::atomic<Py_ssize_t> next(0);
      for (int t = 0; t < nt; ++t)
        pool.emplace_back([&]() {
          CountScratch scratch;
          for (;;) {
            Py_ssize_t i = next.fetch_add(1);
            if (i >= nreads) break;
            count_one(ptrs[i], lens[i], dr[i], sr[i], K, IR, IP, IS, NR,
                      npost, mid_occ, k, w, max_gap, bw, max_iter, max_skip,
                      pen_gap, pen_skip, min_score, q_occ_frac, no_dual,
                      no_diag, hpc != 0, min_cnt, dictp, scratch, &CO[i],
                      &HO[i], PO ? PO + (size_t)i * pmax : nullptr, pmax);
          }
        });
      for (auto& th : pool) th.join();
    }
    Py_END_ALLOW_THREADS
  }
  PyBuffer_Release(&dualrank);
  PyBuffer_Release(&selfrid);
  PyBuffer_Release(&keys);
  PyBuffer_Release(&irid);
  PyBuffer_Release(&ipos);
  PyBuffer_Release(&istrand);
  PyBuffer_Release(&name_rank);
  PyBuffer_Release(&counts_out);
  PyBuffer_Release(&had_out);
  if (pairs_out.buf) PyBuffer_Release(&pairs_out);
  if (uhash.buf) PyBuffer_Release(&uhash);
  if (uoff.buf) PyBuffer_Release(&uoff);
  if (boff.buf) PyBuffer_Release(&boff);
  if (bad) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"encode_seq", py_encode_seq, METH_O,
     "encode_seq(bytes) -> bytes of 2-bit codes (4=ambiguous)"},
    {"parse_fastx", py_parse_fastx, METH_O,
     "parse_fastx(buffer) -> list[(id, seq)] for FASTA/FASTQ data"},
    {"parse_fastx_chunk", py_parse_fastx_chunk, METH_VARARGS,
     "parse_fastx_chunk(buffer, is_final) -> (list[(id, seq)], consumed) — "
     "parse complete records from a stream chunk, reporting how many bytes "
     "were consumed; partial trailing records are left for the next chunk"},
    {"sketch_many", py_sketch_many, METH_VARARGS,
     "sketch_many(seqs, k, w, hpc, threads) -> list[(key_u64le, pos_i32le, "
     "strand_u8)] — exact minimap2-semantics minimizer sketch over raw "
     "ASCII sequences"},
    {"chain_dp", py_chain_dp, METH_VARARGS,
     "chain_dp(key2,rpos,qpos,span,n,max_gap,bw,max_iter,max_skip,pen_gap,"
     "pen_skip,f_out,p_out)"},
    {"count_many", py_count_many, METH_VARARGS,
     "count_many(seqs,dualrank,selfrid,keys,rid,pos,strand,name_rank,"
     "mid_occ,k,w,max_gap,bw,max_iter,max_skip,pen_gap,pen_skip,min_score,"
     "q_occ_frac,no_dual,no_diag,threads,counts_out,had_out) — GIL-free "
     "threaded overlap counting (ONT per-rid best / HPC backtrack peel)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_lrge_torch_native", "lrge_tpu_torch native host runtime",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__lrge_torch_native(void) {
  init_nt4();
  return PyModule_Create(&moduledef);
}
