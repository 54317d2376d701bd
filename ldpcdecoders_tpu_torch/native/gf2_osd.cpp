// Native threaded OSD for problem sizes the device eliminations cannot hold.
//
// The CUDA eliminations (csrc/gf2_elim.cu) keep a lane's reliability-
// permuted packed matrix in one block's shared memory; a circuit-level
// DEM's lane (864 x 31,648 for bb144 R=6: 3.4 MB) is far past that.  On the
// host the same solve is a *column*-reduction: candidate columns in
// per-lane reliability order are reduced against a growing basis of
// (reduced column, pivot row, original-pivot combination) triples, with
// the stopping rule of ops/gf2.py::gf2_osd0, to which it is bitwise equal.
//
// The basis is kept in full RREF form (every stored reduced column has
// exactly one pivot-row bit): reducing a candidate costs one XOR per
// pivot-row bit it carries, about its column weight (DEM columns have
// weight <= 12), and the reduced representative of a coset is unique, so
// pivots, combos and outputs equal the device eliminations'.  Each new
// pivot clears its pivot row from all existing basis columns: O(rank) bit
// tests plus fill-dependent XORs.  The code is
// ldpcdecoders_tpu/native/gf2_osd.cpp's, with the OSD-CS sweep factored out
// (and built for the popcount instruction where the CPU has it) and the
// shared-order OSD-CS added (gf2_osd_cs_prepare, gf2_osd_cs_prepared_host).
//
// C ABI for ctypes; all buffers are caller-allocated numpy arrays.
//   Hcols: [n, mw] u64 packed columns (bit r of word w = row 64w+r)
//   order: [B, n] i32 per-lane column scan order (most reliable first)
//   bp:    [B, n] u8 hard decisions (original column order)
//   syn:   [B, m] u8 syndromes
//   out:   [B, n] u8 corrections (original column order)
//   consistent: [B] u8 — 1 iff the final reduced residual hit zero

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int pick_threads_osd(int64_t work_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t t = work_items;
  if (t > (int64_t)hw) t = hw;
  if (t > 16) t = 16;
  if (t < 1) t = 1;
  return (int)t;
}

// Runs work(lo, hi) over [0, B) in contiguous chunks, one a thread.
template <class Work>
void run_lanes(int64_t B, Work work) {
  int nt = pick_threads_osd(B);
  if (nt <= 1) {
    work(0, B);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (B + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < B ? lo + chunk : B;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

inline void xor_words(uint64_t* dst, const uint64_t* src, int64_t w) {
  for (int64_t i = 0; i < w; ++i) dst[i] ^= src[i];
}

inline bool any_word(const uint64_t* v, int64_t w) {
  for (int64_t i = 0; i < w; ++i)
    if (v[i]) return true;
  return false;
}

inline int64_t lowest_bit(const uint64_t* v, int64_t w) {
  for (int64_t i = 0; i < w; ++i)
    if (v[i]) return i * 64 + __builtin_ctzll(v[i]);
  return -1;
}

inline int64_t popcount_words(const uint64_t* v, int64_t w) {
  int64_t c = 0;
  for (int64_t i = 0; i < w; ++i) c += __builtin_popcountll(v[i]);
  return c;
}

inline int64_t popcount_and(const uint64_t* a, const uint64_t* b,
                            int64_t w) {
  int64_t c = 0;
  for (int64_t i = 0; i < w; ++i) c += __builtin_popcountll(a[i] & b[i]);
  return c;
}

inline int64_t popcount_and3(const uint64_t* a, const uint64_t* b,
                             const uint64_t* c, int64_t w) {
  int64_t r = 0;
  for (int64_t i = 0; i < w; ++i)
    r += __builtin_popcountll(a[i] & b[i] & c[i]);
  return r;
}

// Shared full-RREF elimination state (sized once per worker thread).
struct Rref {
  std::vector<uint64_t> red, combo;    // [m][mw], [m][pw]
  std::vector<uint64_t> pivmask;       // [mw] bitset of pivot rows
  std::vector<int32_t> rowbasis;       // [m] pivot row -> basis index
  std::vector<int64_t> prow;
  std::vector<int32_t> pivcol;
  std::vector<uint64_t> cand, cw, rhs, acc;
  int64_t rank = 0;

  void size_for(int64_t m, int64_t mw, int64_t pw) {
    red.resize(m * mw);
    combo.resize(m * pw);
    pivmask.resize(mw);
    rowbasis.resize(m);
    prow.resize(m);
    pivcol.resize(m);
    cand.resize(mw);
    cw.resize(pw);
    rhs.resize(mw);
    acc.resize(pw);
  }

  void reset(const uint64_t* Hcols, int64_t n, int64_t m, int64_t mw,
             int64_t pw, const uint8_t* bp, const uint8_t* syn) {
    rank = 0;
    std::memset(pivmask.data(), 0, mw * 8);
    std::memset(rhs.data(), 0, mw * 8);
    std::memset(acc.data(), 0, pw * 8);
    for (int64_t r = 0; r < m; ++r)
      if (syn[r]) rhs[r >> 6] ^= 1ull << (r & 63);
    // residual of the full BP assignment: rhs = syn ^ H @ bp
    for (int64_t c = 0; c < n; ++c)
      if (bp[c]) xor_words(rhs.data(), Hcols + c * mw, mw);
  }

  // Reduce Hcols[col] against the RREF basis into (cand, cw).  Because
  // every basis column carries exactly one pivot-row bit, one pass over
  // the candidate's initial pivot-row bits is complete.
  void reduce_candidate(const uint64_t* Hcols, int32_t col, int64_t mw,
                        int64_t pw) {
    std::memcpy(cand.data(), Hcols + (int64_t)col * mw, mw * 8);
    std::memset(cw.data(), 0, pw * 8);
    for (int64_t i = 0; i < mw; ++i) {
      uint64_t t = cand[i] & pivmask[i];
      while (t) {
        int64_t r = i * 64 + __builtin_ctzll(t);
        int32_t b = rowbasis[r];
        xor_words(cand.data(), red.data() + (int64_t)b * mw, mw);
        xor_words(cw.data(), combo.data() + (int64_t)b * pw, pw);
        t &= t - 1;
      }
    }
  }

  // Install (cand, cw) as pivot `rank` for original column `col`,
  // clearing its pivot row from every existing basis column and from
  // the tracked residual.  Returns the pivot row.
  int64_t install_pivot(int32_t col, uint8_t bp_col, int64_t mw,
                        int64_t pw) {
    cw[rank >> 6] ^= 1ull << (rank & 63);  // + itself
    int64_t pr = lowest_bit(cand.data(), mw);
    int64_t w = pr >> 6;
    uint64_t bit = 1ull << (pr & 63);
    for (int64_t b = 0; b < rank; ++b) {
      if (red[b * mw + w] & bit) {
        xor_words(red.data() + b * mw, cand.data(), mw);
        xor_words(combo.data() + b * pw, cw.data(), pw);
      }
    }
    std::memcpy(red.data() + rank * mw, cand.data(), mw * 8);
    std::memcpy(combo.data() + rank * pw, cw.data(), pw * 8);
    prow[rank] = pr;
    pivcol[rank] = col;
    pivmask[w] |= bit;
    rowbasis[pr] = (int32_t)rank;
    // fold the pivot's bp contribution back (its value is re-solved):
    // in reduced coordinates the original column IS pivot index `rank`,
    // so the fold is a single combo-bit toggle (rhs is unchanged —
    // resid_true = rhs XOR P*acc is the tracked invariant)
    if (bp_col) acc[rank >> 6] ^= 1ull << (rank & 63);
    if (rhs[w] & bit) {
      xor_words(rhs.data(), cand.data(), mw);
      xor_words(acc.data(), cw.data(), pw);
    }
    ++rank;
    return pr;
  }
};

void osd0_lane(const uint64_t* Hcols, int64_t n, int64_t m, int64_t mw,
               int64_t pw, const int32_t* order, const uint8_t* bp,
               const uint8_t* syn, uint8_t* out, uint8_t* consistent,
               Rref& ws) {
  ws.reset(Hcols, n, m, mw, pw, bp, syn);
  std::memcpy(out, bp, n);
  for (int64_t j = 0; j < n && ws.rank < m; ++j) {
    if (!any_word(ws.rhs.data(), mw)) break;  // residual in span: stop
    int32_t col = order[j];
    ws.reduce_candidate(Hcols, col, mw, pw);
    if (!any_word(ws.cand.data(), mw)) continue;  // dependent: keeps bp
    ws.install_pivot(col, bp[col], mw, pw);
  }
  *consistent = any_word(ws.rhs.data(), mw) ? 0 : 1;
  // pivot columns take their solved values; non-pivots kept bp
  for (int64_t b = 0; b < ws.rank; ++b)
    out[ws.pivcol[b]] = (ws.acc[b >> 6] >> (b & 63)) & 1;
}

}  // namespace

extern "C" {

void gf2_osd0_host(const uint64_t* Hcols, int64_t n, int64_t m, int64_t mw,
                   const int32_t* order, const uint8_t* bp,
                   const uint8_t* syn, int64_t B, uint8_t* out,
                   uint8_t* consistent) {
  int64_t pw = (m + 63) / 64;
  run_lanes(B, [&](int64_t lo, int64_t hi) {
    Rref ws;
    ws.size_for(m, mw, pw);
    for (int64_t l = lo; l < hi; ++l)
      osd0_lane(Hcols, n, m, mw, pw, order + l * n, bp + l * n, syn + l * m,
                out + l * n, consistent + l, ws);
  });
}

// pack columns: H [m, n] u8 row-major -> Hcols [n, mw] u64
void gf2_pack_cols(const uint8_t* H, int64_t m, int64_t n, int64_t mw,
                   uint64_t* Hcols) {
  std::memset(Hcols, 0, (size_t)(n * mw) * 8);
  for (int64_t r = 0; r < m; ++r) {
    const uint8_t* row = H + r * n;
    uint64_t bit = 1ull << (r & 63);
    int64_t w = r >> 6;
    for (int64_t c = 0; c < n; ++c)
      if (row[c]) Hcols[c * mw + w] |= bit;
  }
}

}  // extern "C"

// ---------------------------------------------------------------- OSD-CS
//
// Combination-sweep OSD (ops/gf2.py::osd_cs_sweep semantics, to which
// this is golden-tested): candidates are the base completion, every
// single non-pivot flip (reliability order), every pair within the
// lam most-reliable non-pivot columns, and — an extension past the
// device sweep — every TRIPLE within the lam3 most-reliable
// non-pivot columns.  Weights come from the reduced combos the
// eliminator tracks (combo bits over pivot indices ARE the RREF
// column entries), so the whole sweep is popcounts — no candidate
// matrices.  Unlike OSD-0's early exit, the elimination must visit
// all columns (every non-pivot needs its combo), which is what makes
// this the expensive-but-at-any-width host path for circuit DEMs.

namespace {

struct CsWorkspace {
  Rref rr;
  std::vector<uint64_t> npw;  // non-pivot combos, enumeration order
  std::vector<int64_t> d1;
  std::vector<int32_t> npcol;
};

// FULL elimination (no early stop) of the columns in `order`: every
// non-pivot column's reduced combo is needed by the sweep.  Where `rec_cand`
// and `rec_cw` are given, pivot k's reduced column and combo (its own bit
// included) as installed are copied to row k of each: what the pivot does
// to the tracked residual, which is all a syndrome changes.  Returns the
// number of non-pivot columns.
int64_t eliminate_full(const uint64_t* Hcols, int64_t n, int64_t mw,
                       int64_t pw, const int32_t* order, const uint8_t* bp,
                       CsWorkspace& ws, uint64_t* rec_cand = nullptr,
                       uint64_t* rec_cw = nullptr) {
  Rref& rr = ws.rr;
  int64_t n_np = 0;
  for (int64_t j = 0; j < n; ++j) {
    int32_t col = order[j];
    rr.reduce_candidate(Hcols, col, mw, pw);
    if (any_word(rr.cand.data(), mw)) {
      rr.install_pivot(col, bp[col], mw, pw);
      if (rec_cand) {
        std::memcpy(rec_cand + (rr.rank - 1) * mw, rr.cand.data(), mw * 8);
        std::memcpy(rec_cw + (rr.rank - 1) * pw, rr.cw.data(), pw * 8);
      }
    } else {
      // non-pivot, in reliability enumeration order; combo = RREF column
      std::memcpy(ws.npw.data() + n_np * pw, rr.cw.data(), pw * 8);
      ws.npcol[n_np] = col;
      ++n_np;
    }
  }
  return n_np;
}

// The popcounts below are the sweep's whole cost.  On x86-64 the sweep is
// built twice, with and without the popcnt instruction, and the loader
// picks the one the CPU runs (an ifunc); elsewhere it is built once,
// portably.  Integer work either way: the outputs do not depend on it.
#if defined(__x86_64__) && defined(__GNUC__) && !defined(LDPC_PORTABLE_POPCOUNT)
#define LDPC_POPCOUNT_CLONES __attribute__((target_clones("popcnt", "default")))
#else
#define LDPC_POPCOUNT_CLONES
#endif

// The combination sweep over an eliminated lane: `y0` is the pivots'
// solved values (bit b for pivot b), `npw`/`npcol` the n_np non-pivot
// combos and columns in enumeration order, `d1` n_np scratch entries.
// Writes the chosen correction to `out`.
LDPC_POPCOUNT_CLONES
void cs_sweep(int64_t n, int64_t pw, int64_t lam, int64_t lam3,
              const uint8_t* bp, int64_t rank, const int32_t* pivcol,
              const uint64_t* y0, const uint64_t* npw, const int32_t* npcol,
              int64_t n_np, int64_t* d1, uint8_t* out) {
  // base solution
  std::memcpy(out, bp, n);
  for (int64_t b = 0; b < rank; ++b)
    out[pivcol[b]] = (y0[b >> 6] >> (b & 63)) & 1;

  // single-flip deltas: delta1(c) = (1 - 2 bp[c])
  //   + popcount(w_c) - 2 popcount(w_c & y0)
  int64_t best1 = 1ll << 40, j1 = -1;
  for (int64_t k = 0; k < n_np; ++k) {
    const uint64_t* w = npw + k * pw;
    int64_t t = popcount_words(w, pw) - 2 * popcount_and(w, y0, pw);
    d1[k] = (bp[npcol[k]] ? -1 : 1) + t;
    if (d1[k] < best1) {
      best1 = d1[k];
      j1 = k;
    }
  }

  // pair flips within the lam most-reliable non-pivot columns:
  // pair(i,j) = d1(i) + d1(j) - 2 * (popcount(wi & wj) -
  //             2 popcount(wi & wj & y0)), lexicographic tie order
  int64_t L = lam < n_np ? lam : n_np;
  int64_t best2 = 1ll << 40, p_i = -1, p_j = -1;
  for (int64_t i = 0; i + 1 < L; ++i) {
    const uint64_t* wi = npw + i * pw;
    for (int64_t j = i + 1; j < L; ++j) {
      const uint64_t* wj = npw + j * pw;
      int64_t ov = popcount_and(wi, wj, pw) - 2 * popcount_and3(wi, wj, y0, pw);
      int64_t d = d1[i] + d1[j] - 2 * ov;
      if (d < best2) {
        best2 = d;
        p_i = i;
        p_j = j;
      }
    }
  }

  // triple flips within the lam3 most-reliable non-pivot columns
  // (order-3 combination sweep; device sweep stops at pairs).  Delta
  // evaluated directly: flipping {i,j,k} changes the pivot completion
  // by wi^wj^wk, so the weight change is
  //   popcount(y0 ^ wi ^ wj ^ wk) - popcount(y0) + sum (1 - 2 bp)
  // = d over the full solution; computed per word with no candidate
  // matrices.  Lexicographic tie order (i<j<k scan).
  int64_t L3 = lam3 < n_np ? lam3 : n_np;
  int64_t best3 = 1ll << 40, t_i = -1, t_j = -1, t_k = -1;
  if (L3 >= 3) {
    int64_t w0 = popcount_words(y0, pw);
    for (int64_t i = 0; i + 2 < L3; ++i) {
      const uint64_t* wi = npw + i * pw;
      for (int64_t j = i + 1; j + 1 < L3; ++j) {
        const uint64_t* wj = npw + j * pw;
        int64_t sij = (bp[npcol[i]] ? -1 : 1) + (bp[npcol[j]] ? -1 : 1);
        for (int64_t k = j + 1; k < L3; ++k) {
          const uint64_t* wk = npw + k * pw;
          int64_t pc = 0;
          for (int64_t q = 0; q < pw; ++q)
            pc += __builtin_popcountll(y0[q] ^ wi[q] ^ wj[q] ^ wk[q]);
          int64_t d = pc - w0 + sij + (bp[npcol[k]] ? -1 : 1);
          if (d < best3) {
            best3 = d;
            t_i = i;
            t_j = j;
            t_k = k;
          }
        }
      }
    }
  }

  // precedence: base, then a strictly-improving single, then a pair
  // strictly better than the best single, then a triple strictly
  // better than both
  int64_t c1 = -1, c2 = -1, c3 = -1;
  if (best3 < 0 && best3 < best2 && best3 < best1) {
    c1 = t_i;
    c2 = t_j;
    c3 = t_k;
  } else if (best2 < 0 && best2 < best1) {
    c1 = p_i;
    c2 = p_j;
  } else if (best1 < 0) {
    c1 = j1;
  }
  for (int64_t k : {c1, c2, c3}) {
    if (k < 0) continue;
    out[npcol[k]] ^= 1;
    const uint64_t* w = npw + k * pw;
    for (int64_t b = 0; b < rank; ++b)
      out[pivcol[b]] ^= (w[b >> 6] >> (b & 63)) & 1;
  }
}

void osd_cs_lane(const uint64_t* Hcols, int64_t n, int64_t m, int64_t mw,
                 int64_t pw, int64_t lam, int64_t lam3,
                 const int32_t* order, const uint8_t* bp,
                 const uint8_t* syn, uint8_t* out, uint8_t* consistent,
                 CsWorkspace& ws) {
  Rref& rr = ws.rr;
  rr.reset(Hcols, n, m, mw, pw, bp, syn);
  int64_t n_np = eliminate_full(Hcols, n, mw, pw, order, bp, ws);
  *consistent = any_word(rr.rhs.data(), mw) ? 0 : 1;
  cs_sweep(n, pw, lam, lam3, bp, rr.rank, rr.pivcol.data(), rr.acc.data(),
           ws.npw.data(), ws.npcol.data(), n_np, ws.d1.data(), out);
}

}  // namespace

extern "C" {

void gf2_osd_cs_host(const uint64_t* Hcols, int64_t n, int64_t m,
                     int64_t mw, int64_t lam, int64_t lam3,
                     const int32_t* order, const uint8_t* bp,
                     const uint8_t* syn, int64_t B, uint8_t* out,
                     uint8_t* consistent) {
  int64_t pw = (m + 63) / 64;
  run_lanes(B, [&](int64_t lo, int64_t hi) {
    CsWorkspace ws;
    ws.rr.size_for(m, mw, pw);
    ws.npw.resize(n * pw);
    ws.d1.resize(n);
    ws.npcol.resize(n);
    for (int64_t l = lo; l < hi; ++l)
      osd_cs_lane(Hcols, n, m, mw, pw, lam, lam3, order + l * n, bp + l * n,
                  syn + l * m, out + l * n, consistent + l, ws);
  });
}

// ------------------------------------------------- OSD-CS in a shared order
//
// A candidate whose column order and hard decisions (bp = 0) every lane
// shares has one elimination for all lanes: the pivots, the basis and the
// non-pivot combos depend on Hcols and the order alone.  A syndrome only
// moves the tracked residual, linearly: at pivot k, if the residual holds
// bit prow[k], it takes cand_k and the solution takes cw_k.  So
// gf2_osd_cs_prepare eliminates once and records that, and
// gf2_osd_cs_prepared_host replays the record on each lane's syndrome,
// then sweeps as gf2_osd_cs_host does (same outputs, bitwise).
//   prepare: order [n] i32; outputs prow [m] i64, cand [m, mw] u64,
//     cw [m, pw] u64, pivcol [m] i32 (first `rank` rows), npw [n, pw] u64,
//     npcol [n] i32 (first n - rank rows); returns rank.

int64_t gf2_osd_cs_prepare(const uint64_t* Hcols, int64_t n, int64_t m,
                           int64_t mw, const int32_t* order, int64_t* prow,
                           uint64_t* cand, uint64_t* cw, int32_t* pivcol,
                           uint64_t* npw, int32_t* npcol) {
  int64_t pw = (m + 63) / 64;
  CsWorkspace ws;
  ws.rr.size_for(m, mw, pw);
  ws.npw.resize(n * pw);
  ws.npcol.resize(n);
  std::vector<uint8_t> zeros(n > m ? n : m, 0);
  ws.rr.reset(Hcols, n, m, mw, pw, zeros.data(), zeros.data());
  int64_t n_np = eliminate_full(Hcols, n, mw, pw, order, zeros.data(), ws,
                                cand, cw);
  int64_t rank = ws.rr.rank;
  std::memcpy(prow, ws.rr.prow.data(), rank * 8);
  std::memcpy(pivcol, ws.rr.pivcol.data(), rank * 4);
  std::memcpy(npw, ws.npw.data(), n_np * pw * 8);
  std::memcpy(npcol, ws.npcol.data(), n_np * 4);
  return rank;
}

void gf2_osd_cs_prepared_host(int64_t n, int64_t m, int64_t mw, int64_t lam,
                              int64_t lam3, int64_t rank,
                              const int64_t* prow, const uint64_t* cand,
                              const uint64_t* cw, const int32_t* pivcol,
                              const uint64_t* npw, const int32_t* npcol,
                              const uint8_t* syn, int64_t B, uint8_t* out,
                              uint8_t* consistent) {
  int64_t pw = (m + 63) / 64;
  int64_t n_np = n - rank;
  run_lanes(B, [&](int64_t lo, int64_t hi) {
    std::vector<uint64_t> rhs(mw), acc(pw);
    std::vector<int64_t> d1(n_np);
    std::vector<uint8_t> zeros(n, 0);
    for (int64_t l = lo; l < hi; ++l) {
      const uint8_t* s = syn + l * m;
      std::memset(rhs.data(), 0, mw * 8);
      std::memset(acc.data(), 0, pw * 8);
      for (int64_t r = 0; r < m; ++r)
        if (s[r]) rhs[r >> 6] ^= 1ull << (r & 63);
      for (int64_t k = 0; k < rank; ++k) {
        if (rhs[prow[k] >> 6] >> (prow[k] & 63) & 1) {
          xor_words(rhs.data(), cand + k * mw, mw);
          xor_words(acc.data(), cw + k * pw, pw);
        }
      }
      consistent[l] = any_word(rhs.data(), mw) ? 0 : 1;
      cs_sweep(n, pw, lam, lam3, zeros.data(), rank, pivcol, acc.data(), npw,
               npcol, n_np, d1.data(), out + l * n);
    }
  });
}

}  // extern "C"
