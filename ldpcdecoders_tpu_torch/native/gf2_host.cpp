// Native bit-packed GF(2) host kernels: packed rows, syndromes of packed
// error rows, and fused decode verification.
//
// Packing rows into uint64 words turns each syndrome bit into
// popcount(H_row & err_row) & 1, threaded over lanes: far cheaper than an
// int64 matrix product in NumPy for an evaluation harness's per-batch
// checks.  The code is ldpcdecoders_tpu/native/gf2_host.cpp's.
//
// C ABI for ctypes; all buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int pick_threads(int64_t work_items, int64_t min_per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t t = work_items / min_per_thread;
  if (t < 1) t = 1;
  if (t > (int64_t)hw) t = hw;
  if (t > 16) t = 16;
  return (int)t;
}

template <typename F>
void parallel_over(int64_t count, int64_t min_per_thread, F&& fn) {
  int nt = pick_threads(count, min_per_thread);
  if (nt <= 1) {
    fn((int64_t)0, count);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (count + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < count ? lo + chunk : count;
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Pack a [rows, n] 0/1 uint8 matrix into [rows, nw] uint64 words
// (little-endian within the word: bit j of word w is column 64*w + j).
void gf2_pack_rows(const uint8_t* src, int64_t rows, int64_t n,
                   int64_t nw, uint64_t* out) {
  parallel_over(rows, 64, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* row = src + r * n;
      uint64_t* orow = out + r * nw;
      for (int64_t w = 0; w < nw; ++w) orow[w] = 0;
      for (int64_t j = 0; j < n; ++j) {
        if (row[j]) orow[j >> 6] |= (uint64_t)1 << (j & 63);
      }
    }
  });
}

// Syndromes of a packed error batch: out[b, i] = popcount(Hp[i] & Ep[b]) & 1.
// Hp: [m, nw] packed H rows; Ep: [B, nw] packed error rows; out: [B, m] uint8.
void gf2_syndromes_packed(const uint64_t* Hp, int64_t m, int64_t nw,
                          const uint64_t* Ep, int64_t B, uint8_t* out) {
  parallel_over(B, 4, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const uint64_t* e = Ep + b * nw;
      uint8_t* o = out + b * m;
      for (int64_t i = 0; i < m; ++i) {
        const uint64_t* h = Hp + i * nw;
        uint64_t acc = 0;
        for (int64_t w = 0; w < nw; ++w) acc ^= h[w] & e[w];
        o[i] = (uint8_t)(__builtin_popcountll(acc) & 1);
      }
    }
  });
}

// Fused decode verification.  For each lane b with injected error Ep[b] and
// decoder guess Gp[b] (both packed):
//   exact[b]  = (Ep[b] == Gp[b])                      — exact recovery
//   smatch[b] = syndrome(Ep[b] XOR Gp[b]) == 0        — syndrome-consistent
// (the guess reproduces the injected syndrome iff the residual E^G lies in
// the kernel of H).  Exact lanes skip the m-row syndrome scan entirely, and
// non-exact lanes early-exit on the first mismatched check.
void gf2_verify_packed(const uint64_t* Hp, int64_t m, int64_t nw,
                       const uint64_t* Ep, const uint64_t* Gp, int64_t B,
                       uint8_t* exact, uint8_t* smatch) {
  parallel_over(B, 4, [&](int64_t lo, int64_t hi) {
    std::vector<uint64_t> diff(nw);
    for (int64_t b = lo; b < hi; ++b) {
      const uint64_t* e = Ep + b * nw;
      const uint64_t* g = Gp + b * nw;
      uint64_t any = 0;
      for (int64_t w = 0; w < nw; ++w) {
        diff[w] = e[w] ^ g[w];
        any |= diff[w];
      }
      if (!any) {
        exact[b] = 1;
        smatch[b] = 1;
        continue;
      }
      exact[b] = 0;
      uint8_t ok = 1;
      for (int64_t i = 0; i < m; ++i) {
        const uint64_t* h = Hp + i * nw;
        uint64_t acc = 0;
        for (int64_t w = 0; w < nw; ++w) acc ^= h[w] & diff[w];
        if (__builtin_popcountll(acc) & 1) {
          ok = 0;
          break;
        }
      }
      smatch[b] = ok;
    }
  });
}

}  // extern "C"
