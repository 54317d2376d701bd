// Whole-decode min-sum / sum-product kernel for group-circulant codes, for sm_90a.
//
// Replaces the Pallas TPU kernel of ldpcdecoders_tpu/ops/pallas_qc.py
// (`kernel` inside make_group_qc_minsum_pallas_fn): every sweep, the syndrome
// check, the per-lane freeze and the early exit of one decode in ONE launch,
// with the decode's state never leaving shared memory.  Device memory sees
// the syndromes (and priors) going in and err / llr / converged / iters
// coming out.  Numerics equal the plain torch version (ops/qc_minsum.py
// qc_minsum_ref) bit for bit in min-sum; all arithmetic is float32 through the
// _rn intrinsics, so nvcc contracts nothing into a fused multiply-add, and
// bfloat16 is a storage type only: values are rounded where the reference
// writes its message scratch and nowhere else.
//
// What differs from the TPU kernel:
//   * The terms (i, j, a, b) are data, not code: the int32 table of
//     ops/qc_minsum.py QCTerms.table() is turned, once per block, into one
//     16-byte word per edge in shared memory (offsets and its shift in the
//     form below), the row and column pointers.  Row weights are runtime
//     values; the two-min state of a check lives in registers.
//   * A shift is index arithmetic without a division.  With w = u*m + v,
//     sigma(w) = ((u+a)%l)*m + (v+b)%m = w + (a*m + b), less m where v >= m - b,
//     less Z where the sum still reaches Z.  A check-oriented read is a load at
//     sigma(w); the inverse shift is the same arithmetic with the inverse
//     monomial ((l-a)%l, (m-b)%m).  A 1-D lift (m = 1) skips the v test.
//   * The row loops are unrolled at compile time for each row weight up to
//     8 (by_weight), so all of a row's shared-memory reads issue before the
//     first of them is used; a heavier row works its later edges in a loop.
//   * A lane needs no other lane.  The TPU tile sweeps until all its lanes
//     are done, with err / llr / iters frozen per lane; here a lane stops
//     sweeping when it is done, which gives the same four outputs.  One
//     block decodes one lane: on the H100 packing several lanes of a small
//     lift into a block was slower at every size tried, down to Z = 36.
//
// Layered (qc_layered_kernel): the reference reads all of a base row before
// it updates, and updates a block column's totals once per edge, in edge
// order.  Shared memory holds the messages mu [Eb, Z] and the totals [nb, Z]
// in the storage type.
//   * A row whose block columns are all distinct (every row of a QC code
//     from a base matrix) takes ONE phase: thread w updates the totals and
//     messages at the positions it read, right after its own reads, since
//     the row's other edges and positions touch none of them.  One barrier
//     follows the row.
//   * A row with several terms in one block column (every bicycle block)
//     takes two: check-oriented (new messages stored through sigma into a
//     float32 row buffer), a barrier, then variable-oriented (thread x
//     applies the row's edges at position x in edge order), a barrier.
//     The row buffer is in shared memory only when some row needs it.
//   * The syndrome check stops at the first violated check any thread meets
//     (a flag per sweep in shared memory), so only a lane's last sweep checks
//     every row; the lane's flag is the barrier that ends the sweep
//     (__syncthreads_or).
//
// Flooding (qc_flooding_kernel): the reference keeps both directions'
// messages, nu and mu [Eb, Z], and sums the totals anew every sweep.  Here
// shared memory holds the totals of the last sweep in float32 [nb, Z] (the
// reference's unrounded `total`) and the check-to-variable messages in one of
// two forms, chosen by shape (qc_flooding_state in ops/qc_minsum.py):
//   * two-min (min-sum, rows of at most kSignBits edges): per check position
//     the row's two outgoing magnitudes max(alpha*min - beta, 0) in the
//     storage type (r1 for every edge but idx1, r2 for idx1) and one word:
//     the sign of each edge's outgoing message in bits 0..26, idx1 in bits
//     27..31.  Edge k's message is rebuilt as sign_k ? -r : r, which is the
//     reference's stored mu bit for bit (rounding commutes with the sign).
//     At the (6, 3)-regular nb=24 Z=128 code that is 34,712 B a lane in
//     float32 (80,384 before).
//   * messages (sum-product, or rows past kSignBits edges): mu [Eb, Z] in the
//     storage type, check-oriented (edge e's message of check position w at
//     e*Z + w).
// A sweep is two passes and two barriers:
//   1. check pass: thread w reads, for each edge of the row, the total at
//      sigma(w) and its own old message, forms nu = round(total - mu_old)
//      (the reference's nu bit for bit) and rewrites its check position's
//      state in place.  The same totals give the row's hard decisions, so
//      the check pass also checks the syndrome against the LAST sweep's
//      totals: the barrier that ends it ORs the threads' findings, and a lane
//      whose last sweep met its syndrome stops there, its totals unchanged.
//   2. variable pass: thread x sums, per block column, the prior and the
//      column's messages at the inverse shift in sorted-term order into the
//      totals; a barrier.
// After the lane's last sweep (max_iters) one standalone check decides
// `converged`.  The prior (one vector or a lane's own) is copied into shared
// memory where the block has room for it (QCParams.prior_sm).  Base rows are
// independent within the check pass and block columns within the variable
// pass, so a block of G*Z threads runs as G groups, group g on the rows and
// columns g, g + G, ... (ops/qc_minsum.py qc_launch_shape picks G): a
// sweep's latency falls about G-fold where few lanes share an SM, which is
// where a decode's slowest lanes run.
//
// What bounds it on the H100: not device memory (a few bytes per variable
// per decode) but, with several lanes on an SM, instruction issue (per edge
// of the check pass the shift, the old message's rebuild, nu and the two-min
// step), and with one or two lanes on an SM, the latency of each pass's
// chain of shared-memory loads.  So the flooding state is cut to what lets
// more blocks share an SM and to fewer shared-memory accesses an edge
// (two-min: the total read in the check pass, the word and the magnitudes
// read in the variable pass; six before), and the rows and columns of a
// sweep are spread over thread groups.
//
// Plain C interface (pointers, sizes, stream), loaded with ctypes.  The
// launcher returns a cudaError_t; 0 is success.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ inline float ld(const float* p, int i) { return p[i]; }
__device__ inline float ld(const bf16* p, int i) { return __bfloat162float(p[i]); }
__device__ inline void st(float* p, int i, float x) { p[i] = x; }
__device__ inline void st(bf16* p, int i, float x) { p[i] = __float2bfloat16_rn(x); }
// x as the storage type would hold it
__device__ inline float round_to(float x, float*) { return x; }
__device__ inline float round_to(float x, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a check position's two outgoing magnitudes (r1, r2) in the storage type
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
  __device__ static float2 get(float2 p) { return p; }
  __device__ static float2 make(float a, float b) { return make_float2(a, b); }
};
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
  __device__ static float2 get(__nv_bfloat162 p) { return __bfloat1622float2(p); }
  __device__ static __nv_bfloat162 make(float a, float b) { return __floats2bfloat162_rn(a, b); }
};

// clamps of the tanh rule (ops/clamps.py) and the two-min sentinel
constexpr float kTanhClamp = 0.99999f;
constexpr float kMsgClamp = 100.0f;
constexpr float kBig = 1e30f;
// edges of a row whose positions and values stay in registers
// (ops/qc_minsum.py HELD_EDGES)
constexpr int kHeld = 8;
// flooding two-min state: sign bits a word holds beside idx1
// (ops/qc_minsum.py SIGN_BITS)
constexpr int kSignBits = 27;
constexpr unsigned kSignMask = (1u << kSignBits) - 1;

// Compile-time shapes of the row loops.  by_weight: f(Held<H>{}) for a row of
// weight rw, H = rw up to kHeld, else kHeld (and the row's later edges in a
// loop).  by_lift: f(Flag<true>{}) for a 1-D lift (m == 1, a shift without
// the v test), else f(Flag<false>{}).
template <int N>
struct Held {
  static constexpr int value = N;
};
template <bool B>
struct Flag {
  static constexpr bool value = B;
};
template <typename F>
__device__ inline void by_lift(bool one_d, F&& f) {
  if (one_d)
    f(Flag<true>{});
  else
    f(Flag<false>{});
}
template <typename F>
__device__ inline void by_weight(int rw, F&& f) {
  switch (rw) {
    case 1: f(Held<1>{}); break;
    case 2: f(Held<2>{}); break;
    case 3: f(Held<3>{}); break;
    case 4: f(Held<4>{}); break;
    case 5: f(Held<5>{}); break;
    case 6: f(Held<6>{}); break;
    case 7: f(Held<7>{}); break;
    default: f(Held<kHeld>{}); break;
  }
}

// The flooding sweep's two-min reduction of a row's nu in edge order
// (ops/qc_minsum.py two_min_mu): the two smallest magnitudes, the first edge
// that holds the smallest, the sign parity, and the signs of edges k < KEPT.
template <int KEPT>
struct TwoMin {
  float min1 = kBig, min2 = kBig;
  int idx1 = 0;
  unsigned parity = 0, negbits = 0;
  __device__ void take(int k, float val) {
    const float mag = fabsf(val);
    const unsigned neg = val < 0.f;
    parity ^= neg;
    if (k < KEPT) negbits |= neg << k;
    if (k == 0) {
      min1 = mag;
    } else {
      const bool smaller = mag < min1;
      min2 = smaller ? min1 : fminf(min2, mag);
      idx1 = smaller ? k : idx1;
      min1 = smaller ? mag : min1;
    }
  }
  // the outgoing magnitude max(alpha * min - beta, 0) of min1 (every edge
  // but idx1's) or min2 (idx1's)
  __device__ float out(bool second, float alpha, float beta) const {
    return fmaxf(__fsub_rn(__fmul_rn(alpha, second ? min2 : min1), beta), 0.f);
  }
};

struct QCParams {
  int B, l, m, mb, nb, Eb, max_rw, buf_rw, max_iters;
  float alpha, beta, L0;
  long long prior_stride;  // 0: one [n] prior vector for all lanes, else n
  int prior_sm;            // flooding: the lane's prior is copied into shared memory
  int groups;              // flooding: groups of Z threads, each on its share of rows and columns
};

// Flooding keeps two-min states (else messages) for min-sum rows of at most
// kSignBits edges.
bool two_min_state(const QCParams& P, bool sumprod) { return !sumprod && P.max_rw <= kSignBits; }

// Shared memory of one block; ops/qc_minsum.py qc_smem_bytes is the same sum.
// buf_rw: the largest weight of a row with a repeated block column (0: none).
size_t smem_need(const QCParams& P, int threads, int itemsize, bool layered, bool sumprod,
                 bool prior_sm) {
  const size_t Z = (size_t)P.l * P.m;
  const int tail = P.max_rw > kHeld ? P.max_rw - kHeld : 0;
  const size_t sp = sumprod ? (size_t)tail * threads : 0;  // suffix products
  if (layered) {
    const size_t ints = 5 * (size_t)P.Eb + 2 * P.mb + P.nb + 4;
    const size_t floats = P.buf_rw * Z + sp;
    return 4 * ints + 4 * floats + itemsize * (P.Eb + P.nb) * Z + P.mb * Z;
  }
  // two int4 tables, the row and column pointers, the totals (and the
  // prior), the messages' state, the syndromes
  const size_t ints = 8 * (size_t)P.Eb + P.mb + P.nb + 2;
  const size_t floats = P.nb * Z * (prior_sm ? 2 : 1) + sp;
  const size_t state = two_min_state(P, sumprod) ? (2 * itemsize + 4) * P.mb * Z
                                                 : (size_t)itemsize * P.Eb * Z;
  return 4 * ints + 4 * floats + state + P.mb * Z;
}

// One block decodes one lane; thread t takes the positions w = t,
// t + blockDim.x, ... of every [Z] array.
template <typename T, bool SUMPROD>
__global__ void qc_layered_kernel(const uint8_t* __restrict__ syn, const float* __restrict__ priors,
                                  const int32_t* __restrict__ table, int8_t* __restrict__ err,
                                  float* __restrict__ llr, uint8_t* __restrict__ conv,
                                  int32_t* __restrict__ iters_out, const QCParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = P.m, Z = P.l * m, Eb = P.Eb, mb = P.mb, nb = P.nb;
  const int tpl = blockDim.x, t = threadIdx.x;
  const long long lane = blockIdx.x;

  // ---- carve the shared memory (the order of smem_need) -------------------
  // per edge: x = j*Z (its block column's totals), y = e*Z (its messages),
  // z = a*m + b and w = m - b (its shift)
  int4* etab = reinterpret_cast<int4*>(smem);
  int32_t* row_ptr = reinterpret_cast<int32_t*>(etab + Eb);
  int32_t* two_phase = row_ptr + mb + nb + 2 + Eb;  // per base row
  // found[it & 1]: sweep it's syndrome check has met a violated check
  volatile int32_t* found = two_phase + mb;
  float* fbase = reinterpret_cast<float*>(two_phase + mb + 2);
  float* rowbuf = fbase;  // two-phase rows: one row's new messages
  fbase += (size_t)P.buf_rw * Z;
  float* bw = fbase + t;  // suffix products of edges kHeld.., slot k at bw[k * tpl]
  fbase += SUMPROD && P.max_rw > kHeld ? (size_t)(P.max_rw - kHeld) * tpl : 0;
  T* sbase = reinterpret_cast<T*>(fbase);
  // s1 = check-to-variable messages mu, s2 = totals
  T* s1 = sbase;
  T* s2 = sbase + (size_t)Eb * Z;
  uint8_t* syn_s = reinterpret_cast<uint8_t*>(sbase + (size_t)(Eb + nb) * Z);

  const float* prior = priors ? priors + lane * P.prior_stride : nullptr;
  auto p32 = [&](int idx) -> float { return prior ? prior[idx] : P.L0; };

  // ---- the table in its kernel form, and the iteration-0 state --------------
  const int32_t* g_j = table;
  const int32_t* g_a = table + Eb;
  const int32_t* g_b = table + 2 * Eb;
  const int32_t* g_ptr = table + 3 * Eb;  // row_ptr, col_ptr, col_idx
  for (int e = t; e < Eb; e += tpl) {
    const int b = g_b[e];
    etab[e] = make_int4(g_j[e] * Z, e * Z, g_a[e] * m + b, m - b);
  }
  for (int i = t; i < mb + nb + 2 + Eb; i += tpl) row_ptr[i] = g_ptr[i];
  if (t < 2) found[t] = 0;
  // a row's terms are sorted by block column: a repeat is a neighbour
  for (int i = t; i < mb; i += tpl) {
    int rep = 0;
    for (int e = g_ptr[i] + 1; e < g_ptr[i + 1]; ++e) rep |= g_j[e] == g_j[e - 1];
    two_phase[i] = rep;
  }
  const uint8_t* syn_l = syn + lane * (long long)mb * Z;
  for (int i = t; i < mb * Z; i += tpl) syn_s[i] = syn_l[i] != 0;
  for (int i = t; i < Eb * Z; i += tpl) st(s1, i, 0.f);
  for (int i = t; i < nb * Z; i += tpl) st(s2, i, p32(i));
  __syncthreads();

  // the weight every row has (at most kHeld), else 0
  int row_w = row_ptr[1] - row_ptr[0];
  for (int i = 1; i < mb; ++i)
    if (row_ptr[i + 1] - row_ptr[i] != row_w) row_w = 0;
  if (row_w > kHeld) row_w = 0;
  // v = w mod m of this thread's positions, without a division in the loops
  const int v_first = t % m, v_step = tpl % m;
  auto v_next = [&](int v) -> int { return v + v_step >= m ? v + v_step - m : v + v_step; };
  auto sigma = [&](const int4& d, int w, int v) -> int {
    int p = w + d.z;
    if (v >= d.w) p -= m;
    if (p >= Z) p -= Z;
    return p;
  };
  auto sigma1 = [&](const int4& d, int w) -> int {  // m == 1
    const int p = w + d.z;
    return p >= Z ? p - Z : p;
  };
  // hard decision of variable position idx as the last sweep left it
  auto decision = [&](int idx) -> unsigned { return (unsigned)(ld(s2, idx) < 0.f); };
  auto tanh_of = [&](float x) -> float {
    return fminf(fmaxf(tanhf(__fmul_rn(x, 0.5f)), -kTanhClamp), kTanhClamp);
  };

  // check update of base row i at this thread's positions.  Edge e's message
  // for check position w belongs to variable position p = sigma(w): read
  // there (total minus old message), written there (one-phase: total and
  // message; two-phase: the row buffer).  H, the row's held edges, is a
  // compile-time constant, so the reads of all of them issue before the
  // first is used.
  auto check_row = [&](int i, bool one_phase) {
    const int e0 = row_ptr[i], rw = row_ptr[i + 1] - e0;
    by_lift(m == 1, [&](auto lift) {
      constexpr bool ONE_D = decltype(lift)::value;
      by_weight(rw, [&](auto held) {
        constexpr int H = decltype(held)::value;
        for (int w = t, v = v_first; w < Z; w += tpl, v = ONE_D ? 0 : v_next(v)) {
          const unsigned s = syn_s[i * Z + w];
          // edge k of the row at this position: the offsets of its total and
          // its message, and the values read there
          auto read = [&](int k, int& ta, int& ma, float& tv, float& ov) {
            const int4 d = etab[e0 + k];
            const int p = ONE_D ? sigma1(d, w) : sigma(d, w, v);
            ta = d.x + p;
            ma = d.y + p;
            tv = ld(s2, ta);
            ov = ld(s1, ma);
          };
          auto nc = [&](float tv, float ov) -> float { return __fsub_rn(tv, ov); };
          auto write = [&](int ta, int ma, float tv, float ov, float out) {
            if (one_phase) {
              st(s2, ta, __fadd_rn(tv, __fsub_rn(out, ov)));
              st(s1, ma, out);
            } else {
              rowbuf[ma - e0 * Z] = out;  // (e - e0) * Z + p
            }
          };
          int ta[H], ma[H];
          float tv[H], ov[H];
#pragma unroll
          for (int k = 0; k < H; ++k) read(k, ta[k], ma[k], tv[k], ov[k]);
          if (SUMPROD) {
            // exclusive products of tanh(nu/2) in the row's edge order: suffix
            // products first, then a forward pass; 2 atanh(x) = log1p(x) - log1p(-x)
            float th[H], suf[H];
#pragma unroll
            for (int k = 0; k < H; ++k) th[k] = tanh_of(nc(tv[k], ov[k]));
            float acc = 1.f;
            if (H == kHeld) {
              for (int k = rw - 1; k >= H; --k) {
                int a2, m2;
                float t2, o2;
                read(k, a2, m2, t2, o2);
                bw[(k - H) * tpl] = acc;
                acc = __fmul_rn(acc, tanh_of(nc(t2, o2)));
              }
            }
#pragma unroll
            for (int k = H - 1; k >= 0; --k) {
              suf[k] = acc;
              if (k > 0) acc = __fmul_rn(acc, th[k]);
            }
            auto emit = [&](float fwd, float sf, int a2, int m2, float t2, float o2) {
              float excl = fminf(fmaxf(__fmul_rn(fwd, sf), -kTanhClamp), kTanhClamp);
              float r = __fsub_rn(log1pf(excl), log1pf(-excl));
              r = fminf(fmaxf(r, -kMsgClamp), kMsgClamp);
              write(a2, m2, t2, o2, s ? -r : r);
            };
            float fwd = 1.f;
#pragma unroll
            for (int k = 0; k < H; ++k) {
              emit(fwd, suf[k], ta[k], ma[k], tv[k], ov[k]);
              if (k + 1 < H || (H == kHeld && k + 1 < rw)) fwd = __fmul_rn(fwd, th[k]);
            }
            if (H == kHeld) {
              for (int k = H; k < rw; ++k) {
                int a2, m2;
                float t2, o2;
                read(k, a2, m2, t2, o2);
                emit(fwd, bw[(k - H) * tpl], a2, m2, t2, o2);
                if (k + 1 < rw) fwd = __fmul_rn(fwd, tanh_of(nc(t2, o2)));
              }
            }
          } else {
            // two-min exclusive reduction; the held edges' signs stay in a
            // register, later edges read their sign again
            float min1 = kBig, min2 = kBig;
            int idx1 = 0;
            unsigned parity = 0, negbits = 0;
            auto take = [&](int k, float val) {
              const float mag = fabsf(val);
              const unsigned neg = val < 0.f;
              parity ^= neg;
              if (k < kHeld) negbits |= neg << k;
              if (k == 0) {
                min1 = mag;
              } else {
                const bool smaller = mag < min1;
                min2 = smaller ? min1 : fminf(min2, mag);
                idx1 = smaller ? k : idx1;
                min1 = smaller ? mag : min1;
              }
            };
#pragma unroll
            for (int k = 0; k < H; ++k) take(k, nc(tv[k], ov[k]));
            if (H == kHeld) {
              for (int k = H; k < rw; ++k) {
                int a2, m2;
                float t2, o2;
                read(k, a2, m2, t2, o2);
                take(k, nc(t2, o2));
              }
            }
            // every edge but idx1's gets min1; the sign is the parity of the
            // others and the syndrome bit
            const float r1 = fmaxf(__fsub_rn(__fmul_rn(P.alpha, min1), P.beta), 0.f);
            const float r2 = fmaxf(__fsub_rn(__fmul_rn(P.alpha, min2), P.beta), 0.f);
            const unsigned sign = parity ^ s;
#pragma unroll
            for (int k = 0; k < H; ++k) {
              const float r = idx1 == k ? r2 : r1;
              write(ta[k], ma[k], tv[k], ov[k], (sign ^ (negbits >> k)) & 1u ? -r : r);
            }
            if (H == kHeld) {
              for (int k = H; k < rw; ++k) {
                int a2, m2;
                float t2, o2;
                read(k, a2, m2, t2, o2);
                const float r = idx1 == k ? r2 : r1;
                write(a2, m2, t2, o2, (sign ^ (unsigned)(nc(t2, o2) < 0.f)) ? -r : r);
              }
            }
          }
        }
      });
    });
  };

  bool done = false;
  int it = 0;
  while (it < P.max_iters && !done) {
    for (int i = 0; i < mb; ++i) {
      const bool two = two_phase[i] != 0;
      check_row(i, !two);
      __syncthreads();
      if (two) {
        // thread x applies the row's edges at variable position x, in
        // edge order: tot <- round(tot + (new - old)), mu <- round(new)
        const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
        for (int x = t; x < Z; x += tpl) {
          for (int e = e0; e < e1; ++e) {
            const int4 d = etab[e];
            const float mu_new = rowbuf[(e - e0) * Z + x];
            st(s2, d.x + x, __fadd_rn(ld(s2, d.x + x), __fsub_rn(mu_new, ld(s1, d.y + x))));
            st(s1, d.y + x, mu_new);
          }
        }
        __syncthreads();
      }
    }

    // syndrome check: XOR of the decisions at sigma(w) per base row.  One
    // violated check decides the sweep, so the first thread to meet one
    // raises the sweep's flag and the others stop at their next group of
    // rows; the barrier that ends the sweep ORs every thread's finding, so
    // ``done`` is uniform over the block
    unsigned bad = 0;
    volatile int32_t* stop = found + (it & 1);
    by_lift(m == 1, [&](auto lift) {
      constexpr bool ONE_D = decltype(lift)::value;
      for (int w = t, v = v_first; w < Z && !*stop; w += tpl, v = ONE_D ? 0 : v_next(v)) {
        // the parity of check (i, w): the syndrome bit and the decisions
        auto parity = [&](auto held, int i, int e0, int rw) -> unsigned {
          constexpr int H = decltype(held)::value;
          unsigned par = syn_s[i * Z + w];
#pragma unroll
          for (int k = 0; k < H; ++k) {
            const int4 d = etab[e0 + k];
            par ^= decision(d.x + (ONE_D ? sigma1(d, w) : sigma(d, w, v)));
          }
          if (H == kHeld) {
            for (int k = H; k < rw; ++k) {
              const int4 d = etab[e0 + k];
              par ^= decision(d.x + (ONE_D ? sigma1(d, w) : sigma(d, w, v)));
            }
          }
          return par;
        };
        if (row_w > 0) {
          // every row has the weight row_w: four rows' loads in flight
          by_weight(row_w, [&](auto held) {
            constexpr int H = decltype(held)::value;
            for (int i0 = 0; i0 < mb && !*stop; i0 += 4) {
              unsigned par = 0;
#pragma unroll
              for (int r = 0; r < 4; ++r)
                if (i0 + r < mb) par |= parity(held, i0 + r, (i0 + r) * H, H);
              if (par) {
                bad = 1;
                *stop = 1;
              }
            }
          });
        } else {
          for (int i = 0; i < mb && !*stop; ++i) {
            const int e0 = row_ptr[i], rw = row_ptr[i + 1] - e0;
            unsigned par = 0;
            by_weight(rw, [&](auto held) { par = parity(held, i, e0, rw); });
            if (par) {
              bad = 1;
              *stop = 1;
            }
          }
        }
      }
    });
    ++it;
    done = __syncthreads_or(bad) == 0;
    if (t == 0) found[it & 1] = 0;  // the next sweep's flag, last read two sweeps ago
  }

  // ---- outputs: the stored totals of the lane's last sweep -------------------
  if (t == 0) {
    conv[lane] = done;
    iters_out[lane] = it;
  }
  int8_t* err_l = err + lane * (long long)nb * Z;
  float* llr_l = llr + lane * (long long)nb * Z;
  for (int j = 0; j < nb; ++j) {
    for (int x = t; x < Z; x += tpl) {
      const int idx = j * Z + x;
      // no sweep ran: the prior, decision 0
      const float total = it == 0 ? p32(idx) : ld(s2, idx);
      err_l[idx] = it == 0 ? 0 : (int8_t)decision(idx);
      llr_l[idx] = total;
    }
  }
}

// One block decodes one lane; thread t takes the positions w = t,
// t + blockDim.x, ... of every [Z] array.  TWO_MIN: the messages as two-min
// states (min-sum only), else as messages.
template <typename T, bool SUMPROD, bool TWO_MIN>
__global__ void qc_flooding_kernel(const uint8_t* __restrict__ syn,
                                   const float* __restrict__ priors,
                                   const int32_t* __restrict__ table, int8_t* __restrict__ err,
                                   float* __restrict__ llr, uint8_t* __restrict__ conv,
                                   int32_t* __restrict__ iters_out, const QCParams P) {
  typedef typename Pair<T>::type PairT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = P.m, Z = P.l * m, Eb = P.Eb, mb = P.mb, nb = P.nb;
  const int tpl = blockDim.x, t = threadIdx.x;
  const long long lane = blockIdx.x;

  // ---- carve the shared memory (the order of smem_need) -------------------
  // etab, per edge in row order: x = j*Z (its block column's totals), y = e*Z
  // (its messages), z = a*m + b and w = m - b (its shift).  ctab, per edge in
  // column order: x = i*Z (two-min: its row's states) or e*Z (its messages),
  // y = k (its place in its row), z and w of the inverse shift
  int4* etab = reinterpret_cast<int4*>(smem);
  int4* ctab = etab + Eb;
  unsigned char* cur = reinterpret_cast<unsigned char*>(ctab + Eb);
  PairT* rpair = reinterpret_cast<PairT*>(cur);  // two-min: (r1, r2) per check position
  cur += TWO_MIN ? sizeof(PairT) * mb * Z : 0;
  uint32_t* sword = reinterpret_cast<uint32_t*>(cur);  // two-min: signs | idx1 << kSignBits
  cur += TWO_MIN ? sizeof(uint32_t) * mb * Z : 0;
  float* tot = reinterpret_cast<float*>(cur);  // the last sweep's totals
  cur += sizeof(float) * nb * Z;
  float* pri_s = reinterpret_cast<float*>(cur);  // the prior, where prior_sm
  cur += P.prior_sm ? sizeof(float) * nb * Z : 0;
  float* bw = reinterpret_cast<float*>(cur) + t;  // suffix products of edges kHeld..
  cur += SUMPROD && P.max_rw > kHeld ? sizeof(float) * (P.max_rw - kHeld) * tpl : 0;
  int32_t* row_ptr = reinterpret_cast<int32_t*>(cur);
  int32_t* col_ptr = row_ptr + mb + 1;
  cur += sizeof(int32_t) * (mb + nb + 2);
  T* mu = reinterpret_cast<T*>(cur);  // messages: mu [Eb, Z], check-oriented
  cur += TWO_MIN ? 0 : sizeof(T) * Eb * Z;
  uint8_t* syn_s = cur;

  const float* prior = priors ? priors + lane * P.prior_stride : nullptr;
  auto p32 = [&](int idx) -> float {
    return P.prior_sm ? pri_s[idx] : prior ? prior[idx] : P.L0;
  };

  // ---- the tables in their kernel form, and the iteration-0 state -----------
  // (totals = prior, every message 0)
  const int32_t* g_j = table;
  const int32_t* g_a = table + Eb;
  const int32_t* g_b = table + 2 * Eb;
  const int32_t* g_ptr = table + 3 * Eb;  // row_ptr, col_ptr, col_idx
  const int32_t* g_col = g_ptr + mb + nb + 2;
  for (int e = t; e < Eb; e += tpl) {
    const int b = g_b[e];
    etab[e] = make_int4(g_j[e] * Z, e * Z, g_a[e] * m + b, m - b);
  }
  for (int c = t; c < Eb; c += tpl) {
    const int e = g_col[c];
    int lo = 0, hi = mb - 1;  // the row of edge e: row_ptr[i] <= e < row_ptr[i + 1]
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (g_ptr[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int ai = g_a[e] == 0 ? 0 : P.l - g_a[e], bi = g_b[e] == 0 ? 0 : m - g_b[e];
    ctab[c] = make_int4(TWO_MIN ? lo * Z : e * Z, e - g_ptr[lo], ai * m + bi, m - bi);
  }
  for (int i = t; i < mb + nb + 2; i += tpl) row_ptr[i] = g_ptr[i];
  const uint8_t* syn_l = syn + lane * (long long)mb * Z;
  for (int i = t; i < mb * Z; i += tpl) syn_s[i] = syn_l[i] != 0;
  for (int i = t; i < nb * Z; i += tpl) {
    const float p = prior ? prior[i] : P.L0;
    tot[i] = p;
    if (P.prior_sm) pri_s[i] = p;
  }
  if (TWO_MIN) {
    for (int i = t; i < mb * Z; i += tpl) {
      rpair[i] = Pair<T>::make(0.f, 0.f);
      sword[i] = 0;
    }
  } else {
    for (int i = t; i < Eb * Z; i += tpl) st(mu, i, 0.f);
  }
  __syncthreads();

  // v = w mod m of this thread's positions, without a division in the loops
  // the block is G groups of pz threads: group g takes the base rows and
  // block columns g, g + G, ..., its thread tg the positions tg, tg + pz, ...
  const int G = P.groups, pz = tpl / G, g = t / pz, tg = t - g * pz;
  const int v_first = tg % m, v_step = pz % m;
  auto v_next = [&](int v) -> int { return v + v_step >= m ? v + v_step - m : v + v_step; };
  auto sigma = [&](const int4& d, int w, int v) -> int {
    int p = w + d.z;
    if (v >= d.w) p -= m;
    if (p >= Z) p -= Z;
    return p;
  };
  auto sigma1 = [&](const int4& d, int w) -> int {  // m == 1
    const int p = w + d.z;
    return p >= Z ? p - Z : p;
  };
  auto nu_of = [&](float tv, float mu_old) -> float {
    return round_to(__fsub_rn(tv, mu_old), (T*)nullptr);
  };
  auto tanh_of = [&](float x) -> float {
    return fminf(fmaxf(tanhf(__fmul_rn(x, 0.5f)), -kTanhClamp), kTanhClamp);
  };

  // 1. check pass over base row i at this thread's positions: every edge's
  // total at sigma(w) gives nu = round(total - old message) and the row's
  // decisions; returns whether a check of the row is violated by the totals
  // read (the last sweep's).  H, the row's held edges, is a compile-time
  // constant, so the reads of all of them issue before the first is used.
  auto check_row = [&](int i) -> unsigned {
    unsigned bad = 0;
    const int e0 = row_ptr[i], rw = row_ptr[i + 1] - e0;
    by_lift(m == 1, [&](auto lift) {
      constexpr bool ONE_D = decltype(lift)::value;
      by_weight(rw, [&](auto held) {
        constexpr int H = decltype(held)::value;
        for (int w = tg, v = v_first; w < Z; w += pz, v = ONE_D ? 0 : v_next(v)) {
          const int q = i * Z + w;
          const unsigned s = syn_s[q];
          unsigned par = s;  // the syndrome bit and the decisions
          auto total_at = [&](int k) -> float {
            const int4 d = etab[e0 + k];
            return tot[d.x + (ONE_D ? sigma1(d, w) : sigma(d, w, v))];
          };
          float tv[H];
#pragma unroll
          for (int k = 0; k < H; ++k) tv[k] = total_at(k);
          if (TWO_MIN) {
            // the old state, the new two-min reduction over nu
            const unsigned word = sword[q];
            const float2 old = Pair<T>::get(rpair[q]);
            const int old_idx = (int)(word >> kSignBits);
            TwoMin<kSignBits> tm;
            auto take = [&](int k, float tvk) {
              par ^= tvk < 0.f;
              const float r = k == old_idx ? old.y : old.x;
              tm.take(k, nu_of(tvk, (word >> k) & 1u ? -r : r));
            };
#pragma unroll
            for (int k = 0; k < H; ++k) take(k, tv[k]);
            if (H == kHeld)
              for (int k = H; k < rw; ++k) take(k, total_at(k));
            // an edge's sign is the parity of the others and the syndrome bit
            rpair[q] = Pair<T>::make(tm.out(false, P.alpha, P.beta), tm.out(true, P.alpha, P.beta));
            sword[q] = (((tm.parity ^ s) ? ~tm.negbits : tm.negbits) & kSignMask) |
                       ((unsigned)tm.idx1 << kSignBits);
          } else {
            // edge k's message slot, its old message and nu
            auto slot = [&](int k) -> int { return etab[e0 + k].y + w; };
            float nv[H];
#pragma unroll
            for (int k = 0; k < H; ++k) {
              par ^= tv[k] < 0.f;
              nv[k] = nu_of(tv[k], ld(mu, slot(k)));
            }
            auto nu_at = [&](int k) -> float { return nu_of(total_at(k), ld(mu, slot(k))); };
            if (SUMPROD) {
              // exclusive products of tanh(nu/2) in the row's edge order:
              // suffix products first, then a forward pass;
              // 2 atanh(x) = log1p(x) - log1p(-x)
              float th[H], suf[H];
#pragma unroll
              for (int k = 0; k < H; ++k) th[k] = tanh_of(nv[k]);
              float acc = 1.f;
              if (H == kHeld) {
                for (int k = rw - 1; k >= H; --k) {
                  const float tvk = total_at(k);
                  par ^= tvk < 0.f;
                  bw[(k - H) * tpl] = acc;
                  acc = __fmul_rn(acc, tanh_of(nu_of(tvk, ld(mu, slot(k)))));
                }
              }
#pragma unroll
              for (int k = H - 1; k >= 0; --k) {
                suf[k] = acc;
                if (k > 0) acc = __fmul_rn(acc, th[k]);
              }
              auto emit = [&](float fwd, float sf, int k) {
                float excl = fminf(fmaxf(__fmul_rn(fwd, sf), -kTanhClamp), kTanhClamp);
                float r = __fsub_rn(log1pf(excl), log1pf(-excl));
                r = fminf(fmaxf(r, -kMsgClamp), kMsgClamp);
                st(mu, slot(k), s ? -r : r);
              };
              float fwd = 1.f;
#pragma unroll
              for (int k = 0; k < H; ++k) {
                emit(fwd, suf[k], k);
                if (k + 1 < H || (H == kHeld && k + 1 < rw)) fwd = __fmul_rn(fwd, th[k]);
              }
              if (H == kHeld) {
                for (int k = H; k < rw; ++k) {
                  // nu of edge k before emit overwrites its message
                  const float th_k = k + 1 < rw ? tanh_of(nu_at(k)) : 1.f;
                  emit(fwd, bw[(k - H) * tpl], k);
                  if (k + 1 < rw) fwd = __fmul_rn(fwd, th_k);
                }
              }
            } else {
              // two-min exclusive reduction; the held edges' signs stay in a
              // register, later edges work their nu out again
              TwoMin<kHeld> tm;
#pragma unroll
              for (int k = 0; k < H; ++k) tm.take(k, nv[k]);
              if (H == kHeld) {
                for (int k = H; k < rw; ++k) {
                  const float tvk = total_at(k);
                  par ^= tvk < 0.f;
                  tm.take(k, nu_of(tvk, ld(mu, slot(k))));
                }
              }
              const float r1 = tm.out(false, P.alpha, P.beta), r2 = tm.out(true, P.alpha, P.beta);
              const unsigned sign = tm.parity ^ s;
#pragma unroll
              for (int k = 0; k < H; ++k) {
                const float r = tm.idx1 == k ? r2 : r1;
                st(mu, slot(k), (sign ^ (tm.negbits >> k)) & 1u ? -r : r);
              }
              if (H == kHeld) {
                for (int k = H; k < rw; ++k) {
                  const float r = tm.idx1 == k ? r2 : r1;
                  st(mu, slot(k), (sign ^ (unsigned)(nu_at(k) < 0.f)) ? -r : r);
                }
              }
            }
          }
          bad |= par;
        }
      });
    });
    return bad;
  };

  // 2. variable pass over block column j: total = prior + the column's
  // messages, at the inverse shift, in sorted-term order
  auto var_column = [&](int j) {
    const int c0 = col_ptr[j], cw = col_ptr[j + 1] - c0;
    by_lift(m == 1, [&](auto lift) {
      constexpr bool ONE_D = decltype(lift)::value;
      by_weight(cw, [&](auto held) {
        constexpr int H = decltype(held)::value;
        for (int x = tg, v = v_first; x < Z; x += pz, v = ONE_D ? 0 : v_next(v)) {
          auto msg = [&](int c) -> float {
            const int4 d = ctab[c];
            const int q = d.x + (ONE_D ? sigma1(d, x) : sigma(d, x, v));
            if (!TWO_MIN) return ld(mu, q);
            const unsigned word = sword[q];
            const float2 r = Pair<T>::get(rpair[q]);
            const float mag = (int)(word >> kSignBits) == d.y ? r.y : r.x;
            return (word >> d.y) & 1u ? -mag : mag;
          };
          float mv[H];
#pragma unroll
          for (int k = 0; k < H; ++k) mv[k] = msg(c0 + k);
          float total = p32(j * Z + x);
#pragma unroll
          for (int k = 0; k < H; ++k) total = __fadd_rn(total, mv[k]);
          if (H == kHeld)
            for (int c = c0 + H; c < c0 + cw; ++c) total = __fadd_rn(total, msg(c));
          tot[j * Z + x] = total;
        }
      });
    });
  };

  bool done = false;
  int it = 0;
  while (it < P.max_iters) {
    unsigned bad = 0;
    for (int i = g; i < mb; i += G) bad |= check_row(i);
    // the barrier ORs the threads' findings on the totals of sweep it - 1,
    // so ``done`` is uniform over the block
    if (__syncthreads_or(bad) == 0 && it > 0) {
      done = true;
      break;
    }
    for (int j = g; j < nb; j += G) var_column(j);
    __syncthreads();
    ++it;
  }
  if (!done && it > 0) {
    // the last sweep's totals against the syndrome
    unsigned bad = 0;
    by_lift(m == 1, [&](auto lift) {
      constexpr bool ONE_D = decltype(lift)::value;
      for (int i = g; i < mb; i += G) {
        const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
        for (int w = tg, v = v_first; w < Z; w += pz, v = ONE_D ? 0 : v_next(v)) {
          unsigned par = syn_s[i * Z + w];
          for (int e = e0; e < e1; ++e) {
            const int4 d = etab[e];
            par ^= tot[d.x + (ONE_D ? sigma1(d, w) : sigma(d, w, v))] < 0.f;
          }
          bad |= par;
        }
      }
    });
    done = __syncthreads_or(bad) == 0;
  }

  // ---- outputs: the stored totals of the lane's last sweep -------------------
  if (t == 0) {
    conv[lane] = done;
    iters_out[lane] = it;
  }
  int8_t* err_l = err + lane * (long long)nb * Z;
  float* llr_l = llr + lane * (long long)nb * Z;
  for (int idx = t; idx < nb * Z; idx += tpl) {
    const float total = tot[idx];  // the prior where no sweep ran
    err_l[idx] = it == 0 ? 0 : (int8_t)(total < 0.f);
    llr_l[idx] = total;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, bool layered, bool sumprod, int itemsize, const void* syn,
                   const void* priors, const void* table, void* err, void* llr, void* conv,
                   void* iters, QCParams P, int threads, int smem_bytes, cudaStream_t st) {
  // the held edges take registers: where 65,536 of them do not reach
  // ``threads`` threads (a lift past 512 positions), the block takes the
  // threads it can have and strides its positions over them
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  if (threads > attr.maxThreadsPerBlock) threads = attr.maxThreadsPerBlock;
  // flooding on a multiple of Z threads: that many groups
  const int Z = P.l * P.m;
  P.groups = !layered && threads >= 2 * Z ? threads / Z : 1;
  if (P.groups > 1) threads = P.groups * Z;
  // flooding: the prior goes on chip where the caller gave the room for it
  P.prior_sm = !layered && priors != nullptr &&
               (size_t)smem_bytes >= smem_need(P, threads, itemsize, false, sumprod, true);
  if ((size_t)smem_bytes < smem_need(P, threads, itemsize, layered, sumprod, P.prior_sm))
    return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<P.B, threads, smem_bytes, st>>>(
      static_cast<const uint8_t*>(syn), static_cast<const float*>(priors),
      static_cast<const int32_t*>(table), static_cast<int8_t*>(err), static_cast<float*>(llr),
      static_cast<uint8_t*>(conv), static_cast<int32_t*>(iters), P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_modes(bool layered, bool sumprod, const void* syn, const void* priors,
                         const void* table, void* err, void* llr, void* conv, void* iters,
                         const QCParams& P, int threads, int smem_bytes, cudaStream_t st) {
#define QC_LAUNCH(K)                                                                          \
  launch(K, layered, sumprod, (int)sizeof(T), syn, priors, table, err, llr, conv, iters, P, \
         threads, smem_bytes, st)
  if (layered)
    return sumprod ? QC_LAUNCH((qc_layered_kernel<T, true>))
                   : QC_LAUNCH((qc_layered_kernel<T, false>));
  if (sumprod) return QC_LAUNCH((qc_flooding_kernel<T, true, false>));
  return two_min_state(P, false) ? QC_LAUNCH((qc_flooding_kernel<T, false, true>))
                                 : QC_LAUNCH((qc_flooding_kernel<T, false, false>));
#undef QC_LAUNCH
}

}  // namespace

extern "C" {

// syn [B, mb*Z] bytes (0/1), priors null or float32 with lane stride
// prior_stride, table int32 (ops/qc_minsum.py QCTerms.table), err [B, nb*Z]
// int8, llr [B, nb*Z] float32, conv [B] bytes, iters [B] int32.  max_rw is
// the largest row weight, buf_rw the largest weight of a row with a repeated
// block column (QCTerms.buffered_row_weight, 0 for none).  Flooding copies
// the prior into shared memory when smem_bytes leaves room for it.
int ldpc_qc_minsum(const void* syn, const void* priors, const void* table, void* err, void* llr,
                   void* conv, void* iters, int B, int l, int m, int mb, int nb, int Eb,
                   int max_rw, int buf_rw, int max_iters, int threads, int layered,
                   int sumproduct, int is_bf16, float alpha, float beta, float L0,
                   long long prior_stride, int smem_bytes, void* stream) {
  if (B < 1 || threads < 1 || threads > 1024) return cudaErrorInvalidValue;
  const QCParams P = {B,     l,    m,  mb,           nb, Eb, max_rw, buf_rw, max_iters,
                      alpha, beta, L0, prior_stride, 0, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_modes<bf16>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                              threads, smem_bytes, st);
  return launch_modes<float>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                             threads, smem_bytes, st);
}

// The shared memory one block needs on ``threads`` threads (the launcher's
// own sum; ops/qc_minsum.py qc_smem_bytes mirrors it).
long long ldpc_qc_smem_bytes(int l, int m, int mb, int nb, int Eb, int max_rw, int buf_rw,
                             int threads, int itemsize, int layered, int sumproduct,
                             int prior_sm) {
  QCParams P = {};
  P.l = l, P.m = m, P.mb = mb, P.nb = nb, P.Eb = Eb, P.max_rw = max_rw, P.buf_rw = buf_rw;
  return (long long)smem_need(P, threads, itemsize, layered, sumproduct, prior_sm);
}

}  // extern "C"
