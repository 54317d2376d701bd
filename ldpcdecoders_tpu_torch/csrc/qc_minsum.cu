// Whole-decode min-sum / sum-product kernel for group-circulant codes, for sm_90a.
//
// Replaces the Pallas TPU kernel of ldpcdecoders_tpu/ops/pallas_qc.py
// (`kernel` inside make_group_qc_minsum_pallas_fn): every sweep, the syndrome
// check, the per-lane freeze and the early exit of one decode in ONE launch,
// with the messages never leaving shared memory.  Device memory sees the
// syndromes (and priors) going in and err / llr / converged / iters coming
// out.  Numerics equal the plain torch version (ops/qc_minsum.py
// qc_minsum_ref) bit for bit in min-sum; all arithmetic is float32 through the
// _rn intrinsics, so nvcc contracts nothing into a fused multiply-add, and
// bfloat16 is a storage type only: values are rounded where they are written
// to the message arrays and nowhere else.
//
// What differs from the TPU kernel:
//   * The terms (i, j, a, b) are data, not code: the int32 table of
//     ops/qc_minsum.py QCTerms.table() is turned, once per block, into one
//     16-byte word per edge in shared memory (the offsets of its block column
//     and of its messages, and its shift in the form below), the row and
//     column pointers, and a flag per base row.  Row weights are runtime
//     values; the two-min state of a check lives in registers.
//   * A shift is index arithmetic without a division.  With w = u*m + v,
//     sigma(w) = ((u+a)%l)*m + (v+b)%m = w + (a*m + b), less m where v >= m - b,
//     less Z where the sum still reaches Z.  A check-oriented read is a load at
//     sigma(w), the inverse shift a store to sigma(w) (a permutation of one
//     edge's Z positions, so no two threads meet).  A 1-D lift (m = 1) skips
//     the v test.  The first 8 edges of a row keep their positions and the
//     values read there in registers from the read to the write; a heavier
//     row works its later edges out again.
//   * The row loops are unrolled at compile time for each row weight up to
//     8 (by_weight), so all of a row's shared-memory reads issue before the
//     first of them is used; the syndrome check of a code whose rows share
//     one weight keeps four rows' reads in flight.
//   * A lane needs no other lane.  The TPU tile sweeps until all its lanes
//     are done, with err / llr / iters frozen per lane; here a lane stops
//     sweeping when it is done, which gives the same four outputs.  One
//     block decodes one lane: on the H100 packing several lanes of a small
//     lift into a block was slower at every size tried, down to Z = 36.
//   * err and llr are written once, when the block ends, from the state the
//     lane's last sweep left (layered: the stored totals; flooding: the
//     prior plus the stored check messages, added in the same order again).
//
// Layered: the reference reads all of a base row before it updates, and
// updates a block column's totals once per edge, in edge order.
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
//
// What bounds it on the H100: issue slots and the latency of shared-memory
// loads, not device memory (a few bytes per variable per decode).  A layered
// sweep of a one-phase row makes 5 shared-memory accesses per edge position
// (the total and the message read and written, the total read again by the
// syndrome check) and one barrier per base row; the lane's flag is the
// barrier that ends the sweep (__syncthreads_or).  The syndrome check stops
// at the first violated check any thread meets (a flag per sweep in shared
// memory), so only a lane's last sweep checks every row.
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

// clamps of the tanh rule (ops/clamps.py) and the two-min sentinel
constexpr float kTanhClamp = 0.99999f;
constexpr float kMsgClamp = 100.0f;
constexpr float kBig = 1e30f;
// edges of a row whose positions and values stay in registers
// (ops/qc_minsum.py HELD_EDGES)
constexpr int kHeld = 8;

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

struct QCParams {
  int B, l, m, mb, nb, Eb, max_rw, buf_rw, max_iters;
  float alpha, beta, L0;
  long long prior_stride;  // 0: one [n] prior vector for all lanes, else n
};

// Shared memory of one block; ops/qc_minsum.py qc_smem_bytes is the same sum.
// buf_rw: the largest weight of a row with a repeated block column (0: none).
size_t smem_need(const QCParams& P, int threads, int itemsize, bool layered, bool sumprod) {
  const size_t Z = (size_t)P.l * P.m;
  const size_t ints = 5 * (size_t)P.Eb + 2 * P.mb + P.nb + 4;
  const int tail = P.max_rw > kHeld ? P.max_rw - kHeld : 0;
  const size_t floats = (layered ? P.buf_rw * Z : 0) + (sumprod ? (size_t)tail * threads : 0);
  const size_t stored = (P.Eb + (layered ? P.nb : P.Eb)) * Z;
  const size_t flags = (P.mb + (layered ? 0 : P.nb)) * Z;
  return 4 * ints + 4 * floats + itemsize * stored + flags;
}

// One block decodes one lane; thread t takes the positions w = t,
// t + blockDim.x, ... of every [Z] array.
template <typename T, bool LAYERED, bool SUMPROD>
__global__ void qc_minsum_kernel(const uint8_t* __restrict__ syn, const float* __restrict__ priors,
                                 const int32_t* __restrict__ table, int8_t* __restrict__ err,
                                 float* __restrict__ llr, uint8_t* __restrict__ conv,
                                 int32_t* __restrict__ iters_out, const QCParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = P.m, Z = P.l * m, Eb = P.Eb, mb = P.mb, nb = P.nb;
  const int tpl = blockDim.x, t = threadIdx.x;
  const long long lane = blockIdx.x;

  // ---- carve the shared memory (the order of smem_need) -------------------
  // per edge: x = j*Z (its block column's totals / decisions), y = e*Z (its
  // messages), z = a*m + b and w = m - b (its shift)
  int4* etab = reinterpret_cast<int4*>(smem);
  int32_t* row_ptr = reinterpret_cast<int32_t*>(etab + Eb);
  const int32_t* col_ptr = row_ptr + mb + 1;
  const int32_t* col_idx = col_ptr + nb + 1;
  int32_t* two_phase = row_ptr + mb + nb + 2 + Eb;  // per base row
  // found[it & 1]: sweep it's syndrome check has met a violated check
  volatile int32_t* found = two_phase + mb;
  float* fbase = reinterpret_cast<float*>(two_phase + mb + 2);
  float* rowbuf = fbase;  // layered, two-phase rows: one row's new messages
  fbase += LAYERED ? (size_t)P.buf_rw * Z : 0;
  float* bw = fbase + t;  // suffix products of edges kHeld.., slot k at bw[k * tpl]
  fbase += SUMPROD && P.max_rw > kHeld ? (size_t)(P.max_rw - kHeld) * tpl : 0;
  const int n2 = LAYERED ? nb : Eb;
  T* sbase = reinterpret_cast<T*>(fbase);
  // layered: s1 = check-to-variable messages mu, s2 = totals;
  // flooding: s1 = variable-to-check messages nu, s2 = mu
  T* s1 = sbase;
  T* s2 = sbase + (size_t)Eb * Z;
  uint8_t* syn_s = reinterpret_cast<uint8_t*>(sbase + (size_t)(Eb + n2) * Z);
  uint8_t* dec = syn_s + (size_t)mb * Z;  // flooding only

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
  if (LAYERED) {
    for (int i = t; i < Eb * Z; i += tpl) st(s1, i, 0.f);
    for (int i = t; i < nb * Z; i += tpl) st(s2, i, p32(i));
  } else {
    for (int e = 0; e < Eb; ++e) {
      const int jz = g_j[e] * Z;
      for (int x = t; x < Z; x += tpl) st(s1, e * Z + x, p32(jz + x));
    }
    for (int i = t; i < nb * Z; i += tpl) dec[i] = 0;
  }
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
  auto decision = [&](int idx) -> unsigned {
    return LAYERED ? (unsigned)(ld(s2, idx) < 0.f) : (unsigned)dec[idx];
  };
  auto tanh_of = [&](float x) -> float {
    return fminf(fmaxf(tanhf(__fmul_rn(x, 0.5f)), -kTanhClamp), kTanhClamp);
  };

  // check update of base row i at this thread's positions.  Edge e's message
  // for check position w belongs to variable position p = sigma(w): read
  // there (layered: total minus old message; flooding: nu), written there
  // (layered one-phase: total and message; two-phase: the row buffer;
  // flooding: mu).  H, the row's held edges, is a compile-time constant, so
  // the reads of all of them issue before the first is used.
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
            tv = ld(LAYERED ? s2 : s1, LAYERED ? ta : ma);
            ov = LAYERED ? ld(s1, ma) : 0.f;
          };
          auto nc = [&](float tv, float ov) -> float { return LAYERED ? __fsub_rn(tv, ov) : tv; };
          auto write = [&](int ta, int ma, float tv, float ov, float out) {
            if (!LAYERED) {
              st(s2, ma, out);
            } else if (one_phase) {
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
    if (LAYERED) {
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
    } else {
      for (int i = 0; i < mb; ++i) check_row(i, false);
      __syncthreads();
      // total = prior + the column's check messages in sorted-term order;
      // nu_e = round(total - mu_e); the decision for the syndrome check
      for (int j = 0; j < nb; ++j) {
        const int c0 = col_ptr[j], c1 = col_ptr[j + 1];
        for (int x = t; x < Z; x += tpl) {
          float total = p32(j * Z + x);
          for (int c = c0; c < c1; ++c) total = __fadd_rn(total, ld(s2, col_idx[c] * Z + x));
          for (int c = c0; c < c1; ++c) {
            const int ex = col_idx[c] * Z + x;
            st(s1, ex, __fsub_rn(total, ld(s2, ex)));
          }
          dec[j * Z + x] = total < 0.f;
        }
      }
      __syncthreads();
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

  // ---- outputs: the state of the lane's last sweep ---------------------------
  if (t == 0) {
    conv[lane] = done;
    iters_out[lane] = it;
  }
  int8_t* err_l = err + lane * (long long)nb * Z;
  float* llr_l = llr + lane * (long long)nb * Z;
  for (int j = 0; j < nb; ++j) {
    for (int x = t; x < Z; x += tpl) {
      const int idx = j * Z + x;
      float total;
      if (it == 0) {
        total = p32(idx);  // no sweep ran: the prior, decision 0
      } else if (LAYERED) {
        total = ld(s2, idx);
      } else {
        total = p32(idx);
        for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c)
          total = __fadd_rn(total, ld(s2, col_idx[c] * Z + x));
      }
      err_l[idx] = it == 0 ? 0 : (int8_t)decision(idx);
      llr_l[idx] = total;
    }
  }
}

template <typename T, bool LAYERED, bool SUMPROD>
cudaError_t launch(const void* syn, const void* priors, const void* table, void* err, void* llr,
                   void* conv, void* iters, const QCParams& P, int threads, int smem_bytes,
                   cudaStream_t st) {
  auto kernel = qc_minsum_kernel<T, LAYERED, SUMPROD>;
  // the held edges take registers: where 65,536 of them do not reach
  // ``threads`` threads (a lift past 512 positions), the block takes the
  // threads it can have and strides its positions over them
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  if (threads > attr.maxThreadsPerBlock) threads = attr.maxThreadsPerBlock;
  if ((size_t)smem_bytes < smem_need(P, threads, (int)sizeof(T), LAYERED, SUMPROD))
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
#define QC_LAUNCH(L, S) \
  launch<T, L, S>(syn, priors, table, err, llr, conv, iters, P, threads, smem_bytes, st)
  if (layered) return sumprod ? QC_LAUNCH(true, true) : QC_LAUNCH(true, false);
  return sumprod ? QC_LAUNCH(false, true) : QC_LAUNCH(false, false);
#undef QC_LAUNCH
}

}  // namespace

extern "C" {

// syn [B, mb*Z] bytes (0/1), priors null or float32 with lane stride
// prior_stride, table int32 (ops/qc_minsum.py QCTerms.table), err [B, nb*Z]
// int8, llr [B, nb*Z] float32, conv [B] bytes, iters [B] int32.  max_rw is
// the largest row weight, buf_rw the largest weight of a row with a repeated
// block column (QCTerms.buffered_row_weight, 0 for none).
int ldpc_qc_minsum(const void* syn, const void* priors, const void* table, void* err, void* llr,
                   void* conv, void* iters, int B, int l, int m, int mb, int nb, int Eb,
                   int max_rw, int buf_rw, int max_iters, int threads, int layered,
                   int sumproduct, int is_bf16, float alpha, float beta, float L0,
                   long long prior_stride, int smem_bytes, void* stream) {
  if (B < 1 || threads < 1 || threads > 1024) return cudaErrorInvalidValue;
  const QCParams P = {B,       l,          m,     mb,   nb,   Eb, max_rw, buf_rw,
                      max_iters, alpha,    beta,  L0,   prior_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_modes<bf16>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                              threads, smem_bytes, st);
  return launch_modes<float>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                             threads, smem_bytes, st);
}

}  // extern "C"
