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
//   * The terms (i, j, a, b) are data, not code: an int32 table (per edge the
//     block column and the two shifts, row pointers, column pointers and
//     column edge lists) copied to shared memory.  Row weights are runtime
//     values; the two-min state of a check lives in registers over a loop.
//   * A shift is index arithmetic.  With (u, v) = divmod(w, m),
//     sigma(w) = ((u+a)%l)*m + (v+b)%m: a check-oriented read is a load at
//     sigma(w), the inverse shift a store to sigma(w) (a permutation of one
//     edge's Z positions, so no two threads meet).
//   * A lane needs no other lane.  The TPU tile sweeps until all its lanes
//     are done, with err / llr / iters frozen per lane; here a lane stops
//     sweeping when it is done, which gives the same four outputs.  One
//     block decodes one lane: on the H100 packing several lanes of a small
//     lift into a block was slower at every size tried, down to Z = 36.
//   * err and llr are written once, when the block ends, from the state the
//     lane's last sweep left (layered: the stored totals; flooding: the
//     prior plus the stored check messages, added in the same order again).
//
// Layered, several terms of one base row in one block column (every bicycle
// block): the reference updates the column's totals once per edge, in edge
// order, rounding each time.  One thread per check position would send
// different threads to the same total.  So a row takes two phases with a
// barrier between: check-oriented (reads totals and old messages, two-min or
// tanh rule, new messages stored through sigma into a float32 row buffer),
// then variable-oriented (thread x applies the row's edges at position x in
// edge order).  All of a row's reads precede its updates, as in the
// reference.
//
// What bounds it on the H100: operations and shared-memory traffic, not
// device memory (a few bytes per variable per decode).  Each sweep makes
// about 10 shared-memory accesses per edge position with a barrier pair per
// base row (layered).
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

struct QCParams {
  int B, l, m, mb, nb, Eb, max_rw, max_iters;
  float alpha, beta, L0;
  long long prior_stride;  // 0: one [n] prior vector for all lanes, else n
};

// int32 words of the term table
__host__ __device__ inline int table_words(int Eb, int mb, int nb) { return 4 * Eb + mb + nb + 2; }

// Shared memory of one block; ops/qc_minsum.py qc_smem_bytes is the same sum.
size_t smem_need(const QCParams& P, int threads, int itemsize, bool layered, bool sumprod) {
  const size_t Z = (size_t)P.l * P.m;
  const size_t ints = table_words(P.Eb, P.mb, P.nb) + 1;
  const size_t floats = (layered ? P.max_rw * Z : 0) + (sumprod ? (size_t)P.max_rw * threads : 0);
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
  const int l = P.l, m = P.m, Z = l * m, Eb = P.Eb, mb = P.mb, nb = P.nb;
  const int tpl = blockDim.x, t = threadIdx.x;
  const long long lane = blockIdx.x;

  // ---- carve the shared memory (the order of smem_need) -------------------
  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  const int n_tab = table_words(Eb, mb, nb);
  const int32_t* e_j = tab;
  const int32_t* e_a = tab + Eb;
  const int32_t* e_b = tab + 2 * Eb;
  const int32_t* row_ptr = tab + 3 * Eb;
  const int32_t* col_ptr = row_ptr + mb + 1;
  const int32_t* col_idx = col_ptr + nb + 1;
  int32_t* okflag = tab + n_tab;
  float* fbase = reinterpret_cast<float*>(okflag + 1);
  float* rowbuf = fbase;  // layered: one row's new messages
  fbase += LAYERED ? (size_t)P.max_rw * Z : 0;
  float* bw = fbase + t;  // suffix products, slot k at bw[k * tpl]
  fbase += SUMPROD ? (size_t)P.max_rw * tpl : 0;
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

  for (int i = t; i < n_tab; i += tpl) tab[i] = table[i];
  __syncthreads();

  // ---- iteration-0 state ---------------------------------------------------
  const uint8_t* syn_l = syn + lane * (long long)mb * Z;
  for (int i = t; i < mb * Z; i += tpl) syn_s[i] = syn_l[i] != 0;
  if (LAYERED) {
    for (int i = t; i < Eb * Z; i += tpl) st(s1, i, 0.f);
    for (int i = t; i < nb * Z; i += tpl) st(s2, i, p32(i));
  } else {
    for (int i = t; i < Eb * Z; i += tpl) {
      const int e = i / Z;
      st(s1, i, p32(e_j[e] * Z + (i - e * Z)));
    }
    for (int i = t; i < nb * Z; i += tpl) dec[i] = 0;
  }

  // hard decision of variable (j, x) as the last sweep left it
  auto decision = [&](int idx) -> unsigned {
    return LAYERED ? (unsigned)(ld(s2, idx) < 0.f) : (unsigned)dec[idx];
  };

  // check update of base row i at this thread's positions.  The new
  // check-to-variable message of edge e, check position w, goes to variable
  // position sigma(w): into the row buffer (layered) or into mu (flooding).
  auto check_row = [&](int i) {
    const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
    for (int w = t; w < Z; w += tpl) {
      const int u = w / m, v = w - u * m;
      const unsigned s = syn_s[i * Z + w];
      auto sigma = [&](int e) -> int {
        int uu = u + e_a[e], vv = v + e_b[e];
        if (uu >= l) uu -= l;
        if (vv >= m) vv -= m;
        return uu * m + vv;
      };
      // variable-to-check message of edge e read at variable position sg
      auto nc = [&](int e, int sg) -> float {
        if (LAYERED) return __fsub_rn(ld(s2, e_j[e] * Z + sg), ld(s1, e * Z + sg));
        return ld(s1, e * Z + sg);
      };
      auto put = [&](int e, int sg, float out) {
        if (LAYERED) rowbuf[(e - e0) * Z + sg] = out;
        else st(s2, e * Z + sg, out);
      };
      if (SUMPROD) {
        // exclusive products of tanh(nu/2): suffix products first (kept in
        // shared memory, one slot per thread and row slot), then a forward
        // pass, each in the row's edge order; 2 atanh(x) = log1p(x) - log1p(-x)
        auto tanh_of = [&](int e, int sg) -> float {
          return fminf(fmaxf(tanhf(__fmul_rn(nc(e, sg), 0.5f)), -kTanhClamp), kTanhClamp);
        };
        float acc = 1.f;
        for (int e = e1 - 1; e >= e0; --e) {
          bw[(e - e0) * tpl] = acc;
          if (e > e0) acc = __fmul_rn(acc, tanh_of(e, sigma(e)));
        }
        float fwd = 1.f;
        for (int e = e0; e < e1; ++e) {
          const int sg = sigma(e);
          float excl = __fmul_rn(fwd, bw[(e - e0) * tpl]);
          excl = fminf(fmaxf(excl, -kTanhClamp), kTanhClamp);
          float r = __fsub_rn(log1pf(excl), log1pf(-excl));
          r = fminf(fmaxf(r, -kMsgClamp), kMsgClamp);
          if (e + 1 < e1) fwd = __fmul_rn(fwd, tanh_of(e, sg));
          put(e, sg, s ? -r : r);
        }
      } else {
        // two-min exclusive reduction; the first 64 sign bits stay in a
        // register, later slots read their sign again
        const float v0 = nc(e0, sigma(e0));
        float min1 = fabsf(v0), min2 = kBig;
        int idx1 = 0;
        unsigned parity = v0 < 0.f;
        unsigned long long negbits = parity;
        for (int e = e0 + 1; e < e1; ++e) {
          const int k = e - e0;
          const float val = nc(e, sigma(e));
          const float mag = fabsf(val);
          const unsigned neg = val < 0.f;
          const bool smaller = mag < min1;
          min2 = smaller ? min1 : fminf(min2, mag);
          idx1 = smaller ? k : idx1;
          min1 = smaller ? mag : min1;
          parity ^= neg;
          if (k < 64) negbits |= (unsigned long long)neg << k;
        }
        for (int e = e0; e < e1; ++e) {
          const int k = e - e0, sg = sigma(e);
          const unsigned neg =
              k < 64 ? (unsigned)((negbits >> k) & 1ull) : (unsigned)(nc(e, sg) < 0.f);
          const float excl = idx1 == k ? min2 : min1;
          const float r = fmaxf(__fsub_rn(__fmul_rn(P.alpha, excl), P.beta), 0.f);
          put(e, sg, (parity ^ neg ^ s) ? -r : r);
        }
      }
    }
  };

  // every thread of the block reads the same flag, so ``done`` is uniform
  bool done = false;
  int it = 0;
  while (it < P.max_iters && !done) {
    // the barrier between the flag's last read and its reset, and between
    // the initial state and the first sweep
    __syncthreads();
    if (t == 0) *okflag = 1;

    if (LAYERED) {
      for (int i = 0; i < mb; ++i) {
        check_row(i);
        __syncthreads();
        // thread x applies the row's edges at variable position x, in
        // edge order: tot <- round(tot + (new - old)), mu <- round(new)
        const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
        for (int x = t; x < Z; x += tpl) {
          for (int e = e0; e < e1; ++e) {
            const int jx = e_j[e] * Z + x;
            const float mu_new = rowbuf[(e - e0) * Z + x];
            st(s2, jx, __fadd_rn(ld(s2, jx), __fsub_rn(mu_new, ld(s1, e * Z + x))));
            st(s1, e * Z + x, mu_new);
          }
        }
        __syncthreads();
      }
    } else {
      for (int i = 0; i < mb; ++i) check_row(i);
      __syncthreads();
      // total = prior + the column's check messages in sorted-term order;
      // nu_e = round(total - mu_e); the decision for the syndrome check
      for (int idx = t; idx < nb * Z; idx += tpl) {
        const int j = idx / Z, x = idx - j * Z;
        float total = p32(idx);
        for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c)
          total = __fadd_rn(total, ld(s2, col_idx[c] * Z + x));
        for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c) {
          const int ex = col_idx[c] * Z + x;
          st(s1, ex, __fsub_rn(total, ld(s2, ex)));
        }
        dec[idx] = total < 0.f;
      }
      __syncthreads();
    }

    // syndrome check: XOR of the decisions at sigma(w) per base row; any
    // mismatch of any position clears the lane's flag
    bool bad = false;
    for (int w = t; w < Z; w += tpl) {
      const int u = w / m, v = w - u * m;
      for (int i = 0; i < mb; ++i) {
        unsigned par = 0;
        for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
          int uu = u + e_a[e], vv = v + e_b[e];
          if (uu >= l) uu -= l;
          if (vv >= m) vv -= m;
          par ^= decision(e_j[e] * Z + uu * m + vv);
        }
        bad |= par != syn_s[i * Z + w];
      }
    }
    if (bad) *okflag = 0;
    __syncthreads();
    ++it;
    done = *okflag != 0;
  }

  // ---- outputs: the state of the lane's last sweep ---------------------------
  if (t == 0) {
    conv[lane] = done;
    iters_out[lane] = it;
  }
  int8_t* err_l = err + lane * (long long)nb * Z;
  float* llr_l = llr + lane * (long long)nb * Z;
  for (int idx = t; idx < nb * Z; idx += tpl) {
    float total;
    if (it == 0) {
      total = p32(idx);  // no sweep ran: the prior, decision 0
    } else if (LAYERED) {
      total = ld(s2, idx);
    } else {
      const int j = idx / Z, x = idx - j * Z;
      total = p32(idx);
      for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c)
        total = __fadd_rn(total, ld(s2, col_idx[c] * Z + x));
    }
    err_l[idx] = it == 0 ? 0 : (int8_t)decision(idx);
    llr_l[idx] = total;
  }
}

template <typename T, bool LAYERED, bool SUMPROD>
cudaError_t launch(const void* syn, const void* priors, const void* table, void* err, void* llr,
                   void* conv, void* iters, const QCParams& P, int threads, int smem_bytes,
                   cudaStream_t st) {
  if ((size_t)smem_bytes < smem_need(P, threads, (int)sizeof(T), LAYERED, SUMPROD))
    return cudaErrorInvalidValue;
  auto kernel = qc_minsum_kernel<T, LAYERED, SUMPROD>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
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
// int8, llr [B, nb*Z] float32, conv [B] bytes, iters [B] int32.
int ldpc_qc_minsum(const void* syn, const void* priors, const void* table, void* err, void* llr,
                   void* conv, void* iters, int B, int l, int m, int mb, int nb, int Eb,
                   int max_rw, int max_iters, int threads, int layered, int sumproduct,
                   int is_bf16, float alpha, float beta, float L0, long long prior_stride,
                   int smem_bytes, void* stream) {
  if (B < 1 || threads < 1 || threads > 1024) return cudaErrorInvalidValue;
  const QCParams P = {B, l, m, mb, nb, Eb, max_rw, max_iters, alpha, beta, L0, prior_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_modes<bf16>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                              threads, smem_bytes, st);
  return launch_modes<float>(layered, sumproduct, syn, priors, table, err, llr, conv, iters, P,
                             threads, smem_bytes, st);
}

}  // extern "C"
