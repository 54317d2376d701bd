// Min-sum message-update kernels, for sm_90a.
//
// Replaces the two Pallas TPU kernels of ldpcdecoders_tpu/ops/pallas_minsum.py:
//   minsum_check_kernel <- pallas_minsum.py:_check_kernel (wrapper check_update_pallas)
//   minsum_var_kernel   <- pallas_minsum.py:_var_kernel   (wrapper var_update_pallas)
// with the cross-layout gathers, which ran as separate device-memory passes
// between the TPU kernels, folded in: each kernel reads the other side's
// messages through the static index table itself.
//
// Numerics follow the reference package's default path (models/minsum.py
// check_core / var_update) and equal the plain torch versions in
// ops/minsum.py bit for bit.  All arithmetic is float32; for bfloat16
// messages every result the plain version rounds is rounded here too
// (round_to<T>), and products, sums and differences use the _rn
// intrinsics so that nvcc contracts none of them into a fused multiply-add.
//
// Layout.  Messages are slot-major [B, slot, node].  One thread per
// (lane, node); neighbouring threads hold neighbouring nodes of one lane, so
// the direct loads, the table loads and all stores are coalesced across a
// warp.  Only the gathered message loads are scattered, inside one lane's
// row (36 KB at the (1000, 10, 9) code), which the L1/L2 caches hold.
//
// Check update: one sweep over the degree axis keeps (min1, argmin, min2,
// sign parity) and the first 64 sign bits in registers; a second loop
// writes the dc outputs (slots past 64 read their sign again).  Variable
// update: one loop sums the dv masked (optionally weighted) messages in
// the reference's order (slot order up to 32 slots, by windows of 32 past
// that: ops/minsum.py slot_sum), a second loop reads them again (from
// cache) for the leave-one-out differences.
//
// What bounds them on the H100: bytes.  Each kernel reads and writes the
// [B, E] message array once (36.9 MB each way at B=1024, float32) and does
// a few operations per message.
//
// Plain C interface (pointers, sizes, stream), loaded with ctypes.  Each
// launcher returns the cudaError_t of its launch; 0 is success.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ inline float load_f(const float* p, long long i) { return p[i]; }
__device__ inline float load_f(const bf16* p, long long i) { return __bfloat162float(p[i]); }
__device__ inline void store_f(float* p, long long i, float x) { p[i] = x; }
__device__ inline void store_f(bf16* p, long long i, float x) { p[i] = __float2bfloat16_rn(x); }

// Round a float32 result to the message type (and back to float32).
template <typename T>
__device__ inline float round_to(float x);
template <>
__device__ inline float round_to<float>(float x) { return x; }
template <>
__device__ inline float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x: [B, x_stride] messages; with idx (a [dc, m] table into a lane's row)
// slot (k, i) reads x[lane, idx[k, i]], without it x[lane, k, i].
template <typename T>
__global__ void minsum_check_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                                    const uint8_t* __restrict__ syn,
                                    const uint8_t* __restrict__ mask, T* __restrict__ mu,
                                    long long threads, int m, int dc, long long x_stride,
                                    float alpha, float beta, float big) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const long long lane = t / m;
  const int i = (int)(t - lane * m);
  const T* xl = x + lane * x_stride;

  // a padded slot reads as +big: never the sign, the minimum only if alone
  auto slot = [&](int k) -> float {
    const int e = k * m + i;
    if (!mask[e]) return big;
    return load_f(xl, idx ? idx[e] : e);
  };

  const float v0 = slot(0);
  float min1 = fabsf(v0), min2 = big;
  int idx1 = 0;
  unsigned parity = v0 < 0.f;
  unsigned long long negbits = parity;
  for (int k = 1; k < dc; ++k) {
    const float v = slot(k);
    const float mag = fabsf(v);
    const unsigned neg = v < 0.f;
    const bool smaller = mag < min1;
    min2 = smaller ? min1 : fminf(min2, mag);
    idx1 = smaller ? k : idx1;
    min1 = smaller ? mag : min1;
    parity ^= neg;
    if (k < 64) negbits |= (unsigned long long)neg << k;
  }

  const unsigned s = syn[lane * m + i] != 0;
  T* out = mu + lane * (long long)dc * m;
  for (int k = 0; k < dc; ++k) {
    const unsigned neg = k < 64 ? (unsigned)((negbits >> k) & 1ull) : (unsigned)(slot(k) < 0.f);
    const float excl = idx1 == k ? min2 : min1;
    float r = round_to<T>(__fmul_rn(alpha, excl));
    r = round_to<T>(__fsub_rn(r, beta));
    r = r > 0.f ? r : 0.f;
    store_f(out, (long long)k * m + i, (parity ^ neg ^ s) ? -r : r);
  }
}

// mu: [B, mu_stride] check-side messages read through v2c [dv, n];
// L0 [B, n]; W [dv, n] or null; nu [B, dv, n] or null; total [B, n].
template <typename T>
__global__ void minsum_var_kernel(const T* __restrict__ mu, const int32_t* __restrict__ v2c,
                                  const uint8_t* __restrict__ mask, const T* __restrict__ L0,
                                  const T* __restrict__ W, T* __restrict__ nu,
                                  T* __restrict__ total, long long threads, int n, int dv,
                                  long long mu_stride) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const long long lane = t / n;
  const int j = (int)(t - lane * n);
  const T* ml = mu + lane * mu_stride;

  // the masked, weighted message as a float32 product (exact for bfloat16
  // factors): the sum takes it as it is, the difference rounds it first
  auto slot = [&](int k) -> float {
    const int e = k * n + j;
    float v = mask[e] ? load_f(ml, v2c[e]) : 0.f;
    if (W) v = __fmul_rn(v, load_f(W, e));
    return v;
  };

  // windows of 32 slots, the padding to a multiple of 32 split before and
  // after; each window summed from 0 into `part`, which is added to `acc` at
  // the window's last slot (at most 32 windows: the launcher refuses
  // dv > 1024).  dv <= 32 is one window, the plain sum.  One loop with the
  // window edge as a counter: a loop per window ran K4 6-11% slower
  // (tools/minsum_kernel_compare.py)
  float acc = 0.f, part = 0.f;
  const int low = (((dv + 31) / 32) * 32 - dv) / 2;
  for (int k = 0, edge = 32 - low; k < dv; ++k) {
    part = __fadd_rn(part, slot(k));
    if (k + 1 == edge) {
      acc = __fadd_rn(acc, part);
      part = 0.f;
      edge += 32;
    }
  }
  acc = __fadd_rn(acc, part);
  const float tot = round_to<T>(__fadd_rn(load_f(L0, t), round_to<T>(acc)));
  store_f(total, t, tot);
  if (nu) {
    T* out = nu + lane * (long long)dv * n;
    for (int k = 0; k < dv; ++k)
      store_f(out, (long long)k * n + j, round_to<T>(__fsub_rn(tot, round_to<T>(slot(k)))));
  }
}

const int kThreads = 256;

unsigned grid_for(long long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int ldpc_minsum_check(const void* x, const void* idx, const void* syn, const void* mask,
                      void* mu, int B, int m, int dc, long long x_stride, float alpha,
                      float beta, float big, int is_bf16, void* stream) {
  const long long threads = (long long)B * m;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    minsum_check_kernel<bf16><<<grid_for(threads), kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(syn), static_cast<const uint8_t*>(mask),
        static_cast<bf16*>(mu), threads, m, dc, x_stride, alpha, beta, big);
  } else {
    minsum_check_kernel<float><<<grid_for(threads), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(syn), static_cast<const uint8_t*>(mask),
        static_cast<float*>(mu), threads, m, dc, x_stride, alpha, beta, big);
  }
  return cudaGetLastError();
}

int ldpc_minsum_var(const void* mu, const void* v2c, const void* mask, const void* L0,
                    const void* W, void* nu, void* total, int B, int n, int dv,
                    long long mu_stride, int is_bf16, void* stream) {
  if (dv > 1024) return cudaErrorInvalidValue;
  const long long threads = (long long)B * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    minsum_var_kernel<bf16><<<grid_for(threads), kThreads, 0, st>>>(
        static_cast<const bf16*>(mu), static_cast<const int32_t*>(v2c),
        static_cast<const uint8_t*>(mask), static_cast<const bf16*>(L0),
        static_cast<const bf16*>(W), static_cast<bf16*>(nu), static_cast<bf16*>(total), threads,
        n, dv, mu_stride);
  } else {
    minsum_var_kernel<float><<<grid_for(threads), kThreads, 0, st>>>(
        static_cast<const float*>(mu), static_cast<const int32_t*>(v2c),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(L0),
        static_cast<const float*>(W), static_cast<float*>(nu), static_cast<float*>(total),
        threads, n, dv, mu_stride);
  }
  return cudaGetLastError();
}

}  // extern "C"
