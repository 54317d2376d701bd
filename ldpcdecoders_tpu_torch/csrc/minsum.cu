// Min-sum message-update kernels, for sm_90a.
//
// Replaces the two Pallas TPU kernels of ldpcdecoders_tpu/ops/pallas_minsum.py:
//   minsum_check_kernel <- pallas_minsum.py:_check_kernel (wrapper check_update_pallas)
//   minsum_var_kernel   <- pallas_minsum.py:_var_kernel   (wrapper var_update_pallas)
//   (on lane tiles also minsum_check_packed_kernel, minsum_var_tiled_kernel and
//   minsum_var_inplace_tiled_kernel)
// and, beyond the TPU kernels, the plain passes of the min-sum iteration
// around them (ldpcdecoders_tpu/models/minsum.py decode / decode_check): the
// cross-layout gathers, the check-layout rebuild ``total[var] - mu``, the
// damping mix and the freeze of the [B, n] outputs.  One iteration is one
// launch of each kernel.
//
// Numerics follow the reference package's default path and equal the plain
// torch versions in ops/minsum.py bit for bit on the real edges.  All
// arithmetic is float32; for bfloat16 messages every result the plain
// version rounds is rounded here too (round_to<T>), and products, sums and
// differences use the _rn intrinsics so that nvcc contracts none of them
// into a fused multiply-add.  The damping mix is, as torch evaluates
// ``g * nu + (1 - g) * new``: round(round(g*nu) + round(round(1-g) * new)).
//
// Layout.  Messages are slot-major [B, slot, node]; a node's real slots come
// first (codes/graph.py), so each node's loops run to its own degree
// (``deg``) and a padded slot is neither loaded nor, in the forms that update
// in place, written.
//
// Lane tiles (lane_tile T = 64 or 128: the check layout's state and the
// variable layout's).  The tiled form of a [B, len] array of lanes is
// [B / T, len, T]: element e of lane b lies at tiled<T>(b, len) + e * T, so
// that T lanes of one node sit side by side.  The float32 check form keeps a
// thread a (lane, check), mapped lanes fastest, so a warp is 32 lanes of one
// check; the bfloat16 check form (minsum_check_packed_kernel) and the
// variable forms give a thread T / 32 neighbouring lanes of one node, so a
// warp is a whole tile row.  Each gather of a message, a
// total or a gamma is then whole lines (128 bytes a warp and load in float32
// on the check side, 512 on the variable side at T = 128) where a lane's own
// row costs a 32-byte sector for the 4 or 2 bytes used, and the node's
// degree, index and weight entries are one broadcast load with no
// divergence.  The per-lane arithmetic and its order are the same for every
// T, so the result is bitwise the same.  T = 1 is [B, len].  On tiles the
// check update takes its GATHER form (the variable layout's nu through c2v,
// the check layout's first iteration) and its ITER form; the variable update
// takes the check layout's form (the totals and the freeze) and the variable
// layout's in-place form (leave-one-out messages, weights, the damping mix
// and the freeze); the staged check form and the fresh-message variable form
// take T = 1 only.
//
// Check update (minsum_check_kernel), one thread per (lane, check), three
// forms of its input message:
//   * DIRECT   the check-slot messages x [B, dc, m] (the TPU kernel's input);
//   * GATHER   x [B, stride] read through idx (the variable layout's nu
//              through c2v; the check layout's first iteration, L0 through
//              the check slots' variables);
//   * ITER     the check layout's iteration: the message is rebuilt from
//              the previous iteration as total[var] - mu_prev and, with
//              damping, mixed with the previous message nu_prev (written
//              back in place); the new mu is written in place over mu_prev.
// One sweep over the check's slots keeps (min1, argmin, min2, sign parity)
// in registers and every sign bit in shared memory (a word per 32 slots,
// the thread's own column), so no slot is read twice; the loads of U slots
// are issued before the first is used.  The gathered row of a lane (the
// totals, or x) is either read from L2 or, where it fits, staged in shared
// memory by a block that takes one lane (STAGE): the gathers then cost no
// 32-byte sector of L2 traffic for 2 or 4 bytes used.
//
// Variable update (minsum_var_kernel), one thread per (lane, variable): the
// node's messages are gathered through v2c into registers (all loads in
// flight at once up to 16 slots), summed in the reference's order (slot
// order up to 32 slots, by windows of 32 past that: ops/minsum.py slot_sum;
// a padded slot adds +0 and is skipped), then ``total`` is written, or the
// leave-one-out messages total - msg (a fresh [B, dv, n], or in place over
// nu_prev with the damping mix), and, given the done flags, the frozen
// outputs err = total < 0 and llrs = total of the lanes still active.
//
// What bounds them on the H100: bytes.  At the bb144 R=6 DEM's shape
// (203,444 edges) an iteration must move each edge's messages once each way
// (mu, and with damping nu) and the totals; lane-major, the check kernel's
// gathers of the totals and the variable kernel's gathers of mu cost L2
// sector traffic on top (8x the bytes used in float32), which staging
// removes for the first and registers-in-flight hide for the second.  On
// lane tiles every gathered line is used whole, and what holds the variable
// forms is the gathers in flight: their vectors of T / 32 lanes make fewer,
// larger requests, and the asynchronous copies into shared memory keep
// them in flight without registers (var_tiled_node).
//
// The variable layout's in-place form on tiles must read each edge's mu
// (gathered) and, damped, its previous nu, and write its nu: 3 x 4 bytes an
// edge in float32, with L0 and the frozen outputs about 2.8 MB a
// lane-iteration at the bb144 DEM, where lane-major a warp's 32 lanes of a
// gathered mu and of a nu slot are 32 sectors each (about 9.7 MB of sector
// traffic).  Its design keeps every one of those reads whole and in flight:
// the previous nu vectors are copied into shared memory beside the gathered
// mu vectors, as a second group of asynchronous copies that lands while the
// totals are summed, so a thread holds neither in registers; a damped block
// takes half the threads to keep the shared memory at 48 KB; the leave-one-
// out messages are written back as whole vectors at the real slots only.
// Measured at that shape in float32 (damping 0.4, the freeze, 2048 lanes on
// 128-lane tiles; chip_smoke.py, H100 80GB HBM3, 700 W): 1.05 us a
// lane-iteration, 1.31x its 0.80 us bound of bytes, against 2.22 us
// lane-major; the gathered check form on the same tiles 0.87 us against 2.45
// us, 1.8x its 0.49 us bound (nu read and mu written at the real slots: it
// writes every padded slot of mu too).
//
// The check layout's iteration on tiles in bfloat16 (the staged decoder's
// deep ensemble and relay legs) must read each edge's mu_prev and nu_prev
// and write its nu and mu, 4 x 2 bytes an edge, with the totals and a
// [B, n] gamma read once: 1.755 MB a lane-iteration at the bb144 DEM, 0.80
// ms for (q)'s 6 x 256 lanes at 3.35 TB/s.  A thread a lane, as the float32
// form keeps it, took 2.47 ms there (3.1x): each 2-byte load and store a
// slot is an instruction with its own 64-bit address, and the registers
// that the floor of 5 blocks an SM left held few loads in flight.  The
// packed body (minsum_check_packed_kernel) gives a thread T / 32 lanes of
// one check: one index load and one vector a slot and array for the
// thread's lanes, the vectors of the next 8 slots copied into shared memory
// while 8 are computed, two lanes rounded a conversion.  Measured (H100
// 80GB HBM3, 700 W, tools/minsum_kernel_compare.py, in turns with the
// floor kernel): (q) 1.08 ms, 1.34x its bound, against 2.47 ms; the relay
// legs' 6 x 128 lanes 0.56 against 1.29 ms, 6 x 32 lanes on 64-lane tiles
// 0.18 against 0.34 ms; the gathered first iteration at (q) 0.49 against
// 0.82 ms.  With the vectors in registers instead it took 2.4x the time,
// with one buffer 1.14x.
//
// Plain C interface (pointers, sizes, stream), loaded with ctypes.  Each
// launcher returns the cudaError_t of its launch; 0 is success.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Slots of a check whose loads go out together (the flat form by message
// type, the staged form), and the variable degree up to which K4 keeps a
// node's messages in registers.  Measured on an H100 80GB HBM3 at 700 W
// (tools/minsum_kernel_compare.py, each against the others in one run):
// the flat form at 8 took 0.78-0.81x its time at 4 at the bb144 DEM's shape
// in float32 but 1.26x in bfloat16 (1.24x at the Gallager code's); the
// staged form at 8 1.26-1.70x its time at 4 (its 1024-thread blocks cap a
// thread at 64 registers); K4 with 12 in registers 0.76-0.82x its time with
// 16 (56-61 registers a thread against 78-80).
#ifndef LDPC_MINSUM_FLAT_UNROLL_F32
#define LDPC_MINSUM_FLAT_UNROLL_F32 8
#endif
#ifndef LDPC_MINSUM_FLAT_UNROLL_BF16
#define LDPC_MINSUM_FLAT_UNROLL_BF16 4
#endif
#ifndef LDPC_MINSUM_STAGED_UNROLL
#define LDPC_MINSUM_STAGED_UNROLL 4
#endif
#ifndef LDPC_MINSUM_VAR_CAP
#define LDPC_MINSUM_VAR_CAP 12
#endif
// The bfloat16 check form on lane tiles (minsum_check_packed_kernel): the
// slots of a chunk whose vectors go out together, and the threads of a
// block.  Measured at the flagship's shapes (tools/minsum_kernel_compare.py,
// H100 80GB HBM3, 700 W; (q), 6 x 256 lanes on 128-lane tiles): chunks of 8
// slots took 0.87x the time of chunks of 4 and 0.88x that of 6, chunks of
// 12 1.41x; blocks of 128 threads 0.87x the time of 64 and 0.97x that of
// 256.
#ifndef LDPC_MINSUM_PACKED_UNROLL
#define LDPC_MINSUM_PACKED_UNROLL 8
#endif
#ifndef LDPC_MINSUM_PACKED_THREADS
#define LDPC_MINSUM_PACKED_THREADS 128
#endif

namespace {

typedef __nv_bfloat16 bf16;

template <typename T>
constexpr int kFlatUnroll = sizeof(T) == 4 ? LDPC_MINSUM_FLAT_UNROLL_F32
                                           : LDPC_MINSUM_FLAT_UNROLL_BF16;
constexpr int kStagedUnroll = LDPC_MINSUM_STAGED_UNROLL;
constexpr int kVarCap = LDPC_MINSUM_VAR_CAP;
constexpr int kPackedUnroll = LDPC_MINSUM_PACKED_UNROLL;
constexpr int kPackedThreads = LDPC_MINSUM_PACKED_THREADS;
constexpr int kThreads = 256;
constexpr int kMaxStageThreads = 1024;
constexpr long long kDefaultSmem = 48 * 1024;
constexpr long long kMaxSmem = 232448;  // what one block may take on the H100
constexpr long long kSmemPerSm = 233472;  // an SM's, each block reserving 1 KB of it
constexpr long long kStageMinRow = 48 * 1024;  // rows below this stay flat

enum Form { DIRECT = 0, GATHER = 1, ITER = 2 };
// the lane tiles a launcher takes besides 1
constexpr int kTiles[] = {64, 128};
enum Gamma { GAMMA_NONE = 0, GAMMA_LANE = 1, GAMMA_VAR = 2 };
enum NuOut { NU_NONE = 0, NU_FRESH = 1, NU_INPLACE = 2 };

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

// g * old + (1 - g) * new, each operation rounded to T; g1 = round(1 - g)
template <typename T>
__device__ inline float damp(float g, float g1, float old, float fresh) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(g, old)), round_to<T>(__fmul_rn(g1, fresh))));
}

// |alpha * excl - beta| clamped at 0, rounded as the plain version rounds
template <typename T>
__device__ inline float out_mag(float excl, float alpha, float beta) {
  float r = round_to<T>(__fmul_rn(alpha, excl));
  r = round_to<T>(__fsub_rn(r, beta));
  return r > 0.f ? r : 0.f;
}

// Offset of element 0 of lane ``lane``'s row of ``len`` in a lane-tiled
// array (see Layout); element e lies TILE * e further.
template <int TILE>
__device__ __forceinline__ long long tiled(long long lane, long long len) {
  return (lane / TILE) * len * TILE + lane % TILE;
}

// Thread t of a launch over the lanes and ``len`` nodes, lanes fastest
// within a tile: its lane and node.  t is also the (lane, node) entry's
// offset in a tiled [B, len] array.
template <int TILE>
__device__ __forceinline__ void lane_node(long long t, int len, long long* lane, int* node) {
  const long long tb = t / ((long long)len * TILE);
  const long long r = t - tb * len * TILE;
  *node = (int)(r / TILE);
  *lane = tb * TILE + r % TILE;
}

// Every [B, ...] array of the two argument structs is lane-tiled by the
// launch's TILE (1: as written).
template <typename T>
struct CheckArgs {
  const T* x;            // DIRECT [B, dc, m]; GATHER [B, x_stride]; ITER the totals [B, n]
  const int32_t* idx;    // [dc * m] index into a lane's row of x (GATHER, ITER)
  const uint8_t* syn;    // [B, m] syndrome bits
  const int32_t* deg;    // [m] real slots of each check (they come first)
  T* mu;                 // [B, dc, m] out; ITER: mu_prev in, mu out
  T* nu;                 // ITER with damping: nu_prev in, the mixed messages out
  const T* gamma;        // GAMMA_LANE: gamma[lane * gamma_stride]; GAMMA_VAR: [B, n]
  long long gamma_stride;
  long long B, x_stride;
  int m, dc;
  float alpha, beta, big;
};

// One check of one lane.  ``row`` is the lane's gathered row (x or the
// totals; element v at row[v * TILE]), in shared memory when staged;
// ``signs`` the thread's column of sign words (word w at signs[w * stride]).
template <typename T, int FORM, int GAMMA, int kUnroll, int TILE>
__device__ __forceinline__ void check_node(const CheckArgs<T>& a, long long lane, int i,
                                           const T* row, unsigned* signs, int stride) {
  const int m = a.m;
  const int d = a.deg[i];
  const long long base = tiled<TILE>(lane, (long long)a.dc * m);  // the lane's [dc, m] messages
  const T* x = a.x + base;
  T* mu = a.mu + base;
  T* nu = a.nu + base;
  float g = 0.f, g1 = 0.f;
  if (GAMMA == GAMMA_LANE) {
    g = load_f(a.gamma, lane * a.gamma_stride);
    g1 = round_to<T>(__fsub_rn(1.f, g));
  }
  // GAMMA_VAR: the lane's [n] strengths
  const T* gvar = a.gamma + tiled<TILE>(lane, a.gamma_stride);

  float min1 = a.big, min2 = a.big;
  int idx1 = 0;
  unsigned parity = 0, word = 0;
  for (int k0 = 0; k0 < d; k0 += kUnroll) {
    float v[kUnroll], prev[kUnroll], old[kUnroll], gk[kUnroll];
    int vi[kUnroll];
    // every load of the chunk first: the index and streamed loads, then the
    // gathers that depend on the index
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      const long long slot = (long long)k * m + i, e = slot * TILE;
      if (k < d) {
        if (FORM == DIRECT) {
          v[u] = load_f(x, e);
        } else {
          vi[u] = a.idx[slot];
        }
        if (FORM == ITER) {
          prev[u] = load_f(mu, e);
          if (GAMMA != GAMMA_NONE) old[u] = load_f(nu, e);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      if (k < d && FORM != DIRECT) {
        v[u] = load_f(row, (long long)vi[u] * TILE);
        if (FORM == ITER && GAMMA == GAMMA_VAR) gk[u] = load_f(gvar, (long long)vi[u] * TILE);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      if (k >= d) continue;
      float val = v[u];
      if (FORM == ITER) {
        val = round_to<T>(__fsub_rn(val, prev[u]));  // total[var] - mu_prev
        if (GAMMA == GAMMA_LANE) val = damp<T>(g, g1, old[u], val);
        if (GAMMA == GAMMA_VAR)
          val = damp<T>(gk[u], round_to<T>(__fsub_rn(1.f, gk[u])), old[u], val);
        if (GAMMA != GAMMA_NONE) {
          store_f(nu, ((long long)k * m + i) * TILE, val);
        }
      }
      const float mag = fabsf(val);
      const unsigned neg = val < 0.f;
      if (k == 0) {
        min1 = mag;
      } else {
        const bool smaller = mag < min1;
        min2 = smaller ? min1 : fminf(min2, mag);
        idx1 = smaller ? k : idx1;
        min1 = smaller ? mag : min1;
      }
      parity ^= neg;
      word |= neg << (k & 31);
      if ((k & 31) == 31) {
        signs[(k >> 5) * stride] = word;
        word = 0;
      }
    }
  }
  if (d & 31) signs[(d >> 5) * stride] = word;
  // the padded slots read as +big: folding it in at the first two of them
  // gives the state the whole padded run would (a third changes nothing)
  const int first_pad = d > 0 ? d : 1;
  for (int k = first_pad; k < a.dc && k < first_pad + 2; ++k) {
    const bool smaller = a.big < min1;
    min2 = smaller ? min1 : fminf(min2, a.big);
    idx1 = smaller ? k : idx1;
    min1 = smaller ? a.big : min1;
  }

  const unsigned s = a.syn[tiled<TILE>(lane, m) + (long long)i * TILE] != 0;
  const float o1 = out_mag<T>(min1, a.alpha, a.beta), o2 = out_mag<T>(min2, a.alpha, a.beta);
  const int nout = FORM == ITER ? d : a.dc;  // ITER leaves the padded slots alone
  for (int k = 0; k < nout; ++k) {
    if ((k & 31) == 0) word = k < d ? signs[(k >> 5) * stride] : 0u;
    const unsigned neg = (word >> (k & 31)) & 1u;
    const float r = idx1 == k ? o2 : o1;
    store_f(mu, ((long long)k * m + i) * TILE, (parity ^ neg ^ s) ? -r : r);
  }
}

// Flat form: one thread per (lane, check) over all lanes; the gathers read
// the lane's row in device memory (through L2).  With TILE > 1 a warp is
// TILE lanes of one check (see Layout).
template <typename T, int FORM, int GAMMA, int TILE>
__device__ __forceinline__ void flat_check(const CheckArgs<T>& a) {
  extern __shared__ unsigned flat_signs[];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.B * a.m) return;
  long long lane;
  int i;
  lane_node<TILE>(t, a.m, &lane, &i);
  check_node<T, FORM, GAMMA, kFlatUnroll<T>, TILE>(
      a, lane, i, a.x + tiled<TILE>(lane, a.x_stride), flat_signs + threadIdx.x, blockDim.x);
}

template <typename T, int FORM, int GAMMA, int TILE>
__global__ void __launch_bounds__(kThreads) minsum_check_kernel(const CheckArgs<T> a) {
  flat_check<T, FORM, GAMMA, TILE>(a);
}

// Staged form: one block per lane; the lane's gathered row is copied into
// shared memory once, then the block's threads take the checks in turn.
template <typename T, int FORM, int GAMMA>
__global__ void __launch_bounds__(kMaxStageThreads)
minsum_check_staged_kernel(const CheckArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (a.dc + 31) / 32;
  unsigned* signs = reinterpret_cast<unsigned*>(smem);
  T* row = reinterpret_cast<T*>(signs + (long long)words * blockDim.x);
  const long long lane = blockIdx.x;
  const T* src = a.x + lane * a.x_stride;
  for (long long j = threadIdx.x; j < a.x_stride; j += blockDim.x) row[j] = src[j];
  __syncthreads();
  for (int i = threadIdx.x; i < a.m; i += blockDim.x)
    check_node<T, FORM, GAMMA, kStagedUnroll, 1>(a, lane, i, row, signs + threadIdx.x,
                                                 blockDim.x);
}

template <typename T>
struct VarArgs {
  const T* mu;           // [B, mu_stride] check-side messages, read through v2c
  const int32_t* v2c;    // [dv * n]
  const int32_t* deg;    // [n] real slots of each variable (they come first)
  const T* L0;           // [B, n]
  const T* W;            // [dv, n] per-edge weights or null
  T* nu;                 // NU_FRESH: out [B, dv, n]; NU_INPLACE: nu_prev in, out
  const T* gamma;        // as CheckArgs (GAMMA_VAR: [B, n], the thread's own entry)
  long long gamma_stride;
  T* total;              // [B, n] out, or null
  const uint8_t* done;   // [B] or null; with it err [B, n] and llrs [B, n]
  float* err;
  T* llrs;
  long long B, mu_stride;
  int n, dv;
};

// L elements of T side by side, loaded and stored as one vector.
template <typename T, int L>
struct alignas(sizeof(T) * L) Pack {
  T v[L];
};

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ inline T from_f(float x);
template <>
__device__ inline float from_f<float>(float x) { return x; }
template <>
__device__ inline bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Copy B = 4, 8 or 16 bytes from device to shared memory asynchronously
// (through L1), and wait for every copy the thread has issued.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the thread's copies issued so far into a group; wait until at most N
// of its groups are still in flight.
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Round each value of v to bfloat16 and back, as round_to<bf16> does, two
// at a time (one conversion a pair).
template <int L>
__device__ __forceinline__ void round_pairs(float (&v)[L]) {
#pragma unroll
  for (int q = 0; q < L; q += 2) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(v[q], v[q + 1]);
    v[q] = __low2float(r);
    v[q + 1] = __high2float(r);
  }
}

// Vectors a slot of the packed check form loads: the gathered row (the
// totals in ITER, x in GATHER) and in ITER mu_prev, with damping nu_prev,
// and with GAMMA_VAR the gathered gamma.
template <int FORM, int GAMMA>
__host__ __device__ constexpr int packed_vectors() {
  return FORM != ITER ? 1 : 2 + (GAMMA != GAMMA_NONE) + (GAMMA == GAMMA_VAR);
}

// The check update on lane tiles in bfloat16 (GATHER and ITER): a thread
// takes L = TILE / 32 neighbouring lanes of one check, so a warp is one
// whole tile row of it.  The check's degree and each slot's index entry are
// loaded once for the L lanes (one broadcast load a warp); each slot's
// mu_prev, nu_prev, gathered total (or x) and gathered gamma are one vector
// of L values (4 or 8 bytes a thread, 128 or 256 a warp), and so are the
// stores of nu and mu.  The vectors of U slots go out together and wait in
// shared memory, each thread's own column, copied asynchronously into one
// of two buffers: the next chunk's copies are issued before a chunk is
// computed, behind index entries loaded a chunk ahead, so a thread holds no
// register for a load in flight.  Each lane's arithmetic and its order are
// check_node's: the same rounding (two lanes a conversion), the padded-slot
// fold, the syndrome flip; the output's sign is put on the bfloat16 bits of
// the rounded magnitude, which is what rounding its negation gives.  The
// sign words of lane q lie at signs[(w * L + q) * blockDim.x].
template <int FORM, int GAMMA, int TILE>
__global__ void __launch_bounds__(kPackedThreads)
minsum_check_packed_kernel(const CheckArgs<bf16> a) {
  constexpr int L = TILE / 32;
  constexpr int U = kPackedUnroll;
  constexpr int NV = packed_vectors<FORM, GAMMA>();
  constexpr bool kOld = FORM == ITER && GAMMA != GAMMA_NONE;  // nu_prev read, nu written
  typedef Pack<bf16, L> P;
  static_assert(FORM != DIRECT, "the direct form takes no lane tile");
  extern __shared__ __align__(16) unsigned char packed_buf[];
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * L;
  if (e >= a.B * a.m) return;
  const int m = a.m, nt = blockDim.x;
  long long lane;
  int i;
  lane_node<TILE>(e, m, &lane, &i);
  const int d = a.deg[i];
  // slot k of the thread's lanes lies k * step past slot 0
  const long long at0 = tiled<TILE>(lane, (long long)a.dc * m) + (long long)i * TILE;
  const long long step = (long long)m * TILE;
  bf16* mu = a.mu + at0;
  bf16* nu = kOld ? a.nu + at0 : nullptr;
  const int32_t* idx = a.idx + i;
  const bf16* row = a.x + tiled<TILE>(lane, a.x_stride);
  const bf16* gvar = GAMMA == GAMMA_VAR ? a.gamma + tiled<TILE>(lane, a.gamma_stride) : nullptr;
  P* stage = reinterpret_cast<P*>(packed_buf);  // [2][U][NV][threads]
  unsigned* signs = reinterpret_cast<unsigned*>(
      packed_buf + 2LL * U * NV * nt * sizeof(P)) + threadIdx.x;
  auto staged = [&](int b, int u, int v) {
    return stage + ((b * U + u) * NV + v) * nt + threadIdx.x;
  };

  float g[L], g1[L];
  if constexpr (GAMMA == GAMMA_LANE) {
#pragma unroll
    for (int q = 0; q < L; ++q) {
      g[q] = load_f(a.gamma, (lane + q) * a.gamma_stride);
      g1[q] = round_to<bf16>(__fsub_rn(1.f, g[q]));
    }
  }
  float min1[L], min2[L];
  int idx1[L];
  unsigned word[L], parity = 0;  // parity: bit q of lane q
#pragma unroll
  for (int q = 0; q < L; ++q) {
    min1[q] = min2[q] = a.big;
    idx1[q] = 0;
    word[q] = 0;
  }
  // slot k's message of each lane from its vectors (x: the gathered row),
  // written to nu where damped, folded into the state
  auto fold = [&](int k, const P& x, const P& prev, const P& old, const P& gk) {
    float val[L];
#pragma unroll
    for (int q = 0; q < L; ++q) val[q] = to_f(x.v[q]);
    if constexpr (FORM == ITER) {
#pragma unroll
      for (int q = 0; q < L; ++q) val[q] = __fsub_rn(val[q], to_f(prev.v[q]));
      round_pairs(val);  // total[var] - mu_prev
      if constexpr (GAMMA != GAMMA_NONE) {  // damp<bf16>, lane by lane
        float gq[L], g1q[L], kept[L], fresh[L];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          gq[q] = GAMMA == GAMMA_LANE ? g[q] : to_f(gk.v[q]);
          g1q[q] = GAMMA == GAMMA_LANE ? g1[q] : __fsub_rn(1.f, gq[q]);
        }
        if (GAMMA == GAMMA_VAR) round_pairs(g1q);
#pragma unroll
        for (int q = 0; q < L; ++q) {
          kept[q] = __fmul_rn(gq[q], to_f(old.v[q]));
          fresh[q] = __fmul_rn(g1q[q], val[q]);
        }
        round_pairs(kept);
        round_pairs(fresh);
#pragma unroll
        for (int q = 0; q < L; ++q) val[q] = __fadd_rn(kept[q], fresh[q]);
        round_pairs(val);
      }
    }
    if constexpr (kOld) {
      P r;
#pragma unroll
      for (int q = 0; q < L; ++q) r.v[q] = from_f<bf16>(val[q]);
      *reinterpret_cast<P*>(nu + k * step) = r;
    }
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const float mag = fabsf(val[q]);
      const unsigned neg = val[q] < 0.f;
      if (k == 0) {
        min1[q] = mag;
      } else {
        const bool smaller = mag < min1[q];
        min2[q] = smaller ? min1[q] : fminf(min2[q], mag);
        idx1[q] = smaller ? k : idx1[q];
        min1[q] = smaller ? mag : min1[q];
      }
      parity ^= neg << q;
      word[q] |= neg << (k & 31);
    }
    if ((k & 31) == 31) {
#pragma unroll
      for (int q = 0; q < L; ++q) {
        signs[((k >> 5) * L + q) * nt] = word[q];
        word[q] = 0;
      }
    }
  };
  // the index entries of the chunk at k0
  auto index = [&](int k0, int* vi) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= d) break;
      vi[u] = idx[(long long)(k0 + u) * m];
    }
  };

  // the chunk at k0's copies into buffer b: the streamed vectors, then the
  // gathers through the index entries vi
  auto issue = [&](int k0, int b, const int* vi) {
    asm volatile("" ::: "memory");  // after every read of the buffer before
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= d) break;
      const long long o = (k0 + u) * step;
      if (FORM == ITER) copy_async<sizeof(P)>(staged(b, u, 1), mu + o);
      if (kOld) copy_async<sizeof(P)>(staged(b, u, 2), nu + o);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= d) break;
      const long long o = (long long)vi[u] * TILE;
      copy_async<sizeof(P)>(staged(b, u, 0), row + o);
      if (GAMMA == GAMMA_VAR) copy_async<sizeof(P)>(staged(b, u, 3), gvar + o);
    }
  };
  int vi[U];
  if (d > 0) {
    index(0, vi);
    issue(0, 0, vi);
  }
  copy_async_commit();
  if (d > U) index(U, vi);
  for (int k0 = 0, b = 0; k0 < d; k0 += U, b ^= 1) {  // chunk k0 + U in flight
    if (k0 + U < d) {
      issue(k0 + U, b ^ 1, vi);
      if (k0 + 2 * U < d) index(k0 + 2 * U, vi);
    }
    copy_async_commit();
    copy_async_wait_group<1>();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= d) break;
      P x = *staged(b, u, 0), prev, old, gk;
      if (FORM == ITER) prev = *staged(b, u, 1);
      if (kOld) old = *staged(b, u, 2);
      if (GAMMA == GAMMA_VAR) gk = *staged(b, u, 3);
      fold(k0 + u, x, prev, old, gk);
    }
  }
  if (d & 31) {
#pragma unroll
    for (int q = 0; q < L; ++q) signs[((d >> 5) * L + q) * nt] = word[q];
  }
  // the padded slots' +big, folded in at the first two of them (check_node)
  const int first_pad = d > 0 ? d : 1;
  for (int k = first_pad; k < a.dc && k < first_pad + 2; ++k) {
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const bool smaller = a.big < min1[q];
      min2[q] = smaller ? min1[q] : fminf(min2[q], a.big);
      idx1[q] = smaller ? k : idx1[q];
      min1[q] = smaller ? a.big : min1[q];
    }
  }
  // each lane's two output magnitudes as bfloat16 bits, and its sign: the
  // parity with the syndrome bit
  unsigned short b1[L], b2[L];
  unsigned flip = parity;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    b1[q] = __bfloat16_as_ushort(from_f<bf16>(out_mag<bf16>(min1[q], a.alpha, a.beta)));
    b2[q] = __bfloat16_as_ushort(from_f<bf16>(out_mag<bf16>(min2[q], a.alpha, a.beta)));
    flip ^= (unsigned)(a.syn[e + q] != 0) << q;
  }
  const int nout = FORM == ITER ? d : a.dc;  // ITER leaves the padded slots alone
  for (int k = 0; k < nout; ++k) {
    if ((k & 31) == 0) {
#pragma unroll
      for (int q = 0; q < L; ++q) word[q] = k < d ? signs[((k >> 5) * L + q) * nt] : 0u;
    }
    P r;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const unsigned neg = ((word[q] >> (k & 31)) ^ (flip >> q)) & 1u;
      r.v[q] = __ushort_as_bfloat16((unsigned short)((idx1[q] == k ? b2[q] : b1[q]) ^ (neg << 15)));
    }
    *reinterpret_cast<P*>(mu + k * step) = r;
  }
}

// Threads of a block of the variable update on lane tiles: a damped form
// stages the previous messages beside the gathered ones, so its blocks take
// half the threads and the same shared memory (48 KB at most).
template <int GAMMA>
__host__ __device__ constexpr int var_tiled_threads() {
  return GAMMA == GAMMA_NONE ? kThreads : kThreads / 2;
}

// The variable update on lane tiles.  NU_NONE: the check layout's form, the
// totals and, given the done flags, the freeze.  NU_INPLACE: the variable
// layout's form besides: the leave-one-out messages total - msg (weighted by
// W where WEIGHTED) written in place over nu at the real slots, mixed with
// the previous ones by GAMMA.  A warp is 32 threads of one variable, each
// taking L = TILE / 32 neighbouring lanes, so that every gathered message of
// a slot is one vector of L values (4-16 bytes a thread, 128-512 a warp) and
// the degree, v2c and W entries are one broadcast load, issued together (a
// padded slot's entry is never used).  The gathered vectors wait in shared
// memory, each thread's own column, copied asynchronously: no register
// waits on a load in flight, so more of them are (on 128-lane tiles 0.40x
// the time of the same body with the vectors in registers in float32, 0.55x
// in bfloat16; tools/minsum_kernel_compare.py, H100 80GB HBM3, 700 W).  A
// damped form copies the previous nu vectors the same way, as a second group
// that lands while the totals are summed.  Each lane's arithmetic runs in
// the lane-major kernel's order.  ``e`` is the thread's first entry in the
// tiled [B, n] arrays (L0, total, err, llrs, a [B, n] gamma).
template <typename T, int TILE, int NU, bool WEIGHTED, int GAMMA>
__device__ __forceinline__ void var_tiled_node(const VarArgs<T>& a) {
  constexpr int L = TILE / 32;
  constexpr int THREADS = var_tiled_threads<GAMMA>();
  constexpr bool kOld = NU == NU_INPLACE && GAMMA != GAMMA_NONE;  // the previous nu read
  typedef Pack<T, L> P;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * L;
  if (e >= a.B * a.n) return;
  const int n = a.n;
  long long lane;
  int j;
  lane_node<TILE>(e, n, &lane, &j);
  const int d = a.deg[j];
  const T* ml = a.mu + tiled<TILE>(lane, a.mu_stride);
  auto gather = [&](int at) { return *reinterpret_cast<const P*>(ml + (long long)at * TILE); };
  // NU_INPLACE: slot k's vector of the lanes' [dv, n] messages
  T* nl = NU == NU_INPLACE ? a.nu + tiled<TILE>(lane, (long long)a.dv * n) : nullptr;
  auto nu_at = [&](int k) { return nl + ((long long)k * n + j) * TILE; };
  // the masked, weighted message as a float32 product (exact for bfloat16
  // factors): the sum takes it as it is, the difference rounds it first
  auto msg = [&](T v, float w) {
    float x = to_f(v);
    if (WEIGHTED) x = __fmul_rn(x, w);
    return x;
  };
  auto weight = [&](int k) { return WEIGHTED ? load_f(a.W, (long long)k * n + j) : 1.f; };

  float acc[L];
#pragma unroll
  for (int q = 0; q < L; ++q) acc[q] = 0.f;
  float tf[L];  // the totals, rounded to T
  float g[L], g1[L];  // kOld: each lane's damping factor and round(1 - g)
  if constexpr (kOld) {
    if constexpr (GAMMA == GAMMA_LANE) {
#pragma unroll
      for (int q = 0; q < L; ++q) g[q] = load_f(a.gamma, (lane + q) * a.gamma_stride);
    } else {  // [B, n] lane-tiled, as L0
      const P gv = *reinterpret_cast<const P*>(a.gamma + e);
#pragma unroll
      for (int q = 0; q < L; ++q) g[q] = to_f(gv.v[q]);
    }
#pragma unroll
    for (int q = 0; q < L; ++q) g1[q] = round_to<T>(__fsub_rn(1.f, g[q]));
  }
  // slot k's leave-one-out messages from its gathered vector v (weight w),
  // mixed with the previous ones (old) where damped, written over them
  auto emit = [&](int k, const P& v, float w, const P& old) {
    P r;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      float x = round_to<T>(__fsub_rn(tf[q], round_to<T>(msg(v.v[q], w))));
      if constexpr (kOld) x = damp<T>(g[q], g1[q], to_f(old.v[q]), x);
      r.v[q] = from_f<T>(x);
    }
    *reinterpret_cast<P*>(nu_at(k)) = r;
  };

  if (a.dv <= kVarCap) {  // one window: every load in flight, then the sums in order
    int at[kVarCap];
    float w[kVarCap];
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < a.dv) {
        at[k] = a.v2c[(long long)k * n + j];
        w[k] = weight(k);
      }
    // a vector is 4-16 bytes (L >= 2), a size cp.async copies whole
    constexpr int kWords = sizeof(P) / 4;
    constexpr int kSlot = THREADS * kWords;  // a slot's words in a buffer
    static_assert(sizeof(P) % 4 == 0, "a lane tile of at least 64 lanes");
    __shared__ __align__(16) uint32_t staged[(kOld ? 2 : 1) * kVarCap * kSlot];
    uint32_t* col = staged + threadIdx.x * kWords;
    uint32_t* old_col = col + kVarCap * kSlot;  // kOld: the previous nu vectors
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < d) copy_async<sizeof(P)>(col + k * kSlot, ml + (long long)at[k] * TILE);
    if constexpr (kOld) {
      copy_async_commit();
#pragma unroll
      for (int k = 0; k < kVarCap; ++k)
        if (k < d) copy_async<sizeof(P)>(old_col + k * kSlot, nu_at(k));
      copy_async_commit();
      copy_async_wait_group<1>();  // the gathered vectors; the previous ones still in flight
    } else {
      copy_async_wait();
    }
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < d) {
        P v;
        memcpy(&v, col + k * kSlot, sizeof(P));
#pragma unroll
        for (int q = 0; q < L; ++q) acc[q] = __fadd_rn(acc[q], msg(v.v[q], w[k]));
      }
    const P l0 = *reinterpret_cast<const P*>(a.L0 + e);
#pragma unroll
    for (int q = 0; q < L; ++q) tf[q] = round_to<T>(__fadd_rn(to_f(l0.v[q]), round_to<T>(acc[q])));
    if constexpr (NU == NU_INPLACE) {
      if constexpr (kOld) copy_async_wait();
#pragma unroll
      for (int k = 0; k < kVarCap; ++k)
        if (k < d) {
          P v, old;
          memcpy(&v, col + k * kSlot, sizeof(P));
          if constexpr (kOld) memcpy(&old, old_col + k * kSlot, sizeof(P));
          emit(k, v, w[k], old);
        }
    }
  } else {  // windows of 32 slots, as the lane-major kernel sums them
    float part[L];
#pragma unroll
    for (int q = 0; q < L; ++q) part[q] = 0.f;
    const int low = (((a.dv + 31) / 32) * 32 - a.dv) / 2;
    for (int k = 0, edge = 32 - low; k < d; ++k) {
      const P v = gather(a.v2c[(long long)k * n + j]);
      const float w = weight(k);
#pragma unroll
      for (int q = 0; q < L; ++q) part[q] = __fadd_rn(part[q], msg(v.v[q], w));
      if (k + 1 == edge) {
#pragma unroll
        for (int q = 0; q < L; ++q) {
          acc[q] = __fadd_rn(acc[q], part[q]);
          part[q] = 0.f;
        }
        edge += 32;
      }
    }
    const P l0 = *reinterpret_cast<const P*>(a.L0 + e);
#pragma unroll
    for (int q = 0; q < L; ++q) {
      acc[q] = __fadd_rn(acc[q], part[q]);
      tf[q] = round_to<T>(__fadd_rn(to_f(l0.v[q]), round_to<T>(acc[q])));
    }
    if constexpr (NU == NU_INPLACE) {
      for (int k = 0; k < d; ++k) {
        P old;
        if constexpr (kOld) old = *reinterpret_cast<const P*>(nu_at(k));
        emit(k, gather(a.v2c[(long long)k * n + j]), weight(k), old);
      }
    }
  }

  P tot;
#pragma unroll
  for (int q = 0; q < L; ++q) tot.v[q] = from_f<T>(tf[q]);
  if (a.total) *reinterpret_cast<P*>(a.total + e) = tot;
  if (a.done) {  // the freeze: done lanes keep their outputs
#pragma unroll
    for (int q = 0; q < L; ++q)
      if (!a.done[lane + q]) {
        a.err[e + q] = tf[q] < 0.f ? 1.f : 0.f;
        a.llrs[e + q] = tot.v[q];
      }
  }
}

template <typename T, int NU, bool WEIGHTED, int GAMMA>
__global__ void __launch_bounds__(kThreads)
minsum_var_kernel(const VarArgs<T> a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.B * a.n) return;
  const int n = a.n;
  const long long lane = t / n;
  const int j = (int)(t - lane * n);
  const int d = a.deg[j];
  const T* ml = a.mu + lane * a.mu_stride;

  // the masked, weighted message as a float32 product (exact for bfloat16
  // factors): the sum takes it as it is, the difference rounds it first
  auto msg = [&](int k, int at) -> float {
    float v = load_f(ml, at);
    if (WEIGHTED) v = __fmul_rn(v, load_f(a.W, (long long)k * n + j));
    return v;
  };

  float vals[kVarCap];
  float acc = 0.f;
  const bool in_regs = a.dv <= kVarCap;
  if (in_regs) {  // one window: every load in flight, then the sum in order
    int at[kVarCap];
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < d) at[k] = a.v2c[(long long)k * n + j];
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < d) vals[k] = msg(k, at[k]);
#pragma unroll
    for (int k = 0; k < kVarCap; ++k)
      if (k < d) acc = __fadd_rn(acc, vals[k]);
  } else {
    // windows of 32 slots, the padding to a multiple of 32 split before and
    // after; each window summed from 0 into `part`, which is added to `acc`
    // at the window's last slot (at most 32 windows: the launcher refuses
    // dv > 1024).  dv <= 32 is one window, the plain sum
    float part = 0.f;
    const int low = (((a.dv + 31) / 32) * 32 - a.dv) / 2;
    for (int k = 0, edge = 32 - low; k < d; ++k) {
      part = __fadd_rn(part, msg(k, a.v2c[(long long)k * n + j]));
      if (k + 1 == edge) {
        acc = __fadd_rn(acc, part);
        part = 0.f;
        edge += 32;
      }
    }
    acc = __fadd_rn(acc, part);
  }
  const float tot = round_to<T>(__fadd_rn(load_f(a.L0, t), round_to<T>(acc)));

  if (NU != NU_NONE) {
    T* out = a.nu + lane * (long long)a.dv * n;
    float g = 0.f, g1 = 0.f;
    if (GAMMA != GAMMA_NONE) {
      g = load_f(a.gamma, GAMMA == GAMMA_VAR ? lane * a.gamma_stride + j
                                             : lane * a.gamma_stride);
      g1 = round_to<T>(__fsub_rn(1.f, g));
    }
    // leave-one-out: total - msg; a padded slot (NU_FRESH only) is total - 0
    auto emit = [&](int k, float mk) {
      const long long e = (long long)k * n + j;
      float r = round_to<T>(__fsub_rn(tot, round_to<T>(mk)));
      if (NU == NU_INPLACE && GAMMA != GAMMA_NONE) r = damp<T>(g, g1, load_f(out, e), r);
      store_f(out, e, r);
    };
    const int nout = NU == NU_FRESH ? a.dv : d;
    if (in_regs) {
#pragma unroll
      for (int k = 0; k < kVarCap; ++k)
        if (k < nout) emit(k, k < d ? vals[k] : 0.f);
    } else {
      for (int k = 0; k < nout; ++k)
        emit(k, k < d ? msg(k, a.v2c[(long long)k * n + j]) : 0.f);
    }
  }
  if (a.total) store_f(a.total, t, tot);
  if (a.done && !a.done[lane]) {  // the freeze: done lanes keep their outputs
    a.err[t] = tot < 0.f ? 1.f : 0.f;
    store_f(a.llrs, t, tot);
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads) minsum_var_tiled_kernel(const VarArgs<T> a) {
  var_tiled_node<T, TILE, NU_NONE, false, GAMMA_NONE>(a);
}

// The variable layout's in-place form on lane tiles.
template <typename T, int TILE, bool WEIGHTED, int GAMMA>
__global__ void __launch_bounds__(var_tiled_threads<GAMMA>())
minsum_var_inplace_tiled_kernel(const VarArgs<T> a) {
  var_tiled_node<T, TILE, NU_INPLACE, WEIGHTED, GAMMA>(a);
}

unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

int words_of(int dc) { return (dc + 31) / 32; }

// Threads of a staged block and its shared memory, or 0 threads where the
// lane's row does not fit beside the sign words of 128 threads.
void stage_plan(long long row_bytes, int m, int dc, int* threads, long long* bytes) {
  int t = (int)((m + 31) / 32 * 32);
  t = t < kMaxStageThreads ? t : kMaxStageThreads;
  long long b = row_bytes + 4LL * words_of(dc) * t;
  while (b > kMaxSmem && t > 128) {
    t = (t / 2 + 31) / 32 * 32;
    b = row_bytes + 4LL * words_of(dc) * t;
  }
  *threads = b <= kMaxSmem ? t : 0;
  *bytes = b;
}

// Threads of a flat block whose sign words fit 48 KB (opt-in above that).
int flat_threads(int dc, long long* bytes) {
  int t = kThreads;
  while (t > 32 && 4LL * words_of(dc) * t > kDefaultSmem) t /= 2;
  *bytes = 4LL * words_of(dc) * t;
  return t;
}

template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The packed check form's block: its threads (a multiple of 32, halved
// until its shared memory fits a block) and its shared-memory bytes; 0
// threads where none fits.
template <int FORM, int GAMMA, int TILE>
int packed_plan(int dc, long long* bytes) {
  constexpr int L = TILE / 32;
  // a thread's sign words and its two buffers of U slots' vectors
  const long long each = 4LL * words_of(dc) * L +
                         2LL * kPackedUnroll * packed_vectors<FORM, GAMMA>() * 2 * L;
  int t = kPackedThreads;
  while (each * t > kMaxSmem && t > 32) t /= 2;
  *bytes = each * t;
  return *bytes <= kMaxSmem ? t : 0;
}

template <int FORM, int GAMMA, int TILE>
int launch_check_packed(const CheckArgs<bf16>& a, cudaStream_t st) {
  long long bytes;
  const int threads = packed_plan<FORM, GAMMA, TILE>(a.dc, &bytes);
  if (threads == 0) return cudaErrorInvalidValue;
  auto kernel = minsum_check_packed_kernel<FORM, GAMMA, TILE>;
  cudaError_t rc = allow_smem(kernel, bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid_for(a.B * a.m / (TILE / 32), threads), threads, bytes, st>>>(a);
  return cudaGetLastError();
}

// stage: 1 staged, 0 flat, -1 the launcher's choice: staged where the row
// is at least 48 KB and two blocks fit an SM.  Measured (as above): staged
// 0.93x the flat form's time on the bb144 DEM's bfloat16 totals (63,296 B,
// two blocks an SM), 1.11x on its float32 totals (one block an SM), 1.2x
// and 1.8x on the Gallager code's rows of 36 KB (float32, bfloat16), whose
// gathers the caches hold anyway
template <typename T, int FORM, int GAMMA, int TILE>
int launch_check(const CheckArgs<T>& a, int stage, cudaStream_t st) {
  if constexpr (TILE > 1) {
    if (stage == 1 || a.B % TILE) return cudaErrorInvalidValue;  // flat form only
    if constexpr (sizeof(T) == 2) return launch_check_packed<FORM, GAMMA, TILE>(a, st);
  } else if (FORM != DIRECT && stage != 0) {
    const long long row = a.x_stride * (long long)sizeof(T);
    int threads;
    long long bytes;
    stage_plan(row, a.m, a.dc, &threads, &bytes);
    if (stage == -1 && (row < kStageMinRow || 2 * (bytes + 1024) > kSmemPerSm)) threads = 0;
    if (threads > 0) {
      auto kernel = minsum_check_staged_kernel<T, FORM, GAMMA>;
      cudaError_t rc = allow_smem(kernel, bytes);
      if (rc != cudaSuccess) return rc;
      kernel<<<(unsigned)a.B, threads, bytes, st>>>(a);
      return cudaGetLastError();
    }
    if (stage == 1) return cudaErrorInvalidValue;
  }
  long long bytes;
  const int threads = flat_threads(a.dc, &bytes);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = minsum_check_kernel<T, FORM, GAMMA, TILE>;
  cudaError_t rc = allow_smem(kernel, bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid_for(a.B * a.m, threads), threads, bytes, st>>>(a);
  return cudaGetLastError();
}

// The check launch at the caller's lane tile (DIRECT takes 1 only).
template <typename T, int FORM, int GAMMA>
int launch_check_at(const CheckArgs<T>& a, int stage, int lane_tile, cudaStream_t st) {
  if (lane_tile == 1) return launch_check<T, FORM, GAMMA, 1>(a, stage, st);
  if constexpr (FORM != DIRECT) {
    if (lane_tile == kTiles[0]) return launch_check<T, FORM, GAMMA, kTiles[0]>(a, stage, st);
    if (lane_tile == kTiles[1]) return launch_check<T, FORM, GAMMA, kTiles[1]>(a, stage, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int check_iter(const CheckArgs<T>& a, int gamma_kind, int stage, int lane_tile,
               cudaStream_t st) {
  switch (gamma_kind) {
    case GAMMA_NONE: return launch_check_at<T, ITER, GAMMA_NONE>(a, stage, lane_tile, st);
    case GAMMA_LANE: return launch_check_at<T, ITER, GAMMA_LANE>(a, stage, lane_tile, st);
    case GAMMA_VAR: return launch_check_at<T, ITER, GAMMA_VAR>(a, stage, lane_tile, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int NU, bool WEIGHTED>
int launch_var_g(const VarArgs<T>& a, int gamma_kind, cudaStream_t st) {
  const unsigned grid = grid_for(a.B * a.n, kThreads);
  if constexpr (NU == NU_INPLACE) {
    if (gamma_kind == GAMMA_LANE) {
      minsum_var_kernel<T, NU, WEIGHTED, GAMMA_LANE><<<grid, kThreads, 0, st>>>(a);
      return cudaGetLastError();
    }
    if (gamma_kind == GAMMA_VAR) {
      minsum_var_kernel<T, NU, WEIGHTED, GAMMA_VAR><<<grid, kThreads, 0, st>>>(a);
      return cudaGetLastError();
    }
  }
  if (gamma_kind != GAMMA_NONE) return cudaErrorInvalidValue;  // damping needs nu in place
  minsum_var_kernel<T, NU, WEIGHTED, GAMMA_NONE><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The variable update on lane tiles: the check layout's form (the totals
// and the freeze: no messages out, no weights, no damping), or the variable
// layout's in place over nu, with or without W, at every damping kind.
template <typename T, int TILE>
int launch_var_tiled(const VarArgs<T>& a, int nu_mode, int gamma_kind, cudaStream_t st) {
  if (a.B % TILE) return cudaErrorInvalidValue;
  const long long threads = a.B * a.n / (TILE / 32);
  if (nu_mode == NU_NONE) {
    if (a.W != nullptr || gamma_kind != GAMMA_NONE) return cudaErrorInvalidValue;
    minsum_var_tiled_kernel<T, TILE><<<grid_for(threads, kThreads), kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (nu_mode != NU_INPLACE) return cudaErrorInvalidValue;
  auto go = [&](auto kernel, int block) {
    kernel<<<grid_for(threads, block), block, 0, st>>>(a);
    return (int)cudaGetLastError();
  };
  const bool w = a.W != nullptr;
  constexpr int kHalf = var_tiled_threads<GAMMA_LANE>();
  switch (gamma_kind) {
    case GAMMA_NONE:
      return w ? go(minsum_var_inplace_tiled_kernel<T, TILE, true, GAMMA_NONE>, kThreads)
               : go(minsum_var_inplace_tiled_kernel<T, TILE, false, GAMMA_NONE>, kThreads);
    case GAMMA_LANE:
      return w ? go(minsum_var_inplace_tiled_kernel<T, TILE, true, GAMMA_LANE>, kHalf)
               : go(minsum_var_inplace_tiled_kernel<T, TILE, false, GAMMA_LANE>, kHalf);
    case GAMMA_VAR:
      return w ? go(minsum_var_inplace_tiled_kernel<T, TILE, true, GAMMA_VAR>, kHalf)
               : go(minsum_var_inplace_tiled_kernel<T, TILE, false, GAMMA_VAR>, kHalf);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_var(const VarArgs<T>& a, int nu_mode, int gamma_kind, int lane_tile,
               cudaStream_t st) {
  if (lane_tile != 1) {
    if (lane_tile == kTiles[0]) return launch_var_tiled<T, kTiles[0]>(a, nu_mode, gamma_kind, st);
    if (lane_tile == kTiles[1]) return launch_var_tiled<T, kTiles[1]>(a, nu_mode, gamma_kind, st);
    return cudaErrorInvalidValue;
  }
  const bool w = a.W != nullptr;
  switch (nu_mode) {
    case NU_NONE:
      return w ? launch_var_g<T, NU_NONE, true>(a, gamma_kind, st)
               : launch_var_g<T, NU_NONE, false>(a, gamma_kind, st);
    case NU_FRESH:
      return w ? launch_var_g<T, NU_FRESH, true>(a, gamma_kind, st)
               : launch_var_g<T, NU_FRESH, false>(a, gamma_kind, st);
    case NU_INPLACE:
      return w ? launch_var_g<T, NU_INPLACE, true>(a, gamma_kind, st)
               : launch_var_g<T, NU_INPLACE, false>(a, gamma_kind, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
CheckArgs<T> check_args(const void* x, const void* idx, const void* syn, const void* deg,
                        void* mu, void* nu, const void* gamma, long long gamma_stride, int B,
                        int m, int dc, long long x_stride, float alpha, float beta, float big) {
  CheckArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.idx = static_cast<const int32_t*>(idx);
  a.syn = static_cast<const uint8_t*>(syn);
  a.deg = static_cast<const int32_t*>(deg);
  a.mu = static_cast<T*>(mu);
  a.nu = static_cast<T*>(nu);
  a.gamma = static_cast<const T*>(gamma);
  a.gamma_stride = gamma_stride;
  a.B = B;
  a.x_stride = x_stride;
  a.m = m;
  a.dc = dc;
  a.alpha = alpha;
  a.beta = beta;
  a.big = big;
  return a;
}

}  // namespace

extern "C" {

// mu = check update of x: direct [B, dc, m] (idx null) or [B, x_stride]
// read through idx [dc * m].  Every slot of mu is written.  lane_tile 1, or
// (gathered only) 64 or 128: every [B, ...] array lane-tiled, B a
// multiple of it.
int ldpc_minsum_check(const void* x, const void* idx, const void* syn, const void* deg, void* mu,
                      int B, int m, int dc, long long x_stride, float alpha, float beta,
                      float big, int stage, int lane_tile, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    auto a = check_args<bf16>(x, idx, syn, deg, mu, nullptr, nullptr, 0, B, m, dc, x_stride,
                              alpha, beta, big);
    return idx ? launch_check_at<bf16, GATHER, GAMMA_NONE>(a, stage, lane_tile, st)
               : launch_check_at<bf16, DIRECT, GAMMA_NONE>(a, stage, lane_tile, st);
  }
  auto a = check_args<float>(x, idx, syn, deg, mu, nullptr, nullptr, 0, B, m, dc, x_stride,
                             alpha, beta, big);
  return idx ? launch_check_at<float, GATHER, GAMMA_NONE>(a, stage, lane_tile, st)
             : launch_check_at<float, DIRECT, GAMMA_NONE>(a, stage, lane_tile, st);
}

// The check layout's iteration, in place: mu [B, dc, m] (previous in, new
// out on the real slots), total [B, n], idx [dc * m] the variable of each
// check slot; gamma_kind 0 none, 1 per lane (gamma_stride 0: one for all),
// 2 per variable [B, n]; with damping nu [B, dc, m] (previous in, mixed out);
// lane_tile 1, 64 or 128 (then the flat form; every [B, ...] array
// lane-tiled).
int ldpc_minsum_check_iter(void* mu, void* nu, const void* total, const void* idx,
                           const void* syn, const void* deg, const void* gamma, int gamma_kind,
                           long long gamma_stride, int B, int m, int dc, int n, float alpha,
                           float beta, float big, int stage, int lane_tile, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gamma_kind != GAMMA_NONE) != (nu != nullptr)) return cudaErrorInvalidValue;
  if (is_bf16) {
    auto a = check_args<bf16>(total, idx, syn, deg, mu, nu, gamma, gamma_stride, B, m, dc, n,
                              alpha, beta, big);
    return check_iter<bf16>(a, gamma_kind, stage, lane_tile, st);
  }
  auto a = check_args<float>(total, idx, syn, deg, mu, nu, gamma, gamma_stride, B, m, dc, n,
                             alpha, beta, big);
  return check_iter<float>(a, gamma_kind, stage, lane_tile, st);
}

// Variable update.  nu_mode 0: no messages out; 1: nu [B, dv, n] = total -
// msg on every slot; 2: in place over nu_prev on the real slots, mixed with
// it by gamma (kinds as above).  total [B, n] out where not null; with done
// [B], err [B, n] float32 and llrs [B, n] take the active lanes' outputs.
// lane_tile 64 or 128 (nu_mode 0 with no W and no gamma, or nu_mode 2):
// every [B, ...] array lane-tiled, B a multiple of it (a [B, n] gamma too).
int ldpc_minsum_var(const void* mu, const void* v2c, const void* deg, const void* L0,
                    const void* W, void* nu, int nu_mode, const void* gamma, int gamma_kind,
                    long long gamma_stride, void* total, const void* done, void* err, void* llrs,
                    int B, int n, int dv, long long mu_stride, int lane_tile, int is_bf16,
                    void* stream) {
  if (dv > 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    VarArgs<bf16> a{static_cast<const bf16*>(mu), static_cast<const int32_t*>(v2c),
                    static_cast<const int32_t*>(deg), static_cast<const bf16*>(L0),
                    static_cast<const bf16*>(W), static_cast<bf16*>(nu),
                    static_cast<const bf16*>(gamma), gamma_stride, static_cast<bf16*>(total),
                    static_cast<const uint8_t*>(done), static_cast<float*>(err),
                    static_cast<bf16*>(llrs), B, mu_stride, n, dv};
    return launch_var<bf16>(a, nu_mode, gamma_kind, lane_tile, st);
  }
  VarArgs<float> a{static_cast<const float*>(mu), static_cast<const int32_t*>(v2c),
                   static_cast<const int32_t*>(deg), static_cast<const float*>(L0),
                   static_cast<const float*>(W), static_cast<float*>(nu),
                   static_cast<const float*>(gamma), gamma_stride, static_cast<float*>(total),
                   static_cast<const uint8_t*>(done), static_cast<float*>(err),
                   static_cast<float*>(llrs), B, mu_stride, n, dv};
  return launch_var<float>(a, nu_mode, gamma_kind, lane_tile, st);
}

// The staged check form's plan for a gathered row of row_bytes: threads (0:
// the flat form) and shared-memory bytes.
void ldpc_minsum_stage_plan(long long row_bytes, int m, int dc, int* out) {
  int threads;
  long long bytes;
  stage_plan(row_bytes, m, dc, &threads, &bytes);
  out[0] = threads;
  out[1] = (int)bytes;
}

// The packed check form's plan (bfloat16 on a lane tile of 64 or 128; form
// 1 gathered, 2 the iteration; gamma_kind as above): out = threads, shared-
// memory bytes, registers a thread and blocks an SM; returns the
// cudaError_t of the queries.
int ldpc_minsum_packed_plan(int dc, int lane_tile, int form, int gamma_kind, int* out) {
  auto plan = [&](auto kernel, int threads, long long bytes) {
    out[0] = threads;
    out[1] = (int)bytes;
    out[2] = out[3] = 0;
    if (threads == 0) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr{};
    cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc == cudaSuccess) rc = allow_smem(kernel, bytes);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, threads, bytes);
    out[2] = attr.numRegs;
    return (int)rc;
  };
  auto go = [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    long long b;
    int t;
    if (form == GATHER && gamma_kind == GAMMA_NONE) {
      t = packed_plan<GATHER, GAMMA_NONE, TILE>(dc, &b);
      return plan(minsum_check_packed_kernel<GATHER, GAMMA_NONE, TILE>, t, b);
    }
    if (form != ITER) return (int)cudaErrorInvalidValue;
    switch (gamma_kind) {
      case GAMMA_NONE:
        t = packed_plan<ITER, GAMMA_NONE, TILE>(dc, &b);
        return plan(minsum_check_packed_kernel<ITER, GAMMA_NONE, TILE>, t, b);
      case GAMMA_LANE:
        t = packed_plan<ITER, GAMMA_LANE, TILE>(dc, &b);
        return plan(minsum_check_packed_kernel<ITER, GAMMA_LANE, TILE>, t, b);
      case GAMMA_VAR:
        t = packed_plan<ITER, GAMMA_VAR, TILE>(dc, &b);
        return plan(minsum_check_packed_kernel<ITER, GAMMA_VAR, TILE>, t, b);
    }
    return (int)cudaErrorInvalidValue;
  };
  if (lane_tile == kTiles[0]) return go(std::integral_constant<int, kTiles[0]>());
  if (lane_tile == kTiles[1]) return go(std::integral_constant<int, kTiles[1]>());
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
