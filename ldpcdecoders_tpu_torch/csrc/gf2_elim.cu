// Batched GF(2) elimination kernels for OSD post-processing, for sm_90a.
//
// Replaces the two Pallas TPU kernels of ldpcdecoders_tpu/ops/pallas_gf2.py:
//   gf2_pipelined_kernel<P, true>, gf2_panel_kernel<P, true>
//       <- pallas_gf2.py:_osd0_kernel (wrapper gf2_osd0_pallas)
//   gf2_pipelined_kernel<P, false>, gf2_panel_kernel<P, false>
//       <- pallas_gf2.py:_elim_kernel (wrapper gf2_eliminate_pallas)
// and computes what they compute: the same pivot columns (the first unused
// row with the column bit set), the same co-transformed syndrome, the same
// pivot map with sentinel n, the same RREF, and for OSD-0 the same
// correction.  ops/gf2.py holds the plain versions: gf2_osd0 / gf2_eliminate
// column by column, and gf2_osd0_blocked / gf2_eliminate_blocked panel by
// panel as here.
//
// Layout.  One block per lane.  The lane's bit-packed, transposed system
// Ht[W][m] (word w of row i holds columns 32w..32w+31) is copied once into
// dynamic shared memory and stays there for the whole elimination; device
// memory sees one read and one write per lane.  The row stride mp is a
// multiple of 4 words with mp % 8 == 4: a warp reads 32 rows of one word, or
// 4 rows of each of 32 words as one 16-byte access per thread, without a
// bank conflict.  One state word per row holds its pivot column (23 bits,
// sentinel n), its syndrome bit and, in gf2_panel_kernel, its code in the
// current panel (8 bits).
//
// Blocked elimination (the "method of four Russians"), P columns a panel,
// P in {8, 4, 2, 1} and all within one word:
//   (1) Panel pass.  The P column trips run on the panel's bits and the
//       syndrome bit only: pivot choice, full-rank stop, OSD-0's stop at the
//       first column at whose entry no residual is left outside the pivot
//       space, and the fold of bp_err[j] into the pivot row stay exactly
//       sequential.  Every row records a code: bit t set when the pivot of
//       the panel's column t was XORed into it.
//   (2) Table.  Q_t, the pivot row of trip t as it stood when its column
//       was reached, is its start XOR the Q_u of its code's lower bits.
//       T[c] = XOR of Q_t over the bits of c, 2^P rows of W words.
//   (3) Apply.  A warp per 4 rows, a lane per word: row ^= T[code], every
//       lane busy, one pass per P columns.  OSD-0 skips the words left of
//       the panel, which no later column reads and which are no output.
//
// gf2_pipelined_kernel (m <= 1024, P > 1) is the main path's.  Warp 0 makes
// the trips alone, without a barrier, on bit slices in its registers: lane b
// holds rows 32 b .. 32 b + 31, one register per panel column, one each for
// the syndrome bits and the free rows.  A trip is a few 32-row logic
// operations, one warp reduction for the first row and one shuffle per
// column for the pivot row's bits.  It runs one panel AHEAD of the apply
// pass: while the other warps apply panel q - 1, warp 0 takes the raw bits
// of panel q (sliced before that pass began), corrects them by panel q - 1's
// pivots (column t' of a row changes by Q_t's bit t' for every bit t of the
// row's code) and makes panel q's trips.  Beside the trips the warps of
// warp 0's scheduler (warps 4, 8, ...) stay out of the apply pass: a warp
// alone on its scheduler makes a trip in two thirds of the time.  Between
// two such overlapped stretches, behind a block barrier: warp 1 works out
// the Q_t of panel q, the other warps turn the code slices into the rows'
// table offsets and state words and slice panel q + 1's raw bits; barrier;
// all warps write the table; barrier.  Three block barriers a panel.
//
// gf2_panel_kernel takes every other shape (m > 1024, P = 1, a lane that
// fits only bare): thread t owns rows t, t + blockDim, ... in shared
// memory; a trip is a warp ballot for the warp's first free row with the
// bit, a slot per warp, one block barrier, a warp reduction over the slots,
// and the XOR of the pivot's panel word into the own rows with the bit.
// With P = 1 there is no table: the trip XORs the pivot row itself into the
// rows with the bit, all words, a thread per row and one barrier a column.
//
// What bounds it on the H100: one SM per lane, in series over n / P
// panels.  A panel is the longer of the apply pass (the lane is read, a
// table row is read, the lane is written: 3 * 4 * W * m bytes of shared
// memory at 128 bytes a clock, and 18 instructions per 4 rows and word) and
// of P dependent trips in one warp, a chain of warp-wide latencies; then
// the stretch behind barriers, whose instructions (32-bit integer and
// shared-memory) are the table's 2^P rows, the bit transposes of the
// slices, and warp 1's chain.  The launcher picks the widest panel whose
// table fits the 232,448 bytes a block may take beside the lane;
// ldpc_gf2_plan reports that choice, and ops/cuda_gf2.py:launch_plan
// computes the same in Python (the card's tests hold the two together).
//
// Plain C interface (pointers, sizes, stream), loaded with ctypes.  Each
// launcher returns the cudaError_t of its launch; 0 is success.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPivMask = 0x7fffffu;  // state word: pivot column, sentinel n
constexpr int kCodeShift = 23;            // 8 bits of panel code
constexpr uint32_t kCodeMask = 0xffu << kCodeShift;
constexpr int kSynShift = 31;             // the row's syndrome bit
constexpr uint32_t kNoKey = 0xffffffffu;    // no candidate row
constexpr uint32_t kNoPivot = 0xfffffffeu;  // trip key: the column has no pivot
constexpr uint32_t kStop = 0xfffffffdu;     // trip key: the panel ended before this trip
constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory of one Hopper block
constexpr uint32_t kFull = 0xffffffffu;

// At least two warps: the pipelined kernel gives warp 0 the trips and warp 1
// the Q rows.
int block_threads(int m) {
  const int t = ((m + 31) / 32) * 32;
  return t < 64 ? 64 : (t > 1024 ? 1024 : t);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Trip slots of a panel in gf2_panel_kernel: one per column; two, taken in
// turn, at P = 1, where a panel has the one barrier of its trip.
__host__ __device__ constexpr int trip_slots(int P) { return P == 1 ? 2 : P; }

// Row stride of the lane in shared memory: padded to mp % 8 == 4, or bare.
int row_stride(int m, bool pad) {
  if (!pad) return m;
  const int m4 = round4(m);
  return m4 % 8 == 4 ? m4 : m4 + 4;
}

// Shared memory of a block, as offsets in 32-bit words; every part is a
// multiple of 4 words (ops/cuda_gf2.py:launch_plan computes the same sum).
struct Layout {
  int ctrl;    // [16] pipelined: loop state of the panel in flight, its trip keys
  int slices;  // [2P + 2][32] pipelined: column, code, syndrome, free-row slices
  int slots;   // [S][nwarps][2] panel kernel: a candidate key and word per warp
  int qs;      // [P][W] pivot rows Q_t (P > 1)
  int state;   // [m] pivot column | code << 23 | syndrome bit << 31
  int rowoff;  // [m] pipelined: the row's code times W, its offset in the table
  int ht;      // [W][mp] the lane
  int table;   // [2^P][W] (P > 1)
  int bpw;     // [W] OSD-0: packed bp_err, if it fits
  int total;
};

// One warp holds 32 chunks of 32 rows in its registers, and a table is needed.
__host__ __device__ constexpr bool is_pipelined(int m, int P) { return P > 1 && m <= 1024; }

__host__ __device__ inline Layout layout(int W, int m, int mp, int P, int nwarps, bool bp_bits) {
  const bool pipelined = is_pipelined(m, P);
  Layout l;
  int o = 0;
  l.ctrl = o, o += pipelined ? 16 : 0;
  l.slices = o, o += pipelined ? 32 * (2 * P + 2) : 0;
  l.slots = o, o += pipelined ? 0 : round4(2 * trip_slots(P) * nwarps);
  l.qs = o, o += P > 1 ? round4(P * W) : 0;
  l.state = o, o += round4(m);
  l.rowoff = o, o += pipelined ? round4(m) : 0;
  l.ht = o, o += W * mp;
  l.table = o, o += P > 1 ? (W << P) : 0;
  l.bpw = o, o += bp_bits ? W : 0;
  l.total = o;
  return l;
}

// The lane and its state into shared memory; OSD-0's bp_err packed.
template <bool OSD0>
__device__ inline void copy_in(const uint32_t* __restrict__ ht_in,
                               const uint32_t* __restrict__ s_in,
                               const int32_t* __restrict__ bp, uint32_t* ht, uint32_t* state,
                               uint32_t* bpw, int W, int m, int mp, int n, int bp_bits) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t lane_off = (size_t)blockIdx.x * W * m;
  for (int w = 0; w < W; ++w) {
    for (int i = tid; i < m; i += nthreads) ht[w * mp + i] = ht_in[lane_off + (size_t)w * m + i];
    if (m + tid < mp) ht[w * mp + m + tid] = 0u;  // rows of padding: never a pivot
  }
  for (int i = tid; i < round4(m); i += nthreads) {
    state[i] = (uint32_t)n |
               (i < m ? (s_in[(size_t)blockIdx.x * m + i] & 1u) << kSynShift : 0u);
  }
  if (OSD0 && bp_bits) {
    for (int w = tid >> 5; w < W; w += nthreads >> 5) {
      const int c = 32 * w + (tid & 31);
      const unsigned word = __ballot_sync(kFull, c < n && bp[(size_t)blockIdx.x * n + c] != 0);
      if ((tid & 31) == 0) bpw[w] = word;
    }
  }
}

// The results out of shared memory: OSD-0's correction (bp_err with each
// pivot column reassigned from the residual), or the RREF, the syndrome
// and the pivot map.  Ends no barrier; begins after one.
template <bool OSD0>
__device__ inline void copy_out(const uint32_t* ht, const uint32_t* state,
                                const int32_t* __restrict__ bp, uint32_t* __restrict__ ht_out,
                                uint32_t* __restrict__ s_out, int32_t* __restrict__ piv_out,
                                int32_t* __restrict__ corr, int W, int m, int mp, int n) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (OSD0) {
    const size_t col_off = (size_t)blockIdx.x * n;
    for (int c = tid; c < n; c += nthreads) corr[col_off + c] = bp[col_off + c];
    __syncthreads();
    for (int i = tid; i < m; i += nthreads) {
      const uint32_t sv = state[i];
      const uint32_t piv = sv & kPivMask;
      if (piv < (uint32_t)n) corr[col_off + piv] = (int32_t)(sv >> kSynShift);
    }
  } else {
    const size_t lane_off = (size_t)blockIdx.x * W * m;
    for (int w = 0; w < W; ++w)
      for (int i = tid; i < m; i += nthreads)
        ht_out[lane_off + (size_t)w * m + i] = ht[w * mp + i];
    for (int i = tid; i < m; i += nthreads) {
      const uint32_t sv = state[i];
      s_out[(size_t)blockIdx.x * m + i] = sv >> kSynShift;
      piv_out[(size_t)blockIdx.x * m + i] = (int32_t)(sv & kPivMask);
    }
  }
}

// (2) Every warp writes the table rows c = g * 2^L + e of its groups g.
template <int P>
__device__ inline void build_table(const uint32_t* qs, uint32_t* table, int W) {
  constexpr int L = P < 3 ? P : 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int w = lane; w < W; w += 32) {
    uint32_t q[P];
#pragma unroll
    for (int t = 0; t < P; ++t) q[t] = qs[t * W + w];
    for (int g = warp; g < (1 << (P - L)); g += nwarps) {
      uint32_t base = 0;
#pragma unroll
      for (int u = L; u < P; ++u)
        if ((g >> (u - L)) & 1) base ^= q[u];
#pragma unroll
      for (int e = 0; e < (1 << L); ++e) {
        uint32_t v = base;
#pragma unroll
        for (int u = 0; u < L; ++u)
          if ((e >> u) & 1) v ^= q[u];
        table[((g << L) | e) * W + w] = v;
      }
    }
  }
}

// (3) row ^= T[code] over the words [w_first, W) but `w_skip`, by the warps
// from `first_warp` on: a warp per 4 rows, a lane per word, 16-byte
// accesses down the column of four rows.  OFFSETS: `rows` holds each row's
// offset in the table, code * W; otherwise its state word.
template <bool OFFSETS>
__device__ inline void apply_table(uint32_t* ht, const uint32_t* rows, const uint32_t* table,
                                   int W, int m, int mp, int w_first, int w_skip,
                                   int first_warp) {
  // beside warp 0's trips (first_warp 1) the warps of its scheduler, warps
  // 4, 8, ..., stay out: the trips keep their pace
  const int lane = threadIdx.x & 31, all = blockDim.x >> 5, me = threadIdx.x >> 5;
  const int warp = first_warp == 0 ? me : (me % 4 != 0 ? me - 1 - (me >> 2) : -1);
  const int nwarps = first_warp == 0 ? all : (all - 1) - ((all - 1) >> 2);
  if (warp < 0) return;
  for (int w = w_first + lane; w < W; w += 32) {
    if (w == w_skip) continue;
    uint32_t* col = ht + w * mp;
    const uint32_t* tw = table + w;
    for (int i = 4 * warp; i < round4(m); i += 4 * nwarps) {
      const uint4 a = *reinterpret_cast<const uint4*>(rows + i);
      uint4 x = *reinterpret_cast<uint4*>(col + i);
      if (OFFSETS) {
        x.x ^= tw[a.x], x.y ^= tw[a.y], x.z ^= tw[a.z], x.w ^= tw[a.w];
      } else {
        x.x ^= tw[((a.x & kCodeMask) >> kCodeShift) * W];
        x.y ^= tw[((a.y & kCodeMask) >> kCodeShift) * W];
        x.z ^= tw[((a.z & kCodeMask) >> kCodeShift) * W];
        x.w ^= tw[((a.w & kCodeMask) >> kCodeShift) * W];
      }
      *reinterpret_cast<uint4*>(col + i) = x;
    }
  }
}

// Phase clocks, compiled in with -DLDPC_GF2_PHASE_CLOCKS only: block 0 of
// the last launch leaves five numbers for ldpc_gf2_phase_clocks: a, b, c,
// the whole elimination, the panels with a pivot.  (The clock read behind a
// barrier may issue before the wait is over: a wait can land in the next
// phase.)  Without the flag the reads are the constant 0 and fall away.
#ifdef LDPC_GF2_PHASE_CLOCKS
__device__ long long g_phase_clocks[5];
// gf2_cluster_kernel, lane 0: the leader's word q in (panel q - 1 applied,
// sliced), its trips, its codes, its waits at the cluster barrier; rank
// 1's pass and its waits; the panels; the whole elimination
__device__ long long g_cluster_clocks[8];
#define LDPC_CLOCK() clock64()
#else
#define LDPC_CLOCK() 0LL
#endif

__device__ inline void write_clocks(long long a, long long b, long long c, long long start,
                                    long long panels) {
#ifdef LDPC_GF2_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_phase_clocks[0] = a, g_phase_clocks[1] = b, g_phase_clocks[2] = c;
    g_phase_clocks[3] = clock64() - start;
    g_phase_clocks[4] = panels;
  }
#endif
}

// Warp 0's registers in the pipelined kernel: lane b holds chunk b (rows
// 32 b .. 32 b + 31, bit l = row 32 b + l).
template <int P>
struct Slices {
  uint32_t code[P];  // bit t of the rows' codes in the panel last made
  uint32_t syn;      // syndrome bits
  uint32_t fre;      // rows not yet a pivot
};

// (1) One panel's trips, by warp 0 alone.  `correct`: the raw column slices
// were cut before the last panel's apply pass, and that panel's pivots are
// still to be brought in.  Leaves the code slices, the trip keys, the
// syndrome slices and the loop state in shared memory.
template <int P, bool OSD0>
__device__ inline void make_trips(Slices<P>& r, const uint32_t* col_bits, uint32_t* code_bits,
                                  uint32_t* syn_bits, uint32_t* trip_key, uint32_t* ctl,
                                  const uint32_t* qs, const uint32_t* bpw,
                                  const int32_t* __restrict__ bp, int j0, bool correct, int rank,
                                  int W, int m, int n, int bp_bits) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < ((m + 31) >> 5);
  uint32_t X[P];
#pragma unroll
  for (int t = 0; t < P; ++t) X[t] = live ? col_bits[t * 32 + lane] : 0u;
  if (correct) {
#pragma unroll
    for (int t = 0; t < P; ++t) {
      // the bits of Q_t at this panel's columns
      const uint32_t q = qs[t * W + (j0 >> 5)] >> (j0 & 31);
#pragma unroll
      for (int u = 0; u < P; ++u) X[u] ^= r.code[t] & (0u - ((q >> u) & 1u));
    }
  }
  const uint32_t bpword = (OSD0 && bp_bits) ? bpw[j0 >> 5] : 0u;
  int pivots = 0, made = 0;
  bool done = false;  // OSD-0: this lane's answer is fixed
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int j = j0 + t;
    bool stop = made < t || j >= n || (!OSD0 && rank >= m);
    // OSD-0: residual left outside the pivot space? (at trip entry)
    if (OSD0 && !stop) done = stop = !__any_sync(kFull, (r.fre & r.syn) != 0u);
    uint32_t rows = 0u;  // the rows with bit j but the pivot row
    uint32_t key = kStop;
    if (!stop) {
      ++made;
      const uint32_t hit = X[t] & r.fre;  // free rows with bit j
      const uint32_t k = __reduce_min_sync(
          kFull, hit != 0u ? (uint32_t)(32 * lane + __ffs(hit) - 1) : kNoKey);
      key = kNoPivot;
      if (k != kNoKey) {
        const int kb = (int)(k >> 5), kl = (int)(k & 31u);
        const uint32_t own = lane == kb ? 1u << kl : 0u;
        rows = X[t] & ~own;
        const uint32_t psyn = 0u - ((__shfl_sync(kFull, r.syn, kb) >> kl) & 1u);
#pragma unroll
        for (int u = 0; u < P; ++u)
          X[u] ^= rows & (0u - ((__shfl_sync(kFull, X[u], kb) >> kl) & 1u));
        // bp_err[j] folds into every row with bit j set; on the rows that
        // are then eliminated it cancels: the pivot row alone keeps it
        uint32_t fold = 0u;
        if (OSD0) {
          fold = 0u - (bp_bits ? (bpword >> (j & 31)) & 1u
                               : (uint32_t)(bp[(size_t)blockIdx.x * n + j] != 0));
        }
        r.syn ^= (rows & psyn) ^ (own & fold);
        r.fre &= ~own;
        ++rank;
        ++pivots;
        key = k;
      }
    }
    r.code[t] = rows;
    code_bits[t * 32 + lane] = rows;
    trip_key[t] = key;  // every lane stores the same key: no branch
  }
  syn_bits[lane] = r.syn;
  ctl[0] = (uint32_t)rank;
  ctl[1] = (done ? 1u : 0u) | (pivots != 0 ? 2u : 0u);
}

template <int P, bool OSD0>
__global__ void __launch_bounds__(1024, 1)
gf2_pipelined_kernel(const uint32_t* __restrict__ ht_in, const uint32_t* __restrict__ s_in,
                     const int32_t* __restrict__ bp, uint32_t* __restrict__ ht_out,
                     uint32_t* __restrict__ s_out, int32_t* __restrict__ piv_out,
                     int32_t* __restrict__ corr, int W, int m,
                     int mp, int n, int bp_bits) {
  static_assert(P > 1, "the pipelined kernel needs a table");
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const Layout l = layout(W, m, mp, P, nwarps, bp_bits != 0);
  uint32_t* ctl = smem + l.ctrl;            // [0] rank, [1] done | pivots << 1
  uint32_t* trip_key = smem + l.ctrl + 8;   // [P] pivot row of trip t, kNoPivot or kStop
  uint32_t* col_bits = smem + l.slices;     // [P][32] column t of chunk b, raw
  uint32_t* code_bits = col_bits + 32 * P;  // [P][32] code bit t of chunk b
  uint32_t* syn_bits = code_bits + 32 * P;  // [32] syndrome bits of chunk b
  uint32_t* free_bits = syn_bits + 32;      // [32] free rows of chunk b (at the start)
  uint32_t* qs = smem + l.qs;
  uint32_t* state = smem + l.state;
  uint32_t* rowoff = smem + l.rowoff;  // [m] the row's offset in the table, code * W
  uint32_t* ht = smem + l.ht;
  uint32_t* table = smem + l.table;
  uint32_t* bpw = smem + l.bpw;
  const int chunks = (m + 31) >> 5;
  // the warps but warp 1, numbered: they share the work beside the Q rows
  const int side = warp == 0 ? 0 : warp - 1, sides = nwarps > 2 ? nwarps - 1 : 1;
  const bool on_side = warp != 1 || nwarps == 2;

  copy_in<OSD0>(ht_in, s_in, bp, ht, state, bpw, W, m, mp, n, bp_bits);
  for (int i = tid; i < round4(m); i += blockDim.x) rowoff[i] = 0u;  // and the rows of padding
  __syncthreads();

  // Chunk b's panel bits as one word per column (bit l = row 32 b + l); at
  // the start also its syndrome bits and free rows.
  auto slice_columns = [&](int j0, bool with_state) {
    const uint32_t* colw = ht + (j0 >> 5) * mp;
    for (int b = side; b < chunks && on_side; b += sides) {
      const int i = 32 * b + lane;
      const uint32_t cv = i < m ? colw[i] >> (j0 & 31) : 0u;
      uint32_t mine = 0u;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const unsigned column = __ballot_sync(kFull, (cv >> t) & 1u);
        if (lane == t) mine = column;
      }
      if (lane < P) col_bits[lane * 32 + b] = mine;
      if (with_state) {
        const uint32_t sv = i < m ? state[i] : 0u;
        const unsigned syn_b = __ballot_sync(kFull, sv >> kSynShift);
        const unsigned free_b = __ballot_sync(kFull, i < m);  // no row is a pivot yet
        if (lane == 0) syn_bits[b] = syn_b, free_bits[b] = free_b;
      }
    }
  };
  slice_columns(0, true);
  __syncthreads();

  Slices<P> r;  // warp 0's
#pragma unroll
  for (int t = 0; t < P; ++t) r.code[t] = 0u;
  r.syn = warp == 0 && lane < chunks ? syn_bits[lane] : 0u;
  r.fre = warp == 0 && lane < chunks ? free_bits[lane] : 0u;

  long long c_trips = 0, c_serial = 0, c_overlap = 0, c_panels = 0;
  const long long c_start = LDPC_CLOCK();

  int rank = 0;              // identical in every thread at the top of a panel
  bool have_table = false;   // the last panel had a pivot: its table waits to be applied
  for (int j0 = 0;; j0 += P) {
    // warp 0 makes this panel's trips while the others apply the last one
    const long long c0 = LDPC_CLOCK();
    if (warp == 0) {
      make_trips<P, OSD0>(r, col_bits, code_bits, syn_bits, trip_key, ctl, qs, bpw, bp, j0,
                          have_table, rank, W, m, n, bp_bits);
      c_trips += LDPC_CLOCK() - c0;
    } else if (have_table) {
      apply_table<true>(ht, rowoff, table, W, m, mp, OSD0 ? (j0 - P) >> 5 : 0, -1, 1);
    }
    __syncthreads();
    const long long c1 = LDPC_CLOCK();
    c_overlap += c1 - c0;
    rank = (int)ctl[0];
    const bool done = ctl[1] & 1u, pivots = ctl[1] & 2u;
    const bool next = !done && j0 + P < n && (OSD0 || rank < m);
    if (pivots) {
      ++c_panels;
      // back from bit slices: every row's code, syndrome bit and pivot column
      for (int b = side; b < chunks && on_side; b += sides) {
        const int i = 32 * b + lane;
        uint32_t code = 0u, piv = kNoKey;
#pragma unroll
        for (int t = 0; t < P; ++t) {
          code |= ((code_bits[t * 32 + b] >> lane) & 1u) << t;
          if (trip_key[t] == (uint32_t)i) piv = (uint32_t)(j0 + t);
        }
        if (i < m) {
          rowoff[i] = code * W;
          state[i] = (piv != kNoKey ? piv : state[i] & kPivMask) |
                     (((syn_bits[b] >> lane) & 1u) << kSynShift);
        }
      }
      // Q_t: the pivot row of trip t as it stood when its column was
      // reached: its words now, XOR the Q_u of its code's lower bits
      if (warp == 1 && !done) {
        uint32_t mask[P][P];  // all ones where the code of pivot t has bit u
#pragma unroll
        for (int t = 0; t < P; ++t) {
          const uint32_t k = trip_key[t] < kStop ? trip_key[t] : 0u;
#pragma unroll
          for (int u = 0; u < t; ++u)
            mask[t][u] = 0u - ((code_bits[u * 32 + (k >> 5)] >> (k & 31u)) & 1u);
        }
        for (int w = lane; w < W; w += 32) {
          uint32_t q[P];
#pragma unroll
          for (int t = 0; t < P; ++t) {
            q[t] = trip_key[t] < kStop ? ht[w * mp + trip_key[t]] : 0u;
#pragma unroll
            for (int u = 0; u < t; ++u) q[t] ^= q[u] & mask[t][u];
            qs[t * W + w] = q[t];
          }
        }
      }
    }
    if (done) break;  // OSD-0 has its answer
    if (next) slice_columns(j0 + P, false);
    if (!pivots && !next) break;
    __syncthreads();
    if (pivots) build_table<P>(qs, table, W);
    __syncthreads();
    c_serial += LDPC_CLOCK() - c1;
    have_table = pivots;
    if (!next) {
      if (pivots) apply_table<true>(ht, rowoff, table, W, m, mp, OSD0 ? j0 >> 5 : 0, -1, 0);
      break;
    }
  }
  __syncthreads();
  write_clocks(c_trips, c_serial, c_overlap, c_start, c_panels);
  copy_out<OSD0>(ht, state, bp, ht_out, s_out, piv_out, corr, W, m, mp, n);
}

__device__ inline uint32_t make_key(int row, uint32_t st) {
  return ((uint32_t)row << 9) | ((st >> (kCodeShift - 1)) & 0x1feu) | (st >> kSynShift);
}

template <int P, bool OSD0>
__global__ void __launch_bounds__(1024, 1)
gf2_panel_kernel(const uint32_t* __restrict__ ht_in, const uint32_t* __restrict__ s_in,
                 const int32_t* __restrict__ bp, uint32_t* __restrict__ ht_out,
                 uint32_t* __restrict__ s_out, int32_t* __restrict__ piv_out,
                 int32_t* __restrict__ corr, int W, int m,
                 int mp, int n, int bp_bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const Layout l = layout(W, m, mp, P, nwarps, bp_bits != 0);
  uint32_t* slot_key = smem + l.slots;                         // [S][nwarps] candidate key
  uint32_t* slot_word = slot_key + trip_slots(P) * nwarps;     // [S][nwarps] its panel word
  uint32_t* qs = smem + l.qs;
  uint32_t* state = smem + l.state;
  uint32_t* ht = smem + l.ht;
  uint32_t* table = smem + l.table;
  uint32_t* bpw = smem + l.bpw;
  const size_t col_off = (size_t)blockIdx.x * n;

  copy_in<OSD0>(ht_in, s_in, bp, ht, state, bpw, W, m, mp, n, bp_bits);
  __syncthreads();

  long long c_trips = 0, c_table = 0, c_apply = 0, c_panels = 0;
  const long long c_start = LDPC_CLOCK();

  int rank = 0;       // identical in every thread
  bool done = false;  // OSD-0: this lane's answer is fixed
  for (int j0 = 0; j0 < n && !done && (OSD0 || rank < m); j0 += P) {
    const int wd = j0 >> 5;
    uint32_t* colw = ht + wd * mp;  // the trips update the panel's word in place
    const long long c0 = LDPC_CLOCK();
    int pivots = 0, made = 0;
    const uint32_t bpword = (OSD0 && bp_bits) ? bpw[wd] : 0u;

    // (1) panel pass
#pragma unroll 1  // one copy of the trip
    for (int t = 0; t < P; ++t) {
      const int j = j0 + t;
      if (j >= n || (!OSD0 && rank >= m)) break;
      const int bit = j & 31;
      const int ts = P == 1 ? (j0 & 1) : t;  // this trip's slot
      int rem = 0;  // residual left outside the pivot space (at trip entry)
      bool found = false;  // uniform in the warp
      for (int i0 = 0; i0 < m; i0 += nthreads) {
        const int i = i0 + tid;
        uint32_t sv = i < m ? state[i] : 0u;
        if (P > 1 && t == 0 && i < m) state[i] = sv = sv & ~kCodeMask;  // the last panel's code
        const uint32_t cv = i < m ? colw[i] : 0u;
        const bool unused = i < m && (sv & kPivMask) == (uint32_t)n;
        if (OSD0) rem |= unused && (sv >> kSynShift);
        if (!found) {
          const unsigned ballot = __ballot_sync(kFull, unused && ((cv >> bit) & 1u));
          if (ballot && lane == __ffs(ballot) - 1) {
            slot_key[ts * nwarps + warp] = make_key(i, sv);
            if (P > 1) slot_word[ts * nwarps + warp] = cv;
          }
          found = ballot != 0;
        }
      }
      if (!found && lane == 0) slot_key[ts * nwarps + warp] = kNoKey;
      if (OSD0) {
        if (!__syncthreads_or(rem)) {
          done = true;
          break;
        }
      } else {
        __syncthreads();
      }
      ++made;
      // the least key is the first row: rows differ between warps
      const uint32_t key =
          __reduce_min_sync(kFull, lane < nwarps ? slot_key[ts * nwarps + lane] : kNoKey);
      if (key != kNoKey) {
        const int k = (int)(key >> 9);
        const uint32_t code = (key >> 1) & 0xffu;
        const uint32_t pw =
            P > 1 ? slot_word[ts * nwarps + ((k < nthreads ? k : k % nthreads) >> 5)] : 0u;
        // bp_err[j] folds into every row with bit j set; on the rows that
        // are then eliminated it cancels: the pivot row alone keeps it
        uint32_t fold = 0u;
        if (OSD0) {
          fold = (bp_bits ? (bpword >> bit) & 1u : (uint32_t)(bp[col_off + j] != 0))
                 << kSynShift;
        }
        const uint32_t mark =
            ((key & 1u) << kSynShift) | (P > 1 ? 1u << (kCodeShift + t) : 0u);
        for (int i = tid; i < m; i += nthreads) {
          if (i == k) {
            state[i] = ((state[i] & ~kPivMask) | (uint32_t)j) ^ fold;
          } else if ((colw[i] >> bit) & 1u) {
            state[i] ^= mark;
            if (P > 1) {
              colw[i] ^= pw;
            } else {
              // no table: the row takes the pivot row itself, in every word
              // it still needs, now.  A thread reads and writes its own
              // rows alone, here and in the trip, but for the pivot row,
              // which no one writes between two trips' barriers
#pragma unroll 4
              for (int w = OSD0 ? wd : 0; w < W; ++w) ht[w * mp + i] ^= ht[w * mp + k];
            }
          }
        }
        // Q_t: the pivot row as it stands now, in the other words
        if (P > 1 && warp == 0) {
          for (int w = lane; w < W; w += 32) {
            uint32_t q = ht[w * mp + k];
            for (int u = 0; u < t; ++u)
              if ((code >> u) & 1u) q ^= qs[u * W + w];
            qs[t * W + w] = q;
          }
        }
        ++rank;
        ++pivots;
      } else if (P > 1 && warp == 0) {
        for (int w = lane; w < W; w += 32) qs[t * W + w] = 0u;
      }
    }
    const long long c1 = LDPC_CLOCK();
    c_trips += c1 - c0;
    if (P == 1 || done || pivots == 0) continue;  // nothing to apply
    ++c_panels;
    if (warp == 0) {
      for (int t = made; t < P; ++t)
        for (int w = lane; w < W; w += 32) qs[t * W + w] = 0u;
    }
    __syncthreads();

    // (2) table, (3) apply; the trips brought the panel's own word up to date
    build_table<P>(qs, table, W);
    __syncthreads();
    const long long c2 = LDPC_CLOCK();
    c_table += c2 - c1;
    apply_table<false>(ht, state, table, W, m, mp, OSD0 ? wd + 1 : 0, wd, 0);
    __syncthreads();
    c_apply += LDPC_CLOCK() - c2;
  }
  __syncthreads();
  write_clocks(c_trips, c_table, c_apply, c_start, c_panels);
  copy_out<OSD0>(ht, state, bp, ht_out, s_out, piv_out, corr, W, m, mp, n);
}

// ---------------------------------------------------------------------------
// gf2_cluster_kernel: a lane past a block.  Where plan() finds no layout in
// shared memory (panel 0: the lane alone, W * m words, is larger than a
// block's 232,448 bytes, e.g. [75, 1200] for the (2400, 6, 3) code or the
// [989, 864] lane of the bb144 R=6 DEM), the lane stays in device memory:
// `work` holds it (K2: the output Ht' itself; K1: a workspace the wrapper
// allocates, with one pivot word a row beside it).  The column trips are the
// plain forms' exactly (ops/gf2.py gf2_osd0 / gf2_eliminate): the pivot of
// column j is the first unused row with bit j; OSD-0 stops at the first
// column at whose entry no residual is left outside the pivot space, and its
// bp_err[j] stays on the pivot row alone.
//
// A thread-block cluster of C CTAs (2, 4 or 8) takes a lane, by panels of
// 32 columns: panel q is word q of every row.
//   * CTA 0, the leader, makes the trips.  Word q of every row is brought
//     into its shared memory as 32 bit slices (slice t, chunk c: bit l is
//     bit t of row 32 c + l) with panel q - 1 applied on the way in, and
//     warp 0 makes the panel's 32 trips on the slices alone: no device
//     memory and no block barrier inside a trip.  A trip brings its column
//     up to date (the XOR of the rows listed by the earlier trips whose
//     pivot had its bit), takes a warp reduction for the first free row
//     with the bit, reads the pivot's bits (two ballots), and stores the
//     listed rows; the free rows and the syndrome bits stay as slices across
//     panels.  The rows listed in trip t replace slice t (the slice itself
//     is then known: the pivot's bit alone), and M[t], the pivot row of
//     trip t as it stood then in terms of
//     the panel's pivot rows at its start (bit v: row k_v), is M[t] = e_t ^
//     XOR of M[u] over the earlier trips u whose pivot was XORed into it (a
//     ballot and a warp XOR reduction).  After the trips every row's code is
//     XOR of M[t] over the trips t that listed it: the row is then its start
//     XOR the starts of the pivot rows in its code, in every later word.
//   * The other C - 1 CTAs apply the panel: each takes every (C - 1)-th word
//     past the next panel's, copies the codes and pivot rows from the
//     leader's shared memory (distributed shared memory), and for up to 32
//     words at a time reads the 32 pivot rows' words, builds eight 16-entry
//     XOR tables a word (four columns each: the Four Russians method), and
//     rewrites the rows whose code is not 0 in the words where a pivot row
//     is not 0, 16 words in flight a thread.
//     Meanwhile the leader applies the panel to the next panel's word itself
//     as it slices it, and makes that panel's trips: the trips of panel q + 1
//     overlap the pass of panel q.  One cluster barrier a panel; the codes,
//     pivot rows and loop flags are double-buffered by panel parity.
// The words before the panel's are zero in every pivot row (every earlier
// column either had a pivot, whose trip cleared that bit in every other
// row, or had no unused row with the bit), so no pass touches them.
// What bounds it on the H100 (the phase clocks of -DLDPC_GF2_PHASE_CLOCKS,
// g_cluster_clocks): the leader's trips, 0.4-1.9 thousand SM clocks a trip,
// chains of dependent shared-memory loads (the column and the pivot's later
// bits brought up to date from the earlier trips' listed rows, one load a
// trip each); and the appliers' pass, bound by the latency of device memory
// or L2 at 16 words in flight a thread.  At the (2400, 6, 3) lane with 2
// CTAs the two take about as long, 40-60 thousand clocks a panel each; at
// the DEM lane with 8 the leader's trips, word and codes set the pace.  The
// launcher takes the largest C (of 8, 4, 2) whose clusters, by
// cudaOccupancyMaxActiveClusters, hold all B lanes at once: few lanes (the
// DEM's 16) spread their passes over 7 CTAs, many (256 of the (2400, 6, 3)
// code) fill the card with pairs.
constexpr int kClusterThreads = 512;
constexpr int kTileWords = 32;  // words a CTA's XOR tables cover at once

// Chunks of 32 rows, at an odd stride: lanes reading slice `lane` of one
// chunk meet no bank conflict.
__host__ __device__ inline int chunk_stride(int m) { return ((m + 31) / 32) | 1; }

// Shared memory of gf2_cluster_kernel, in 32-bit words.  The leader's
// (loop flags, pivot rows, M, its word's starts and tables, slices, free
// rows, syndrome bits, codes) and an applier's (codes, pivot rows, starts
// and tables of a tile of words) share the buffer; the appliers read the
// leader's at these offsets.
struct ClusterLayout {
  int ctl, keys, msh, st, tab, x, f, y, codes;  // the leader
  int acodes, akeys, alive, ast, atab;          // an applier
  int mr, cs, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int m) {
  ClusterLayout l;
  l.mr = round4(m);
  l.cs = chunk_stride(m);
  int o = 0;
  l.ctl = o, o += 8;     // [2][4] per parity: pivots made, more panels
  l.keys = o, o += 64;   // [2][32] pivot row of trip t, kNoKey where none
  l.msh = o, o += 32;    // [32] M[t]
  l.st = o, o += 32;     // [32] the pivot rows' starts in the next panel's word
  l.tab = o, o += 128;   // [8][16] their nibble tables
  l.x = o, o += round4(32 * l.cs);  // [32][cs] slices
  l.f = o, o += round4(l.cs);       // [cs] free rows
  l.y = o, o += round4(l.cs);       // [cs] syndrome bits
  l.codes = o, o += 2 * l.mr;       // [2][mr] codes by panel parity
  const int leader = o;
  o = 0;
  l.acodes = o, o += l.mr;
  l.akeys = o, o += 32;
  l.alive = o, o += 4;
  l.ast = o, o += 32 * kTileWords;
  l.atab = o, o += 128 * kTileWords;
  l.total = leader > o ? leader : o;
  return l;
}

// XOR of the starts named by a code, from its eight nibble tables.
__device__ inline uint32_t lookup(const uint32_t* tab, uint32_t code) {
  uint32_t x = 0u;
#pragma unroll
  for (int g = 0; g < 8; ++g) x ^= tab[g * 16 + ((code >> (4 * g)) & 15u)];
  return x;
}

// Entry e of the tables [words][8][16] from starts [words][32].
__device__ inline uint32_t table_entry(const uint32_t* st, int e) {
  const uint32_t* s = st + (e >> 7) * 32 + 4 * ((e >> 4) & 7);
  const int x = e & 15;
  return ((x & 1) ? s[0] : 0u) ^ ((x & 2) ? s[1] : 0u) ^ ((x & 4) ? s[2] : 0u) ^
         ((x & 8) ? s[3] : 0u);
}

// XOR of p[u * stride] over the bits u of `set`.  (Unrolled into 32
// predicated loads, or four loads a round, it took the trips as long or
// longer on the H100.)
__device__ inline uint32_t xor_of(const uint32_t* p, int stride, uint32_t set) {
  uint32_t x = 0u;
  for (uint32_t rest = set; rest != 0u; rest &= rest - 1u) x ^= p[(__ffs(rest) - 1) * stride];
  return x;
}

// Panel q's trips, by warp 0 of the leader alone, on the slices X.  A
// column is brought up to date when its trip reaches it, from the trips
// before whose pivot had its bit: lane u keeps that set of trips (bmask) and
// reads their listed rows, which replace the slice of each trip with a
// pivot; so a trip loads, XORs and stores no other column.  Leaves in X the
// listed rows of each trip with a pivot and the current column of every
// other trip, the pivot rows in keys, M in msh and the flags in ctl ([0]
// pivots made, [1] more panels).
template <bool OSD0>
__device__ inline void cluster_trips(uint32_t* X, uint32_t* F, uint32_t* Y, uint32_t* keys,
                                     uint32_t* msh, uint32_t* ctl, int32_t* __restrict__ piv,
                                     const int32_t* __restrict__ bp, int q, int& rank, int cs,
                                     int m, int n) {
  const int lane = threadIdx.x & 31;
  const int chunks = (m + 31) >> 5;
  keys[lane] = kNoKey;
  uint32_t mreg = 0u, found = 0u;
  uint32_t bmask = 0u;  // lane u: the trips before u whose pivot had bit u
  bool done = false;    // OSD-0: this lane's answer is fixed
  // OSD-0: the panel's bp_err bits, read once (not a device-memory load a trip)
  const int jl = 32 * q + lane;
  const uint32_t bpbits = OSD0 ? __ballot_sync(kFull, jl < n && bp[jl] != 0) : 0u;
  int t = 0;
  for (; t < 32; ++t) {
    const int j = 32 * q + t;
    if (j >= n || (!OSD0 && rank >= m)) break;  // uniform
    __syncwarp();  // the last trip's writes, before this trip's reads
    if (OSD0) {  // residual left outside the pivot space? (at trip entry)
      bool rem = false;
      for (int c = lane; c < chunks; c += 32) rem |= (F[c] & Y[c]) != 0u;
      if (!__any_sync(kFull, rem)) {
        done = true;
        break;
      }
    }
    // column t brought up to date on this lane's chunks, and its first free
    // row with the bit (chunks ascend along a lane: its first hit is its least)
    const uint32_t bt = __shfl_sync(kFull, bmask, t);
    uint32_t best = kNoKey;
    for (int c = lane; c < chunks; c += 32) {
      uint32_t x = X[t * cs + c];
      x ^= xor_of(X + c, cs, bt);
      X[t * cs + c] = x;
      const uint32_t h = x & F[c];
      if (h != 0u && best == kNoKey) best = 32u * (uint32_t)c + (uint32_t)(__ffs(h) - 1);
    }
    const uint32_t k = __reduce_min_sync(kFull, best);
    if (k == kNoKey) continue;  // no free row has bit j
    const int kc = (int)(k >> 5);
    const uint32_t kbit = 1u << (k & 31u);
    // the pivot's bits: of the later columns (up to date through bmask),
    // and of the earlier trips that were XORed into it (their listed rows)
    uint32_t xv = X[lane * cs + kc];
    if (lane > t) xv ^= xor_of(X + kc, cs, bmask);
    const bool v = (xv & kbit) != 0u;
    const bool psyn = (Y[kc] & kbit) != 0u;
    const uint32_t pw = __ballot_sync(kFull, v && lane > t);
    const uint32_t lc = __ballot_sync(kFull, v && lane < t && ((found >> lane) & 1u));
    const uint32_t mt = (1u << t) ^ __reduce_xor_sync(kFull, ((lc >> lane) & 1u) ? mreg : 0u);
    if (lane == t) mreg = mt;
    if ((pw >> lane) & 1u) bmask |= 1u << t;
    __syncwarp();  // every read of the pivot's chunk before its writes
    for (int c = lane; c < chunks; c += 32) {
      const bool own = c == kc;
      const uint32_t r = X[t * cs + c] & ~(own ? kbit : 0u);
      X[t * cs + c] = r;
      uint32_t y = Y[c] ^ (psyn ? r : 0u);
      if (own) {
        // bp_err[j] folds into every row with bit j set; on the rows that
        // are then eliminated it cancels: the pivot row alone keeps it
        if (OSD0 && ((bpbits >> t) & 1u)) y ^= kbit;
        F[c] &= ~kbit;
        piv[k] = j;
        keys[t] = k;
      }
      Y[c] = y;
    }
    ++rank;
    found |= 1u << t;
  }
  __syncwarp();
  if (!OSD0) {
    // K2's word: the columns past the last trip made, brought up to date
    for (int c = 0; c < chunks && lane >= t; ++c) X[lane * cs + c] ^= xor_of(X + c, cs, bmask);
  }
  msh[lane] = mreg;
  if (lane == 0) {
    ctl[0] = found != 0u;
    ctl[1] = !done && 32 * (q + 1) < n && (OSD0 || rank < m);
  }
}

template <bool OSD0>
__global__ void __launch_bounds__(kClusterThreads, 2)
gf2_cluster_kernel(const uint32_t* __restrict__ ht_in, const uint32_t* __restrict__ s_in,
                   const int32_t* __restrict__ bp, uint32_t* __restrict__ work,
                   uint32_t* __restrict__ s_out, int32_t* __restrict__ piv_out,
                   int32_t* __restrict__ corr, int W, int m, int n) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int napply = csize - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const size_t b = blockIdx.x / csize;
  const ClusterLayout L = cluster_layout(m);
  const int cs = L.cs, mr = L.mr, chunks = (m + 31) >> 5;
  uint32_t* ht = work + b * W * m;
  int32_t* piv = piv_out + b * m;
  const int32_t* bp_lane = OSD0 ? bp + b * n : nullptr;
  const uint32_t* lead = cluster.map_shared_rank(smem, 0);  // the leader's buffer

  // the lane into the workspace, spread over the cluster
  const size_t lane_words = (size_t)W * m;
  for (size_t e = (size_t)crank * nthreads + tid; e < lane_words; e += (size_t)csize * nthreads)
    ht[e] = ht_in[b * lane_words + e];
  uint32_t *X = smem + L.x, *F = smem + L.f, *Y = smem + L.y;
  if (crank == 0) {
    for (int c = warp; c < chunks; c += nwarps) {
      const int i = 32 * c + lane;
      const unsigned f = __ballot_sync(kFull, i < m);  // no row is a pivot yet
      const unsigned y = __ballot_sync(kFull, i < m && (s_in[b * m + i] & 1u));
      if (lane == 0) F[c] = f, Y[c] = y;
    }
    for (int i = tid; i < m; i += nthreads) piv[i] = n;
  }
  cluster.sync();

  int rank = 0;  // warp 0 of the leader: pivots made
  bool apply_prev = false, trips = true;
  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long c_start = LDPC_CLOCK();
  for (int q = 0;; ++q) {
    const int par = q & 1, prev = par ^ 1;
    const long long c0 = LDPC_CLOCK();
    long long c1 = c0, c2 = c0;
    if (crank == 0) {
      uint32_t* st = smem + L.st;
      uint32_t* tab = smem + L.tab;
      const uint32_t* codes_prev = smem + L.codes + prev * mr;
      if (apply_prev && q < W) {  // the starts of panel q - 1's pivot rows in word q
        if (tid < 32) {
          const uint32_t k = smem[L.keys + prev * 32 + tid];
          st[tid] = k != kNoKey ? ht[(size_t)q * m + k] : 0u;
        }
        __syncthreads();
        for (int e = tid; e < 128; e += nthreads) tab[e] = table_entry(st, e);
        __syncthreads();
      }
      if (trips) {
        // word q, panel q - 1 applied, into slices
        for (int c = warp; c < chunks; c += nwarps) {
          const int i = 32 * c + lane;
          uint32_t v = 0u;
          if (i < m) {
            v = ht[(size_t)q * m + i];
            if (apply_prev) v ^= lookup(tab, codes_prev[i]);
          }
          uint32_t x = 0u;
#pragma unroll 8
          for (int t = 0; t < 32; ++t) {
            const unsigned bits = __ballot_sync(kFull, (v >> t) & 1u);
            if (lane == t) x = bits;
          }
          X[lane * cs + c] = x;
        }
        __syncthreads();
        c1 = LDPC_CLOCK();
        if (warp == 0)
          cluster_trips<OSD0>(X, F, Y, smem + L.keys + par * 32, smem + L.msh,
                              smem + L.ctl + par * 4, piv, bp_lane, q, rank, cs, m, n);
        __syncthreads();
        c2 = LDPC_CLOCK();
        // every row's code (rows listed by a trip with a pivot, through M),
        // and K2's word q (the trip's pivot alone in its column, or the slice)
        const uint32_t* keys = smem + L.keys + par * 32;
        const uint32_t* msh = smem + L.msh;
        uint32_t* codes = smem + L.codes + par * mr;
        const bool pivots = smem[L.ctl + par * 4] != 0u;
        if (pivots || !OSD0) {
          for (int c = warp; c < chunks; c += nwarps) {
            const uint32_t kt = keys[lane];
            const bool ft = kt != kNoKey;
            const uint32_t xv = X[lane * cs + c];
            const uint32_t z = ft ? xv : 0u;
            const uint32_t y = ft ? ((int)(kt >> 5) == c ? 1u << (kt & 31u) : 0u) : xv;
            uint32_t code = 0u, word = 0u;
#pragma unroll 8
            for (int r = 0; r < 32; ++r) {
              const unsigned bz = __ballot_sync(kFull, (z >> r) & 1u);
              if (lane == r) code = bz;
              if (!OSD0) {
                const unsigned by = __ballot_sync(kFull, (y >> r) & 1u);
                if (lane == r) word = by;
              }
            }
            const uint32_t cp = xor_of(msh, 1, code);
            const int i = 32 * c + lane;
            if (i < m) {
              codes[i] = cp;
              if (!OSD0) ht[(size_t)q * m + i] = word;
            }
          }
        }
      } else {
        // K2 only: no more trips; the last panel into word q
        if (apply_prev && q < W) {
          for (int i = tid; i < m; i += nthreads) {
            const uint32_t cp = codes_prev[i];
            if (cp != 0u) ht[(size_t)q * m + i] ^= lookup(tab, cp);
          }
        }
        if (tid == 0) smem[L.ctl + par * 4] = 0u, smem[L.ctl + par * 4 + 1] = 0u;
      }
    } else if (apply_prev) {
      // panel q - 1 into this CTA's words past word q: the words w with
      // w % (C - 1) == rank - 1, up to kTileWords at a time
      uint32_t* codes = smem + L.acodes;
      uint32_t* keys = smem + L.akeys;
      uint32_t* st = smem + L.ast;
      uint32_t* tab = smem + L.atab;
      const uint32_t* lcodes = lead + L.codes + prev * mr;
      for (int i = tid; i < m; i += nthreads) codes[i] = lcodes[i];
      if (tid < 32) keys[tid] = lead[L.keys + prev * 32 + tid];
      __syncthreads();
      uint32_t* live = smem + L.alive;  // [1] the tile's words with a nonzero start
      const int r = crank - 1, first = q + 1;
      const int w0 = first + ((r - first % napply) % napply + napply) % napply;
      for (int wt = w0; wt < W; wt += napply * kTileWords) {
        const int nw = min(kTileWords, (W - wt + napply - 1) / napply);
        if (tid == 0) *live = 0u;
        for (int e = tid; e < 32 * nw; e += nthreads) {
          const uint32_t k = keys[e & 31];
          st[e] = k != kNoKey ? ht[(size_t)(wt + (e >> 5) * napply) * m + k] : 0u;
        }
        __syncthreads();
        // a word whose pivot rows are all zero there changes no row
        for (int wl = warp; wl < nw; wl += nwarps)
          if (__any_sync(kFull, st[wl * 32 + lane] != 0u) && lane == 0) atomicOr(live, 1u << wl);
        for (int e = tid; e < 128 * nw; e += nthreads) tab[e] = table_entry(st, e);
        __syncthreads();
        const uint32_t words = *live;
        for (int i = tid; i < m && words != 0u; i += nthreads) {
          const uint32_t cp = codes[i];
          if (cp == 0u) continue;  // no pivot row was XORed into row i
          uint32_t* col = ht + (size_t)wt * m + i;
          const size_t stride = (size_t)napply * m;
#pragma unroll
          for (int half = 0; half < kTileWords; half += kTileWords / 2) {
            uint32_t x[kTileWords / 2];
#pragma unroll
            for (int u = 0; u < kTileWords / 2; ++u)
              if ((words >> (half + u)) & 1u) x[u] = col[(half + u) * stride];
#pragma unroll
            for (int u = 0; u < kTileWords / 2; ++u)
              if ((words >> (half + u)) & 1u)
                col[(half + u) * stride] = x[u] ^ lookup(tab + (half + u) * 128, cp);
          }
        }
        __syncthreads();
      }
    }
    const long long c3 = LDPC_CLOCK();
    cluster.sync();
    const long long c4 = LDPC_CLOCK();
    if (crank == 0) clk[0] += c1 - c0, clk[1] += c2 - c1, clk[2] += c3 - c2, clk[3] += c4 - c3;
    if (crank == 1) clk[4] += c3 - c0, clk[5] += c4 - c3;
    ++clk[6];
    const bool pivots = lead[L.ctl + par * 4] != 0u, more = lead[L.ctl + par * 4 + 1] != 0u;
    if ((OSD0 && !more) || (!pivots && !more)) break;  // uniform over the cluster
    apply_prev = pivots;
    trips = more;
  }

  if (crank == 0) {
    if (OSD0) {
      const size_t col_off = b * n;
      for (int c = tid; c < n; c += nthreads) corr[col_off + c] = bp[col_off + c];
      __syncthreads();
      for (int i = tid; i < m; i += nthreads) {
        const int p = piv[i];
        if (p < n) corr[col_off + p] = (int32_t)((Y[i >> 5] >> (i & 31)) & 1u);
      }
    } else {
      for (int i = tid; i < m; i += nthreads) s_out[b * m + i] = (Y[i >> 5] >> (i & 31)) & 1u;
    }
  }
#ifdef LDPC_GF2_PHASE_CLOCKS
  if (b == 0 && crank <= 1 && tid == 0) {
    for (int e = 4 * crank; e < (crank == 0 ? 4 : 7); ++e) g_cluster_clocks[e] = clk[e];
    if (crank == 0) g_cluster_clocks[7] = LDPC_CLOCK() - c_start;
  }
#endif
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

size_t cluster_smem_bytes(int m) { return 4 * (size_t)cluster_layout(m).total; }

// Clusters of size csize that the card holds at once for this kernel.
template <bool OSD0>
int active_clusters(int csize, size_t bytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.attrs = &attr, cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, gf2_cluster_kernel<OSD0>, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// The largest cluster of 8, 4, 2 CTAs whose clusters hold all B lanes at
// once (2 where none does); 0 on an error.  out: the size, the clusters
// the card holds of it.
template <bool OSD0>
int pick_cluster(int B, size_t bytes, int* active) {
  for (int csize = 8; csize >= 2; csize >>= 1) {
    const int a = active_clusters<OSD0>(csize, bytes);
    if (a < 0) return 0;
    *active = a;
    if (a >= B || csize == 2) return csize;
  }
  return 2;
}

template <bool OSD0>
cudaError_t launch_cluster(const void* ht_in, const void* s_in, const void* bp, void* work,
                           void* s_out, void* piv_out, void* corr, int B, int W, int m, int n,
                           int csize, void* stream) {
  if ((uint32_t)n > kPivMask || m < 1 || W != (n + 31) / 32) return cudaErrorInvalidValue;
  const size_t bytes = cluster_smem_bytes(m);
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gf2_cluster_kernel<OSD0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int active = 0;
  if (csize == 0) csize = pick_cluster<OSD0>(B, bytes, &active);
  if (csize != 2 && csize != 4 && csize != 8) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)csize);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.attrs = &attr, cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gf2_cluster_kernel<OSD0>, static_cast<const uint32_t*>(ht_in),
                           static_cast<const uint32_t*>(s_in), static_cast<const int32_t*>(bp),
                           static_cast<uint32_t*>(work), static_cast<uint32_t*>(s_out),
                           static_cast<int32_t*>(piv_out), static_cast<int32_t*>(corr), W, m, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Plan {
  int panel;     // 0: the lane does not fit
  bool pad;      // row stride padded against bank conflicts
  bool bp_bits;  // OSD-0: bp_err packed into shared memory
  size_t bytes;
};

size_t smem_bytes(int W, int m, int P, bool pad, bool bp_bits) {
  return 4 * (size_t)layout(W, m, row_stride(m, pad), P, block_threads(m) / 32, bp_bits).total;
}

// The widest panel whose table fits beside the padded lane; without room
// for that even at P = 1, the bare lane with P = 1.
Plan plan(int W, int m, bool osd0, int max_panel) {
  for (int P = max_panel; P >= 1; P >>= 1) {
    const size_t bytes = smem_bytes(W, m, P, true, osd0);
    if (bytes <= kMaxSmemBytes) return {P, true, osd0, bytes};
  }
  const size_t bytes = smem_bytes(W, m, 1, false, false);
  return {bytes <= kMaxSmemBytes ? 1 : 0, false, false, bytes};
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Plan& p, const void* ht_in, const void* s_in,
                   const void* bp, void* ht_out, void* s_out, void* piv_out, void* corr, int B, int W, int m, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, block_threads(m), p.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ht_in), static_cast<const uint32_t*>(s_in),
      static_cast<const int32_t*>(bp), static_cast<uint32_t*>(ht_out),
      static_cast<uint32_t*>(s_out), static_cast<int32_t*>(piv_out),
      static_cast<int32_t*>(corr), W, m, row_stride(m, p.pad), n, (int)p.bp_bits);
  return cudaGetLastError();
}

template <bool OSD0>
cudaError_t dispatch(int max_panel, const void* ht_in, const void* s_in, const void* bp,
                     void* ht_out, void* s_out, void* piv_out, void* corr, int B, int W, int m,
                     int n, void* stream) {
  if ((uint32_t)n > kPivMask || m < 1 || W != (n + 31) / 32) return cudaErrorInvalidValue;
  const Plan p = plan(W, m, OSD0, max_panel);
  const bool pipelined = is_pipelined(m, p.panel);  // every plan with P > 1 is padded
#define LDPC_GF2_LAUNCH(KERNEL) \
  return launch(KERNEL, p, ht_in, s_in, bp, ht_out, s_out, piv_out, corr, B, W, m, n, stream)
  switch (p.panel) {
    case 8:
      if (pipelined) LDPC_GF2_LAUNCH((gf2_pipelined_kernel<8, OSD0>));
      LDPC_GF2_LAUNCH((gf2_panel_kernel<8, OSD0>));
    case 4:
      if (pipelined) LDPC_GF2_LAUNCH((gf2_pipelined_kernel<4, OSD0>));
      LDPC_GF2_LAUNCH((gf2_panel_kernel<4, OSD0>));
    case 2:
      if (pipelined) LDPC_GF2_LAUNCH((gf2_pipelined_kernel<2, OSD0>));
      LDPC_GF2_LAUNCH((gf2_panel_kernel<2, OSD0>));
    case 1:
      LDPC_GF2_LAUNCH((gf2_panel_kernel<1, OSD0>));
    default:
      return cudaErrorInvalidValue;  // the lane does not fit a block
  }
#undef LDPC_GF2_LAUNCH
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// max_panel (8, 4, 2 or 1) caps the panel width; the launcher narrows it
// further where the table does not fit.
int ldpc_gf2_eliminate(const void* ht_in, const void* s_in, void* ht_out, void* s_out,
                       void* piv_out, int B, int W, int m, int n, int max_panel, void* stream) {
  return dispatch<false>(max_panel, ht_in, s_in, nullptr, ht_out, s_out, piv_out, nullptr, B, W,
                         m, n, stream);
}

int ldpc_gf2_osd0(const void* ht_in, const void* resid, const void* bp, void* corr, int B,
                  int W, int m, int n, int max_panel, void* stream) {
  return dispatch<true>(max_panel, ht_in, resid, bp, nullptr, nullptr, nullptr, corr, B, W, m,
                        n, stream);
}

// Lanes past a block (ops/cuda_gf2.py routes here where launch_plan finds
// panel 0): the lane in device memory, a cluster of `cluster` CTAs a lane
// (0: the launcher's choice).  The elimination works in ht_out; OSD-0 in
// `work`, B lanes of W * m words, with the pivot columns in `piv_work`,
// B lanes of m words.
int ldpc_gf2_eliminate_cluster(const void* ht_in, const void* s_in, void* ht_out, void* s_out,
                               void* piv_out, int B, int W, int m, int n, int cluster,
                               void* stream) {
  return launch_cluster<false>(ht_in, s_in, nullptr, ht_out, s_out, piv_out, nullptr, B, W, m,
                               n, cluster, stream);
}

int ldpc_gf2_osd0_cluster(const void* ht_in, const void* resid, const void* bp, void* corr,
                          void* work, void* piv_work, int B, int W, int m, int n, int cluster,
                          void* stream) {
  return launch_cluster<true>(ht_in, resid, bp, work, nullptr, piv_work, corr, B, W, m, n,
                              cluster, stream);
}

// What the launcher takes for B lanes of m rows in the cluster body: out[0]
// the CTAs of a cluster, out[1] the bytes of dynamic shared memory, out[2]
// the clusters of that size the card holds at once.  Returns the
// cudaError_t of the queries (the current device's).
int ldpc_gf2_cluster_plan(int B, int m, int osd0, int* out) {
  const size_t bytes = cluster_smem_bytes(m);
  out[0] = 0, out[1] = (int)bytes, out[2] = 0;
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = osd0 ? cudaFuncSetAttribute(gf2_cluster_kernel<true>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)bytes)
                         : cudaFuncSetAttribute(gf2_cluster_kernel<false>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = osd0 ? pick_cluster<true>(B, bytes, &out[2]) : pick_cluster<false>(B, bytes, &out[2]);
  return out[0] == 0 ? (int)cudaGetLastError() : 0;
}

// What the launcher takes for a [W, m] lane: out[0] the panel width (0: the
// lane fits no block), out[1] the bytes of dynamic shared memory, out[2]
// whether the row stride is padded, out[3] whether OSD-0's bp_err is packed
// into shared memory.
void ldpc_gf2_plan(int W, int m, int osd0, int max_panel, int* out) {
  const Plan p = plan(W, m, osd0 != 0, max_panel);
  out[0] = p.panel, out[1] = (int)p.bytes, out[2] = (int)p.pad, out[3] = (int)p.bp_bits;
}

#ifdef LDPC_GF2_PHASE_CLOCKS
// Block 0's clocks of the last elimination on the current device, after a
// synchronization.  Pipelined kernel: warp 0 in its trips, the stretches
// behind barriers (codes, Q rows, table), the overlapped stretches (trips
// beside the apply pass), the whole elimination, the panels that had a
// pivot.  Panel kernel: trips, table, apply pass, whole, panels (P = 1:
// all is trips).
int ldpc_gf2_phase_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
}

// The cluster body's clocks of lane 0 (g_cluster_clocks above), 8 numbers.
int ldpc_gf2_cluster_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cluster_clocks, sizeof(g_cluster_clocks));
}
#endif

}  // extern "C"
