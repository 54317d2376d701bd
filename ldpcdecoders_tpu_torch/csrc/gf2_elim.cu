// Batched GF(2) elimination kernels for OSD post-processing, for sm_90a.
//
// Replaces the two Pallas TPU kernels of ldpcdecoders_tpu/ops/pallas_gf2.py:
//   gf2_osd0_kernel  <- pallas_gf2.py:_osd0_kernel (wrapper gf2_osd0_pallas)
//   gf2_elim_kernel  <- pallas_gf2.py:_elim_kernel (wrapper gf2_eliminate_pallas)
// and computes what they compute: the same pivot columns (the first unused
// row with the column bit set), the same co-transformed syndrome, the same
// pivot map with sentinel n, and for OSD-0 the same correction.
//
// Layout.  One block per lane.  The lane's bit-packed, transposed system
// Ht[W][m] (word w of row i holds columns 32w..32w+31) is copied once into
// dynamic shared memory and stays there for the whole column loop; device
// memory sees one read and one write per lane.  Thread t owns rows
// t, t + blockDim, ...  Reading a column and XOR-ing the pivot row are then
// runs of neighbouring words across a warp (conflict-free), and the pivot
// row's words are a broadcast.
//
// Each column trip j: (1) every thread tests its rows' bit j; a warp ballot
// plus __ffs gives the warp's first free row with the bit set, and an
// atomicMin in shared memory the block's; (2) after a __syncthreads the
// pivot row's W words and syndrome bit are XORed into every other row with
// the bit set; a second __syncthreads ends the trip.
//
// What bounds it on the H100: a serial loop of up to n trips, each two
// block-wide barriers plus shared-memory traffic of at most W words per
// eliminated row.  At the (1000, 10, 9) code a lane takes
// 4 * (32 * 900 + 3 * 900) bytes, about 126 KB, so one block fits an SM and
// 132 lanes run at a time.  The design keeps the trip short (one ballot,
// one atomic per warp, no copy of the pivot row: row k is never written in
// its own trip) and lets a lane leave the loop as soon as its answer is
// fixed: at full rank (elimination) or once the residual outside the pivot
// space is empty (OSD-0).
//
// Plain C interface (pointers, sizes, stream), loaded with ctypes.  Each
// launcher returns the cudaError_t of its launch; 0 is success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Shared memory: [kmin 2][piv m][s nbuf*m][ht W*m] 32-bit words
// (ops/cuda_gf2.py:smem_bytes computes the same size).
inline size_t smem_words(int W, int m, int nbuf) {
  return 2 + (size_t)m * (1 + nbuf) + (size_t)W * m;
}

// First row (ascending) among this thread's rows where `pred(i)` holds,
// reduced over the warp with a ballot; returns m if none.  Every thread of
// the warp must call it (the loop bound is uniform).
template <typename Pred>
__device__ inline int warp_first_row(int m, Pred pred) {
  const int lane_base = threadIdx.x & ~31;
  for (int i0 = 0; i0 < m; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const unsigned ballot = __ballot_sync(0xffffffffu, i < m && pred(i));
    if (ballot) return i0 + lane_base + __ffs(ballot) - 1;
  }
  return m;
}

__global__ void gf2_elim_kernel(const uint32_t* __restrict__ ht_in,
                                const uint32_t* __restrict__ s_in,
                                uint32_t* __restrict__ ht_out,
                                uint32_t* __restrict__ s_out,
                                int32_t* __restrict__ piv_out,
                                int W, int m, int n) {
  extern __shared__ uint32_t smem[];
  int* kmin = reinterpret_cast<int*>(smem);
  int32_t* piv = reinterpret_cast<int32_t*>(smem + 2);
  uint32_t* s = smem + 2 + m;
  uint32_t* ht = s + m;

  const size_t lane_off = (size_t)blockIdx.x * W * m;
  const size_t row_off = (size_t)blockIdx.x * m;
  for (int idx = threadIdx.x; idx < W * m; idx += blockDim.x) ht[idx] = ht_in[lane_off + idx];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s[i] = s_in[row_off + i];
    piv[i] = n;
  }
  if (threadIdx.x == 0) kmin[0] = kmin[1] = m;
  __syncthreads();

  int rank = 0;  // identical in every thread
  for (int j = 0; j < n && rank < m; ++j) {
    const uint32_t* colw = ht + (size_t)(j >> 5) * m;
    const int bit = j & 31;
    // (1) pivot: first unused row with bit j set
    const int first = warp_first_row(m, [&](int i) {
      return piv[i] == n && ((colw[i] >> bit) & 1u);
    });
    if ((threadIdx.x & 31) == 0 && first < m) atomicMin(&kmin[j & 1], first);
    __syncthreads();
    const int k = kmin[j & 1];
    // the other slot was last read before the previous trip's final barrier
    if (threadIdx.x == 0) kmin[(j + 1) & 1] = m;
    if (k < m) {
      // (2) eliminate bit j from every other row; row k is not written
      const uint32_t sk = s[k];
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        if (i != k && ((colw[i] >> bit) & 1u)) {
          s[i] ^= sk;
          for (int w = 0; w < W; ++w) ht[(size_t)w * m + i] ^= ht[(size_t)w * m + k];
        }
      }
      if (threadIdx.x == 0) piv[k] = j;
      ++rank;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < W * m; idx += blockDim.x) ht_out[lane_off + idx] = ht[idx];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_out[row_off + i] = s[i];
    piv_out[row_off + i] = piv[i];
  }
}

__global__ void gf2_osd0_kernel(const uint32_t* __restrict__ ht_in,
                                const uint32_t* __restrict__ resid,
                                const int32_t* __restrict__ bp,
                                int32_t* __restrict__ corr,
                                int W, int m, int n) {
  extern __shared__ uint32_t smem[];
  int* kmin = reinterpret_cast<int*>(smem);
  int32_t* piv = reinterpret_cast<int32_t*>(smem + 2);
  // the residual is double-buffered: a trip reads every row of one buffer
  // (including the pivot row, whose bit changes in the same trip) and
  // writes the other
  uint32_t* sbuf[2] = {smem + 2 + m, smem + 2 + 2 * m};
  uint32_t* ht = smem + 2 + 3 * m;

  const size_t lane_off = (size_t)blockIdx.x * W * m;
  const size_t row_off = (size_t)blockIdx.x * m;
  const size_t col_off = (size_t)blockIdx.x * n;
  for (int idx = threadIdx.x; idx < W * m; idx += blockDim.x) ht[idx] = ht_in[lane_off + idx];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sbuf[0][i] = resid[row_off + i];
    piv[i] = n;
  }
  if (threadIdx.x == 0) kmin[0] = kmin[1] = m;
  __syncthreads();

  int cur = 0;  // identical in every thread
  for (int j = 0; j < n; ++j) {
    const uint32_t* colw = ht + (size_t)(j >> 5) * m;
    const int bit = j & 31;
    const uint32_t* s = sbuf[cur];
    // residual left outside the pivot space? (tested at trip entry)
    int rem = 0;
    for (int i = threadIdx.x; i < m; i += blockDim.x) rem |= (piv[i] == n) && s[i];
    const int first = warp_first_row(m, [&](int i) {
      return piv[i] == n && ((colw[i] >> bit) & 1u);
    });
    if ((threadIdx.x & 31) == 0 && first < m) atomicMin(&kmin[j & 1], first);
    if (!__syncthreads_or(rem)) break;  // this lane's answer is fixed
    const int k = kmin[j & 1];
    if (threadIdx.x == 0) kmin[(j + 1) & 1] = m;
    if (k < m) {
      // bp_err[j] folds into every row with bit j set; on the rows that
      // are then eliminated it cancels, so only the pivot row keeps it
      const uint32_t sk = s[k];
      uint32_t* s_next = sbuf[cur ^ 1];
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        uint32_t v = s[i];
        if (i == k) {
          v ^= (uint32_t)bp[col_off + j];
          piv[i] = j;
        } else if ((colw[i] >> bit) & 1u) {
          v ^= sk;
          for (int w = 0; w < W; ++w) ht[(size_t)w * m + i] ^= ht[(size_t)w * m + k];
        }
        s_next[i] = v;
      }
      cur ^= 1;
    }
    __syncthreads();
  }

  // correction: bp_err with each pivot column reassigned from the residual
  for (int c = threadIdx.x; c < n; c += blockDim.x) corr[col_off + c] = bp[col_off + c];
  __syncthreads();
  const uint32_t* s = sbuf[cur];
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    if (piv[i] < n) corr[col_off + piv[i]] = (int32_t)s[i];
}

int block_threads(int m) {
  const int t = ((m + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ldpc_gf2_eliminate(const void* ht_in, const void* s_in, void* ht_out, void* s_out,
                       void* piv_out, int B, int W, int m, int n, void* stream) {
  const size_t bytes = 4 * smem_words(W, m, 1);
  cudaError_t err = set_smem(gf2_elim_kernel, bytes);
  if (err != cudaSuccess) return err;
  gf2_elim_kernel<<<B, block_threads(m), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ht_in), static_cast<const uint32_t*>(s_in),
      static_cast<uint32_t*>(ht_out), static_cast<uint32_t*>(s_out),
      static_cast<int32_t*>(piv_out), W, m, n);
  return cudaGetLastError();
}

int ldpc_gf2_osd0(const void* ht_in, const void* resid, const void* bp, void* corr,
                  int B, int W, int m, int n, void* stream) {
  const size_t bytes = 4 * smem_words(W, m, 2);
  cudaError_t err = set_smem(gf2_osd0_kernel, bytes);
  if (err != cudaSuccess) return err;
  gf2_osd0_kernel<<<B, block_threads(m), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ht_in), static_cast<const uint32_t*>(resid),
      static_cast<const int32_t*>(bp), static_cast<int32_t*>(corr), W, m, n);
  return cudaGetLastError();
}

}  // extern "C"
