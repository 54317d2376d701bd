// Native Tanner-graph edge-list compiler.
//
// Compiles a dense 0/1 parity-check matrix into the padded adjacency and
// the cross-layout gather permutations of codes/graph.py in one O(nnz)
// pass.  The code is ldpcdecoders_tpu/native/graph_compiler.cpp's.
//
// C ABI for ctypes; all buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <vector>

extern "C" {

// Returns 0 on success, -1 if a row/column exceeds the padded degree.
int compile_tanner(const uint8_t* H, int64_t m, int64_t n,
                   int64_t max_dc, int64_t max_dv,
                   int32_t* chk_vars, uint8_t* chk_mask,
                   int32_t* var_chks, uint8_t* var_mask,
                   int32_t* c2v, int32_t* v2c) {
  // per-node fill counters
  std::vector<int32_t> cfill(m, 0), vfill(n, 0);
  // slot of edge (i, j) within check i's list / var j's list
  // recorded during the single scan (row-major: j ascending within i,
  // i ascending within j — both orders are ascending, so one pass fills
  // both layouts in their canonical sorted order simultaneously)
  for (int64_t i = 0; i < m; ++i) {
    const uint8_t* row = H + i * n;
    for (int64_t j = 0; j < n; ++j) {
      if (!row[j]) continue;
      int32_t kc = cfill[i]++;
      int32_t kv = vfill[j]++;
      if (kc >= max_dc || kv >= max_dv) return -1;
      chk_vars[i * max_dc + kc] = (int32_t)j;
      chk_mask[i * max_dc + kc] = 1;
      var_chks[j * max_dv + kv] = (int32_t)i;
      var_mask[j * max_dv + kv] = 1;
      c2v[i * max_dc + kc] = (int32_t)(j * max_dv + kv);
      v2c[j * max_dv + kv] = (int32_t)(i * max_dc + kc);
    }
  }
  return 0;
}

// Degree computation helper (row + column sums in one pass).
void degrees(const uint8_t* H, int64_t m, int64_t n,
             int64_t* row_deg, int64_t* col_deg) {
  for (int64_t i = 0; i < m; ++i) {
    const uint8_t* row = H + i * n;
    int64_t r = 0;
    for (int64_t j = 0; j < n; ++j) {
      if (row[j]) {
        ++r;
        ++col_deg[j];
      }
    }
    row_deg[i] = r;
  }
}

}  // extern "C"
