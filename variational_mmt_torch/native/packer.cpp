// Native sequence packer: the host-side hot path of packed training input.
//
// Called through ctypes (native/__init__.py). Two entry points, mirroring
// data/packing.py's Python path exactly (the Python implementation is the
// behavioural spec and the fallback; tests/test_torch_native.py asserts
// array-identical output):
//
//   pack_plan       — greedy first-fit row assignment for a whole epoch.
//                     Scans the open rows of the current batch newest-first
//                     (older rows are fuller); a row takes <=K segments and
//                     src/tgt token budgets of L each (tgt cost includes the
//                     BOS/EOS shift: min(len(tgt)+1, L)).
//   assemble_packed — fill one batch's static (B, L)/(B, K) arrays from the
//                     plan: PAD/-1 fills, per-segment BOS/EOS framing,
//                     segment id streams, first/last source positions.
//
// Layout contract:
//   src_data/src_off, tgt_data/tgt_off: flat ragged int32 + int64 offsets
//     (BinarizedDataset.src_flat()/tgt_flat()).
//   Empty source or target lines are refused in Python before any plan:
//   seg_last of a zero-length source segment would be wrong here.
//   plan: row_off (n_rows+1 int64) into row_examples (corpus indices in
//     segment order). Batch b covers rows [b*B, min((b+1)*B, n_rows)).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct OpenRow {
  int64_t src_used;
  int64_t tgt_used;
  int64_t segs[16];  // K is validated <= 16 on the Python side
  int64_t n_segs;
};

}  // namespace

extern "C" {

// Returns the number of rows produced. row_off must hold n+1 entries,
// row_examples n entries (every example lands in exactly one segment).
int64_t pack_plan(const int64_t* src_off, const int64_t* tgt_off,
                  const int64_t* order, int64_t n,
                  int64_t B, int64_t L, int64_t K,
                  int64_t* row_off, int64_t* row_examples) {
  if (K > 16) return -1;  // guarded in the wrapper; belt-and-braces
  std::vector<OpenRow> rows;
  rows.reserve(static_cast<size_t>(B));
  int64_t n_rows = 0;
  int64_t out_pos = 0;

  auto flush = [&]() {
    for (const OpenRow& r : rows) {
      row_off[n_rows++] = out_pos;
      for (int64_t k = 0; k < r.n_segs; ++k) row_examples[out_pos++] = r.segs[k];
    }
    rows.clear();
  };

  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    const int64_t ls = std::min<int64_t>(src_off[i + 1] - src_off[i], L);
    const int64_t lt = std::min<int64_t>(tgt_off[i + 1] - tgt_off[i] + 1, L);
    bool placed = false;
    for (auto it = rows.rbegin(); it != rows.rend(); ++it) {
      if (it->n_segs < K && it->src_used + ls <= L && it->tgt_used + lt <= L) {
        it->src_used += ls;
        it->tgt_used += lt;
        it->segs[it->n_segs++] = i;
        placed = true;
        break;
      }
    }
    if (!placed) {
      if (static_cast<int64_t>(rows.size()) == B) flush();
      OpenRow r;
      r.src_used = ls;
      r.tgt_used = lt;
      r.segs[0] = i;
      r.n_segs = 1;
      rows.push_back(r);
    }
  }
  flush();
  row_off[n_rows] = out_pos;
  return n_rows;
}

// Fill one packed batch. Rows [row0, row0 + n_rows) of the plan map to
// batch rows [0, n_rows); remaining rows (partial final batch) stay PAD
// with seg_mask 0.
void assemble_packed(const int32_t* src_data, const int64_t* src_off,
                     const int32_t* tgt_data, const int64_t* tgt_off,
                     const int64_t* row_off, const int64_t* row_examples,
                     int64_t row0, int64_t n_rows,
                     int64_t B, int64_t L, int64_t K,
                     int32_t bos, int32_t eos, int32_t pad,
                     int32_t* out_src, int32_t* out_tin, int32_t* out_tout,
                     int32_t* out_sseg, int32_t* out_tseg,
                     int32_t* out_first, int32_t* out_last,
                     int32_t* out_idx, float* out_segmask) {
  const int64_t bl = B * L;
  const int64_t bk = B * K;
  std::fill(out_src, out_src + bl, pad);
  std::fill(out_tin, out_tin + bl, pad);
  std::fill(out_tout, out_tout + bl, pad);
  std::fill(out_sseg, out_sseg + bl, static_cast<int32_t>(-1));
  std::fill(out_tseg, out_tseg + bl, static_cast<int32_t>(-1));
  std::fill(out_first, out_first + bk, 0);
  std::fill(out_last, out_last + bk, 0);
  std::fill(out_idx, out_idx + bk, 0);
  std::fill(out_segmask, out_segmask + bk, 0.0f);

  for (int64_t r = 0; r < n_rows && r < B; ++r) {
    const int64_t gr = row0 + r;
    int64_t sp = 0, tp = 0;
    for (int64_t pos = row_off[gr], k = 0; pos < row_off[gr + 1]; ++pos, ++k) {
      const int64_t i = row_examples[pos];
      const int64_t s0 = src_off[i];
      const int64_t ls = std::min<int64_t>(src_off[i + 1] - s0, L);
      std::memcpy(out_src + r * L + sp, src_data + s0, ls * sizeof(int32_t));
      for (int64_t p = 0; p < ls; ++p)
        out_sseg[r * L + sp + p] = static_cast<int32_t>(k);
      out_first[r * K + k] = static_cast<int32_t>(sp);
      out_last[r * K + k] = static_cast<int32_t>(sp + ls - 1);

      const int64_t t0 = tgt_off[i];
      const int64_t lt_t = std::min<int64_t>(tgt_off[i + 1] - t0, L - 1);
      int32_t* tin = out_tin + r * L + tp;
      int32_t* tout = out_tout + r * L + tp;
      tin[0] = bos;
      std::memcpy(tin + 1, tgt_data + t0, lt_t * sizeof(int32_t));
      std::memcpy(tout, tgt_data + t0, lt_t * sizeof(int32_t));
      tout[lt_t] = eos;
      for (int64_t p = 0; p <= lt_t; ++p)
        out_tseg[r * L + tp + p] = static_cast<int32_t>(k);

      out_idx[r * K + k] = static_cast<int32_t>(i);
      out_segmask[r * K + k] = 1.0f;
      sp += ls;
      tp += lt_t + 1;
    }
  }
}

}  // extern "C"
