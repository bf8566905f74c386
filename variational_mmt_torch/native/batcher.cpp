// Native batch assembler: the host-side hot path of the input pipeline.
//
// The per-batch O(B*L) fill and the image-feature row gather run in C++,
// called through ctypes (native/__init__.py), so the prefetch thread
// (data/prefetch.py) spends almost no Python time on a batch.
//
// Layout contract (matches data/dataset.py, BucketIterator._make_batch):
//   src_data/src_off: flat ragged int32 sequences + int64 offsets
//   out_src:     (B, L) PAD-filled, row r <- sequence indices[r] (truncated)
//   out_tgt_in:  (B, L) BOS + tgt[:L-1]
//   out_tgt_out: (B, L) tgt[:L-1] + EOS
//   rows >= n_idx stay fully PAD with mask 0 (partial final batch).
//   With tgt_data null the target outputs stay PAD; the Python wrapper
//   returns None for them, as the Python path does.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

void assemble_batch(const int32_t* src_data, const int64_t* src_off,
                    const int32_t* tgt_data, const int64_t* tgt_off,
                    const int64_t* indices, int64_t n_idx,
                    int64_t B, int64_t L,
                    int32_t bos, int32_t eos, int32_t pad,
                    int32_t* out_src, int32_t* out_tgt_in,
                    int32_t* out_tgt_out, int32_t* out_indices,
                    float* out_mask) {
  const int64_t total = B * L;
  std::fill(out_src, out_src + total, pad);
  std::fill(out_tgt_in, out_tgt_in + total, pad);
  std::fill(out_tgt_out, out_tgt_out + total, pad);
  std::fill(out_indices, out_indices + B, 0);
  std::fill(out_mask, out_mask + B, 0.0f);

  for (int64_t r = 0; r < n_idx && r < B; ++r) {
    const int64_t i = indices[r];
    const int64_t s0 = src_off[i], s1 = src_off[i + 1];
    const int64_t slen = std::min<int64_t>(s1 - s0, L);
    std::memcpy(out_src + r * L, src_data + s0, slen * sizeof(int32_t));
    if (tgt_data != nullptr) {
      const int64_t t0 = tgt_off[i], t1 = tgt_off[i + 1];
      const int64_t tlen = std::min<int64_t>(t1 - t0, L - 1);
      int32_t* tin = out_tgt_in + r * L;
      int32_t* tout = out_tgt_out + r * L;
      tin[0] = bos;
      std::memcpy(tin + 1, tgt_data + t0, tlen * sizeof(int32_t));
      std::memcpy(tout, tgt_data + t0, tlen * sizeof(int32_t));
      tout[tlen] = eos;
    }
    out_indices[r] = static_cast<int32_t>(i);
    out_mask[r] = 1.0f;
  }
}

// Gather feature rows by batch indices; rows with mask 0 are zeroed
// (mirrors dataset.py's masked gather).
void gather_rows_f32(const float* feats, int64_t row_elems,
                     const int32_t* indices, int64_t B,
                     const float* mask, float* out) {
  for (int64_t r = 0; r < B; ++r) {
    float* dst = out + r * row_elems;
    if (mask[r] == 0.0f) {
      std::memset(dst, 0, row_elems * sizeof(float));
    } else {
      std::memcpy(dst, feats + static_cast<int64_t>(indices[r]) * row_elems,
                  row_elems * sizeof(float));
    }
  }
}

}  // extern "C"
