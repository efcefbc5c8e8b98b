// Host-side batch assembly engine (C ABI, loaded via ctypes): the port's own
// copy of the JAX package's engine, the same code, so both assemble the
// same bits.
//
// The training step is fed by a single prefetch thread
// (lam_slide_tpu_torch/data/loader.py); at reference batch sizes the Python
// per-sample path dominates wall clock (the reference hides the same cost
// behind num_workers=31 torch DataLoader processes, configs/data/*.yaml).
// These routines assemble a padded, masked, augmentation-applied batch from
// raw trajectory buffers in one pass per array: window gather + entity
// padding (collate_functions.py:46-82 semantics), batched 2D/3D rotation +
// translation (data_utils.py rotate_point_cloud), frame-0 centering
// (datasets/md17.py:103), and mask fill. Everything is plain C++17 on
// contiguous row-major numpy buffers; one call per output array, no
// per-sample Python object churn.
//
// Threading: intentionally single-threaded. The Loader already overlaps
// assembly with device compute via its producer thread; the win here is
// eliminating interpreter and small-allocation overhead, not parallelism.

#include <cstdint>
#include <cstring>

extern "C" {

// Gather B windows of `span` frames from per-sample source buffers and pad
// the entity axis: srcs[b] points at a [F_b, n_src[b], c] float32 buffer,
// window starts at frame starts[b]; out is [B, span, n_pad, c] (zero-filled
// padding). `c` is the trailing feature width (2/3 for positions, 1 for
// per-entity scalars stored as float).
void gather_pad_f32(const float** srcs, const int64_t* starts,
                    const int64_t* n_src, int64_t span, int64_t n_pad,
                    int64_t c, int64_t batch, float* out) {
  const int64_t row_out = n_pad * c;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t n = n_src[b];
    const float* src = srcs[b] + starts[b] * n * c;
    float* dst = out + b * span * row_out;
    for (int64_t t = 0; t < span; ++t) {
      std::memcpy(dst, src, sizeof(float) * n * c);
      if (n < n_pad) std::memset(dst + n * c, 0, sizeof(float) * (n_pad - n) * c);
      src += n * c;
      dst += row_out;
    }
  }
}

// Same for int64 label arrays [F_b, n_src[b]] -> [B, span, n_pad].
void gather_pad_i64(const int64_t** srcs, const int64_t* starts,
                    const int64_t* n_src, int64_t span, int64_t n_pad,
                    int64_t batch, int64_t* out) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t n = n_src[b];
    const int64_t* src = srcs[b] + starts[b] * n;
    int64_t* dst = out + b * span * n_pad;
    for (int64_t t = 0; t < span; ++t) {
      std::memcpy(dst, src, sizeof(int64_t) * n);
      if (n < n_pad) std::memset(dst + n, 0, sizeof(int64_t) * (n_pad - n));
      src += n;
      dst += n_pad;
    }
  }
}

// Broadcast per-sample entity rows [n_src[b]] over time and pad:
// out [B, span, n_pad] (reference stage-2 samples broadcast entity ids over
// the window, datasets/md17.py:118).
void broadcast_pad_i64(const int64_t** rows, const int64_t* n_src,
                       int64_t span, int64_t n_pad, int64_t batch,
                       int64_t* out) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t n = n_src[b];
    int64_t* dst = out + b * span * n_pad;
    std::memcpy(dst, rows[b], sizeof(int64_t) * n);
    if (n < n_pad) std::memset(dst + n, 0, sizeof(int64_t) * (n_pad - n));
    for (int64_t t = 1; t < span; ++t)
      std::memcpy(dst + t * n_pad, dst, sizeof(int64_t) * n_pad);
  }
}

// In-place batched rotation + shift/scale + translation over padded
// positions: pos [B, T, N, c] row-major, rots [B, c, c] (c = 2 or 3),
// trans [B, c] or null. Applies p <- ((p - shift) / scale) @ R^T + trans —
// the per-sample augmentation chain of datasets/{md17,nba,pedestrian}.py.
// Frame-0 centering is a separate call (below) because its mean is taken
// before normalization.
// Only the first n_real[b] entities of each frame are touched — padding
// rows stay exactly zero, matching the reference order (augment, THEN pad).
void rotate_batch_f32(float* pos, const float* rots, const float* trans,
                      const int64_t* n_real, float shift, float scale,
                      int64_t batch, int64_t t, int64_t n, int64_t c) {
  const float inv = 1.0f / scale;
  for (int64_t b = 0; b < batch; ++b) {
    const float* R = rots + b * c * c;
    const float* tr = trans ? trans + b * c : nullptr;
    const int64_t nr = n_real[b];
    for (int64_t tt = 0; tt < t; ++tt) {
      float* p = pos + ((b * t + tt) * n) * c;
      if (c == 2) {
        const float r00 = R[0], r01 = R[1], r10 = R[2], r11 = R[3];
        for (int64_t i = 0; i < nr; ++i, p += 2) {
          const float x = (p[0] - shift) * inv, y = (p[1] - shift) * inv;
          p[0] = x * r00 + y * r01 + (tr ? tr[0] : 0.0f);
          p[1] = x * r10 + y * r11 + (tr ? tr[1] : 0.0f);
        }
      } else {  // c == 3
        for (int64_t i = 0; i < nr; ++i, p += 3) {
          const float x = (p[0] - shift) * inv, y = (p[1] - shift) * inv,
                      z = (p[2] - shift) * inv;
          p[0] = x * R[0] + y * R[1] + z * R[2] + (tr ? tr[0] : 0.0f);
          p[1] = x * R[3] + y * R[4] + z * R[5] + (tr ? tr[1] : 0.0f);
          p[2] = x * R[6] + y * R[7] + z * R[8] + (tr ? tr[2] : 0.0f);
        }
      }
    }
  }
}

// In-place frame-0 centering over the REAL entities of each sample:
// pos [B, T, N, c], n_real [B]; subtracts mean over frame 0's real rows
// (datasets/md17.py:103: pos -= pos[0].mean(axis=0)).
void center_frame0_f32(float* pos, const int64_t* n_real, int64_t batch,
                       int64_t t, int64_t n, int64_t c) {
  for (int64_t b = 0; b < batch; ++b) {
    float* p = pos + b * t * n * c;
    const int64_t nr = n_real[b];
    float mean[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t i = 0; i < nr; ++i)
      for (int64_t k = 0; k < c; ++k) mean[k] += p[i * c + k];
    for (int64_t k = 0; k < c; ++k) mean[k] /= static_cast<float>(nr);
    for (int64_t tt = 0; tt < t; ++tt) {
      float* row = p + tt * n * c;
      for (int64_t i = 0; i < nr; ++i)
        for (int64_t k = 0; k < c; ++k) row[i * c + k] -= mean[k];
    }
  }
}

// attention_mask fill: mask [B, T, n_pad] uint8, true for real entities
// (collate_functions.py mask semantics, exact from sample lengths).
void mask_fill_u8(uint8_t* mask, const int64_t* n_real, int64_t batch,
                  int64_t t, int64_t n_pad) {
  for (int64_t b = 0; b < batch; ++b) {
    uint8_t* m = mask + b * t * n_pad;
    const int64_t nr = n_real[b];
    std::memset(m, 1, nr);
    if (nr < n_pad) std::memset(m + nr, 0, n_pad - nr);
    for (int64_t tt = 1; tt < t; ++tt)
      std::memcpy(m + tt * n_pad, m, n_pad);
  }
}

// Conditional in-place team swap (1<->2) per sample: team [B, T, N] int64,
// flip [B] uint8 (reference team-flip augmentation, datasets/nba.py:97-107).
void team_flip_i64(int64_t* team, const uint8_t* flip, int64_t batch,
                   int64_t rows) {
  for (int64_t b = 0; b < batch; ++b) {
    if (!flip[b]) continue;
    int64_t* p = team + b * rows;
    for (int64_t i = 0; i < rows; ++i) {
      if (p[i] == 1) p[i] = 2;
      else if (p[i] == 2) p[i] = 1;
    }
  }
}

}  // extern "C"
