// Host-side data packer of vidsgg_big_tpu_torch (the PyTorch/CUDA port).
//
// A plain C++ library that owns the host-side hot loops
// of the ingestion pipeline (the reference spends hours building its caches
// in pure python, reference dataloaders/*.py):
//   * stretch_index: the repeat-padding gather index (reference
//     stack_with_repeat_2d semantics, see ops/segments.py).
//   * pad_pack / stretch_pack: copy ragged per-trajectory feature rows into
//     fixed (N, T, D) buckets, optionally applying the stretch gather.
//   * group_tracklet_rows: group a uniform (R, 12+D) tracklet array by tid,
//     order by frame, majority-vote the category, and emit per-trajectory
//     segment offsets (the python row loop in the parsers).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 at first use (ops/build.py)
// Python binding: ctypes (vidsgg_big_tpu_torch/data/native.py).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// out[n, t] = source frame index for the repeat-stretched row t of a
// trajectory with lengths[n] valid frames, bucket length T.
// counts[j] = ceil((T - j) / L); rows longer than T are truncated.
void stretch_index(const int32_t* lengths, int64_t n, int64_t t,
                   int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t L = lengths[i];
    int32_t* row = out + i * t;
    if (L <= 0) {
      std::memset(row, 0, sizeof(int32_t) * t);
      continue;
    }
    if (L >= t) {
      for (int64_t k = 0; k < t; ++k)
        row[k] = static_cast<int32_t>(std::min(k, L - 1));
      continue;
    }
    int64_t k = 0;
    for (int64_t j = 0; j < L && k < t; ++j) {
      int64_t count = (t - j + L - 1) / L;  // ceil((t - j) / L)
      for (int64_t c = 0; c < count && k < t; ++c) row[k++] = j;
    }
    for (; k < t; ++k) row[k] = L - 1;  // unreachable, defensive
  }
}

// Copy ragged rows (concatenated trajectories, row-major (total_rows, D))
// into a zeroed (N, T, D) float32 buffer.
void pad_pack(const float* src, const int64_t* offsets,  // (N+1,) row offsets
              const int32_t* lengths, int64_t n, int64_t t, int64_t d,
              float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t L = std::min<int64_t>(lengths[i], t);
    if (L <= 0) continue;
    std::memcpy(dst + (i * t) * d, src + offsets[i] * d,
                sizeof(float) * L * d);
  }
}

// Like pad_pack but applies the stretch gather so dst rows are fully
// populated with repeated source rows.
void stretch_pack(const float* src, const int64_t* offsets,
                  const int32_t* lengths, int64_t n, int64_t t, int64_t d,
                  float* dst) {
  std::vector<int32_t> idx(t);
  for (int64_t i = 0; i < n; ++i) {
    int64_t L = lengths[i];
    float* out = dst + i * t * d;
    const float* in = src + offsets[i] * d;
    if (L <= 0) {
      std::memset(out, 0, sizeof(float) * t * d);
      continue;
    }
    stretch_index(lengths + i, 1, t, idx.data());
    for (int64_t k = 0; k < t; ++k)
      std::memcpy(out + k * d, in + idx[k] * d, sizeof(float) * d);
  }
}

// Group uniform tracklet rows by tid.
//
// rows: (R, C) float32/float64-converted-to-float32 with columns
//   [fid, tid, ...]; rows need not be sorted.  Emits:
//   order:    (R,) row indices sorted by (tid, fid)
//   traj_off: (max_trajs+1,) offsets into `order` per trajectory
//   traj_tid: (max_trajs,) the tid of each group
// Returns the number of trajectories (or -1 if max_trajs too small).
int64_t group_tracklet_rows(const float* rows, int64_t r, int64_t c,
                            int64_t max_trajs, int32_t* order,
                            int64_t* traj_off, int32_t* traj_tid) {
  std::vector<int64_t> ord(r);
  for (int64_t i = 0; i < r; ++i) ord[i] = i;
  auto key = [&](int64_t i) {
    return std::make_pair(static_cast<int64_t>(rows[i * c + 1]),
                          static_cast<int64_t>(rows[i * c + 0]));
  };
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int64_t a, int64_t b) { return key(a) < key(b); });
  int64_t n_traj = 0;
  int64_t prev_tid = INT64_MIN;
  for (int64_t k = 0; k < r; ++k) {
    int64_t i = ord[k];
    int64_t tid = static_cast<int64_t>(rows[i * c + 1]);
    if (tid != prev_tid) {
      if (n_traj >= max_trajs) return -1;
      traj_off[n_traj] = k;
      traj_tid[n_traj] = static_cast<int32_t>(tid);
      ++n_traj;
      prev_tid = tid;
    }
    order[k] = static_cast<int32_t>(i);
  }
  traj_off[n_traj] = r;
  return n_traj;
}

// Majority (mode) of the int-valued category column over a row range,
// considering only rows where the category is > 0.  Ties break toward the
// smaller id (numpy bincount-argmax semantics).  Returns 0 if none.
int32_t majority_category(const float* rows, const int32_t* order,
                          int64_t begin, int64_t end, int64_t c,
                          int64_t cat_col) {
  std::unordered_map<int32_t, int32_t> counts;
  for (int64_t k = begin; k < end; ++k) {
    int32_t cat = static_cast<int32_t>(rows[order[k] * c + cat_col]);
    if (cat > 0) counts[cat]++;
  }
  int32_t best = 0, best_n = 0;
  for (auto& kv : counts) {
    if (kv.second > best_n || (kv.second == best_n && kv.first < best)) {
      best = kv.first;
      best_n = kv.second;
    }
  }
  return best;
}

}  // extern "C"
