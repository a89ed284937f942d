// Native host runtime for the map data model: the hot irregular
// bookkeeping that stays on the CPU while kernels run on the GPU.
// (A copy of hfnet_slam_tpu/native/mapcore.cpp; the port keeps its own.)
//
// The original HFNet-SLAM's analogous code paths are C++ members of
// KeyFrame/MapPoint (KeyFrame::UpdateConnections, MapPoint observation
// upkeep) operating on pointer graphs under mutexes. Here the map lives in dense arrays
// (slam/map.py MapStore) and these routines scan them linearly —
// cache-friendly, branch-light, no locks. Python binds via ctypes
// (hfnet_slam_torch/native/__init__.py) with a numpy fallback.
//
// Build (done at first use into the package's build directory):
//   g++ -O3 -shared -fPIC mapcore.cpp -o libmapcore.so

#include <cstdint>
#include <cstring>

extern "C" {

// Recompute covisibility weights of keyframe k against all valid
// keyframes: weight(k, j) = |obs(k) ∩ obs(j)| (UpdateConnections
// analogue). kf_obs is the (K, N) slot->map-point table (-1 = none);
// writes row/col k of the (K, K) covis matrix in place.
void covis_update(const int32_t* kf_obs, const uint8_t* kf_valid,
                  int64_t K, int64_t N, int64_t M, int64_t k,
                  int32_t* covis, uint8_t* scratch /* M bytes, zeroed */) {
  const int32_t* row_k = kf_obs + k * N;
  // mark k's observations
  int64_t n_marked = 0;
  for (int64_t s = 0; s < N; ++s) {
    int32_t mp = row_k[s];
    if (mp >= 0 && mp < M && !scratch[mp]) {
      scratch[mp] = 1;
      ++n_marked;
    }
  }
  if (n_marked == 0) {
    // clear marks not needed (none set); zero k's row/col against valid KFs
    return;
  }
  for (int64_t j = 0; j < K; ++j) {
    if (!kf_valid[j] || j == k) continue;
    const int32_t* row_j = kf_obs + j * N;
    int32_t w = 0;
    for (int64_t s = 0; s < N; ++s) {
      int32_t mp = row_j[s];
      if (mp >= 0 && mp < M && scratch[mp]) ++w;
    }
    covis[k * K + j] = w;
    covis[j * K + k] = w;
  }
  // clear marks for reuse
  for (int64_t s = 0; s < N; ++s) {
    int32_t mp = row_k[s];
    if (mp >= 0 && mp < M) scratch[mp] = 0;
  }
}

// Emit all (kf, slot, mp) observation triples of the given map-point
// member set (observing_slots analogue — the BA edge builder). Returns
// the number of triples written (capped at cap).
int64_t observing_slots(const int32_t* kf_obs, const uint8_t* kf_valid,
                        int64_t K, int64_t N, int64_t M,
                        const uint8_t* member,
                        int32_t* out_kf, int32_t* out_slot, int32_t* out_mp,
                        int64_t cap) {
  int64_t n = 0;
  for (int64_t k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_obs + k * N;
    for (int64_t s = 0; s < N; ++s) {
      int32_t mp = row[s];
      if (mp >= 0 && mp < M && member[mp]) {
        if (n >= cap) return n;
        out_kf[n] = (int32_t)k;
        out_slot[n] = (int32_t)s;
        out_mp[n] = mp;
        ++n;
      }
    }
  }
  return n;
}

// Batch observation-count maintenance: apply new assignments
// kf_obs[k, slots[i]] = mp_ids[i], updating mp_obs_count (+1 new, -1 old).
void assign_observations(int32_t* kf_obs, int32_t* mp_obs_count,
                         int64_t N, int64_t M, int64_t k,
                         const int64_t* slots, const int32_t* mp_ids,
                         int64_t n) {
  int32_t* row = kf_obs + k * N;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = slots[i];
    int32_t old_mp = row[s];
    if (old_mp >= 0 && old_mp < M) --mp_obs_count[old_mp];
    int32_t mp = mp_ids[i];
    row[s] = mp;
    if (mp >= 0 && mp < M) ++mp_obs_count[mp];
  }
}

}  // extern "C"
