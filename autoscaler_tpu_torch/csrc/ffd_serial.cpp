// Serial first-fit-decreasing binpacking — the compiled host baseline.
//
// Mirrors the algorithmic structure of the reference's Go
// BinpackingNodeEstimator (cluster-autoscaler/estimator/binpacking_estimator.go
// :65-141: score-sort descending, first-fit over open template nodes in open
// order, open-on-miss, skip pods that cannot fit an empty node) as a compiled
// serial implementation. Two jobs:
//   1. bench.py baseline: a fair stand-in for the reference's compiled Go
//      hot loop (the numpy oracle under-represents it by ~an order of
//      magnitude of interpreter overhead).
//   2. host-side fallback when no accelerator is present.
//
// C ABI for ctypes: see autoscaler_tpu_torch/native_bridge.py, which builds
// this copy with g++ into build/native/ at first use (the estimator's
// native rung).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// pod_req: P x R row-major; pod_mask: P (0/1); template_alloc: R
// out_scheduled: P (0/1). Returns the number of nodes opened, or -1 on error.
int32_t ffd_binpack_serial(const float* pod_req, const uint8_t* pod_mask,
                           const float* template_alloc, int32_t P, int32_t R,
                           int32_t max_nodes, int32_t cpu_axis,
                           int32_t mem_axis, uint8_t* out_scheduled) {
  if (P < 0 || R <= 0 || max_nodes < 0) return -1;
  const float cpu_cap = template_alloc[cpu_axis];
  const float mem_cap = template_alloc[mem_axis];

  // Division-free order-equivalent of cpu/cpu_cap + mem/mem_cap (see
  // ops/binpack.ffd_scores: TPU f32 divide is not correctly rounded, so
  // every FFD order producer computes this same mul/add spec; the build
  // pins -ffp-contract=off so no FMA re-rounds the sum).
  const float c_scale = cpu_cap > 0 ? cpu_cap : 1.0f;
  const float m_scale = mem_cap > 0 ? mem_cap : 1.0f;
  std::vector<float> score(P, 0.0f);
  for (int32_t i = 0; i < P; ++i) {
    const float* req = pod_req + (size_t)i * R;
    if (cpu_cap > 0) score[i] += req[cpu_axis] * m_scale;
    if (mem_cap > 0) score[i] += req[mem_axis] * c_scale;
  }
  std::vector<int32_t> order(P);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return score[a] > score[b]; });

  // open-node usage, flat [n][r]
  std::vector<float> used;
  used.reserve((size_t)std::min(max_nodes, P) * R);
  int32_t opened = 0;
  std::memset(out_scheduled, 0, P);

  for (int32_t oi = 0; oi < P; ++oi) {
    const int32_t i = order[oi];
    if (!pod_mask[i]) continue;
    const float* req = pod_req + (size_t)i * R;
    bool placed = false;
    for (int32_t n = 0; n < opened && !placed; ++n) {
      float* u = used.data() + (size_t)n * R;
      bool fits = true;
      for (int32_t r = 0; r < R; ++r) {
        if (req[r] > template_alloc[r] - u[r]) { fits = false; break; }
      }
      if (fits) {
        for (int32_t r = 0; r < R; ++r) u[r] += req[r];
        placed = true;
      }
    }
    if (!placed && opened < max_nodes) {
      bool fits_empty = true;
      for (int32_t r = 0; r < R; ++r) {
        if (req[r] > template_alloc[r]) { fits_empty = false; break; }
      }
      if (fits_empty) {
        used.resize((size_t)(opened + 1) * R, 0.0f);
        float* u = used.data() + (size_t)opened * R;
        for (int32_t r = 0; r < R; ++r) u[r] = req[r];
        ++opened;
        placed = true;
      }
    }
    out_scheduled[i] = placed ? 1 : 0;
  }
  return opened;
}

// Serial FFD with dynamic inter-pod (anti-)affinity — the compiled baseline
// for the affinity estimator bench. Mirrors the reference's
// re-run-the-InterPodAffinity-filter-after-every-placement behavior
// (binpacking_estimator.go:119-141) over the term factorization, with the
// exact semantics of estimator/reference_impl.ffd_binpack_reference_affinity
// (parity-locked in tests/test_processors_rpc_native.py): per-term counts
// (pm = pods matching term t, ha = pods holding anti term t), hostname-level
// terms scoped to the single node, other keys to the whole group, the
// Kubernetes self-match seeding rule, and the symmetric anti-affinity rule.
//
// match/aff_of/anti_of: T x P row-major (0/1); node_level/has_label: T.
// out_scheduled: P (0/1). Returns nodes opened, or -1 on error.
int32_t ffd_binpack_serial_affinity(
    const float* pod_req, const uint8_t* pod_mask, const float* template_alloc,
    int32_t P, int32_t R, int32_t max_nodes, int32_t cpu_axis,
    int32_t mem_axis, int32_t T, const uint8_t* match, const uint8_t* aff_of,
    const uint8_t* anti_of, const uint8_t* node_level,
    const uint8_t* has_label, uint8_t* out_scheduled) {
  if (P < 0 || R <= 0 || max_nodes < 0 || T < 0) return -1;
  const float cpu_cap = template_alloc[cpu_axis];
  const float mem_cap = template_alloc[mem_axis];

  // Division-free order-equivalent of cpu/cpu_cap + mem/mem_cap (see
  // ops/binpack.ffd_scores: TPU f32 divide is not correctly rounded, so
  // every FFD order producer computes this same mul/add spec; the build
  // pins -ffp-contract=off so no FMA re-rounds the sum).
  const float c_scale = cpu_cap > 0 ? cpu_cap : 1.0f;
  const float m_scale = mem_cap > 0 ? mem_cap : 1.0f;
  std::vector<float> score(P, 0.0f);
  for (int32_t i = 0; i < P; ++i) {
    const float* req = pod_req + (size_t)i * R;
    if (cpu_cap > 0) score[i] += req[cpu_axis] * m_scale;
    if (mem_cap > 0) score[i] += req[mem_axis] * c_scale;
  }
  std::vector<int32_t> order(P);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return score[a] > score[b]; });

  std::vector<float> used;          // [n][r]
  std::vector<int64_t> pm, ha;      // [n][t] per-node term counts
  std::vector<int64_t> pm_tot(T, 0), ha_tot(T, 0);
  int32_t opened = 0;
  std::memset(out_scheduled, 0, P);

  auto node_allowed = [&](int32_t i, int32_t m) -> bool {
    const int64_t* npm = pm.data() + (size_t)m * T;
    const int64_t* nha = ha.data() + (size_t)m * T;
    for (int32_t t = 0; t < T; ++t) {
      const size_t ti = (size_t)t * P + i;
      const int64_t dom_pm = node_level[t] ? npm[t] : pm_tot[t];
      const int64_t dom_ha = node_level[t] ? nha[t] : ha_tot[t];
      if (aff_of[ti]) {
        const bool seed = match[ti] && pm_tot[t] == 0;
        if (!(has_label[t] && (dom_pm > 0 || seed))) return false;
      }
      // no topology label -> no domain -> an anti term cannot be violated
      if (has_label[t] && anti_of[ti] && dom_pm > 0) return false;
      if (has_label[t] && match[ti] && dom_ha > 0) return false;
    }
    return true;
  };

  auto new_node_allowed = [&](int32_t i) -> bool {
    for (int32_t t = 0; t < T; ++t) {
      const size_t ti = (size_t)t * P + i;
      if (aff_of[ti]) {
        const bool seed = match[ti] && pm_tot[t] == 0;
        if (node_level[t]) {
          if (!seed) return false;
        } else if (!(has_label[t] && (pm_tot[t] > 0 || seed))) {
          return false;
        }
      }
      if (!node_level[t] && has_label[t]) {
        if (anti_of[ti] && pm_tot[t] > 0) return false;
        if (match[ti] && ha_tot[t] > 0) return false;
      }
    }
    return true;
  };

  auto commit = [&](int32_t i, int32_t m) {
    float* u = used.data() + (size_t)m * R;
    const float* req = pod_req + (size_t)i * R;
    for (int32_t r = 0; r < R; ++r) u[r] += req[r];
    int64_t* npm = pm.data() + (size_t)m * T;
    int64_t* nha = ha.data() + (size_t)m * T;
    for (int32_t t = 0; t < T; ++t) {
      const size_t ti = (size_t)t * P + i;
      npm[t] += match[ti];
      nha[t] += anti_of[ti];
      pm_tot[t] += match[ti];
      ha_tot[t] += anti_of[ti];
    }
  };

  for (int32_t oi = 0; oi < P; ++oi) {
    const int32_t i = order[oi];
    if (!pod_mask[i]) continue;
    const float* req = pod_req + (size_t)i * R;
    bool placed = false;
    for (int32_t n = 0; n < opened && !placed; ++n) {
      const float* u = used.data() + (size_t)n * R;
      bool fits = true;
      for (int32_t r = 0; r < R; ++r) {
        if (req[r] > template_alloc[r] - u[r]) { fits = false; break; }
      }
      if (fits && node_allowed(i, n)) {
        commit(i, n);
        placed = true;
      }
    }
    if (!placed && opened < max_nodes) {
      bool fits_empty = true;
      for (int32_t r = 0; r < R; ++r) {
        if (req[r] > template_alloc[r]) { fits_empty = false; break; }
      }
      if (fits_empty && new_node_allowed(i)) {
        used.resize((size_t)(opened + 1) * R, 0.0f);
        pm.resize((size_t)(opened + 1) * T, 0);
        ha.resize((size_t)(opened + 1) * T, 0);
        ++opened;
        commit(i, opened - 1);
        placed = true;
      }
    }
    out_scheduled[i] = placed ? 1 : 0;
  }
  return opened;
}

// Serial per-(pod,node) first-fit predicate scan — the schedulerbased.go:90
// FitsAnyNodeMatching shape, for baseline comparisons of the fit kernel.
// free: N x R row-major; mask: P x N row-major (0/1).
// out_first: P (node index or -1).
void first_fit_serial(const float* pod_req, const float* free,
                      const uint8_t* mask, int32_t P, int32_t N, int32_t R,
                      int32_t* out_first) {
  for (int32_t i = 0; i < P; ++i) {
    const float* req = pod_req + (size_t)i * R;
    int32_t hit = -1;
    const uint8_t* mrow = mask + (size_t)i * N;
    for (int32_t n = 0; n < N && hit < 0; ++n) {
      if (!mrow[n]) continue;
      const float* f = free + (size_t)n * R;
      bool fits = true;
      for (int32_t r = 0; r < R; ++r) {
        if (req[r] > f[r]) { fits = false; break; }
      }
      if (fits) hit = n;
    }
    out_first[i] = hit;
  }
}

}  // extern "C"
