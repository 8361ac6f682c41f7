// Scheduling policy library — C++ core of the node-selection path.
//
// Reference analog: src/ray/raylet/scheduling/policy/
// hybrid_scheduling_policy.cc:99-186 and the fixed-point resource
// arithmetic in src/ray/common/scheduling/ (FixedPoint, ResourceSet).
// The policy semantics mirror the reference's HybridSchedulingPolicy:
//   1. filter to alive, non-excluded nodes whose TOTAL resources fit the
//      demand (feasibility);
//   2. among nodes whose AVAILABLE resources fit, score each by
//      critical-resource utilization (max over resource kinds of
//      (used + demand) / total) — lower is better;
//   3. nodes scoring <= spread_threshold tie at the threshold (the
//      reference's clamp that spreads load instead of bin-packing onto
//      the emptiest node);
//   4. pick uniformly among the top_k best-scoring candidates
//      (top_k = max(1, min(top_k, #candidates)));
//   5. if nothing is available, fall back to the first feasible-but-busy
//      node; else report infeasible (-1).
//
// Resource QUANTITIES use fixed-point int64 micros (reference
// FixedPoint) for exact feasibility comparisons; utilization RATIOS are
// computed in double — a micros-scale multiply overflows int64 for
// byte-denominated resources like memory (64e9 * 1e6 >> 2^63).
// Exposed via C ABI for ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr double kScale = 1e6;  // fixed-point micros

int64_t fp(double x) {
  // clamp: 10TB-in-bytes scale quantities must not overflow the micros
  // representation (comparisons remain correct at the clamp)
  double scaled = x * kScale;
  constexpr double kMax = 9.0e18;
  if (scaled >= kMax) return static_cast<int64_t>(kMax);
  if (scaled <= -kMax) return -static_cast<int64_t>(kMax);
  return static_cast<int64_t>(scaled + 0.5);
}

}  // namespace

extern "C" {

// totals/avails: [n_nodes * n_kinds] row-major; demand: [n_kinds].
// alive/exclude: per-node flags. Returns the chosen node index or -1.
// Deterministic for a given seed (seed only matters when top_k > 1).
int sched_pick_node(const double* totals, const double* avails,
                    const unsigned char* alive,
                    const unsigned char* excluded, int n_nodes,
                    const double* demand, int n_kinds,
                    double spread_threshold, int top_k,
                    unsigned int seed) {
  std::vector<int64_t> dem(n_kinds);
  bool zero_demand = true;
  for (int k = 0; k < n_kinds; k++) {
    dem[k] = fp(demand[k]);
    if (dem[k] > 0) zero_demand = false;
  }
  (void)zero_demand;

  struct Cand {
    int node;
    double score;
  };
  std::vector<Cand> cands;
  int feasible_busy = -1;

  for (int i = 0; i < n_nodes; i++) {
    if (!alive[i] || excluded[i]) continue;
    const double* tot = totals + static_cast<int64_t>(i) * n_kinds;
    const double* avl = avails + static_cast<int64_t>(i) * n_kinds;
    bool feasible = true, available = true;
    double crit = 0.0;  // max over kinds of (used + demand) / total
    for (int k = 0; k < n_kinds; k++) {
      int64_t t = fp(tot[k]);
      int64_t a = fp(avl[k]);
      if (dem[k] > 0) {
        if (t < dem[k]) {
          feasible = false;
          break;
        }
        if (a < dem[k]) available = false;
      } else if (t <= 0) {
        continue;  // kind absent on the node AND not demanded: ignore
      }
      // zero-demand kinds still contribute their utilization (matches
      // the Python policy: a TPU-saturated node scores worse even for
      // num_tpus=0 tasks)
      double util = t <= 0 ? 0.0
                           : static_cast<double>((t - a) + dem[k])
                                 / static_cast<double>(t);
      if (util > 1.0) util = 1.0;
      if (util > crit) crit = util;
    }
    if (!feasible) continue;
    if (!available) {
      if (feasible_busy < 0) feasible_busy = i;
      continue;
    }
    // spread clamp: everything at or below the threshold ties
    double clamped = crit <= spread_threshold ? spread_threshold : crit;
    cands.push_back({i, clamped});
  }

  if (cands.empty()) return feasible_busy;

  // partial sort by (score, node index) for determinism
  for (size_t i = 0; i < cands.size(); i++) {
    size_t best = i;
    for (size_t j = i + 1; j < cands.size(); j++) {
      if (cands[j].score < cands[best].score ||
          (cands[j].score == cands[best].score &&
           cands[j].node < cands[best].node)) {
        best = j;
      }
    }
    if (best != i) std::swap(cands[i], cands[best]);
  }
  int k = top_k < 1 ? 1 : top_k;
  if (static_cast<size_t>(k) > cands.size())
    k = static_cast<int>(cands.size());
  // splitmix-style mixer: one xorshift round is linear enough that
  // small consecutive seeds all collapse to the same residue mod small k
  unsigned int x = seed + 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return cands[x % k].node;
}

// Batch scoring helper (autoscaler / tests): writes per-node critical
// utilization (or -1 when infeasible) into scores_out [n_nodes].
void sched_score_nodes(const double* totals, const double* avails,
                       const unsigned char* alive, int n_nodes,
                       const double* demand, int n_kinds,
                       double* scores_out) {
  for (int i = 0; i < n_nodes; i++) {
    scores_out[i] = -1.0;
    if (!alive[i]) continue;
    const double* tot = totals + static_cast<int64_t>(i) * n_kinds;
    const double* avl = avails + static_cast<int64_t>(i) * n_kinds;
    bool feasible = true;
    double crit = 0.0;
    for (int k = 0; k < n_kinds; k++) {
      int64_t d = fp(demand[k]);
      int64_t t = fp(tot[k]);
      if (d > 0 && t < d) {
        feasible = false;
        break;
      }
      if (t <= 0) continue;
      double util = static_cast<double>((t - fp(avl[k])) + d)
                    / static_cast<double>(t);
      if (util > 1.0) util = 1.0;
      if (util > crit) crit = util;
    }
    if (feasible) scores_out[i] = crit;
  }
}

}  // extern "C"
