// Native score-graph edge builder — the compiled core of the data path
// (host C++, built with g++ by analysisgnn_tpu_torch/kernels/build.py and
// called through analysisgnn_tpu_torch/data/native.py).
//
// The semantics and the order of analysisgnn_tpu_torch/data/graph_build.py's
// numpy builder (which mirrors the reference hetero_graph_from_note_array,
// analysisgnn/utils/hgraph.py:214-300), array for array: given notes sorted
// by onset_div, emit typed edges
//   0 onset        i→j  same onset, i≠j
//   1 consecutive  i→j  onset[j] == onset[i] + dur[i]
//   2 during       i→j  onset[i] < onset[j] < onset[i] + dur[i]
//   3 rest         i→j  silence gap between i's end and the next onset group
// each ordered by source, then destination; rest edges by the source's end,
// then source, then destination.
//
// Exposed via a C ABI for ctypes, in two calls.  agt_edge_plan stable-sorts
// the notes by end, finds every note's onset group and the onsets at its end
// by linear sweeps (no binary search), and counts each relation's edges.
// agt_edge_write then writes each relation into its own [2, E] buffer
// (sources, then destinations), so no pass splits the edges by type.

#include <algorithm>
#include <cstdint>
#include <numeric>

namespace {

// The plan's four rows of n: the end of each note's onset group, the first
// onset at or after its end, the first onset after its end, and the notes
// stable-sorted by end (the enders of one end in index order).
struct Plan {
  const int64_t* group_end;
  const int64_t* end_lo;
  const int64_t* end_hi;
  const int64_t* order;
};

// Calls emit(ender, first, last) for each silent end's enders in order, with
// [first, last) its next onset group: an end is silent if no onset falls on it
// and one comes after it; the latest end has none after it.
template <typename Emit>
void for_each_silent_end(const int64_t* onset, const int64_t* dur, int64_t n,
                         const Plan& p, Emit emit) {
  const auto end = [&](int64_t i) { return onset[i] + dur[i]; };
  const int64_t max_end = end(p.order[n - 1]);
  for (int64_t k = 0; k < n;) {
    const int64_t first = p.order[k], et = end(first);
    int64_t k2 = k + 1;
    while (k2 < n && end(p.order[k2]) == et) ++k2;
    const int64_t dlo = p.end_hi[first];
    if (et != max_end && p.end_lo[first] == dlo && dlo < n) {
      for (int64_t s = k; s < k2; ++s) emit(p.order[s], dlo, p.group_end[dlo]);
    }
    k = k2;
  }
}

}  // namespace

extern "C" {

// plan: [4, n] int64 scratch (the rows of Plan); counts: [4] int64, the
// edges of each relation.  Returns 0, or -1 if the onsets are not sorted.
int64_t agt_edge_plan(const int64_t* onset, const int64_t* dur, int64_t n,
                      int64_t* plan, int64_t* counts) {
  std::fill(counts, counts + 4, 0);
  for (int64_t i = 1; i < n; ++i) {
    if (onset[i] < onset[i - 1]) return -1;
  }
  if (n <= 0) return 0;
  int64_t* group_end = plan;
  int64_t* end_lo = plan + n;
  int64_t* end_hi = plan + 2 * n;
  int64_t* order = plan + 3 * n;

  for (int64_t a = 0; a < n;) {
    int64_t b = a + 1;
    while (b < n && onset[b] == onset[a]) ++b;
    std::fill(group_end + a, group_end + b, b);
    counts[0] += (b - a) * (b - a - 1);
    a = b;
  }

  const auto end = [&](int64_t i) { return onset[i] + dur[i]; };
  std::iota(order, order + n, int64_t{0});
  std::stable_sort(order, order + n,
                   [&](int64_t a, int64_t b) { return end(a) < end(b); });
  // the ends rise along order, so both bounds only move forward
  int64_t lo = 0, hi = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k], e = end(i);
    while (lo < n && onset[lo] < e) ++lo;
    hi = std::max(hi, lo);
    while (hi < n && onset[hi] <= e) ++hi;
    end_lo[i] = lo;
    end_hi[i] = hi;
    counts[1] += hi - lo;
    counts[2] += std::max<int64_t>(lo - group_end[i], 0);
  }

  const Plan p{group_end, end_lo, end_hi, order};
  for_each_silent_end(onset, dur, n, p, [&](int64_t, int64_t first, int64_t last) {
    counts[3] += last - first;
  });
  return 0;
}

// Writes relation t's counts[t] edges into out_t ([2, counts[t]]: sources,
// then destinations), from agt_edge_plan's plan and counts.  Returns the
// edges written.
int64_t agt_edge_write(const int64_t* onset, const int64_t* dur, int64_t n,
                       const int64_t* plan, const int64_t* counts,
                       int64_t* out_onset, int64_t* out_consecutive,
                       int64_t* out_during, int64_t* out_rest) {
  if (n <= 0) return 0;
  const Plan p{plan, plan + n, plan + 2 * n, plan + 3 * n};
  int64_t* out[4] = {out_onset, out_consecutive, out_during, out_rest};
  int64_t written[4] = {0, 0, 0, 0};
  const auto emit = [&](int t, int64_t s, int64_t d) {
    out[t][written[t]] = s;
    out[t][counts[t] + written[t]] = d;
    ++written[t];
  };

  for (int64_t a = 0; a < n; a = p.group_end[a]) {
    for (int64_t i = a; i < p.group_end[a]; ++i)
      for (int64_t j = a; j < p.group_end[a]; ++j)
        if (i != j) emit(0, i, j);
  }
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = p.end_lo[i]; j < p.end_hi[i]; ++j) emit(1, i, j);
    for (int64_t j = p.group_end[i]; j < p.end_lo[i]; ++j) emit(2, i, j);
  }
  for_each_silent_end(onset, dur, n, p, [&](int64_t s, int64_t first, int64_t last) {
    for (int64_t j = first; j < last; ++j) emit(3, s, j);
  });
  return written[0] + written[1] + written[2] + written[3];
}

}  // extern "C"
