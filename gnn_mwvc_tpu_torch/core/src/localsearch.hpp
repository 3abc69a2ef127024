// Anytime weighted local search over the irreducible core — the FastWVC
// family (capability-equivalent to the reference's local_search.hpp):
// remove the heap-best cover vertex, greedily re-cover uncovered edges with
// dynamic edge-weight inflation, configuration checking and age tiebreaks,
// tracking both the snapshotted best cover and the cheapest cost ever seen
// (the reference README's "written" vs "best seen" distinction).
//
// Re-designed around an indexed 4-ary min-heap (shallower than binary for
// the update-heavy workload) and flat CSR adjacency with an uncovered
// partition point per vertex.

#pragma once
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <limits>
#include <vector>

namespace mwvc {

class LocalSearch {
  public:
    using u32 = uint32_t;
    using u64 = uint64_t;

    u32 n = 0, m = 0;
    std::vector<u32> adj_nbr, adj_eid;     // grouped per vertex
    std::vector<u32> adj_off;              // n+1
    std::vector<u32> part;                 // per-vertex partition cursor
    std::vector<u32> wt, edge_w, dscore, age;
    std::vector<u32> eu, ev;
    std::vector<uint8_t> in_s, best_s, conf;
    u64 cost = 0, best_cost = 0, best_seen = UINT64_MAX;
    u64 step = 0;

    // indexed min-heap
    std::vector<u32> heap, hpos;

    void init(u32 n_, const u32 *weights, u32 m_, const u32 *eu_,
              const u32 *ev_, const uint8_t *s0) {
        n = n_;
        m = m_;
        wt.assign(weights, weights + n);
        eu.assign(eu_, eu_ + m);
        ev.assign(ev_, ev_ + m);
        edge_w.assign(m, 1);
        dscore.assign(n, 0);
        age.assign(n, 0);
        conf.assign(n, 1);
        in_s.assign(s0, s0 + n);
        best_s.assign(n, 0);

        adj_off.assign(n + 1, 0);
        for (u32 i = 0; i < m; ++i) {
            adj_off[eu[i] + 1]++;
            adj_off[ev[i] + 1]++;
        }
        for (u32 i = 0; i < n; ++i)
            adj_off[i + 1] += adj_off[i];
        adj_nbr.resize(2ull * m);
        adj_eid.resize(2ull * m);
        std::vector<u32> fill(adj_off.begin(), adj_off.end() - 1);
        for (u32 i = 0; i < m; ++i) {
            adj_nbr[fill[eu[i]]] = ev[i];
            adj_eid[fill[eu[i]]++] = i;
            adj_nbr[fill[ev[i]]] = eu[i];
            adj_eid[fill[ev[i]]++] = i;
        }
        part.assign(adj_off.begin(), adj_off.end() - 1);

        cost = 0;
        for (u32 u = 0; u < n; ++u)
            if (in_s[u])
                cost += wt[u];
        // dscore init: #edges covered solely by this vertex
        for (u32 i = 0; i < m; ++i) {
            if (in_s[eu[i]] && !in_s[ev[i]])
                dscore[eu[i]]++;
            else if (!in_s[eu[i]] && in_s[ev[i]])
                dscore[ev[i]]++;
        }
        // drop redundant cover vertices (reference: local_search.hpp:89-97)
        for (u32 u = 0; u < n; ++u) {
            if (in_s[u] && dscore[u] == 0) {
                in_s[u] = 0;
                cost -= wt[u];
                for (u32 k = adj_off[u]; k < adj_off[u + 1]; ++k)
                    dscore[adj_nbr[k]]++;
            }
        }
        best_s = in_s;
        best_cost = cost;
        best_seen = cost;

        heap.resize(n);
        hpos.resize(n);
        for (u32 i = 0; i < n; ++i) {
            heap[i] = i;
            hpos[i] = i;
        }
        build_heap();
    }

    // ---- heap: top = cheapest-to-remove cover vertex ---------------------
    // priority: removable (in_s && conf) first; among removable, smaller
    // dscore/weight first; ties broken by smaller age.
    inline bool before(u32 a, u32 b) const {
        bool ra = in_s[a] && conf[a], rb = in_s[b] && conf[b];
        if (!ra)
            return false;
        if (!rb)
            return true;
        u64 lhs = (u64)dscore[a] * wt[b], rhs = (u64)dscore[b] * wt[a];
        if (lhs != rhs)
            return lhs < rhs;
        return age[a] < age[b];
    }

    static constexpr u32 ARITY = 4;

    void sift_up(u32 u) {
        u32 i = hpos[u];
        while (i > 0) {
            u32 p = (i - 1) / ARITY;
            if (!before(heap[i], heap[p]))
                break;
            std::swap(hpos[heap[i]], hpos[heap[p]]);
            std::swap(heap[i], heap[p]);
            i = p;
        }
    }

    void sift_down(u32 u) {
        u32 i = hpos[u];
        for (;;) {
            u32 c0 = i * ARITY + 1;
            if (c0 >= n)
                break;
            u32 best = c0;
            u32 cend = std::min(c0 + ARITY, n);
            for (u32 c = c0 + 1; c < cend; ++c)
                if (before(heap[c], heap[best]))
                    best = c;
            if (!before(heap[best], heap[i]))
                break;
            std::swap(hpos[heap[i]], hpos[heap[best]]);
            std::swap(heap[i], heap[best]);
            i = best;
        }
    }

    void build_heap() {
        for (u32 i = n; i-- > 0;)
            sift_down(heap[i]);
    }

    inline void update(u32 u) {
        sift_up(u);
        sift_down(u);
    }

    // ---- one batch of search steps (reference: local_search.hpp:149-210)
    // Returns true if the snapshotted best improved.
    bool search(u32 iterations, double time_budget) {
        auto t0 = std::chrono::steady_clock::now();
        std::vector<std::pair<u32, u32>> order;  // (nbr, eid)
        for (u32 it = 0; it < iterations; ++it) {
            step++;
            if (std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                              t0)
                    .count() >= time_budget)
                break;

            u32 u = heap[0];
            if (!in_s[u]) {
                // no removable candidate: reset configuration flags
                // (kept for parity with the reference's CC mechanism)
                for (u32 v = 0; v < n; ++v) {
                    if (in_s[v] && !conf[v]) {
                        conf[v] = 1;
                        update(v);
                    }
                }
                continue;
            }
            in_s[u] = 0;
            cost -= wt[u];
            dscore[u] = 0;
            age[u] = (u32)step;
            update(u);

            // Process u's adjacency with now-uncovered endpoints first,
            // ordered by edge_w/w desc then age asc, then the still-covered
            // ones (the reference's partition + sort,
            // local_search.hpp:171-175).
            order.clear();
            for (u32 k = adj_off[u]; k < adj_off[u + 1]; ++k)
                order.push_back({adj_nbr[k], adj_eid[k]});
            auto mid = std::partition(
                order.begin(), order.end(),
                [&](const auto &a) { return !in_s[a.first]; });
            std::sort(order.begin(), mid, [&](const auto &a, const auto &b) {
                u64 lhs = (u64)edge_w[a.second] * wt[b.first];
                u64 rhs = (u64)edge_w[b.second] * wt[a.first];
                if (lhs != rhs)
                    return lhs > rhs;
                return age[a.first] < age[b.first];
            });

            u32 count = 1;
            for (auto &[v, id] : order) {
                if (!in_s[v]) {
                    age[v] = (u32)step;
                    in_s[v] = 1;
                    cost += wt[v];
                    edge_w[id] += count;
                    dscore[v] = edge_w[id];
                    update(v);
                    for (u32 k = adj_off[v]; k < adj_off[v + 1]; ++k) {
                        u32 x = adj_nbr[k];
                        if (x == u)
                            continue;
                        dscore[x] -= edge_w[adj_eid[k]];  // u32 wrap == ref
                        update(x);
                    }
                    count++;
                } else {
                    dscore[v] += edge_w[id];
                    update(v);
                }
            }
            if (cost < best_seen)
                best_seen = cost;
        }
        if (cost < best_cost) {
            best_cost = cost;
            best_s = in_s;
            return true;
        }
        return false;
    }

    // ---- diversification helpers (beyond-reference anytime behavior) ----
    // The reference phase-2 search has none; these implement the classic ILS
    // recipe (HILS main.cpp:215-340 pattern): intensify by restoring the
    // best cover, diversify by forcing k random removals + greedy repair.

    // Rebuild dscores from scratch under the current cover and edge weights,
    // reset configuration flags, rebuild the heap.  O(n + m).
    void rebuild_scores() {
        std::fill(dscore.begin(), dscore.end(), 0);
        for (u32 i = 0; i < m; ++i) {
            u32 a = eu[i], b = ev[i];
            if (in_s[a] && !in_s[b])
                dscore[a] += edge_w[i];
            else if (!in_s[a] && in_s[b])
                dscore[b] += edge_w[i];
            else if (!in_s[a] && !in_s[b]) {  // uncovered (mid-perturbation)
                dscore[a] += edge_w[i];
                dscore[b] += edge_w[i];
            }
        }
        std::fill(conf.begin(), conf.end(), 1);
        build_heap();
    }

    // Intensification: jump back to the snapshotted best cover, keeping the
    // learned edge weights (the landscape) and ages (the history).
    void restore_best() {
        in_s = best_s;
        cost = best_cost;
        rebuild_scores();
    }

    static inline u64 splitmix64(u64 &seed) {
        seed += 0x9e3779b97f4a7c15ull;
        u64 z = seed;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return z ^ (z >> 31);
    }

    // Greedy repair over the uncovered edges (add the endpoint with the
    // better gain/weight ratio, FastWVC-ConstructVC style); shared by the
    // uniform and guided kicks.
    void repair_greedy() {
        std::vector<u32> uncov;
        std::vector<u64> gain(n, 0);
        for (u32 i = 0; i < m; ++i) {
            if (!in_s[eu[i]] && !in_s[ev[i]]) {
                uncov.push_back(i);
                gain[eu[i]] += edge_w[i];
                gain[ev[i]] += edge_w[i];
            }
        }
        for (u32 id : uncov) {
            u32 a = eu[id], b = ev[id];
            if (in_s[a] || in_s[b])
                continue;
            u32 v = ((double)gain[a] / wt[a] >= (double)gain[b] / wt[b]) ? a
                                                                         : b;
            in_s[v] = 1;
            cost += wt[v];
            age[v] = (u32)step;
            for (u32 j = adj_off[v]; j < adj_off[v + 1]; ++j) {
                u32 x = adj_nbr[j];
                if (!in_s[x])
                    gain[x] -= std::min<u64>(gain[x], edge_w[adj_eid[j]]);
            }
        }
        if (cost < best_seen)
            best_seen = cost;
        rebuild_scores();
    }

    // Diversification: remove k random cover vertices, then repair.  Call
    // after restore_best for the standard ILS kick.  Deterministic per seed.
    void perturb(u32 k, u64 seed) {
        step++;
        for (u32 t = 0, done = 0; done < k && t < 16 * k + 64; ++t) {
            u32 u = (u32)(splitmix64(seed) % n);
            if (!in_s[u])
                continue;
            in_s[u] = 0;
            cost -= wt[u];
            age[u] = (u32)step;
            done++;
        }
        repair_greedy();
    }

    // GNN-guided kick (round 3, device-assisted phase 2): removal targets
    // are sampled with acceptance probability bias[u] in [0,1] — the
    // model's "u should not be in the cover" signal, computed on device
    // over the kernel (solver/device_assist.py) — so diversification aims
    // where the trained prior disagrees with the incumbent instead of
    // uniformly at random.  Falls back to uniform acceptance for vertices
    // past the bias array (gadget-id safety).
    void perturb_guided(u32 k, u64 seed, const float *bias, u32 bias_n) {
        step++;
        for (u32 t = 0, done = 0; done < k && t < 64 * k + 256; ++t) {
            u32 u = (u32)(splitmix64(seed) % n);
            if (!in_s[u])
                continue;
            float b = u < bias_n ? bias[u] : 1.0f;
            if ((splitmix64(seed) & 0xffffffu) >= (u64)(b * 16777216.0f))
                continue;
            in_s[u] = 0;
            cost -= wt[u];
            age[u] = (u32)step;
            done++;
        }
        repair_greedy();
    }

    // ---- device-batched region re-optimization (round 3) -----------------
    // The reference keeps its single CPU busy for the whole budget
    // (reference: src/GNN_VC.cpp:338-358, local_search.hpp:149-210); here
    // the otherwise-idle device works phase 2 too: the host extracts
    // boundary-conditioned <=16-vertex sub-instances around model-misfit
    // centers, the device exact-solves thousands per call by 2^16 subset
    // enumeration (ops/smallsolve.py), and proven improvements are patched
    // back between search batches (SURVEY §2.4 host<->device row).

    std::vector<u32> region_mark;  // per-vertex claim epoch
    u32 region_epoch = 0;

    // Start a new extraction batch: regions within one batch are disjoint,
    // so their patches can be validated and applied independently.
    void begin_region_batch() {
        if (region_mark.empty())
            region_mark.assign(n, 0);
        region_epoch++;
    }

    // Grow a BFS region (<= rmax <= 20 vertices: local adjacency is an
    // int32 bitmask; the device kernels solve 2^16 by enumeration and up
    // to 2^20 by meet-in-the-middle) around center c, skipping
    // vertices claimed earlier in this batch; emit the boundary-conditioned
    // exact instance: local adjacency bitmasks (a self-loop forces the
    // vertex into the cover — an outside non-cover neighbor pins it),
    // int32 weights, and the region's vertex ids.  Returns k (0 = center
    // already claimed or the region's weight sum would overflow int32).
    u32 extract_region(u32 c, u32 rmax, u32 *ids, int32_t *adj_out,
                       int32_t *w_out) {
        if (rmax > 20)
            rmax = 20;
        if (region_mark[c] == region_epoch)
            return 0;
        u32 k = 0;
        ids[k++] = c;
        region_mark[c] = region_epoch;
        for (u32 qi = 0; qi < k && k < rmax; ++qi) {
            u32 u = ids[qi];
            for (u32 e = adj_off[u]; e < adj_off[u + 1] && k < rmax; ++e) {
                u32 x = adj_nbr[e];
                if (region_mark[x] != region_epoch) {
                    region_mark[x] = region_epoch;
                    ids[k++] = x;
                }
            }
        }
        u64 wsum = 0;
        for (u32 i = 0; i < k; ++i) {
            adj_out[i] = 0;
            w_out[i] = (int32_t)wt[ids[i]];
            wsum += wt[ids[i]];
        }
        if (wsum >= (1u << 30))
            return 0;  // keep 2^16-subset costs safely inside int32
        for (u32 i = 0; i < k; ++i) {
            u32 u = ids[i];
            for (u32 e = adj_off[u]; e < adj_off[u + 1]; ++e) {
                u32 x = adj_nbr[e];
                int j = -1;
                for (u32 t = 0; t < k; ++t)
                    if (ids[t] == x) {
                        j = (int)t;
                        break;
                    }
                if (j >= 0)
                    adj_out[i] |= (int32_t)(1u << j);
                else if (!in_s[x])
                    adj_out[i] |= (int32_t)(1u << i);  // forced into cover
            }
        }
        return k;
    }

    std::vector<u32> touch_mark;  // dedup stamp for 1-ring refreshes
    u32 touch_epoch = 0;

    // Recompute one vertex's dscore from scratch under the current cover
    // and edge weights (O(deg)), reset its CC flag, fix its heap slot.
    inline void refresh_vertex(u32 x) {
        // in cover: sum of edges x covers alone; out of cover: sum of
        // uncovered incident edges — the same expression either way
        u32 ds = 0;
        for (u32 e = adj_off[x]; e < adj_off[x + 1]; ++e)
            if (!in_s[adj_nbr[e]])
                ds += edge_w[adj_eid[e]];
        dscore[x] = ds;
        conf[x] = 1;
        update(x);
    }

    // Validate + apply a device-proved region assignment (bit i of
    // new_mask = ids[i] in cover).  Rejects unless the local cost strictly
    // improves AND every edge incident to a removed vertex stays covered
    // (the surrounding cover may have drifted since extraction).  dscores,
    // CC flags and heap slots are refreshed INCREMENTALLY over the changed
    // vertices' 1-ring (~regionsize*deg work), so patching never pays the
    // O(n+m) rebuild the uniform kicks use.
    //
    // This copy differs from the JAX package's in one place: `changed`
    // holds every vertex a u32 mask can name (32), where that copy has 16
    // entries and a width-20 region whose patch flips more than 16 vertices
    // writes past the buffer.  A region wider than the mask is rejected
    // before anything is written.
    int apply_region(u32 k, const u32 *ids, u32 new_mask) {
        if (k > 32)
            return 0;
        u64 old_c = 0, new_c = 0;
        for (u32 i = 0; i < k; ++i) {
            u32 u = ids[i];
            if (in_s[u])
                old_c += wt[u];
            if ((new_mask >> i) & 1)
                new_c += wt[u];
        }
        if (new_c >= old_c)
            return 0;
        for (u32 i = 0; i < k; ++i) {
            if ((new_mask >> i) & 1)
                continue;
            u32 u = ids[i];
            for (u32 e = adj_off[u]; e < adj_off[u + 1]; ++e) {
                u32 x = adj_nbr[e];
                int j = -1;
                for (u32 t = 0; t < k; ++t)
                    if (ids[t] == x) {
                        j = (int)t;
                        break;
                    }
                bool covered =
                    (j >= 0) ? (((new_mask >> j) & 1) != 0) : (in_s[x] != 0);
                if (!covered)
                    return 0;
            }
        }
        step++;
        if (touch_mark.empty())
            touch_mark.assign(n, 0);
        touch_epoch++;
        u32 changed[32];
        u32 nchanged = 0;
        for (u32 i = 0; i < k; ++i) {
            u32 u = ids[i];
            bool nv = (new_mask >> i) & 1;
            if (in_s[u] && !nv) {
                in_s[u] = 0;
                cost -= wt[u];
                age[u] = (u32)step;
                changed[nchanged++] = u;
            } else if (!in_s[u] && nv) {
                in_s[u] = 1;
                cost += wt[u];
                age[u] = (u32)step;
                changed[nchanged++] = u;
            }
        }
        for (u32 i = 0; i < nchanged; ++i) {
            u32 u = changed[i];
            if (touch_mark[u] != touch_epoch) {
                touch_mark[u] = touch_epoch;
                refresh_vertex(u);
            }
            for (u32 e = adj_off[u]; e < adj_off[u + 1]; ++e) {
                u32 x = adj_nbr[e];
                if (touch_mark[x] != touch_epoch) {
                    touch_mark[x] = touch_epoch;
                    refresh_vertex(x);
                }
            }
        }
        if (cost < best_seen)
            best_seen = cost;
        return 1;
    }

    // After a patch batch: snapshot if improved (dscores/heap were kept
    // live incrementally by apply_region).
    bool commit_patches() {
        if (cost < best_cost) {
            best_cost = cost;
            best_s = in_s;
            return true;
        }
        return false;
    }

    // ---- diversification: edge-weight forgetting -------------------------
    // The GNN_VC phase-2 search has no diversification (reference:
    // local_search.hpp); FastWVC's ForgetEdgeWeights (FastWVC/mwvc.h:734)
    // decays the learned edge weights so the dscore landscape flattens and
    // the search escapes the basin it has over-fit.  Opt-in: the solve
    // driver invokes it when the step-size floor stalls (beyond-reference
    // anytime behavior; off by default for trajectory parity).
    void forget(double scale) {
        for (u32 i = 0; i < m; ++i) {
            edge_w[i] = (u32)(edge_w[i] * scale);
            if (edge_w[i] < 1)
                edge_w[i] = 1;
        }
        // rebuild dscores from scratch under the new weights
        std::fill(dscore.begin(), dscore.end(), 0);
        for (u32 i = 0; i < m; ++i) {
            u32 a = eu[i], b = ev[i];
            if (in_s[a] && !in_s[b])
                dscore[a] += edge_w[i];
            else if (!in_s[a] && in_s[b])
                dscore[b] += edge_w[i];
            // both-in edges contribute 0 (removing either keeps it covered);
            // both-out cannot happen between steps (the cover is valid)
        }
        build_heap();
    }
};

}  // namespace mwvc
