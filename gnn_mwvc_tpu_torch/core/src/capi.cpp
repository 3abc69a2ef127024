// C API over the MWVC host core (solver + local search), consumed from
// Python via ctypes (gnn_mwvc_tpu/core/api.py).
#include "baselines.hpp"
#include "cpuforward.hpp"
#include "heuristics.hpp"
#include "localsearch.hpp"
#include "metisio.hpp"
#include "solver.hpp"

using namespace mwvc;

extern "C" {

// ---- native CPU GNN forward (cpuforward.hpp) ------------------------------
void mwvc_cpu_forward(u32 n, const u64 *indptr, const u32 *indices,
                      const u32 *wts, const u64 *nw, const u32 *deg,
                      float ws, u32 n_layers, const int8_t *kinds,
                      const int32_t *dims, const float *params, float *out,
                      u32 n_threads) {
    cpu_forward(n, indptr, indices, wts, nw, deg, ws, n_layers, kinds,
                dims, params, out, n_threads);
}

// ---- solver ---------------------------------------------------------------
void *mwvc_create(u32 n, const u32 *weights, u64 m, const u32 *eu,
                  const u32 *ev, u32 num_rules) {
    auto *s = new Solver();
    s->init(n, weights, m, eu, ev, num_rules);
    return s;
}

void mwvc_destroy(void *h) { delete (Solver *)h; }

void mwvc_reduce(void *h, int do_critical) {
    ((Solver *)h)->reduce(do_critical != 0);
}

u32 mwvc_n_nodes(void *h) { return ((Solver *)h)->g.size(); }
u32 mwvc_n_org(void *h) { return ((Solver *)h)->n_org; }
u32 mwvc_active_count(void *h) { return ((Solver *)h)->g.n_active; }
u64 mwvc_cost(void *h) { return ((Solver *)h)->cost; }
u64 mwvc_timestamp(void *h) { return ((Solver *)h)->timestamp(); }
u64 mwvc_label_count(void *h) { return ((Solver *)h)->wl.label_count; }
void mwvc_reset_label_count(void *h) { ((Solver *)h)->wl.label_count = 0; }

void mwvc_counters(void *h, u64 *out8) {
    auto *s = (Solver *)h;
    for (int i = 0; i < 8; ++i)
        out8[i] = s->cnt.r[i];
}

int mwvc_is_active(void *h, u32 u) { return ((Solver *)h)->g.active[u]; }
int mwvc_decided(void *h, u32 u) { return ((Solver *)h)->S[u]; }

void mwvc_select_node(void *h, u32 u) { ((Solver *)h)->select_node(u); }
void mwvc_select_neighborhood(void *h, u32 u) {
    ((Solver *)h)->select_neighborhood(u);
}

u64 mwvc_snapshot_edges(void *h) {
    auto *s = (Solver *)h;
    u64 e = 0;
    for (u32 u = 0; u < s->g.size(); ++u)
        if (s->g.active[u])
            e += s->g.deg[u];
    return e;
}

// Compacted CSR of the active subgraph, rows in ascending node id.
// ids: n_act core ids; wts/deg/nw per row; indptr n_act+1; indices directed.
u32 mwvc_snapshot(void *h, u32 *ids, u32 *wts, u64 *nw, u32 *deg, u64 *indptr,
                  u32 *indices) {
    auto *s = (Solver *)h;
    RevGraph &g = s->g;
    u32 n = g.size(), k = 0;
    std::vector<u32> newid(n, UINT32_MAX);
    for (u32 u = 0; u < n; ++u)
        if (g.active[u]) {
            newid[u] = k;
            ids[k] = u;
            // clamp (not wrap) fold-grown weights that exceed the u32
            // snapshot field; scoring consumes f32 anyway and the clamp is
            // monotone where a wrap would invert comparisons
            wts[k] = (u32)std::min<u64>(g.w[u], UINT32_MAX);
            nw[k] = g.nw[u];
            deg[k] = g.deg[u];
            k++;
        }
    u64 p = 0;
    for (u32 i = 0; i < k; ++i) {
        indptr[i] = p;
        u32 u = ids[i];
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next)
            indices[p++] = newid[g.arena[e].nbr];
        indptr[i + 1] = p;
    }
    return k;
}

// Bulk-apply rule-1 (neighborhood reduction) candidates from a device
// prepass: each id is re-verified against live state (NW <= W, active)
// before applying, so stale device masks are safe.  Returns #applied.
u32 mwvc_bulk_r1(void *h, const u32 *ids, u32 k) {
    auto *s = (Solver *)h;
    u32 applied = 0;
    for (u32 i = 0; i < k; ++i) {
        u32 u = ids[i];
        if (u >= s->g.size() || !s->g.active[u])
            continue;
        if (s->g.nw[u] <= s->g.w[u]) {
            s->cnt.r[0] += s->g.deg[u] + 1;
            s->mark_closed_2hop_dirty(u);
            s->select_neighborhood(u);
            applied++;
        }
    }
    return applied;
}

void mwvc_bulk_begin(void *h) { ((Solver *)h)->begin_bulk_pass(); }

// Confidence-sort comparator of the peel loop (reference: GNN_VC.cpp:194-205
// via the vectorized analog in solver/pipeline.py confidence_order): primary
// key eps-bucketed min(p, 1-p) ascending; within a bucket exclusions first;
// inclusion ties by weight asc then degree desc, exclusion ties by weight
// desc then degree asc; stable.  One packed-key std::sort replaces a 4-key
// numpy lexsort (~2x on 1.4M rows, called every peel round).
void mwvc_confidence_order(u32 n, const float *prob, const u64 *w,
                           const u32 *deg, double eps, u32 *out) {
    struct K {
        u64 a, b;  // a = bucket<<1 | incl; b = weight key (full 64-bit)
        u32 c, i;  // c = degree key; i = stability tie-break
    };
    std::vector<K> ks(n);
    for (u32 i = 0; i < n; ++i) {
        float p = prob[i];
        // all-f32 arithmetic, matching the numpy fallback exactly
        // (np.minimum(prob, 1.0 - prob) / eps stays float32)
        float av = std::min(p, 1.0f - p);
        u64 bucket = (u64)std::floor(av / (float)eps);
        u64 incl = p > 0.5f ? 1 : 0;
        u64 wkey = incl ? w[i] : ~w[i];
        u32 dkey = incl ? ~deg[i] : deg[i];
        ks[i] = {bucket << 1 | incl, wkey, dkey, i};
    }
    std::sort(ks.begin(), ks.end(), [](const K &x, const K &y) {
        if (x.a != y.a)
            return x.a < y.a;
        if (x.b != y.b)
            return x.b < y.b;
        if (x.c != y.c)
            return x.c < y.c;
        return x.i < y.i;  // stability, matching np.lexsort
    });
    for (u32 i = 0; i < n; ++i)
        out[i] = ks[i].i;
}

// Live per-node state over the full id space [0, size) — O(n) memcpy-grade,
// no CSR walk.  The sticky-scoring path (solver/static_score.py) refreshes
// node features each round from this instead of re-snapshotting the graph.
void mwvc_node_arrays(void *h, uint8_t *active, u64 *w, u64 *nw, u32 *deg) {
    auto *s = (Solver *)h;
    u32 n = s->g.size();
    for (u32 u = 0; u < n; ++u) {
        active[u] = s->g.active[u] ? 1 : 0;
        w[u] = (u64)s->g.w[u];  // u64: twin folds sum weights past 2^32
        nw[u] = (u64)s->g.nw[u];
        deg[u] = s->g.deg[u];
    }
}

// Directed live-edge count (sum of active degrees): the size-routing
// input for the sticky/sharded scorers, without copying node arrays out.
u64 mwvc_live_edges(void *h) {
    auto *s = (Solver *)h;
    const u32 n = s->g.size();
    u64 e = 0;
    for (u32 u = 0; u < n; ++u)
        if (s->g.active[u])
            e += s->g.deg[u];
    return e;
}

// Live (active, w, deg) over an id range [lo, hi) — the gadget-node tail
// created by folds after a sticky build; O(hi - lo).
void mwvc_node_range(void *h, u32 lo, u32 hi, uint8_t *act, u64 *w,
                     u32 *deg) {
    auto *s = (Solver *)h;
    for (u32 u = lo; u < hi; ++u) {
        act[u - lo] = s->g.active[u] ? 1 : 0;
        w[u - lo] = (u64)s->g.w[u];
        deg[u - lo] = s->g.deg[u];
    }
}

// One-pass delta refresh for sticky scoring (solver/static_score.py,
// solver/sharded_score.py): for each static-build row r (live node id
// ids[r]) compare the live (w, nw, deg, active) against the caller's raw
// previous copies, update those in place, and emit changed rows into the
// fixed-capacity device-delta buffers as the f32 values the forward
// consumes.  Returns the TOTAL changed count — when it exceeds max_out
// the caller full-uploads from the (fully updated) prev arrays instead.
// Replaces a ~10-pass numpy gather/compare chain (~1 s/round at road1600
// scale, r5a record: seconds_prep 48 s over 50 rounds).
u32 mwvc_sticky_deltas(void *h, u32 k, const u32 *ids, u64 *prev_w,
                       u64 *prev_nw, u32 *prev_deg, uint8_t *prev_act,
                       int32_t *out_idx, float *out_vw, float *out_vnw,
                       float *out_vdeg, uint8_t *out_vm, u32 max_out) {
    auto *s = (Solver *)h;
    u32 cnt = 0;
    for (u32 r = 0; r < k; ++r) {
        const u32 u = ids[r];
        const u64 wv = (u64)s->g.w[u];
        const u64 nwv = (u64)s->g.nw[u];
        const u32 dv = s->g.deg[u];
        const uint8_t av = s->g.active[u] ? 1 : 0;
        if (wv != prev_w[r] || nwv != prev_nw[r] || dv != prev_deg[r] ||
            av != prev_act[r]) {
            if (cnt < max_out) {
                out_idx[cnt] = (int32_t)r;
                out_vw[cnt] = (float)wv;
                out_vnw[cnt] = (float)nwv;
                out_vdeg[cnt] = (float)dv;
                out_vm[cnt] = av;
            }
            prev_w[r] = wv;
            prev_nw[r] = nwv;
            prev_deg[r] = dv;
            prev_act[r] = av;
            ++cnt;
        }
    }
    return cnt;
}

// Bulk-apply rule-5 (neighborhood meta-reduction) verdicts from the device
// batched exact solver (ops/rules.py r5_candidates).  The device proved
// W(u) >= NW(u) - VC(N(u)) on the snapshot instance; that proof transfers to
// live state iff u's 1-hop instance is untouched since the pass began, i.e.
// u and every current neighbor are clean.  Dirty candidates are skipped —
// the worklist engine re-derives them later.  Returns #applied.
u32 mwvc_bulk_r5(void *h, const u32 *ids, u32 k) {
    auto *s = (Solver *)h;
    u32 applied = 0;
    for (u32 i = 0; i < k; ++i) {
        u32 u = ids[i];
        if (u >= s->g.size() || !s->g.active[u] ||
            s->g.deg[u] > MAX_SMALL_SOLVE)
            continue;
        if (s->is_dirty(u))
            continue;
        bool clean = true;
        for (u32 e = s->g.first(u); !s->g.at_end(u, e);
             e = s->g.arena[e].next)
            if (s->is_dirty(s->g.arena[e].nbr)) {
                clean = false;
                break;
            }
        if (!clean)
            continue;
        s->cnt.r[4] += s->g.deg[u] + 1;
        s->mark_closed_2hop_dirty(u);
        s->select_neighborhood(u);
        applied++;
    }
    return applied;
}

// Bulk-verify + fold twin candidate groups from the device twin-hash pass.
// pairs: flattened (u, v) candidate pairs; each is re-checked with the exact
// is_twin predicate before folding.  Returns #folds.
u32 mwvc_bulk_twins(void *h, const u32 *pairs, u32 npairs) {
    auto *s = (Solver *)h;
    u32 applied = 0;
    for (u32 i = 0; i < npairs; ++i) {
        u32 u = pairs[2 * i], v = pairs[2 * i + 1];
        if (u >= s->g.size() || v >= s->g.size())
            continue;
        if (!s->g.active[u] || !s->g.active[v])
            continue;
        if (s->g.is_twin(u, v)) {
            s->cnt.r[1] += 1;
            // fold changes w(u), drops v, and shifts every common
            // neighbor's nw: mark both closed neighborhoods dirty
            s->mark_dirty(u);
            s->mark_dirty(v);
            for (u32 e = s->g.first(u); !s->g.at_end(u, e);
                 e = s->g.arena[e].next)
                s->mark_dirty(s->g.arena[e].nbr);
            for (u32 e = s->g.first(v); !s->g.at_end(v, e);
                 e = s->g.arena[e].next)
                s->mark_dirty(s->g.arena[e].nbr);
            s->g.fold_twin(u, v);
            s->wl.push(u);
            for (u32 e = s->g.first(u); !s->g.at_end(u, e);
                 e = s->g.arena[e].next)
                s->wl.push(s->g.arena[e].nbr);
            applied++;
        }
    }
    return applied;
}

u32 mwvc_solve_small_components(void *h, u32 limit) {
    return ((Solver *)h)->solve_small_components(limit);
}

u64 mwvc_peel(void *h, const u32 *order, const float *prob, u64 n_order,
              int relable_interval, u32 flags) {
    return ((Solver *)h)->peel(order, prob, n_order, relable_interval, flags);
}

u64 mwvc_labels_from_model(void *h) {
    return ((Solver *)h)->labels_from_model;
}
u64 mwvc_mistakes_from_model(void *h) {
    return ((Solver *)h)->mistakes_from_model;
}

// Folds on a dependent neighbourhood that rule_independent_fold refused
// (those of the exact component solves included): the JAX package's copy
// of the core makes them.  exact = 0: the sorted-merge independence test
// of N(u) that the rule tries first; else the order-free one.
u64 mwvc_dependent_folds(void *h) { return ((Solver *)h)->dependent_folds; }
int mwvc_neighbors_independent(void *h, u32 u, int exact) {
    auto &g = ((Solver *)h)->g;
    return exact ? g.neighbors_independent(u) : g.has_independent_neighbors(u);
}

// The meta rules' small instances over the whole solve (the exact component
// solves' included): evaluated, decided by a weight bound, solved.
void mwvc_meta_counts(void *h, u64 *out3) {
    auto *s = (Solver *)h;
    out3[0] = s->meta_evals;
    out3[1] = s->meta_bound_decided;
    out3[2] = s->meta_solved;
}

// The solver's profile (solver.hpp's Profile) over its life, in this order:
// per local rule in enum order its evaluations, fires and nanoseconds;
// rule_critical_weight's calls, live vertices summed and nanoseconds;
// peel()'s decisions and nanoseconds; solve_small_components' calls and
// nanoseconds, and its exact solves' count and nanoseconds.  Writes the
// first min(len, count) entries to out and returns the count.
u32 mwvc_profile(void *h, u64 *out, u32 len) {
    const Profile &p = ((Solver *)h)->prof;
    u64 all[3 * NUM_LOCAL_RULES + 9];
    u32 k = 0;
    for (u32 r = 0; r < NUM_LOCAL_RULES; ++r) {
        all[k++] = p.evals[r];
        all[k++] = p.fires[r];
        all[k++] = p.rule_ns[r];
    }
    for (u64 x : {p.critical_calls, p.critical_live, p.critical_ns,
                  p.select_calls, p.select_ns, p.components_calls,
                  p.components_ns, p.exact_calls, p.exact_ns})
        all[k++] = x;
    std::memcpy(out, all, std::min(len, k) * sizeof(u64));
    return k;
}

void mwvc_unfold(void *h, u64 t) { ((Solver *)h)->unfold(t); }

// Non-destructive full-solution preview: deep-copy the solver (RevGraph is
// index-based, so the default copy is a true clone), unfold the copy to
// timestamp 0 and read its solution.  Enables anytime checkpointing without
// losing the live action log.
void mwvc_preview_solution(void *h, int8_t *out) {
    Solver tmp = *(Solver *)h;
    tmp.unfold(0);
    for (u32 u = 0; u < tmp.n_org; ++u)
        out[u] = tmp.S[u];
}

void mwvc_get_solution(void *h, int8_t *out) {
    auto *s = (Solver *)h;
    for (u32 u = 0; u < s->n_org; ++u)
        out[u] = s->S[u];
}

// Overwrite cover membership for the given (active, kernel-state) nodes and
// adjust cost by the current node weights — the reference's
// local_search::get_cover write-back (reference: local_search.hpp:212-222).
void mwvc_apply_cover(void *h, const u32 *ids, const uint8_t *vals, u32 k) {
    auto *s = (Solver *)h;
    for (u32 i = 0; i < k; ++i) {
        u32 u = ids[i];
        bool nv = vals[i] != 0;
        bool cur = s->S[u] == 1;
        if (cur && !nv)
            s->cost -= s->g.w[u];
        else if (!cur && nv)
            s->cost += s->g.w[u];
        s->S[u] = nv ? 1 : 0;
    }
}

// ---- local search ---------------------------------------------------------
void *mwvc_ls_create(u32 n, const u32 *weights, u32 m, const u32 *eu,
                     const u32 *ev, const uint8_t *s0) {
    auto *ls = new LocalSearch();
    ls->init(n, weights, m, eu, ev, s0);
    return ls;
}

void mwvc_ls_destroy(void *h) { delete (LocalSearch *)h; }

int mwvc_ls_search(void *h, u32 iterations, double time_budget) {
    return ((LocalSearch *)h)->search(iterations, time_budget) ? 1 : 0;
}

u64 mwvc_ls_cost(void *h) { return ((LocalSearch *)h)->cost; }
u64 mwvc_ls_best_cost(void *h) { return ((LocalSearch *)h)->best_cost; }
u64 mwvc_ls_best_seen(void *h) { return ((LocalSearch *)h)->best_seen; }
void mwvc_ls_forget(void *h, double scale) {
    ((LocalSearch *)h)->forget(scale);
}

void mwvc_ls_restore_best(void *h) { ((LocalSearch *)h)->restore_best(); }

void mwvc_ls_perturb(void *h, u32 k, u64 seed) {
    ((LocalSearch *)h)->perturb(k, seed);
}

u64 mwvc_ls_steps(void *h) { return ((LocalSearch *)h)->step; }

void mwvc_ls_get_best(void *h, uint8_t *out) {
    auto *ls = (LocalSearch *)h;
    for (u32 i = 0; i < ls->n; ++i)
        out[i] = ls->best_s[i];
}

void mwvc_ls_get_current(void *h, uint8_t *out) {
    auto *ls = (LocalSearch *)h;
    for (u32 i = 0; i < ls->n; ++i)
        out[i] = ls->in_s[i];
}

void mwvc_ls_perturb_guided(void *h, u32 k, u64 seed, const float *bias,
                            u32 bias_n) {
    ((LocalSearch *)h)->perturb_guided(k, seed, bias, bias_n);
}

// ---- device-assisted phase 2: region extraction / patching ---------------
// Extract up to ncenters disjoint boundary-conditioned regions for the
// device small-solver; fills out_ids/out_adj/out_w as (ncenters, stride)
// rows (stride = 16 for the 2^16 enumeration kernel, 20 for the pallas
// meet-in-the-middle kernel) and out_k with per-row sizes.  Returns the
// number of non-empty regions.
u32 mwvc_ls_extract_regions(void *h, const u32 *centers, u32 ncenters,
                            u32 rmax, u32 stride, u32 *out_ids,
                            int32_t *out_adj, int32_t *out_w,
                            uint8_t *out_k) {
    auto *ls = (LocalSearch *)h;
    if (rmax > stride)
        rmax = stride;
    ls->begin_region_batch();
    u32 built = 0;
    for (u32 i = 0; i < ncenters; ++i) {
        u32 *ids = out_ids + (u64)i * stride;
        int32_t *adj = out_adj + (u64)i * stride;
        int32_t *w = out_w + (u64)i * stride;
        for (u32 t = 0; t < stride; ++t) {
            ids[t] = 0;
            adj[t] = 0;
            w[t] = 0;
        }
        out_k[i] = (uint8_t)ls->extract_region(centers[i], rmax, ids, adj, w);
        if (out_k[i])
            built++;
    }
    return built;
}

int mwvc_ls_apply_region(void *h, u32 k, const u32 *ids, u32 new_mask) {
    return ((LocalSearch *)h)->apply_region(k, ids, new_mask);
}

// A finished region batch applied in one call: rows 0..b-1 of the
// (b, stride) ids and the (b,) sizes as mwvc_ls_extract_regions wrote them,
// with the solver's (b,) masks, in row order through apply_region; rows
// with k = 0 are skipped.  Returns the patches applied; *out_wide counts
// those that flipped more than 16 vertices of the live cover (the most a
// 16-entry buffer of flipped vertices, the JAX package's copy of
// apply_region, could hold).  The flips are read just before each apply;
// the regions of a batch are disjoint, so a read before the whole batch
// gives the same count.
u32 mwvc_ls_apply_regions(void *h, u32 b, u32 stride, const u32 *ids,
                          const uint8_t *ks, const int32_t *masks,
                          u32 *out_wide) {
    auto *ls = (LocalSearch *)h;
    u32 applied = 0, wide = 0;
    for (u32 i = 0; i < b; ++i) {
        u32 k = ks[i];
        if (k == 0)
            continue;
        const u32 *row = ids + (u64)i * stride;
        u32 mask = (u32)masks[i];
        u32 flips = 0;
        if (k > 16 && k <= 32)
            for (u32 t = 0; t < k; ++t)
                flips += (ls->in_s[row[t]] != 0) != (((mask >> t) & 1) != 0);
        if (ls->apply_region(k, row, mask)) {
            applied++;
            if (flips > 16)
                wide++;
        }
    }
    *out_wide = wide;
    return applied;
}

int mwvc_ls_commit_patches(void *h) {
    return ((LocalSearch *)h)->commit_patches() ? 1 : 0;
}

// test hooks: incremental-refresh invariant (dscores after patches must
// equal a from-scratch rebuild)
void mwvc_ls_get_dscores(void *h, u32 *out) {
    auto *ls = (LocalSearch *)h;
    for (u32 i = 0; i < ls->n; ++i)
        out[i] = ls->dscore[i];
}

void mwvc_ls_rebuild_scores(void *h) { ((LocalSearch *)h)->rebuild_scores(); }

// Locality-improving vertex order: BFS from a min-degree root, neighbors
// visited in degree order (pseudo Cuthill-McKee).  Fills perm with old ids
// in new order; disconnected pieces appended from fresh min-degree roots.
void mwvc_bfs_order(u32 n, const u64 *indptr, const u32 *indices, u32 *perm) {
    std::vector<uint8_t> visited(n, 0);
    std::vector<u32> order;
    order.reserve(n);
    std::vector<u32> by_deg(n);
    for (u32 i = 0; i < n; ++i)
        by_deg[i] = i;
    std::sort(by_deg.begin(), by_deg.end(), [&](u32 a, u32 b) {
        return indptr[a + 1] - indptr[a] < indptr[b + 1] - indptr[b];
    });
    std::vector<u32> q, nbrs;
    for (u32 root : by_deg) {
        if (visited[root])
            continue;
        visited[root] = 1;
        q.push_back(root);
        size_t head = order.size();
        order.push_back(root);
        while (head < order.size()) {
            u32 u = order[head++];
            nbrs.clear();
            for (u64 k = indptr[u]; k < indptr[u + 1]; ++k) {
                u32 v = indices[k];
                if (!visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(), [&](u32 a, u32 b) {
                return indptr[a + 1] - indptr[a] < indptr[b + 1] - indptr[b];
            });
            for (u32 v : nbrs)
                order.push_back(v);
        }
    }
    for (u32 i = 0; i < n; ++i)
        perm[i] = order[i];
}

// Cluster ordering for window locality: greedily grow BFS balls of
// ~cluster_size nodes; each cluster's nodes are emitted together, and the
// next seed continues from the previous cluster's boundary, chaining
// clusters along the graph.  For geometrically local graphs this puts most
// edges inside or between adjacent 128-node windows (better than
// Cuthill-McKee, whose level sets destroy 2-D locality).
void mwvc_cluster_order(u32 n, const u64 *indptr, const u32 *indices,
                        u32 cluster_size, u32 *perm) {
    std::vector<uint8_t> visited(n, 0);
    std::vector<u32> order;
    order.reserve(n);
    std::vector<u32> boundary;  // seeds for subsequent clusters
    std::vector<u32> q;
    u32 scan = 0;
    while (order.size() < n) {
        // next seed: boundary of previous clusters, else next unvisited
        u32 seed = UINT32_MAX;
        while (!boundary.empty()) {
            u32 c = boundary.back();
            boundary.pop_back();
            if (!visited[c]) {
                seed = c;
                break;
            }
        }
        if (seed == UINT32_MAX) {
            while (scan < n && visited[scan])
                ++scan;
            if (scan >= n)
                break;
            seed = scan;
        }
        // BFS ball of cluster_size nodes
        q.clear();
        visited[seed] = 1;
        q.push_back(seed);
        size_t head = 0;
        u32 taken = 0;
        while (head < q.size() && taken < cluster_size) {
            u32 u = q[head++];
            order.push_back(u);
            taken++;
            for (u64 k = indptr[u]; k < indptr[u + 1]; ++k) {
                u32 v = indices[k];
                if (!visited[v] && q.size() < (size_t)cluster_size * 4) {
                    visited[v] = 1;
                    q.push_back(v);
                }
            }
        }
        // unconsumed BFS frontier: unmark and queue as future seeds
        for (size_t i = head; i < q.size(); ++i) {
            visited[q[i]] = 0;
            boundary.push_back(q[i]);
        }
    }
    for (u32 i = 0; i < n; ++i)
        perm[i] = order[i];
}

// Edge order for the windowed aggregation plan: stable-sort edge positions
// by (dst_window, src_window).  Destination windows are contiguous in a
// dst-sorted CSR, so this is a cheap segmented sort (cache-local, no global
// argsort) — the host-prep hot path of ops/blocked.py.
void mwvc_pair_order(u32 n, const u64 *indptr, const u32 *indices, u32 win,
                     u64 *order_out) {
    u64 e = indptr[n];
    for (u64 i = 0; i < e; ++i)
        order_out[i] = i;
    for (u32 w0 = 0; w0 < n; w0 += win) {
        u32 w1 = std::min(n, w0 + win);
        u64 lo = indptr[w0], hi = indptr[w1];
        std::stable_sort(order_out + lo, order_out + hi,
                         [&](u64 a, u64 b) {
                             return indices[a] / win < indices[b] / win;
                         });
    }
}

// Single-pass packer for the windowed aggregation plan (ops/blocked.py):
// walks the (dst-window, src-window)-sorted edge order once, splitting each
// window-pair run into 128/32/8-slot chunks.  Pass 1 (fill == 0) returns the
// chunk counts per class; pass 2 fills the preallocated chunk arrays.
// Padding slots must be pre-initialized by the caller (dw = n_win, ld = win).
void mwvc_blocked_pack(u32 n, const u64 *indptr, const u32 *indices,
                       const u64 *order, u32 win, u64 counts_out[3],
                       int fill,
                       u32 *sw0, u32 *dw0, u32 *ls0, u32 *ld0,
                       u32 *sw1, u32 *dw1, u32 *ls1, u32 *ld1,
                       u32 *sw2, u32 *dw2, u32 *ls2, u32 *ld2) {
    const u32 SIZES[3] = {128, 32, 8};
    u32 *SW[3] = {sw0, sw1, sw2};
    u32 *DW[3] = {dw0, dw1, dw2};
    u32 *LS[3] = {ls0, ls1, ls2};
    u32 *LD[3] = {ld0, ld1, ld2};
    u64 e = indptr[n];
    // dst row per edge position: walk rows to map positions -> dst
    std::vector<u32> dst_of(e);
    for (u32 u = 0; u < n; ++u)
        for (u64 k = indptr[u]; k < indptr[u + 1]; ++k)
            dst_of[k] = u;

    u64 c[3] = {0, 0, 0};
    u64 i = 0;
    while (i < e) {
        u64 p0 = order[i];
        u32 dw = dst_of[p0] / win, sw = indices[p0] / win;
        u64 j = i;
        while (j < e && dst_of[order[j]] / win == dw &&
               indices[order[j]] / win == sw)
            ++j;
        u64 k = j - i;  // run length
        u64 n128 = k / 128, rem = k % 128;
        u64 mid = rem > 8 ? std::min<u64>(rem, 32) : 0;
        u64 small = rem - mid;
        u64 n8 = (small + 7) / 8;
        if (fill) {
            u64 pos = i;
            for (u64 t = 0; t < n128; ++t, pos += 128) {
                u64 ci = c[0] + t;
                SW[0][ci] = sw;
                DW[0][ci] = dw;
                for (u32 q = 0; q < 128; ++q) {
                    u64 pp = order[pos + q];
                    LS[0][ci * 128 + q] = indices[pp] % win;
                    LD[0][ci * 128 + q] = dst_of[pp] % win;
                }
            }
            if (mid) {
                u64 ci = c[1];
                SW[1][ci] = sw;
                DW[1][ci] = dw;
                for (u64 q = 0; q < mid; ++q) {
                    u64 pp = order[pos + q];
                    LS[1][ci * 32 + q] = indices[pp] % win;
                    LD[1][ci * 32 + q] = dst_of[pp] % win;
                }
                pos += mid;
            }
            for (u64 t = 0; t < n8; ++t) {
                u64 ci = c[2] + t;
                SW[2][ci] = sw;
                DW[2][ci] = dw;
                u64 take = std::min<u64>(8, small - t * 8);
                for (u64 q = 0; q < take; ++q) {
                    u64 pp = order[pos + q];
                    LS[2][ci * 8 + q] = indices[pp] % win;
                    LD[2][ci * 8 + q] = dst_of[pp] % win;
                }
                pos += take;
            }
        }
        c[0] += n128;
        c[1] += mid ? 1 : 0;
        c[2] += n8;
        i = j;
    }
    counts_out[0] = c[0];
    counts_out[1] = c[1];
    counts_out[2] = c[2];
}

// Relabel a CSR under a permutation (perm[i] = old id at new position i):
// new row i = sorted inv-mapped neighbors of perm[i].  Row-local sorts keep
// this near memory speed (vs a global edge lexsort in numpy).
void mwvc_relabel_csr(u32 n, const u64 *indptr, const u32 *indices,
                      const u32 *perm, u64 *out_indptr, u32 *out_indices) {
    std::vector<u32> inv(n);
    for (u32 i = 0; i < n; ++i)
        inv[perm[i]] = i;
    out_indptr[0] = 0;
    for (u32 i = 0; i < n; ++i) {
        u32 old = perm[i];
        u64 lo = indptr[old], hi = indptr[old + 1];
        u64 base = out_indptr[i];
        for (u64 k = lo; k < hi; ++k)
            out_indices[base + (k - lo)] = inv[indices[k]];
        std::sort(out_indices + base, out_indices + base + (hi - lo));
        out_indptr[i + 1] = base + (hi - lo);
    }
}

// METIS files (metisio.hpp): pass 1 over a file's body, then the CSR of the
// upper entries it kept.
int mwvc_read_metis(const char *body, u64 len, u64 n, i64 *weights,
                    u64 *up_count, i64 *upper, u64 *out3) {
    return metis_upper(body, len, n, weights, up_count, upper, out3);
}

void mwvc_metis_csr(u64 n, const u64 *up_count, const i64 *upper, u64 kept,
                    i64 *indptr, i64 *indices) {
    metis_csr(n, up_count, upper, kept, indptr, indices);
}

// ---- standalone heuristics ------------------------------------------------
u64 mwvc_improve_cover(u32 n, const u32 *w, u64 m, const u32 *eu,
                       const u32 *ev, uint8_t *vc) {
    return improve_cover(n, w, m, eu, ev, vc);
}

u64 mwvc_approx_construct(u32 n, const u32 *w, u64 m, const u32 *eu,
                          const u32 *ev, uint8_t *vc) {
    return approx_construct(n, w, m, eu, ev, vc);
}

u64 mwvc_greedy_construct(u32 n, const u32 *w, u64 m, const u32 *eu,
                          const u32 *ev, uint8_t *vc) {
    return greedy_construct(n, w, m, eu, ev, vc);
}

// ---- comparison baselines -------------------------------------------------
// solver: 0 = FastWVC, 1 = DynWVC2, 2 = NuMWVC, 3 = HILS (MWIS).
// Returns best cover cost (for HILS: total weight - best IS weight) and
// fills vc; best_time receives seconds-to-best.
// HILS with the reference's full flag surface (ArgPack.h: -i iterations,
// -p p1,p2,p3,p4 intensification params, -target); MWVC = complement cost.
u64 mwvc_hils_solve(u32 n, const u32 *w, u64 m, const u32 *eu, const u32 *ev,
                    u32 seed, double cutoff, u64 max_iters, int p0, int p1,
                    int p2, int p3, u64 target, uint8_t *vc,
                    double *best_time) {
    using namespace baselines;
    HilsSolver h(n, w, m, eu, ev, seed);
    h.run(cutoff, max_iters, p0, p1, p2, p3, target);
    u64 total = 0;
    for (u32 v = 0; v < n; ++v) {
        vc[v] = 1;
        total += w[v];
    }
    for (u32 v : h.best_set)
        vc[v] = 0;
    if (best_time)
        *best_time = h.best_time;
    return total - h.best_weight;
}

u64 mwvc_baseline_solve(int which, u32 n, const u32 *w, u64 m, const u32 *eu,
                        const u32 *ev, u32 seed, double cutoff, int cc_mode,
                        uint8_t *vc, double *best_time) {
    using namespace baselines;
    if (which == 3) {
        HilsSolver h(n, w, m, eu, ev, seed);
        h.run(cutoff);
        for (u32 v = 0; v < n; ++v)
            vc[v] = 1;
        u64 total = 0;
        for (u32 v = 0; v < n; ++v)
            total += w[v];
        for (u32 v : h.best_set)
            vc[v] = 0;
        if (best_time)
            *best_time = h.best_time;
        return total - h.best_weight;
    }
    if (which == 2) {
        NuMwvcSolver s2(n, w, m, eu, ev, seed);
        s2.construct_numwvc();
        s2.numwvc_search(cutoff);
        for (u32 v = 0; v < n; ++v)
            vc[v] = s2.best_c[v];
        if (best_time)
            *best_time = s2.best_time;
        return s2.best_weight;
    }
    WvcBaseline s2(n, w, m, eu, ev, seed,
                   which == 0 ? WvcBaseline::FASTWVC : WvcBaseline::DYNWVC2,
                   cc_mode);
    s2.construct();
    s2.search(cutoff);
    for (u32 v = 0; v < n; ++v)
        vc[v] = s2.best_c[v];
    if (best_time)
        *best_time = s2.best_time;
    return s2.best_weight;
}

}  // extern "C"
