// MWVC kernelization engine: the 8 reduction rules, rule worklists, decision
// application, unfold, connected-component exact solving, and the GNN peel
// loop — capability-equivalent to the reference's mwvc_reductions.hpp /
// medium_solve.hpp / small_solve.hpp / flow_graph.hpp, re-implemented around
// the dancing-links RevGraph (stable ids, no relabeling).
//
// Rule priority order and worklist semantics mirror the reference exactly
// (reference: mwvc_reductions.hpp:22-30, 335-380): rules are tried in enum
// order, any success restarts at rule 0, vertices with live degree > 20 are
// skipped, and a vertex re-enters every rule's worklist when its
// neighborhood changes.

#pragma once
#include <algorithm>
#include <chrono>
#include <cstring>
#include <limits>
#include <numeric>
#include <queue>

#include "revgraph.hpp"

namespace mwvc {

constexpr u32 MAX_SMALL_SOLVE = 8;   // reference: mwvc_reductions.hpp:20
constexpr u32 DEGREE_SKIP = 20;      // reference: mwvc_reductions.hpp:344
constexpr u32 CRITICAL_LIMIT = 1000; // reference: GNN_VC.cpp:21
constexpr u32 NUM_LOCAL_RULES = 7;

// ---------------------------------------------------------------------------
// Exact solver for <= 16 vertices by subset enumeration (replaces the
// reference's SSE2 small_mwvc_solver; scalar code auto-vectorizes under
// -O3, and the device-side batched version lives in ops/smallsolve.py).
struct Small16 {
    u64 labels[16];
    int64_t wts[16];
    uint16_t adj[16];
    u32 n = 0;
    int64_t best_cost = std::numeric_limits<int64_t>::max();
    uint16_t best_set = 0;

    void reset() {
        n = 0;
        best_cost = std::numeric_limits<int64_t>::max();
        best_set = 0;
        std::memset(adj, 0, sizeof(adj));
    }
    void add_node(u64 label, int64_t wt) {
        labels[n] = label;
        wts[n] = wt;
        ++n;
    }
    int find(u64 label) const {
        for (u32 i = 0; i < n; ++i)
            if (labels[i] == label)
                return (int)i;
        return -1;
    }
    void add_edge(u64 a, u64 b) {
        int i = find(a), j = find(b);
        if (i < 0 || j < 0)
            return;
        adj[i] |= (uint16_t)(1u << j);
        adj[j] |= (uint16_t)(1u << i);
    }
    int64_t solve() {
        u32 lim = 1u << n;
        for (u32 s = 0; s < lim; ++s) {
            int64_t c = 0;
            bool valid = true;
            for (u32 j = 0; j < n; ++j) {
                bool in = (s >> j) & 1u;
                if (in)
                    c += wts[j];
                else if ((s & adj[j]) != adj[j]) {
                    valid = false;
                    break;
                }
            }
            if (valid && c < best_cost) {
                best_cost = c;
                best_set = (uint16_t)s;
            }
        }
        return best_cost;
    }
    bool in_cover(u64 label) const {
        int i = find(label);
        return i >= 0 && ((best_set >> i) & 1u);
    }
};

// ---------------------------------------------------------------------------
// Dinic max-flow for the critical-weight (r8) reduction.  The reference uses
// push-relabel with gap+global relabeling (reference: flow_graph.hpp); any
// max flow yields a valid critical set, and these graphs are < 2002 nodes.
struct Dinic {
    struct E {
        u32 to;
        i64 cap;
        u32 rev;
    };
    std::vector<std::vector<E>> g;
    std::vector<int> level, it;

    void init(u32 n) {
        g.assign(n, {});
        level.assign(n, -1);
        it.assign(n, 0);
    }
    void add_edge(u32 a, u32 b, i64 cap) {
        g[a].push_back({b, cap, (u32)g[b].size()});
        g[b].push_back({a, 0, (u32)(g[a].size() - 1)});
    }
    bool bfs(u32 s, u32 t) {
        std::fill(level.begin(), level.end(), -1);
        std::queue<u32> q;
        level[s] = 0;
        q.push(s);
        while (!q.empty()) {
            u32 u = q.front();
            q.pop();
            for (auto &e : g[u])
                if (e.cap > 0 && level[e.to] < 0) {
                    level[e.to] = level[u] + 1;
                    q.push(e.to);
                }
        }
        return level[t] >= 0;
    }
    i64 dfs(u32 u, u32 t, i64 f) {
        if (u == t)
            return f;
        for (int &i = it[u]; i < (int)g[u].size(); ++i) {
            E &e = g[u][i];
            if (e.cap > 0 && level[e.to] == level[u] + 1) {
                i64 d = dfs(e.to, t, std::min(f, e.cap));
                if (d > 0) {
                    e.cap -= d;
                    g[e.to][e.rev].cap += d;
                    return d;
                }
            }
        }
        return 0;
    }
    i64 solve(u32 s, u32 t) {
        i64 flow = 0;
        while (bfs(s, t)) {
            std::fill(it.begin(), it.end(), 0);
            i64 f;
            while ((f = dfs(s, t, std::numeric_limits<i64>::max())) > 0)
                flow += f;
        }
        return flow;
    }
};

// ---------------------------------------------------------------------------
struct Counters {
    u64 r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
};

// Per-rule worklists with "visited" re-queue semantics
// (reference: mwvc_reductions.hpp:32-71).
struct Worklists {
    std::vector<std::vector<u32>> stack;
    std::vector<std::vector<uint8_t>> visited;
    u64 label_count = 0;
    u32 nrules = NUM_LOCAL_RULES;

    void init(u32 n, u32 rules = NUM_LOCAL_RULES) {
        nrules = rules;
        stack.assign(nrules, {});
        visited.assign(nrules, std::vector<uint8_t>(n, 0));
        for (u32 r = 0; r < nrules; ++r) {
            stack[r].resize(n);
            for (u32 u = 0; u < n; ++u)
                stack[r][u] = u;
        }
    }
    void push(u32 u) {
        for (u32 r = 0; r < nrules; ++r) {
            if (visited[r][u])
                stack[r].push_back(u);
            visited[r][u] = 0;
        }
    }
    u32 pop(u32 r) {
        u32 u = stack[r].back();
        stack[r].pop_back();
        visited[r][u] = 1;
        return u;
    }
    void extend(u32 u) {
        for (u32 r = 0; r < nrules; ++r) {
            visited[r].push_back(0);
            stack[r].push_back(u);
        }
    }
    void shrink() {  // gadget node destroyed on unfold
        for (u32 r = 0; r < nrules; ++r)
            visited[r].pop_back();
    }
};

// ---------------------------------------------------------------------------
class Solver {
  public:
    RevGraph g;
    std::vector<int8_t> S;  // -1 undecided / 0 excluded / 1 included
    u64 cost = 0;
    Counters cnt;
    Worklists wl;
    Small16 sms;
    u32 n_org = 0;

    u64 labels_from_model = 0, mistakes_from_model = 0;
    u64 dependent_folds = 0;  // folds refused by rule_independent_fold

    // ---- device bulk-apply support (solver/device_reduce.py) -----------
    // Device rule masks are computed on a snapshot; during the bulk-apply
    // pass a node whose 1-hop instance may have drifted from that snapshot
    // is "dirty" and its device verdict can no longer be trusted.  Epoch
    // tagging makes begin_bulk_pass O(1) amortised.
    std::vector<u32> bulk_dirty;
    u32 bulk_epoch = 0;

    void begin_bulk_pass() {
        if (bulk_dirty.size() < g.size())
            bulk_dirty.resize(g.size(), 0);
        ++bulk_epoch;
    }
    void mark_dirty(u32 u) {
        if (u < bulk_dirty.size())
            bulk_dirty[u] = bulk_epoch;
    }
    bool is_dirty(u32 u) const {
        return u < bulk_dirty.size() && bulk_dirty[u] == bulk_epoch;
    }
    // Removing the closed neighborhood of u changes the 1-hop instance of
    // every neighbor of a removed node: mark the closed 2-hop ball.  Must be
    // called BEFORE the mutation (walks live adjacency).
    void mark_closed_2hop_dirty(u32 u) {
        mark_dirty(u);
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            mark_dirty(v);
            for (u32 f = g.first(v); !g.at_end(v, f); f = g.arena[f].next)
                mark_dirty(g.arena[f].nbr);
        }
    }

    void init(u32 n, const u32 *weights, u64 m, const u32 *eu, const u32 *ev,
              u32 nrules = NUM_LOCAL_RULES) {
        g.init(n, weights, m, eu, ev);
        S.assign(n, -1);
        n_org = n;
        wl.init(n, nrules);
    }

    u64 timestamp() const { return g.timestamp(); }

    // ---- decisions (reference: mwvc_reductions.hpp:98-129) -------------
    void select_node(u32 u) {
        assert(S[u] == -1);
        S[u] = 1;
        cost += g.w[u];
        wl.label_count++;
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next)
            wl.push(g.arena[e].nbr);
        g.remove_node(u);
    }

    void select_neighborhood(u32 u) {
        assert(S[u] == -1);
        S[u] = 0;
        wl.label_count += g.deg[u];
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            assert(S[v] == -1);
            S[v] = 1;
            cost += g.w[v];
        }
        g.remove_neighborhood(u);
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            for (u32 f = g.first(v); !g.at_end(v, f); f = g.arena[f].next)
                if (g.active[g.arena[f].nbr])
                    wl.push(g.arena[f].nbr);
        }
    }

    // ---- rules ---------------------------------------------------------
    bool rule_neighborhood(u32 u) {  // r1
        if (g.nw[u] <= g.w[u]) {
            cnt.r[0] += g.deg[u] + 1;
            select_neighborhood(u);
            return true;
        }
        return false;
    }

    bool rule_twin(u32 u) {  // r2
        if (g.deg[u] == 0)
            return false;
        u32 anchor = g.arena[g.last(u)].nbr;  // highest-label neighbor
        bool found = false;
        u32 e = g.first(anchor);
        while (!g.at_end(anchor, e)) {
            u32 next = g.arena[e].next;  // v may be unlinked below
            u32 v = g.arena[e].nbr;
            if (v != u && g.is_twin(u, v)) {
                cnt.r[1] += 1;
                g.fold_twin(u, v);
                found = true;
            }
            e = next;
        }
        if (found) {
            wl.push(u);
            for (u32 f = g.first(u); !g.at_end(u, f); f = g.arena[f].next)
                wl.push(g.arena[f].nbr);
            return true;
        }
        return false;
    }

    bool rule_domination(u32 u) {  // r3
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            if (g.w[v] >= g.w[u] && g.is_dominating(u, v)) {
                cnt.r[2] += 1;
                select_node(u);
                return true;
            }
            if (g.w[v] <= g.w[u] && g.is_dominating(v, u)) {
                cnt.r[2] += 1;
                select_node(v);
                return true;
            }
        }
        return false;
    }

    bool rule_isolated(u32 u) {  // r4 slot (enum order: isolated_fold)
        if (!g.is_isolated(u))
            return false;
        cost += g.w[u] * g.deg[u];
        g.fold_isolated(u);
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            wl.push(v);
            for (u32 f = g.first(v); !g.at_end(v, f); f = g.arena[f].next)
                wl.push(g.arena[f].nbr);
        }
        cnt.r[6] += 1;  // reference counts isolated_fold in r7
        wl.label_count++;
        return true;
    }

    bool rule_independent_fold(u32 u) {  // r6 counter slot
        if (g.deg[u] == 0)
            return false;  // rule 0 removes degree-0 nodes first
        assert(g.w[u] < g.nw[u]);
        u64 min_w = std::numeric_limits<u64>::max();
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next)
            min_w = std::min(min_w, g.w[g.arena[e].nbr]);
        if (g.w[u] < g.nw[u] - min_w)
            return false;
        // This copy differs from the JAX package's here.  There the merge
        // alone decides, and it can pass a dependent N(u) when u or a
        // neighbour is a gadget (has_independent_neighbors); unfolding that
        // fold with the gadget out leaves an edge inside N(u) open.  Here the
        // order-free check must agree, and where it does not the case is
        // counted and N(u) is taken.  That is exact: an edge inside N(u)
        // costs at least min_w to cover, so a cover holding u pays at least
        // w(u) + min_w >= NW(u) on N[u], what N(u) alone pays.
        bool independent = g.has_independent_neighbors(u);
        if (independent && !g.neighbors_independent(u)) {
            dependent_folds++;
            independent = false;
        }
        if (independent) {
            wl.label_count += g.deg[u];
            cnt.r[5] += g.deg[u];
            cost += g.w[u];
            u32 z = g.fold_neighborhood(u);
            wl.extend(z);
            S.push_back(-1);
            for (u32 e = g.first(z); !g.at_end(z, e); e = g.arena[e].next)
                wl.push(g.arena[e].nbr);
        } else {
            cnt.r[5] += g.deg[u] + 1;
            select_neighborhood(u);
        }
        return true;
    }

    // N(v) \ (N(u) + {u}) with the reference's exact tail-copy and cutoff
    // quirks (reference: mwvc_reductions.hpp:179-202).  Every entry of N(v)
    // is written out unless it matches an equal entry of N(u) or is u, so
    // out holds N(v) \ N[u] whatever the order; a gadget's unsorted list can
    // only add entries of N(v) that are in N[u].  rule_neighbor_meta's
    // C - VC is the heaviest independent set of G[out], which only grows as
    // out grows, so an extra entry can only make the rule miss.
    void neighborhood_difference(u32 v, u32 u, std::vector<u32> &out,
                                 u32 cutoff) {
        u32 a = g.first(v), b = g.first(u);
        u32 t = 0;
        while (!g.at_end(v, a) && !g.at_end(u, b)) {
            u32 x = g.arena[a].nbr, y = g.arena[b].nbr;
            if (x < y) {
                if (x != u) {
                    out.push_back(x);
                    if (++t > cutoff)
                        return;
                }
                a = g.arena[a].next;
            } else if (y < x) {
                b = g.arena[b].next;
            } else {
                a = g.arena[a].next;
                b = g.arena[b].next;
            }
        }
        for (; !g.at_end(v, a); a = g.arena[a].next)
            out.push_back(g.arena[a].nbr);
    }

    bool rule_neighbor_meta(u32 u) {  // r4 counter slot
        std::vector<u32> tmp;
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            if (g.w[v] <= g.w[u] ||
                (g.deg[v] > g.deg[u] && g.deg[v] - g.deg[u] > MAX_SMALL_SOLVE))
                continue;
            neighborhood_difference(v, u, tmp, MAX_SMALL_SOLVE);
            if (tmp.size() <= MAX_SMALL_SOLVE) {
                sms.reset();
                for (u32 x : tmp) {
                    sms.add_node(x, (int64_t)g.w[x]);
                    for (u32 f = g.first(x); !g.at_end(x, f);
                         f = g.arena[f].next)
                        sms.add_edge(x, g.arena[f].nbr);
                }
                i64 C = 0, VC = sms.solve();
                for (u32 x : tmp)
                    C += (i64)g.w[x];
                if (C - VC + (i64)g.w[u] <= (i64)g.w[v]) {
                    cnt.r[3] += 1;
                    select_node(u);
                    return true;
                }
            }
            tmp.clear();
        }
        return false;
    }

    bool rule_neighborhood_meta(u32 u) {  // r5 counter slot
        if (g.deg[u] > MAX_SMALL_SOLVE)
            return false;
        sms.reset();
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            sms.add_node(v, (int64_t)g.w[v]);
            for (u32 f = g.first(v); !g.at_end(v, f); f = g.arena[f].next)
                sms.add_edge(v, g.arena[f].nbr);
        }
        if ((i64)g.w[u] >= (i64)g.nw[u] - sms.solve()) {
            cnt.r[4] += g.deg[u] + 1;
            select_neighborhood(u);
            return true;
        }
        return false;
    }

    // r8: critical weight set via bipartite max flow
    // (reference: mwvc_reductions.hpp:294-332).
    bool rule_critical_weight() {
        u32 n = g.size();
        u32 s = 2 * n, t = 2 * n + 1;
        Dinic fg;
        fg.init(2 * n + 2);
        std::vector<u32> s_edge_idx(n, UINT32_MAX);
        for (u32 u = 0; u < n; ++u) {
            if (!g.active[u])
                continue;
            s_edge_idx[u] = (u32)fg.g[s].size();
            fg.add_edge(s, u, (i64)g.w[u]);
            fg.add_edge(n + u, t, (i64)g.w[u]);
            for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next)
                fg.add_edge(u, n + g.arena[e].nbr, (i64)g.w[u]);
        }
        fg.solve(s, t);
        std::vector<uint8_t> cs(n, 0);
        for (u32 u = 0; u < n; ++u)
            if (s_edge_idx[u] != UINT32_MAX)
                cs[u] = fg.g[s][s_edge_idx[u]].cap > 0;
        for (u32 u = 0; u < n; ++u) {
            if (g.active[u] && cs[u])
                for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next)
                    cs[g.arena[e].nbr] = 0;
        }
        std::vector<u32> rn;
        for (u32 u = 0; u < n; ++u)
            if (g.active[u] && cs[u])
                rn.push_back(u);
        for (u32 u : rn) {
            cnt.r[7] += g.deg[u] + 1;
            select_neighborhood(u);
        }
        return !rn.empty();
    }

    // ---- fixed-point driver (reference: mwvc_reductions.hpp:335-380) ----
    void reduce(bool do_critical) {
        bool critical;
        do {
            critical = false;
            u32 rule = 0;
            while (rule < wl.nrules) {
                if (wl.stack[rule].empty()) {
                    rule++;
                    continue;
                }
                u32 u = wl.pop(rule);
                if (u >= g.size() || !g.active[u] || g.deg[u] > DEGREE_SKIP)
                    continue;
                bool found = false;
                switch (rule) {
                case 0: found = rule_neighborhood(u); break;
                case 1: found = rule_twin(u); break;
                case 2: found = rule_domination(u); break;
                case 3: found = rule_isolated(u); break;
                case 4: found = rule_independent_fold(u); break;
                case 5: found = rule_neighbor_meta(u); break;
                case 6: found = rule_neighborhood_meta(u); break;
                }
                if (found)
                    rule = 0;
            }
            if (do_critical)
                critical = rule_critical_weight();
        } while (critical);
    }

    // ---- unfold (reference: mwvc_reductions.hpp:74-96) ------------------
    // Beyond the reference: unfolding a fold whose deciding node is still
    // undecided restores the structure and reverts the fold's upfront cost
    // instead of asserting (the reference's unfold is UB in that state);
    // this makes reduce+unfold round-trips usable for explore/restart.
    void unfold(u64 t) {
        while (g.timestamp() > t) {
            const LogEntry &le = g.log.back();
            if (le.type == Act::TwinFold) {
                assert(S[le.v] == -1);
                if (S[le.u] != -1)
                    S[le.v] = S[le.u];
            } else if (le.type == Act::IsoFold) {
                assert(S[le.u] == -1);
                bool any_decided = false, any_out = false,
                     all_decided = true;
                for (u32 e = g.first(le.u); !g.at_end(le.u, e);
                     e = g.arena[e].next) {
                    int8_t sv = S[g.arena[e].nbr];
                    if (sv == -1)
                        all_decided = false;
                    else
                        any_decided = true;
                    if (sv == 0)
                        any_out = true;
                }
                if (any_decided) {
                    assert(all_decided);
                    S[le.u] = any_out ? 1 : 0;
                } else {
                    cost -= g.w[le.u] * g.deg[le.u];  // revert upfront pay
                }
            } else if (le.type == Act::NbhdFold) {
                u32 z = le.v;
                assert(z == S.size() - 1);
                if (S[z] != -1) {
                    S[le.u] = S[z] ? 0 : 1;
                    for (u32 e = g.first(le.u); !g.at_end(le.u, e);
                         e = g.arena[e].next)
                        S[g.arena[e].nbr] = S[z];
                } else {
                    cost -= g.w[le.u];  // revert upfront pay
                }
                S.pop_back();
                wl.shrink();
            }
            g.pop_action();
        }
    }

    // ---- components + exact medium solve --------------------------------
    // (reference: GNN_VC.cpp:112-150, medium_solve.hpp)
    u32 solve_small_components(u32 limit);

    // ---- GNN peel loop (reference: GNN_VC.cpp:198-236; ablation variant
    // GNN_VC_experimental.cpp:104-180) ------------------------------------
    // order: active node ids sorted by confidence; prob: aligned scores.
    // flags: bit0 = GNN decides node-vs-neighborhood (else neighborhood
    // always), bit1 = run the reduction cascade after each decision.
    // Returns index i where it stopped (== n_order when exhausted).
    u64 peel(const u32 *order, const float *prob, u64 n_order,
             int relable_interval, u32 flags = 3) {
        bool use_gnn = flags & 1, use_red = flags & 2;
        u64 i = 0, j = 0;
        while (i < n_order && g.n_active > 0) {
            if ((relable_interval > 0 && j > (u64)relable_interval) ||
                (relable_interval < 0 && j > 0 &&
                 wl.label_count > n_order / 20))
                break;
            u32 u = order[i];
            bool model_in = prob[i] > 0.5f;
            bool mistake =
                S[u] != -1 &&
                (use_gnn ? (S[u] == 1) != model_in : S[u] == 1);
            if (mistake) {
                mistakes_from_model++;
                j++;
                i++;
            } else if (g.active[u]) {
                if (use_gnn && use_red) {
                    if (model_in) {
                        select_node(u);
                        labels_from_model++;
                    } else {
                        labels_from_model += g.deg[u] + 1;
                        select_neighborhood(u);
                    }
                } else {
                    labels_from_model += g.deg[u] + 1;
                    select_neighborhood(u);
                }
                i++;
                if (use_red)
                    reduce(g.n_active < CRITICAL_LIMIT);
            } else {
                i++;
            }
        }
        return i;
    }
};

// --------------------------------------------------------------------------
// Branch-and-reduce exact solve of one small component, on a child Solver
// (reference: medium_solve.hpp:3-82).
inline void medium_solve_req(Solver &sv) {
    RevGraph &g = sv.g;
    std::vector<u32> nodes;
    for (u32 u = 0; u < g.size(); ++u)
        if (g.active[u])
            nodes.push_back(u);
    if (nodes.empty())
        return;
    std::sort(nodes.begin(), nodes.end(),
              [&](u32 a, u32 b) { return g.deg[a] > g.deg[b]; });

    size_t k = std::max((size_t)(nodes.size() / 4), (size_t)50), tk = 0;
    while (tk < nodes.size() && g.deg[nodes[tk]] > tk)
        ++tk;

    if (tk >= k) {  // "degree-k" exhaustive split
        auto S_copy = sv.S;
        u64 cost_copy = sv.cost;
        u64 t = g.timestamp();
        for (size_t i = 0; i < tk; ++i)
            sv.select_node(nodes[i]);
        medium_solve_req(sv);
        sv.unfold(t);
        auto best_S = sv.S;
        u64 best_cost = sv.cost;
        sv.S = S_copy;
        sv.cost = cost_copy;
        for (size_t i = 0; i < tk; ++i) {
            sv.select_neighborhood(nodes[i]);
            medium_solve_req(sv);
            sv.unfold(t);
            if (sv.cost < best_cost) {
                best_cost = sv.cost;
                best_S = sv.S;
            }
            sv.S = S_copy;
            sv.cost = cost_copy;
        }
        sv.S = best_S;
        sv.cost = best_cost;
    } else {  // branch on max-degree vertex
        u64 t1 = g.timestamp();
        sv.reduce(true);
        if (g.n_active == 0) {
            sv.unfold(t1);
            return;
        }
        auto S_copy = sv.S;
        u64 cost_copy = sv.cost;
        u64 t2 = g.timestamp();

        u32 u = UINT32_MAX;
        for (u32 v = 0; v < g.size(); ++v)
            if (g.active[v] && (u == UINT32_MAX || g.deg[v] > g.deg[u]))
                u = v;

        sv.select_neighborhood(u);
        medium_solve_req(sv);
        sv.unfold(t2);
        auto best_S = sv.S;
        u64 best_cost = sv.cost;
        sv.S = S_copy;
        sv.cost = cost_copy;

        sv.select_node(u);
        medium_solve_req(sv);
        sv.unfold(t2);
        if (best_cost < sv.cost) {
            sv.S = best_S;
            sv.cost = best_cost;
        }
        sv.unfold(t1);
    }
}

// Extract the component as a fresh child Solver, solve exactly, then apply
// its decisions to the parent (reference: medium_solve.hpp:85-116).
inline void medium_solve(Solver &parent, std::vector<u32> &nodes) {
    std::sort(nodes.begin(), nodes.end());
    RevGraph &g = parent.g;
    u32 cn = (u32)nodes.size();
    std::vector<u32> wts(cn);
    for (u32 i = 0; i < cn; ++i)
        wts[i] = (u32)g.w[nodes[i]];
    std::vector<u32> eu, ev;
    for (u32 i = 0; i < cn; ++i) {
        u32 u = nodes[i];
        for (u32 e = g.first(u); !g.at_end(u, e); e = g.arena[e].next) {
            u32 v = g.arena[e].nbr;
            if (v < u)
                continue;
            u32 vi = (u32)(std::lower_bound(nodes.begin(), nodes.end(), v) -
                           nodes.begin());
            eu.push_back(i);
            ev.push_back(vi);
        }
    }
    Solver child;
    child.init(cn, wts.data(), eu.size(), eu.data(), ev.data());
    medium_solve_req(child);
    parent.dependent_folds += child.dependent_folds;

    for (u32 i = 0; i < cn; ++i) {
        if (!g.active[nodes[i]])
            continue;
        if (child.S[i] == 0)
            parent.select_neighborhood(nodes[i]);
        else
            parent.select_node(nodes[i]);
    }
}

inline u32 Solver::solve_small_components(u32 limit) {
    u32 n = g.size();
    std::vector<uint8_t> visited(n, 0);
    std::vector<u32> comp, dfs;
    u32 res = 0;
    for (u32 u0 = 0; u0 < n; ++u0) {
        if (visited[u0] || !g.active[u0])
            continue;
        comp.clear();
        dfs.push_back(u0);
        visited[u0] = 1;
        while (!dfs.empty()) {
            u32 v = dfs.back();
            dfs.pop_back();
            comp.push_back(v);
            for (u32 e = g.first(v); !g.at_end(v, e); e = g.arena[e].next) {
                u32 x = g.arena[e].nbr;
                if (!visited[x]) {
                    visited[x] = 1;
                    dfs.push_back(x);
                }
            }
        }
        res++;
        if (comp.size() < limit)
            medium_solve(*this, comp);
    }
    return res;
}

}  // namespace mwvc
