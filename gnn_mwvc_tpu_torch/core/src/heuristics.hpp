// Standalone cover heuristics over flat edge arrays (no reversible graph):
//
//  * improve_cover — the neighborhood-improvement pass shared by the
//    reference's ablation harness and approximation solver
//    (reference: old_files/src/apps/approximation_solver.cpp:94-145,
//    GNN_VC_experimental.cpp:219-280): repeatedly (a) drop a cover vertex
//    whose excluded-neighbor weight is below its own, (b) for an excluded
//    vertex, swap in a profitable independent subset of its cover neighbors.
//  * approx_construct — primal-dual (pricing) 2-approximation construction
//    (reference: approximation_solver.cpp:59-92).
//  * greedy_construct — degree/weight greedy cover used as a local-search
//    warm start (the fastWVC_tuned construction role).

#pragma once
#include <cstdint>
#include <vector>

namespace mwvc {

struct FlatGraph {
    uint32_t n;
    std::vector<uint32_t> off, nbr;
    FlatGraph(uint32_t n_, uint64_t m, const uint32_t *eu, const uint32_t *ev)
        : n(n_), off(n_ + 1, 0) {
        for (uint64_t i = 0; i < m; ++i) {
            off[eu[i] + 1]++;
            off[ev[i] + 1]++;
        }
        for (uint32_t i = 0; i < n; ++i)
            off[i + 1] += off[i];
        nbr.resize(2 * m);
        std::vector<uint32_t> fill(off.begin(), off.end() - 1);
        for (uint64_t i = 0; i < m; ++i) {
            nbr[fill[eu[i]]++] = ev[i];
            nbr[fill[ev[i]]++] = eu[i];
        }
    }
};

inline uint64_t improve_cover(uint32_t n, const uint32_t *w, uint64_t m,
                              const uint32_t *eu, const uint32_t *ev,
                              uint8_t *vc) {
    FlatGraph g(n, m, eu, ev);
    uint64_t cost = 0;
    std::vector<uint64_t> deact(n, 0);  // weight of excluded neighbors
    for (uint32_t u = 0; u < n; ++u) {
        if (vc[u])
            cost += w[u];
        else
            for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k)
                deact[g.nbr[k]] += w[u];
    }
    std::vector<uint8_t> tmp(n, 0);

    auto remove_from_vc = [&](uint32_t u) {
        vc[u] = 0;
        cost -= w[u];
        for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k) {
            uint32_t v = g.nbr[k];
            deact[v] += w[u];
            if (!vc[v]) {
                vc[v] = 1;
                cost += w[v];
                for (uint32_t k2 = g.off[v]; k2 < g.off[v + 1]; ++k2)
                    deact[g.nbr[k2]] -= w[v];
            }
        }
    };

    bool improvement = true;
    while (improvement) {
        improvement = false;
        for (uint32_t u = 0; u < n; ++u) {
            if (!vc[u]) {
                uint64_t gain = 0;
                for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k)
                    tmp[g.nbr[k]] = 1;
                for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k) {
                    uint32_t v = g.nbr[k];
                    if (!tmp[v])
                        continue;
                    if (deact[v] - w[u] < w[v]) {
                        gain += w[v] - (deact[v] - w[u]);
                        for (uint32_t k2 = g.off[v]; k2 < g.off[v + 1]; ++k2)
                            tmp[g.nbr[k2]] = 0;
                    } else {
                        tmp[v] = 0;
                    }
                }
                if (gain > w[u]) {
                    improvement = true;
                    for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k)
                        if (tmp[g.nbr[k]])
                            remove_from_vc(g.nbr[k]);
                }
                for (uint32_t k = g.off[u]; k < g.off[u + 1]; ++k)
                    tmp[g.nbr[k]] = 0;
            } else if (deact[u] < w[u]) {
                improvement = true;
                remove_from_vc(u);
            }
        }
    }
    return cost;
}

inline uint64_t approx_construct(uint32_t n, const uint32_t *w, uint64_t m,
                                 const uint32_t *eu, const uint32_t *ev,
                                 uint8_t *vc) {
    FlatGraph g(n, m, eu, ev);
    std::vector<int64_t> slack(n);
    for (uint32_t u = 0; u < n; ++u) {
        slack[u] = w[u];
        vc[u] = 0;
    }
    std::vector<uint8_t> edge_live(m, 1);
    // edge id lists per vertex for deactivation
    std::vector<uint32_t> eoff(n + 1, 0), eids(2 * m);
    for (uint64_t i = 0; i < m; ++i) {
        eoff[eu[i] + 1]++;
        eoff[ev[i] + 1]++;
    }
    for (uint32_t i = 0; i < n; ++i)
        eoff[i + 1] += eoff[i];
    {
        std::vector<uint32_t> fill(eoff.begin(), eoff.end() - 1);
        for (uint64_t i = 0; i < m; ++i) {
            eids[fill[eu[i]]++] = (uint32_t)i;
            eids[fill[ev[i]]++] = (uint32_t)i;
        }
    }
    uint64_t cost = 0;
    for (uint64_t i = 0; i < m; ++i) {
        if (!edge_live[i])
            continue;
        uint32_t u = eu[i], v = ev[i];
        uint32_t k = slack[u] < slack[v] ? u : v;
        int64_t s = slack[k];
        slack[u] -= s;
        slack[v] -= s;
        vc[k] = 1;
        cost += w[k];
        for (uint32_t j = eoff[k]; j < eoff[k + 1]; ++j)
            edge_live[eids[j]] = 0;
    }
    return cost;
}

inline uint64_t greedy_construct(uint32_t n, const uint32_t *w, uint64_t m,
                                 const uint32_t *eu, const uint32_t *ev,
                                 uint8_t *vc) {
    FlatGraph g(n, m, eu, ev);
    for (uint32_t u = 0; u < n; ++u)
        vc[u] = 0;
    uint64_t cost = 0;
    for (uint64_t i = 0; i < m; ++i) {
        uint32_t u = eu[i], v = ev[i];
        if (vc[u] || vc[v])
            continue;
        // prefer the endpoint with larger degree/weight
        uint64_t du = g.off[u + 1] - g.off[u], dv = g.off[v + 1] - g.off[v];
        uint32_t k = du * (uint64_t)w[v] >= dv * (uint64_t)w[u] ? u : v;
        vc[k] = 1;
        cost += w[k];
    }
    return cost;
}

}  // namespace mwvc
