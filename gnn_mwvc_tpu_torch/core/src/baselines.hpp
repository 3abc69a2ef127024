// The comparison-solver family (reference: other_solvers/): re-implemented
// from the published algorithms so differential benchmarking needs no
// vendored binaries.
//
//  * WvcBaseline — the FastWVC / DynWVC2 engine family:
//      FastWVC  (Cai et al., Inf. Sci. 2019): random-tournament removal by
//      w/|dscore|, per-step tabu on re-added vertices, dynamic edge weights
//      with periodic forgetting, configuration checking.
//      DynWVC2  (Cai et al., IJCAI 2018): minimum-valid-score removal,
//      switching to the tournament rule after 5 non-improving steps, and a
//      second removal when the removed degree is below average.
//  * NuMwvcSolver (Li et al., JORS 2020): construction-time degree-1/2
//      reduction rules marking must-in vertices, then CC local search.
//  * HilsSolver (Nogueira et al., Opt. Lett. 2017): Max Weight Independent
//      Set hybrid ILS with (1,2)-swap and (omega,1)-swap neighborhoods and
//      adaptive force(k) perturbation; MWVC obtained by complement.
//
// All take the same preprocessed edge arrays the rest of the core uses.

#pragma once
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <random>
#include <vector>

namespace mwvc {

namespace baselines {

using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

struct Clock {
    std::chrono::steady_clock::time_point t0 =
        std::chrono::steady_clock::now();
    double elapsed() const {
        return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                             t0)
            .count();
    }
};

struct CsrGraph {
    u32 n;
    u64 m;
    std::vector<u32> off, nbr, eid, eu, ev, w;
    CsrGraph(u32 n_, const u32 *wt, u64 m_, const u32 *eu_, const u32 *ev_)
        : n(n_), m(m_), off(n_ + 1, 0), w(wt, wt + n_) {
        eu.assign(eu_, eu_ + m);
        ev.assign(ev_, ev_ + m);
        for (u64 i = 0; i < m; ++i) {
            off[eu[i] + 1]++;
            off[ev[i] + 1]++;
        }
        for (u32 i = 0; i < n; ++i)
            off[i + 1] += off[i];
        nbr.resize(2 * m);
        eid.resize(2 * m);
        std::vector<u32> fill(off.begin(), off.end() - 1);
        for (u64 i = 0; i < m; ++i) {
            nbr[fill[eu[i]]] = ev[i];
            eid[fill[eu[i]]++] = (u32)i;
            nbr[fill[ev[i]]] = eu[i];
            eid[fill[ev[i]]++] = (u32)i;
        }
    }
    u32 deg(u32 v) const { return off[v + 1] - off[v]; }
};

// ---------------------------------------------------------------------------
class WvcBaseline {
  public:
    // NUMWVC = the FastWVC engine driving NuMWVC's CC search, except the
    // repair scans the whole uncovered-edge stack (choose_add) — the
    // behavior NuMwvcSolver was built and validated against; the restricted
    // ChooseAddV rules below are FastWVC/DynWVC2 reference semantics only.
    enum Strategy { FASTWVC, DYNWVC2, NUMWVC };

    CsrGraph g;
    std::mt19937 rng;
    Strategy strat;
    // FastWVC always uses configuration checking in its add rule
    // (reference: other_solvers/FastWVC/mwvc.h:423,462,481 — unconditional);
    // the CLI "CC mode" bit only gates the conf-reset on uncovered endpoints
    // inside UpdateEdgeWeight (mwvc.h:766–770).  DynWVC2 has no conf arrays
    // at all (other_solvers/DynWVC2/mwvc.h).  mode/2 enables edge-weight
    // forgetting in both (mwvc.h:775).
    bool conf_on_uncovered, forget_mode;

    bool use_cc() const { return strat == FASTWVC || strat == NUMWVC; }

    std::vector<uint8_t> in_c, best_c, conf, tabu, must_in;
    std::vector<i64> dscore, valid_score;
    std::vector<u32> edge_w, time_stamp;
    std::vector<u32> uncov, uncov_pos;       // uncovered edge stack
    std::vector<u32> cand, cand_pos;         // cover vertices
    u64 now_weight = 0, best_weight = UINT64_MAX;
    u64 step = 1, delta_total = 0;
    u64 ave_weight = 1, threshold = 0;
    double best_time = 0.0;

    WvcBaseline(u32 n, const u32 *wt, u64 m, const u32 *eu, const u32 *ev,
                u32 seed, Strategy s, int cc)
        : g(n, wt, m, eu, ev), rng(seed), strat(s),
          conf_on_uncovered(cc % 2 == 1), forget_mode(cc / 2 == 1) {
        in_c.assign(n, 0);
        best_c.assign(n, 0);
        conf.assign(n, 1);
        tabu.assign(n, 0);
        must_in.assign(n, 0);
        dscore.assign(n, 0);
        valid_score.assign(n, 1'000'000);
        edge_w.assign(m, 1);
        time_stamp.assign(n, 0);
        uncov_pos.assign(m, UINT32_MAX);
        cand_pos.assign(n, UINT32_MAX);
        threshold = (u64)(0.5 * n);
    }

    // -- uncovered-edge stack -------------------------------------------
    void uncover(u32 e) {
        uncov_pos[e] = (u32)uncov.size();
        uncov.push_back(e);
    }
    void cover(u32 e) {
        u32 p = uncov_pos[e];
        uncov[p] = uncov.back();
        uncov_pos[uncov[p]] = p;
        uncov.pop_back();
        uncov_pos[e] = UINT32_MAX;
    }

    void cand_add(u32 v) {
        cand_pos[v] = (u32)cand.size();
        cand.push_back(v);
    }
    void cand_del(u32 v) {
        u32 p = cand_pos[v];
        cand[p] = cand.back();
        cand_pos[cand[p]] = p;
        cand.pop_back();
        cand_pos[v] = UINT32_MAX;
    }

    void add(u32 v) {
        in_c[v] = 1;
        now_weight += g.w[v];
        dscore[v] = -dscore[v];
        valid_score[v] = -(i64)g.w[v];
        cand_add(v);
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
            u32 nb = g.nbr[k], e = g.eid[k];
            if (!in_c[nb]) {
                dscore[nb] -= edge_w[e];
                if (use_cc())
                    conf[nb] = 1;
                cover(e);
                valid_score[v] += g.w[nb];
            } else {
                dscore[nb] += edge_w[e];
                valid_score[nb] -= (i64)g.w[v];
                // DynWVC: a cover neighbor that now uniquely covers nothing
                // is removed immediately (its valid_score hit -w).
                if (strat == DYNWVC2 && !must_in[nb] &&
                    valid_score[nb] == -(i64)g.w[nb])
                    remove(nb);
            }
        }
    }

    void remove(u32 v) {
        in_c[v] = 0;
        now_weight -= g.w[v];
        dscore[v] = -dscore[v];
        valid_score[v] = 1'000'000;
        cand_del(v);
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
            u32 nb = g.nbr[k], e = g.eid[k];
            if (!in_c[nb]) {
                dscore[nb] += edge_w[e];
                if (use_cc())
                    conf[nb] = 1;
                uncover(e);
            } else {
                dscore[nb] -= edge_w[e];
                valid_score[nb] += (i64)g.w[v];
            }
        }
        if (use_cc())
            conf[v] = 0;
    }

    void init_uncovered() {
        for (u64 e = 0; e < g.m; ++e) {
            uncover((u32)e);
            dscore[g.eu[e]] += edge_w[e];
            dscore[g.ev[e]] += edge_w[e];
        }
    }

    void construct(int passes = 10) {
        // deg/w greedy over edges, several randomized orders, keep best
        std::vector<uint8_t> best(g.n, 0);
        u64 bw = UINT64_MAX;
        std::vector<u32> order(g.m);
        for (u64 i = 0; i < g.m; ++i)
            order[i] = (u32)i;
        for (int t = 0; t < passes; ++t) {
            std::vector<uint8_t> sel(g.n, 0);
            u64 wsum = 0;
            for (u32 e : order) {
                u32 a = g.eu[e], b = g.ev[e];
                if (sel[a] || sel[b])
                    continue;
                double add_ =
                    (double)g.deg(a) * g.w[b] - (double)g.deg(b) * g.w[a];
                u32 kpick = add_ > 0 ? a : b;
                sel[kpick] = 1;
                wsum += g.w[kpick];
            }
            if (wsum < bw) {
                bw = wsum;
                best = sel;
            }
            std::shuffle(order.begin(), order.end(), rng);
        }
        init_uncovered();
        for (u32 v = 0; v < g.n; ++v)
            if (best[v])
                add(v);
        remove_redundant();
        if (uncov.empty() && now_weight < best_weight) {
            best_weight = now_weight;
            best_c = in_c;
        }
    }

    void remove_redundant() {
        for (size_t i = 0; i < cand.size();) {
            u32 v = cand[i];
            if (dscore[v] == 0 && !must_in[v])
                remove(v);  // swaps a new vertex into slot i
            else
                ++i;
        }
    }

    void update_best(const Clock &clk) {
        if (now_weight < best_weight && uncov.empty()) {
            best_weight = now_weight;
            best_c = in_c;
            best_time = clk.elapsed();
        }
    }

    // remove the single cover vertex with the worst weight/|dscore| ratio
    // (the "target size" shrink both solvers perform each step).
    // Reference quirk kept (FastWVC/DynWVC2 mwvc.h UpdateTargetSize): the
    // scan starts from cand[0]; if cand[0] is redundant (dscore 0) it is
    // removed without a scan, and a redundant vertex met mid-scan merely
    // truncates the scan without being selected.  must_in entries are
    // skipped (NuMWVC pinning; no-op for the plain solvers).
    u32 update_target_size() {
        u32 best_v = UINT32_MAX;
        double best_r = -1.0;
        for (u32 v : cand) {
            if (must_in[v])
                continue;
            if (best_v == UINT32_MAX) {  // the "cand[0]" role
                best_v = v;
                if (dscore[v] == 0)
                    break;
                best_r = (double)g.w[v] / std::abs((double)dscore[v]);
                continue;
            }
            if (dscore[v] == 0)
                break;
            double r = (double)g.w[v] / std::abs((double)dscore[v]);
            if (r > best_r) {
                best_r = r;
                best_v = v;
            }
        }
        if (best_v != UINT32_MAX)
            remove(best_v);
        return best_v;
    }

    u32 choose_remove_min_valid() {  // DynWVC1 rule
        u32 rv = UINT32_MAX;
        i64 best = 0;
        for (u32 v : cand) {
            if (must_in[v])
                continue;
            if (rv == UINT32_MAX || valid_score[v] < best ||
                (valid_score[v] == best && time_stamp[v] < time_stamp[rv])) {
                rv = v;
                best = valid_score[v];
            }
        }
        return rv;
    }

    u32 choose_remove_tournament(bool use_tabu) {  // FastWVC / DynWVC2 rule
        if (cand.empty())
            return UINT32_MAX;
        auto pick = [&]() { return cand[rng() % cand.size()]; };
        u32 rv = pick();
        for (int i = 1; i < 50; ++i) {
            u32 v = pick();
            if (must_in[v] || (use_tabu && tabu[v]))
                continue;
            // plain w/|dscore| as in the reference; dscore 0 -> +inf, so a
            // redundant vertex wins the tournament outright
            double r_v = (double)g.w[v] / std::abs((double)dscore[v]);
            double r_rv = (double)g.w[rv] / std::abs((double)dscore[rv]);
            if (r_v > r_rv || (r_v == r_rv && time_stamp[v] < time_stamp[rv]))
                rv = v;
        }
        return rv;
    }

    u32 choose_add() {
        // best dscore/w endpoint of an uncovered edge (CC-gated); used by
        // the NuMWVC greedy construction, not the FastWVC/DynWVC2 repair
        u32 av = UINT32_MAX;
        double best = -1.0;
        for (u32 e : uncov) {
            for (u32 v : {g.eu[e], g.ev[e]}) {
                if (in_c[v])
                    continue;
                if (use_cc() && !conf[v])
                    continue;
                double r = (double)dscore[v] / (double)g.w[v];
                if (r > best ||
                    (r == best && av != UINT32_MAX &&
                     time_stamp[v] < time_stamp[av])) {
                    best = r;
                    av = v;
                }
            }
        }
        if (av == UINT32_MAX && !uncov.empty())  // CC deadlock fallback
            av = fallback_uncov_endpoint();
        return av;
    }

    u32 fallback_uncov_endpoint() {
        // safe stand-in for the reference's Add(0)-on-sentinel path (which
        // adds an out-of-range vertex): guarantee progress by covering the
        // first uncovered edge, ignoring CC
        u32 e = uncov[0];
        return in_c[g.eu[e]] ? g.ev[e] : g.eu[e];
    }

    // one ChooseAddV candidate probe: strictly-better dscore/w, timestamp
    // tie-break (reference FastWVC mwvc.h:444–519, DynWVC2 mwvc.h:472–560)
    void consider_add(u32 v, bool cc_gate, u32 &av, double &best) const {
        if (v == UINT32_MAX || in_c[v])
            return;
        if (cc_gate && !conf[v])
            return;
        double r = (double)dscore[v] / (double)g.w[v];
        if (r > best) {
            best = r;
            av = v;
        } else if (r == best && av != UINT32_MAX &&
                   time_stamp[v] < time_stamp[av]) {
            av = v;
        }
    }

    // FastWVC repair rule: scan N(remove_v) ∪ {remove_v} ∪ N(update_v) ∪
    // {update_v}, CC-gated, starting improvement at 0 (so only vertices
    // that cover at least one uncovered edge qualify)
    u32 choose_add_fast(u32 remove_v, u32 update_v) {
        u32 av = UINT32_MAX;
        double best = 0.0;
        if (remove_v != UINT32_MAX) {
            for (u32 k = g.off[remove_v]; k < g.off[remove_v + 1]; ++k)
                consider_add(g.nbr[k], true, av, best);
            consider_add(remove_v, true, av, best);
        }
        if (update_v != UINT32_MAX) {
            for (u32 k = g.off[update_v]; k < g.off[update_v + 1]; ++k)
                consider_add(g.nbr[k], true, av, best);
            consider_add(update_v, true, av, best);
        }
        return av;
    }

    // DynWVC2 repair rule: scan N(update_v) ∪ N(remove_v) ∪ N(remove_v2),
    // no CC, the removed vertices themselves are NOT candidates — a removal
    // cannot be undone within the same repair
    u32 choose_add_dyn(u32 update_v, u32 remove_v, u32 remove_v2) {
        u32 av = UINT32_MAX;
        double best = 0.0;
        for (u32 src : {update_v, remove_v, remove_v2}) {
            if (src == UINT32_MAX)
                continue;
            for (u32 k = g.off[src]; k < g.off[src + 1]; ++k)
                consider_add(g.nbr[k], false, av, best);
        }
        return av;
    }

    void forget_edge_weights() {
        u64 total = 0;
        for (u64 e = 0; e < g.m; ++e) {
            edge_w[e] = (u32)(edge_w[e] * 0.3);
            if (edge_w[e] < 1)
                edge_w[e] = 1;
            total += edge_w[e];
        }
        // rebuild dscores
        std::fill(dscore.begin(), dscore.end(), 0);
        for (u64 e = 0; e < g.m; ++e) {
            u32 a = g.eu[e], b = g.ev[e];
            if (!in_c[a] && !in_c[b]) {
                dscore[a] += edge_w[e];
                dscore[b] += edge_w[e];
            } else if (in_c[a] && !in_c[b])
                dscore[a] -= edge_w[e];
            else if (in_c[b] && !in_c[a])
                dscore[b] -= edge_w[e];
        }
        ave_weight = total / std::max<u64>(g.m, 1);
    }

    void update_edge_weights() {
        for (u32 e : uncov) {
            edge_w[e] += 1;
            dscore[g.eu[e]] += 1;
            dscore[g.ev[e]] += 1;
            if (use_cc() && conf_on_uncovered) {
                conf[g.eu[e]] = 1;
                conf[g.ev[e]] = 1;
            }
        }
        delta_total += uncov.size();
        if (forget_mode) {
            if (delta_total >= g.m) {
                ave_weight += 1;
                delta_total -= g.m;
            }
            if (ave_weight >= threshold)
                forget_edge_weights();
        }
    }

    void repair(bool tabu_added) {
        // generic repair over the whole uncovered-edge stack — the NUMWVC
        // search step; FastWVC/DynWVC2 use their restricted ChooseAddV rules
        while (!uncov.empty()) {
            u32 av = choose_add();
            if (av == UINT32_MAX)
                break;
            add(av);
            update_edge_weights();
            if (tabu_added)
                tabu[av] = 1;
            time_stamp[av] = (u32)step;
        }
    }

    void search(double cutoff) {
        Clock clk;
        const u64 try_step = 100;
        u32 avg_deg = (u32)(2 * g.m / std::max<u32>(g.n, 1));
        u64 no_improve = 0;
        int dyn_count = 0;
        while (true) {
            u64 before = now_weight;
            update_best(clk);
            u32 update_v = update_target_size();
            if (update_v == UINT32_MAX)
                return;  // nothing removable
            if (strat == DYNWVC2)  // only DynWVC2 stamps the target-size
                time_stamp[update_v] = (u32)step;  // removal (mwvc.h:815)
            if (step % try_step == 0 && clk.elapsed() >= cutoff)
                return;

            u32 rv, rv2 = UINT32_MAX;
            if (strat != DYNWVC2) {
                rv = choose_remove_tournament(true);
            } else if (no_improve < 5) {
                rv = choose_remove_min_valid();
            } else {
                // DynWVC2 strategy switch: after 5 cumulative non-improving
                // steps run the tournament rule for exactly 2 steps, then
                // reset the counter (reference DynWVC2/mwvc.h:823–842)
                if (no_improve == 5)
                    dyn_count = 2;
                if (dyn_count == 1)
                    no_improve = 0;
                rv = choose_remove_tournament(false);
                dyn_count--;
            }
            if (rv == UINT32_MAX)
                return;
            remove(rv);
            time_stamp[rv] = (u32)step;

            if (strat == DYNWVC2 &&
                g.deg(update_v) + g.deg(rv) < avg_deg) {
                rv2 = choose_remove_tournament(false);
                if (rv2 != UINT32_MAX) {
                    remove(rv2);
                    time_stamp[rv2] = (u32)step;
                }
            }
            if (strat != DYNWVC2)
                std::fill(tabu.begin(), tabu.end(), 0);
            if (strat == NUMWVC) {
                repair(/*tabu_added=*/true);
            } else {
                while (!uncov.empty()) {
                    u32 av = strat == FASTWVC
                                 ? choose_add_fast(rv, update_v)
                                 : choose_add_dyn(update_v, rv, rv2);
                    if (av == UINT32_MAX)
                        av = fallback_uncov_endpoint();
                    add(av);
                    update_edge_weights();
                    if (strat == FASTWVC)
                        tabu[av] = 1;
                    time_stamp[av] = (u32)step;
                }
            }
            if (strat != DYNWVC2)
                remove_redundant();
            step++;
            // the no-improvement counter accumulates and is only reset by
            // the dyn_count==1 path above (reference: DynWVC2/mwvc.h:862
            // never resets it on improvement)
            if (now_weight >= before)
                no_improve++;
        }
    }
};

// ---------------------------------------------------------------------------
// NuMWVC: greedy construction with degree-based reduction rules, then the
// CC-mode WvcBaseline search with must-in pinning.
class NuMwvcSolver : public WvcBaseline {
  public:
    NuMwvcSolver(u32 n, const u32 *wt, u64 m, const u32 *eu, const u32 *ev,
                 u32 seed)
        : WvcBaseline(n, wt, m, eu, ev, seed, NUMWVC, /*cc=*/1) {}

    // uncovered-degree of a non-cover vertex
    u32 uncov_deg(u32 v, u32 *n1 = nullptr, u32 *n2 = nullptr) const {
        u32 c = 0;
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
            u32 nb = g.nbr[k];
            if (!in_c[nb] && uncov_pos[g.eid[k]] != UINT32_MAX) {
                if (c == 0 && n1)
                    *n1 = nb;
                else if (c == 1 && n2)
                    *n2 = nb;
                c++;
            }
        }
        return c;
    }

    bool adjacent(u32 a, u32 b) const {
        for (u32 k = g.off[a]; k < g.off[a + 1]; ++k)
            if (g.nbr[k] == b)
                return true;
        return false;
    }

    bool apply_rules() {
        bool any = false;
        // R1: v with one uncovered neighbor n1 and w(v) >= w(n1) -> take n1
        // R2: v with two adjacent uncovered neighbors n1,n2,
        //     w(v) > w(n1)+w(n2) -> take both
        // R3: triangle variant — pick the cheaper endpoint
        for (u32 v = 0; v < g.n; ++v) {
            if (in_c[v] || uncov.empty())
                continue;
            u32 n1 = UINT32_MAX, n2 = UINT32_MAX;
            u32 c = uncov_deg(v, &n1, &n2);
            if (c == 1 && g.w[v] >= g.w[n1]) {
                add(n1);
                must_in[n1] = 1;
                any = true;
            } else if (c == 2 && adjacent(n1, n2)) {
                if (g.w[v] > g.w[n1] + g.w[n2]) {
                    add(n1);
                    add(n2);
                    must_in[n1] = must_in[n2] = 1;
                    any = true;
                } else if (uncov_deg(n1) == 2 || uncov_deg(n2) == 2) {
                    u32 other = uncov_deg(n1) == 2 ? n1 : n2;
                    u32 kpick = g.w[v] < g.w[other] ? v : other;
                    add(kpick);
                    must_in[kpick] = 1;
                    any = true;
                }
            } else if (c == 2) {
                // R4: n1, n2 NOT adjacent — if a second non-cover vertex u
                // with exactly two uncovered edges closes the 4-cycle
                // v-n1-u-n2 and w(v)+w(u) > w(n1)+w(n2), taking {n1,n2}
                // dominates covering the cycle through {v,u}
                // (reference: other_solvers/NuMWVC/wvcp_0123.c:844-949).
                for (u32 k = g.off[n1]; k < g.off[n1 + 1]; ++k) {
                    u32 u = g.nbr[k];
                    if (u == v || in_c[u] || uncov_deg(u) != 2 ||
                        !adjacent(n2, u))
                        continue;
                    if (g.w[v] + g.w[u] > g.w[n1] + g.w[n2]) {
                        add(n1);
                        add(n2);
                        must_in[n1] = must_in[n2] = 1;
                        any = true;
                    }
                    break;
                }
            }
        }
        return any;
    }

    void construct_with_rules() {
        init_uncovered();
        while (!uncov.empty()) {
            if (apply_rules())
                continue;
            // greedy: best dscore/w endpoint of an uncovered edge
            u32 av = choose_add();
            if (av == UINT32_MAX)
                break;
            add(av);
        }
        remove_redundant();
        if (uncov.empty() && now_weight < best_weight) {
            best_weight = now_weight;
            best_c = in_c;
        }
    }

    // reference pipeline: Reduction() rules pin must_in vertices, then the
    // init_fast edge-greedy cover seeds the search (wvcp_0123.c:1030-1031)
    void construct_numwvc() {
        init_uncovered();
        while (!uncov.empty() && apply_rules()) {
        }
        n_init_fast_cover();
    }

    // ---- the published NuMWVC search ----------------------------------
    // Faithful to reference other_solvers/NuMWVC/wvcp_0123.c:366-505:
    // strict-improvement bounded repair (abandon any repair whose running
    // cost reaches best-1), random-uncovered-edge endpoint selection with
    // configuration checking, score/cost ratio removal with per-repair
    // tabu, and +1 inflation of every currently-uncovered edge after each
    // repair add.  State is self-contained (signed score convention as in
    // the reference: in-cover score = -loss), initialized from the
    // rule-based construction's cover.
    std::vector<i64> nscore;
    std::vector<u32> new_w;           // dynamic edge weights
    std::vector<u32> nuncov, nupos;   // uncovered edge stack + position
    std::vector<uint8_t> nconf, ntabu;

    void n_init_state() {
        nscore.assign(g.n, 0);
        new_w.assign(g.m, 1);
        nuncov.clear();
        nupos.assign(g.m, UINT32_MAX);
        nconf.assign(g.n, 1);
        ntabu.assign(g.n, 0);
        for (u64 e = 0; e < g.m; ++e) {
            u32 a = g.eu[e], b = g.ev[e];
            int cov = (int)in_c[a] + (int)in_c[b];
            if (cov == 0) {
                nupos[e] = (u32)nuncov.size();
                nuncov.push_back((u32)e);
                nscore[a] += 1;
                nscore[b] += 1;
            } else if (cov == 1) {
                nscore[in_c[a] ? a : b] -= 1;
            }
        }
    }

    void n_add(u32 c) {
        in_c[c] = 1;
        now_weight += g.w[c];
        nscore[c] = -nscore[c];
        nconf[c] = 0;
        for (u32 k = g.off[c]; k < g.off[c + 1]; ++k) {
            u32 j = g.nbr[k], e = g.eid[k];
            if (nupos[e] != UINT32_MAX) {  // was uncovered
                u32 last = nuncov.back();
                nuncov[nupos[e]] = last;
                nupos[last] = nupos[e];
                nuncov.pop_back();
                nupos[e] = UINT32_MAX;
            }
            nconf[j] = 1;
            if (!in_c[j])
                nscore[j] -= (i64)new_w[e];
            else
                nscore[j] += (i64)new_w[e];
        }
    }

    void n_remove(u32 c) {
        in_c[c] = 0;
        now_weight -= g.w[c];
        nscore[c] = -nscore[c];
        nconf[c] = 0;
        for (u32 k = g.off[c]; k < g.off[c + 1]; ++k) {
            u32 j = g.nbr[k], e = g.eid[k];
            nconf[j] = 1;
            if (!in_c[j]) {  // edge becomes uncovered
                nupos[e] = (u32)nuncov.size();
                nuncov.push_back(e);
                nscore[j] += (i64)new_w[e];
            } else {
                nscore[j] -= (i64)new_w[e];
            }
        }
    }

    // max score/cost ratio among removable cover vertices; ties -> older
    // (reference find_best_in_c, wvcp_0123.c:320-348)
    u32 n_find_best(bool respect_tabu) const {
        u32 maxc = UINT32_MAX;
        for (u32 v = 0; v < g.n; ++v) {
            if (!in_c[v] || must_in[v] || (respect_tabu && ntabu[v]))
                continue;
            if (maxc == UINT32_MAX) {
                maxc = v;
                continue;
            }
            // nscore[v]/w[v] > nscore[maxc]/w[maxc] ?
            i64 lhs = nscore[v] * (i64)g.w[maxc];
            i64 rhs = nscore[maxc] * (i64)g.w[v];
            if (lhs > rhs ||
                (lhs == rhs && time_stamp[maxc] > time_stamp[v]))
                maxc = v;
        }
        return maxc;
    }

    u32 n_uncov_deg_edges(u32 v) const {
        u32 c = 0;
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k)
            if (nupos[g.eid[k]] != UINT32_MAX)
                c++;
        return c;
    }

    void n_inflate_uncovered() {
        for (u32 e : nuncov) {
            new_w[e] += 1;
            nconf[g.eu[e]] = 1;
            nconf[g.ev[e]] = 1;
            nscore[g.eu[e]] += 1;
            nscore[g.ev[e]] += 1;
        }
    }

    void n_update_best(const Clock &clk) {
        if (now_weight < best_weight) {
            best_weight = now_weight;
            best_c = in_c;
            best_time = clk.elapsed();
        }
    }

    // init_fast-style cover (reference wvcp_0123.c:102-214): after the
    // construction rules pin must_in vertices, cover every remaining edge
    // with the endpoint of better degree/cost ratio, then drop vertices
    // covering nothing solely.  Replaces the engine-greedy construction as
    // the search's starting point (scores here are rebuilt exactly, not the
    // reference's stale leftovers).
    void n_init_fast_cover() {
        for (u64 e = 0; e < g.m; ++e) {
            u32 a = g.eu[e], b = g.ev[e];
            if (!in_c[a] && !in_c[b]) {
                u64 lhs = (u64)g.deg(a) * g.w[b], rhs = (u64)g.deg(b) * g.w[a];
                u32 pick = lhs > rhs ? a : b;
                in_c[pick] = 1;
                now_weight += g.w[pick];
            }
        }
        // solely-covered edge counts; drop redundant cover vertices
        std::vector<u32> solo(g.n, 0);
        for (u64 e = 0; e < g.m; ++e) {
            u32 a = g.eu[e], b = g.ev[e];
            if (in_c[a] != in_c[b])
                solo[in_c[a] ? a : b]++;
        }
        for (u32 v = 0; v < g.n; ++v) {
            if (in_c[v] && !must_in[v] && solo[v] == 0) {
                in_c[v] = 0;
                now_weight -= g.w[v];
                for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
                    u32 x = g.nbr[k];
                    if (in_c[x] && !in_c[v])
                        solo[x]++;
                }
            }
        }
        if (now_weight < best_weight) {
            best_weight = now_weight;
            best_c = in_c;
        }
    }

    void numwvc_search(double cutoff) {
        Clock clk;
        n_init_state();
        u64 no_improve = 0;
        int num_remove = 3;
        while (clk.elapsed() < cutoff) {
            if (nuncov.empty()) {
                if (now_weight < best_weight) {
                    n_update_best(clk);
                    no_improve = 0;
                } else {
                    no_improve++;
                }
                u32 maxc = n_find_best(false);
                if (maxc == UINT32_MAX)
                    return;
                n_remove(maxc);
                time_stamp[maxc] = (u32)step;
                continue;
            }
            if (num_remove > 1 && no_improve <= 100) {
                num_remove--;
                no_improve = 0;
            }
            for (int hh = 0; hh < num_remove; ++hh) {
                u32 v = n_find_best(true);
                if (v == UINT32_MAX)
                    break;
                n_remove(v);
                time_stamp[v] = (u32)step;
            }
            std::fill(ntabu.begin(), ntabu.end(), 0);
            while (!nuncov.empty()) {
                if (now_weight + 1 >= best_weight)  // bounded repair
                    break;
                u32 e = nuncov[rng() % nuncov.size()];
                u32 maxc = UINT32_MAX;
                bool have_ratio = false;  // maxc picked by score/cost ratio
                u32 ends[2] = {g.eu[e], g.ev[e]};
                for (u32 j : ends) {
                    if (nconf[j] == 0) {
                        // CC-blocked: only usable if it alone finishes the
                        // repair under the cost bound (reference
                        // wvcp_0123.c:443-459); never overrides a
                        // ratio-selected candidate
                        if (now_weight + g.w[j] >= best_weight)
                            continue;
                        if (!have_ratio &&
                            n_uncov_deg_edges(j) == nuncov.size())
                            maxc = j;
                    } else if (!have_ratio) {
                        maxc = j;
                        have_ratio = true;
                    } else {
                        i64 lhs = nscore[j] * (i64)g.w[maxc];
                        i64 rhs = nscore[maxc] * (i64)g.w[j];
                        if (lhs > rhs || (lhs == rhs &&
                                          time_stamp[maxc] > time_stamp[j]))
                            maxc = j;
                    }
                }
                if (maxc == UINT32_MAX)
                    break;  // both endpoints CC-blocked (reference UB path)
                n_add(maxc);
                ntabu[maxc] = 1;
                time_stamp[maxc] = (u32)step;
                n_inflate_uncovered();
            }
            step++;
        }
    }
};

// ---------------------------------------------------------------------------
// HILS for Max Weight IS; cover = complement of the best solution.
class HilsSolver {
  public:
    CsrGraph g;
    std::mt19937 rng;
    // permutation of vertices: [solution | free | nonfree]
    std::vector<u32> perm, pos, tight;
    std::vector<i64> mu;
    u32 sol_sz = 0, free_sz = 0;
    u64 weight = 0;
    std::vector<u32> best_set;
    u64 best_weight = 0;
    double best_time = 0.0;

    HilsSolver(u32 n, const u32 *wt, u64 m, const u32 *eu, const u32 *ev,
               u32 seed)
        : g(n, wt, m, eu, ev), rng(seed), perm(n), pos(n), tight(n, 0),
          mu(n) {
        for (u32 v = 0; v < n; ++v) {
            perm[v] = v;
            pos[v] = v;
            mu[v] = (i64)g.w[v];
        }
        free_sz = n;
    }

    bool in_sol(u32 v) const { return pos[v] < sol_sz; }
    bool is_free(u32 v) const {
        return pos[v] >= sol_sz && pos[v] < sol_sz + free_sz;
    }

    void swap_to(u32 v, u32 target) {
        u32 u = perm[target], pv = pos[v];
        std::swap(perm[pv], perm[target]);
        pos[u] = pv;
        pos[v] = target;
    }

    void make_free(u32 v) {  // from nonfree region
        swap_to(v, sol_sz + free_sz);
        free_sz++;
    }
    void make_nonfree(u32 v) {  // from free region
        free_sz--;
        swap_to(v, sol_sz + free_sz);
    }

    void add_vertex(u32 v) {
        // v must be free: swap with the first free slot, absorb it into the
        // solution region (displaced vertex stays free).
        swap_to(v, sol_sz);
        sol_sz++;
        free_sz--;
        weight += g.w[v];
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
            u32 nb = g.nbr[k];
            if (tight[nb] == 0 && is_free(nb))
                make_nonfree(nb);
            tight[nb]++;
            mu[nb] -= (i64)g.w[v];
        }
    }

    void remove_vertex(u32 v) {
        sol_sz--;
        swap_to(v, sol_sz);
        free_sz++;  // v becomes free (no solution neighbors by invariant)
        weight -= g.w[v];
        for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
            u32 nb = g.nbr[k];
            tight[nb]--;
            mu[nb] += (i64)g.w[v];
            if (tight[nb] == 0 && !in_sol(nb) && !is_free(nb))
                make_free(nb);
        }
    }

    void add_random_free() {
        if (free_sz == 0)
            return;
        u32 v = perm[sol_sz + rng() % free_sz];
        add_vertex(v);
    }

    void make_maximal() {
        while (free_sz > 0)
            add_random_free();
    }

    bool omega_improvement() {
        for (u32 idx = g.n; idx-- > sol_sz;) {
            u32 v = perm[idx];
            if (mu[v] > 0) {
                for (u32 k = g.off[v]; k < g.off[v + 1]; ++k) {
                    u32 nb = g.nbr[k];
                    if (in_sol(nb))
                        remove_vertex(nb);
                }
                add_vertex(v);
                return true;
            }
        }
        return false;
    }

    bool two_improvement() {
        for (u32 idx = 0; idx < sol_sz; ++idx) {
            u32 x = perm[idx];
            // 1-tight neighbors of x
            std::vector<u32> ones;
            for (u32 k = g.off[x]; k < g.off[x + 1]; ++k)
                if (tight[g.nbr[k]] == 1)
                    ones.push_back(g.nbr[k]);
            if (ones.size() < 2)
                continue;
            std::sort(ones.begin(), ones.end());
            for (u32 v : ones) {
                // find w in ones, w != v, not adjacent to v,
                // with w(v) + w(w) > w(x)
                for (u32 wv : ones) {
                    if (wv <= v || adjacent(v, wv))
                        continue;
                    if ((u64)g.w[v] + g.w[wv] <= g.w[x])
                        continue;
                    remove_vertex(x);
                    add_vertex(v);
                    add_vertex(wv);
                    return true;
                }
            }
        }
        return false;
    }

    bool adjacent(u32 a, u32 b) const {
        if (g.deg(a) > g.deg(b))
            std::swap(a, b);
        for (u32 k = g.off[a]; k < g.off[a + 1]; ++k)
            if (g.nbr[k] == b)
                return true;
        return false;
    }

    void force(u32 k) {
        for (u32 i = 0; i < k; ++i) {
            u32 nonfree = g.n - sol_sz - free_sz;
            if (nonfree == 0)
                return;
            u32 v = perm[sol_sz + free_sz + rng() % nonfree];
            for (u32 kk = g.off[v]; kk < g.off[v + 1]; ++kk) {
                u32 nb = g.nbr[kk];
                if (in_sol(nb))
                    remove_vertex(nb);
            }
            add_vertex(v);
        }
    }

    void snapshot(const Clock &clk) {
        if (weight > best_weight) {
            best_weight = weight;
            best_set.assign(perm.begin(), perm.begin() + sol_sz);
            best_time = clk.elapsed();
        }
    }

    // target > 0 stops the search once the IS weight reaches it
    // (reference: HILS/main.cpp:312, ArgPack.h "-target")
    void run(double cutoff, u64 max_iters = 2'000'000, int p0 = 2, int p1 = 4,
             int p2 = 4, int p3 = 1, u64 target = 0) {
        Clock clk;
        make_maximal();
        while ((omega_improvement() || two_improvement()) &&
               clk.elapsed() < cutoff)
            make_maximal();
        snapshot(clk);

        // the ILS outer loop: perturb a copy, re-optimize, accept if better
        i64 k = 1;
        u64 local_best = weight;
        auto state = save();
        for (u64 iter = 0; iter < max_iters && clk.elapsed() < cutoff &&
                           !(target && best_weight >= target);
             ++iter) {
            auto cur = save();
            force(p0);
            make_maximal();
            while ((omega_improvement() || two_improvement()) &&
                   clk.elapsed() < cutoff)
                make_maximal();
            if (weight > cur.weight) {
                k = 1;
                if (local_best < weight) {
                    k -= (i64)(sol_sz / std::max(1, p1));
                    local_best = weight;
                }
                if (best_weight < weight) {
                    snapshot(clk);
                    k -= (i64)sol_sz * p2;
                }
            } else if (k <= (i64)(sol_sz / std::max(1, p1))) {
                restore(cur);
                k++;
            } else {
                restore(cur);
                local_best = weight;
                force(p3);
                make_maximal();
                k = 1;
            }
        }
    }

    struct State {
        std::vector<u32> perm, pos, tight;
        std::vector<i64> mu;
        u32 sol_sz, free_sz;
        u64 weight;
    };
    State save() const {
        return {perm, pos, tight, mu, sol_sz, free_sz, weight};
    }
    void restore(const State &s) {
        perm = s.perm;
        pos = s.pos;
        tight = s.tight;
        mu = s.mu;
        sol_sz = s.sol_sz;
        free_sz = s.free_sz;
        weight = s.weight;
    }
};

}  // namespace baselines
}  // namespace mwvc
