// chemkit — native chemistry kernels for llamole_tpu's host-side runtime.
//
// The reference outsources these inner loops to RDKit C++ (SURVEY.md §2 L0);
// llamole_tpu's chemistry is first-party, so the hot paths get a first-party
// native implementation too:
//
//   ck_wl_ranks         canonical atom ranking (Weisfeiler-Lehman refinement
//                       with deterministic tie-breaking) — the inner loop of
//                       SMILES canonicalization, called for every molecule
//                       the planner touches
//   ck_morgan_bits      Morgan/ECFP environment hashing for the cost model
//   ck_match_component  SMARTS subgraph-isomorphism matcher — the inner loop
//                       of retro-template application (the planner applies
//                       ~50 templates per expansion; reference outsources
//                       this to RDKit's substructure matcher via
//                       rdchiralRunText, graph_predictor/model.py:193)
//
// All functions are exact ports of the Python reference implementations in
// chem/smiles.py (canonical_ranks), chem/fingerprint.py and chem/smarts.py
// (match_component) — outputs are bit-identical (including enumeration
// order), so the ctypes wrapper can dispatch freely.
//
// C ABI over flat arrays; no global state; thread-safe.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <array>
#include <cctype>
#include <functional>
#include <map>
#include <set>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Weisfeiler-Lehman canonical ranks
//
// invariants : n_atoms x inv_width row-major int64 initial invariant tuples
// edges      : m x 3 (a1, a2, order2x) int32
// out_ranks  : n_atoms int32
// ---------------------------------------------------------------------------

static void ranks_from_keys(const std::vector<std::vector<int64_t>>& keys,
                            std::vector<int32_t>& ranks) {
    std::vector<const std::vector<int64_t>*> uniq;
    uniq.reserve(keys.size());
    for (const auto& k : keys) uniq.push_back(&k);
    std::sort(uniq.begin(), uniq.end(),
              [](const auto* a, const auto* b) { return *a < *b; });
    uniq.erase(std::unique(uniq.begin(), uniq.end(),
                           [](const auto* a, const auto* b) { return *a == *b; }),
               uniq.end());
    std::map<std::vector<int64_t>, int32_t> lookup;
    for (size_t r = 0; r < uniq.size(); ++r) lookup[*uniq[r]] = (int32_t)r;
    for (size_t i = 0; i < keys.size(); ++i) ranks[i] = lookup[keys[i]];
}

static void refine(int32_t n,
                   const std::vector<std::vector<std::pair<int32_t, int32_t>>>& adj,
                   std::vector<int32_t>& ranks) {
    std::vector<std::vector<int64_t>> keys((size_t)n);
    std::vector<int32_t> new_ranks((size_t)n);
    while (true) {
        for (int32_t i = 0; i < n; ++i) {
            std::vector<std::pair<int32_t, int32_t>> nbrs;
            nbrs.reserve(adj[i].size());
            for (const auto& [w, order2] : adj[i])
                nbrs.emplace_back(order2, ranks[w]);
            std::sort(nbrs.begin(), nbrs.end());
            auto& key = keys[i];
            key.clear();
            key.push_back(ranks[i]);
            for (const auto& [o, r] : nbrs) {
                key.push_back(o);
                key.push_back(r);
            }
        }
        ranks_from_keys(keys, new_ranks);
        if (new_ranks == ranks) return;
        ranks.swap(new_ranks);
    }
}

// ranks_from_keys + refine + deterministic tie-breaking (the full
// canonical_ranks pipeline of chem/smiles.py:665-701) — shared between
// ck_wl_ranks and ck_canonicalize
static void canonical_rank_core(
    int32_t n, std::vector<std::vector<int64_t>>& keys,
    const std::vector<std::vector<std::pair<int32_t, int32_t>>>& adj,
    std::vector<int32_t>& ranks) {
    ranks_from_keys(keys, ranks);
    refine(n, adj, ranks);
    // tie-breaking: promote the lowest atom index in the smallest tied class
    while (true) {
        std::map<int32_t, int32_t> counts;
        for (auto r : ranks) counts[r]++;
        int32_t target = -1;
        for (const auto& [r, c] : counts)
            if (c > 1) { target = r; break; }
        if (target < 0) break;
        int32_t pick = -1;
        for (int32_t i = 0; i < n; ++i)
            if (ranks[i] == target) { pick = i; break; }
        std::vector<std::vector<int64_t>> tb((size_t)n);
        for (int32_t i = 0; i < n; ++i)
            tb[i] = {ranks[i], i == pick ? 0 : 1};
        ranks_from_keys(tb, ranks);
        refine(n, adj, ranks);
    }
}

int32_t ck_wl_ranks(int32_t n_atoms, int32_t inv_width,
                    const int64_t* invariants,
                    int32_t n_edges, const int32_t* edges,
                    int32_t* out_ranks) {
    if (n_atoms <= 0) return 0;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> adj((size_t)n_atoms);
    for (int32_t e = 0; e < n_edges; ++e) {
        int32_t a = edges[3 * e], b = edges[3 * e + 1], o = edges[3 * e + 2];
        if (a < 0 || b < 0 || a >= n_atoms || b >= n_atoms) return -1;
        adj[a].emplace_back(b, o);
        adj[b].emplace_back(a, o);
    }
    std::vector<std::vector<int64_t>> keys((size_t)n_atoms);
    for (int32_t i = 0; i < n_atoms; ++i)
        keys[i].assign(invariants + (size_t)i * inv_width,
                       invariants + (size_t)(i + 1) * inv_width);
    std::vector<int32_t> ranks((size_t)n_atoms);
    canonical_rank_core(n_atoms, keys, adj, ranks);
    std::memcpy(out_ranks, ranks.data(), sizeof(int32_t) * (size_t)n_atoms);
    return 0;
}

// ---------------------------------------------------------------------------
// Morgan fingerprint bits (FNV-chained environment hashing; exact port of
// chem/fingerprint.py _mix + morgan_fingerprint)
// ---------------------------------------------------------------------------

static const uint64_t MASK61 = ((uint64_t)1 << 61) - 1;

static uint64_t mix(const uint64_t* vals, size_t count) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (size_t i = 0; i < count; ++i) {
        uint64_t v = vals[i] & MASK61;
        do {
            h ^= v & 0xFF;
            h *= 0x100000001B3ULL;
            v >>= 8;
        } while (v != 0);
        h ^= 0xFF;
        h *= 0x100000001B3ULL;
    }
    return h;
}

// invariants: n x 7 int64 (z, charge+16, degree, total_h, bos2x, in_ring,
//             aromatic) — same layout the Python fingerprint builds
// edges:      m x 3 (a1, a2, order2x)
// out_bits:   n_bits bytes (0/1)
int32_t ck_morgan_bits(int32_t n_atoms, const int64_t* invariants,
                       int32_t n_edges, const int32_t* edges,
                       int32_t radius, int32_t n_bits, uint8_t* out_bits) {
    if (n_atoms <= 0 || n_bits <= 0) return -1;
    std::memset(out_bits, 0, (size_t)n_bits);
    std::vector<std::vector<std::pair<int32_t, int32_t>>> adj((size_t)n_atoms);
    for (int32_t e = 0; e < n_edges; ++e) {
        int32_t a = edges[3 * e], b = edges[3 * e + 1], o = edges[3 * e + 2];
        if (a < 0 || b < 0 || a >= n_atoms || b >= n_atoms) return -1;
        adj[a].emplace_back(b, o);
        adj[b].emplace_back(a, o);
    }
    std::vector<uint64_t> ids((size_t)n_atoms);
    for (int32_t i = 0; i < n_atoms; ++i) {
        uint64_t vals[7];
        for (int k = 0; k < 7; ++k)
            vals[k] = (uint64_t)invariants[(size_t)i * 7 + k];
        ids[i] = mix(vals, 7);
    }
    std::vector<uint64_t> bits(ids.begin(), ids.end());
    std::vector<uint64_t> new_ids((size_t)n_atoms);
    for (int32_t r = 0; r < radius; ++r) {
        for (int32_t i = 0; i < n_atoms; ++i) {
            std::vector<std::pair<uint64_t, uint64_t>> env;
            env.reserve(adj[i].size());
            for (const auto& [w, o] : adj[i])
                env.emplace_back((uint64_t)o, ids[w]);
            std::sort(env.begin(), env.end());
            std::vector<uint64_t> flat;
            flat.reserve(1 + 2 * env.size());
            flat.push_back(ids[i]);
            for (const auto& [o, nid] : env) {
                flat.push_back(o);
                flat.push_back(nid);
            }
            new_ids[i] = mix(flat.data(), flat.size());
        }
        ids = new_ids;
        bits.insert(bits.end(), ids.begin(), ids.end());
    }
    for (uint64_t b : bits) out_bits[b % (uint64_t)n_bits] = 1;
    return 0;
}

// ---------------------------------------------------------------------------
// SMARTS component matching (exact port of chem/smarts.py match_component:
// same traversal order, same candidate order, same enumeration order, same
// max_matches cutoff — the Python path stays the reference implementation)
//
// Molecule side (serialized by chem/smarts.py _native_mol):
//   ctx        : n_atoms x 7 int32 [z, charge, aromatic, degree, total_h,
//                in_ring, ring_count]
//   ring_masks : n_atoms uint64 — bit s set when an SSSR ring of size s<64
//                passes through the atom (mols with a ring >=64 never get
//                serialized; Python path handles them)
//   adjacency  : CSR in bond-insertion order (matches the Python dict
//                insertion order): adj_off[n_atoms+1] into adj_nbr /
//                adj_order / adj_arom / adj_ring
//
// Query side (serialized by chem/smarts.py _native_query):
//   prog   : predicate program stream, per query atom:
//              n_groups, { n_alts, { n_terms, { neg, kind, val }* }* }*
//            AND over groups / OR over alternatives / AND over terms —
//            QueryAtom.matches semantics
//   qbonds : n_qbonds x 3 (a, b, bond_kind) in source order; duplicate
//            (a,b) pairs overwrite the kind but keep the first position,
//            mirroring QueryMol.adjacency()'s dict assignment
// ---------------------------------------------------------------------------

namespace {

// primitive kinds — keep in sync with smarts.py _PRIM_CODE
enum PrimKind {
    PK_ANY = 0, PK_ELEM = 1, PK_ELEM_AROM = 2, PK_ELEM_ALIPH = 3,
    PK_AROMATIC = 4, PK_ALIPHATIC = 5, PK_HCOUNT = 6, PK_DEGREE = 7,
    PK_CONNECTIVITY = 8, PK_RING = 9, PK_RING_COUNT = 10,
    PK_RINGSIZE = 11, PK_CHARGE = 12,
};

// bond kinds — keep in sync with smarts.py _BOND_CODE
enum BondKind {
    BK_DEFAULT = 0, BK_SINGLE = 1, BK_DOUBLE = 2, BK_TRIPLE = 3,
    BK_AROMATIC = 4, BK_ANY = 5, BK_RING = 6,
};

struct MolView {
    int32_t n;
    const int32_t* ctx;        // n x 7
    const uint64_t* ring_masks;
    const int32_t* off;
    const int32_t* nbr;
    const int32_t* order;
    const int32_t* arom;
    const int32_t* ring;
};

struct Term { int32_t neg, kind, val; };
struct QAtomProg {
    // groups[g] = list of alternatives; alternative = range into terms
    std::vector<std::vector<std::pair<int32_t, int32_t>>> groups;
    std::vector<Term> terms;
};

static bool eval_primitive(const Term& t, const MolView& m, int32_t mi) {
    const int32_t* c = m.ctx + (size_t)mi * 7;
    const int32_t z = c[0], charge = c[1], aromatic = c[2], degree = c[3],
                  total_h = c[4], in_ring = c[5], ring_count = c[6];
    bool v;
    switch (t.kind) {
        case PK_ANY:          v = true; break;
        case PK_ELEM:         v = z == t.val; break;
        case PK_ELEM_AROM:    v = z == t.val && aromatic; break;
        case PK_ELEM_ALIPH:   v = z == t.val && !aromatic; break;
        case PK_AROMATIC:     v = aromatic != 0; break;
        case PK_ALIPHATIC:    v = aromatic == 0; break;
        case PK_HCOUNT:       v = total_h == t.val; break;
        case PK_DEGREE:       v = degree == t.val; break;
        case PK_CONNECTIVITY: v = degree + total_h == t.val; break;
        case PK_RING:         v = in_ring != 0; break;
        case PK_RING_COUNT:   v = ring_count == t.val; break;
        case PK_RINGSIZE:
            v = t.val == 0 ? in_ring != 0
                           : (t.val < 64 &&
                              ((m.ring_masks[mi] >> t.val) & 1) != 0);
            break;
        case PK_CHARGE:       v = charge == t.val; break;
        default:              return false;  // unknown => never matches
    }
    return t.neg ? !v : v;
}

static bool atom_matches(const QAtomProg& q, const MolView& m, int32_t mi) {
    for (const auto& group : q.groups) {
        bool ok = false;
        for (const auto& [t0, t1] : group) {
            bool all = true;
            for (int32_t t = t0; t < t1; ++t)
                if (!eval_primitive(q.terms[(size_t)t], m, mi)) { all = false; break; }
            if (all) { ok = true; break; }
        }
        if (!ok) return false;
    }
    return true;
}

static bool bond_matches(int32_t kind, int32_t order, int32_t aromatic,
                         int32_t in_ring) {
    switch (kind) {
        case BK_ANY:      return true;
        case BK_DEFAULT:  return aromatic || order == 1;
        case BK_SINGLE:   return order == 1 && !aromatic;
        case BK_DOUBLE:   return order == 2 && !aromatic;
        case BK_TRIPLE:   return order == 3;
        case BK_AROMATIC: return aromatic != 0;
        case BK_RING:     return in_ring != 0;
        default:          return false;
    }
}

struct MatchState {
    const MolView& m;
    const std::vector<QAtomProg>& qatoms;
    const std::vector<std::vector<std::pair<int32_t, int32_t>>>& qadj;
    const std::vector<int32_t>& order;
    int32_t nq, max_matches;
    std::vector<int32_t> assignment;  // query idx -> mol idx, -1 unset
    std::vector<uint8_t> used;        // mol idx used
    int32_t* out;
    int32_t count = 0;

    MatchState(const MolView& m_, const std::vector<QAtomProg>& qa,
               const std::vector<std::vector<std::pair<int32_t, int32_t>>>& adj,
               const std::vector<int32_t>& ord, int32_t nq_, int32_t mm,
               int32_t* out_)
        : m(m_), qatoms(qa), qadj(adj), order(ord), nq(nq_),
          max_matches(mm), assignment((size_t)nq_, -1),
          used((size_t)m_.n, 0), out(out_) {}

    bool bond_ok(int32_t qi, int32_t mi) const {
        for (const auto& [qn, qb] : qadj[(size_t)qi]) {
            int32_t mn = assignment[(size_t)qn];
            if (mn < 0) continue;
            // find mol bond mi-mn in mi's adjacency
            int32_t found = -1;
            for (int32_t e = m.off[mi]; e < m.off[mi + 1]; ++e)
                if (m.nbr[e] == mn) { found = e; break; }
            if (found < 0) return false;
            if (!bond_matches(qb, m.order[found], m.arom[found],
                              m.ring[found]))
                return false;
        }
        return true;
    }

    bool backtrack(int32_t pos) {
        if (count >= max_matches) return true;
        if (pos == (int32_t)order.size()) {
            std::memcpy(out + (size_t)count * nq, assignment.data(),
                        sizeof(int32_t) * (size_t)nq);
            ++count;
            return count >= max_matches;
        }
        int32_t qi = order[(size_t)pos];
        // anchor: first already-assigned query neighbor (adjacency order)
        int32_t anchor = -1;
        for (const auto& [qn, qb] : qadj[(size_t)qi]) {
            (void)qb;
            if (assignment[(size_t)qn] >= 0) { anchor = qn; break; }
        }
        if (anchor >= 0) {
            int32_t ma = assignment[(size_t)anchor];
            for (int32_t e = m.off[ma]; e < m.off[ma + 1]; ++e)
                if (try_candidate(qi, m.nbr[e], pos)) return true;
        } else {
            for (int32_t mi = 0; mi < m.n; ++mi)
                if (try_candidate(qi, mi, pos)) return true;
        }
        return false;
    }

    bool try_candidate(int32_t qi, int32_t mi, int32_t pos) {
        if (used[(size_t)mi]) return false;
        if (!atom_matches(qatoms[(size_t)qi], m, mi)) return false;
        assignment[(size_t)qi] = mi;
        if (bond_ok(qi, mi)) {
            used[(size_t)mi] = 1;
            if (backtrack(pos + 1)) {
                used[(size_t)mi] = 0;
                assignment[(size_t)qi] = -1;
                return true;
            }
            used[(size_t)mi] = 0;
        }
        assignment[(size_t)qi] = -1;
        return false;
    }
};

// parsed query component: predicate programs + adjacency + BFS order
struct QueryProg {
    int32_t nq = 0;
    std::vector<QAtomProg> qatoms;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> qadj;
    std::vector<int32_t> order;
};

// decode the flat predicate program (smarts.py _native_query layout);
// returns bytes of `prog` consumed, or -1 on malformed input
static int32_t ck_build_query(int32_t nq, const int32_t* prog,
                              int32_t prog_len, int32_t n_qbonds,
                              const int32_t* qbonds, QueryProg& Q) {
    if (nq <= 0) return -1;
    Q.nq = nq;
    Q.qatoms.assign((size_t)nq, {});
    int32_t p = 0;
    for (int32_t q = 0; q < nq; ++q) {
        if (p >= prog_len) return -1;
        int32_t ngroups = prog[p++];
        auto& qa = Q.qatoms[(size_t)q];
        qa.groups.resize((size_t)ngroups);
        for (int32_t g = 0; g < ngroups; ++g) {
            if (p >= prog_len) return -1;
            int32_t nalts = prog[p++];
            for (int32_t a = 0; a < nalts; ++a) {
                if (p >= prog_len) return -1;
                int32_t nterms = prog[p++];
                int32_t t0 = (int32_t)qa.terms.size();
                if (p + 3 * nterms > prog_len) return -1;
                for (int32_t t = 0; t < nterms; ++t) {
                    qa.terms.push_back({prog[p], prog[p + 1], prog[p + 2]});
                    p += 3;
                }
                qa.groups[(size_t)g].emplace_back(t0, t0 + nterms);
            }
        }
    }

    // query adjacency: insertion order, duplicate pairs overwrite the kind
    // in place (QueryMol.adjacency() dict semantics)
    Q.qadj.assign((size_t)nq, {});
    for (int32_t e = 0; e < n_qbonds; ++e) {
        int32_t a = qbonds[3 * e], b = qbonds[3 * e + 1], k = qbonds[3 * e + 2];
        if (a < 0 || b < 0 || a >= nq || b >= nq) return -1;
        auto upsert = [k](std::vector<std::pair<int32_t, int32_t>>& lst,
                          int32_t other) {
            for (auto& [o, kk] : lst)
                if (o == other) { kk = k; return; }
            lst.emplace_back(other, k);
        };
        upsert(Q.qadj[(size_t)a], b);
        upsert(Q.qadj[(size_t)b], a);
    }

    // traversal order: BFS from query atom 0 (smarts.py match_component)
    Q.order.clear();
    Q.order.reserve((size_t)nq);
    std::vector<uint8_t> seen((size_t)nq, 0);
    Q.order.push_back(0);
    seen[0] = 1;
    for (size_t head = 0; head < Q.order.size(); ++head) {
        int32_t v = Q.order[head];
        for (const auto& [w, kk] : Q.qadj[(size_t)v]) {
            (void)kk;
            if (!seen[(size_t)w]) {
                seen[(size_t)w] = 1;
                Q.order.push_back(w);
            }
        }
    }
    for (int32_t i = 0; i < nq; ++i)
        if (!seen[(size_t)i]) Q.order.push_back(i);
    return p;
}

static int32_t ck_run_match(const MolView& m, const QueryProg& Q,
                            int32_t max_matches, int32_t* out) {
    MatchState st(m, Q.qatoms, Q.qadj, Q.order, Q.nq, max_matches, out);
    st.backtrack(0);
    return st.count;
}

}  // namespace

int32_t ck_match_component(
    int32_t n_atoms, const int32_t* ctx, const uint64_t* ring_masks,
    const int32_t* adj_off, const int32_t* adj_nbr, const int32_t* adj_order,
    const int32_t* adj_arom, const int32_t* adj_ring,
    int32_t nq, const int32_t* prog, int32_t prog_len,
    int32_t n_qbonds, const int32_t* qbonds,
    int32_t max_matches, int32_t* out, int32_t* out_count) {
    *out_count = 0;
    if (nq <= 0 || n_atoms <= 0 || max_matches <= 0) return 0;
    QueryProg Q;
    const int32_t used = ck_build_query(nq, prog, prog_len, n_qbonds,
                                        qbonds, Q);
    if (used != prog_len) return -1;
    MolView m{n_atoms, ctx, ring_masks, adj_off, adj_nbr,
              adj_order, adj_arom, adj_ring};
    *out_count = ck_run_match(m, Q, max_matches, out);
    return 0;
}

// ---------------------------------------------------------------------------
// Exact SSSR (minimum cycle basis) — port of Mol.smallest_rings
// (chem/mol.py): shortest cycle through every non-bridge bond as
// candidates, stable smallest-first selection under GF(2) edge-mask
// independence, Horton vertex-rooted top-up for the rank-deficient
// case. Enumeration orders follow the Python implementation exactly
// (CSR adjacency is serialized in `_adj` insertion order), so the
// output ring lists are identical element-for-element.
//
// Inputs: bonds = n_bonds x 2 (a1, a2); CSR adj with parallel bond-
// index array; target = m - n + c precomputed by the caller (> 0).
// Outputs: rings concatenated into out_atoms with out_off[k]..[k+1]
// delimiting ring k. Returns 0 on success, 1 when a cap would be
// exceeded (caller falls back to Python), -1 on malformed input.
// ---------------------------------------------------------------------------

namespace {

struct Bitset {
    std::vector<uint64_t> w;
    explicit Bitset(size_t words) : w(words, 0) {}
    void set(int32_t b) { w[(size_t)b >> 6] |= (uint64_t)1 << (b & 63); }
    void operator^=(const Bitset& o) {
        for (size_t i = 0; i < w.size(); ++i) w[i] ^= o.w[i];
    }
    int32_t leading_bit() const {  // -1 when empty
        for (size_t i = w.size(); i-- > 0;)
            if (w[i]) return (int32_t)(i * 64 + 63 - __builtin_clzll(w[i]));
        return -1;
    }
};

}  // namespace

// Tarjan lowlink bridge finding over CSR adjacency (port of
// Mol._find_bridges, chem/mol.py:478 — the bridge set is graph-unique)
static void compute_bridges(
    int32_t n_atoms, const int32_t* adj_off, const int32_t* adj_nbr,
    const int32_t* adj_bidx, std::vector<uint8_t>& is_bridge) {
    std::vector<int32_t> disc((size_t)n_atoms, -1), low((size_t)n_atoms, 0);
    int32_t timer = 0;
    // explicit stack: (vertex, parent-edge, next CSR cursor)
    std::vector<std::array<int32_t, 3>> st;
    for (int32_t root = 0; root < n_atoms; ++root) {
        if (disc[(size_t)root] != -1) continue;
        disc[(size_t)root] = low[(size_t)root] = timer++;
        st.push_back({root, -1, adj_off[root]});
        while (!st.empty()) {
            auto& top = st.back();
            int32_t v = top[0], pe = top[1];
            bool advanced = false;
            while (top[2] < adj_off[v + 1]) {
                int32_t e = top[2]++;
                int32_t w = adj_nbr[e], be = adj_bidx[e];
                if (be == pe) continue;
                if (disc[(size_t)w] == -1) {
                    disc[(size_t)w] = low[(size_t)w] = timer++;
                    st.push_back({w, be, adj_off[w]});
                    advanced = true;
                    break;
                }
                low[(size_t)v] = std::min(low[(size_t)v], disc[(size_t)w]);
            }
            if (!advanced && top[2] >= adj_off[v + 1]) {
                st.pop_back();
                if (!st.empty()) {
                    int32_t u = st.back()[0];
                    low[(size_t)u] = std::min(low[(size_t)u], low[(size_t)v]);
                    if (low[(size_t)v] > disc[(size_t)u])
                        is_bridge[(size_t)pe] = 1;
                }
            }
        }
    }
}

int32_t ck_sssr(
    int32_t n_atoms, int32_t n_bonds, const int32_t* bonds,
    const int32_t* adj_off, const int32_t* adj_nbr, const int32_t* adj_bidx,
    int32_t target,
    int32_t* out_atoms, int32_t out_cap,
    int32_t* out_off, int32_t max_rings, int32_t* out_n_rings) {
    *out_n_rings = 0;
    if (n_atoms <= 0 || n_bonds <= 0 || target <= 0) return -1;

    std::vector<uint8_t> is_bridge((size_t)n_bonds, 0);
    compute_bridges(n_atoms, adj_off, adj_nbr, adj_bidx, is_bridge);

    // -- candidate rings: shortest cycle through each non-bridge bond -----
    std::vector<std::vector<int32_t>> cands;
    std::set<std::vector<int32_t>> seen;
    std::vector<int32_t> parent((size_t)n_atoms);
    std::vector<int32_t> queue;
    queue.reserve((size_t)n_atoms);
    for (int32_t bi = 0; bi < n_bonds; ++bi) {
        if (is_bridge[(size_t)bi]) continue;
        int32_t src = bonds[2 * bi], dst = bonds[2 * bi + 1];
        std::fill(parent.begin(), parent.end(), -2);
        parent[(size_t)src] = -1;
        queue.clear();
        queue.push_back(src);
        for (size_t head = 0; head < queue.size(); ++head) {
            int32_t v = queue[head];
            if (v == dst) break;
            for (int32_t e = adj_off[v]; e < adj_off[v + 1]; ++e) {
                int32_t w = adj_nbr[e];
                if (adj_bidx[e] == bi || parent[(size_t)w] != -2) continue;
                parent[(size_t)w] = v;
                queue.push_back(w);
            }
        }
        if (parent[(size_t)dst] == -2) continue;
        std::vector<int32_t> ring;
        for (int32_t x = dst; x != -1; x = parent[(size_t)x])
            ring.push_back(x);
        std::vector<int32_t> key(ring);
        std::sort(key.begin(), key.end());
        if (seen.insert(std::move(key)).second)
            cands.push_back(std::move(ring));
    }
    std::stable_sort(cands.begin(), cands.end(),
                     [](const std::vector<int32_t>& a,
                        const std::vector<int32_t>& b) {
                         return a.size() < b.size();
                     });

    // -- GF(2) independence selection -------------------------------------
    const size_t words = ((size_t)n_bonds + 63) / 64;
    std::vector<Bitset> basis((size_t)n_bonds, Bitset(0));  // by leading bit
    std::vector<uint8_t> has_basis((size_t)n_bonds, 0);

    auto edge_mask = [&](const std::vector<int32_t>& ring) {
        Bitset m(words);
        for (size_t j = 0; j < ring.size(); ++j) {
            int32_t v = ring[j], w = ring[(j + 1) % ring.size()];
            for (int32_t e = adj_off[v]; e < adj_off[v + 1]; ++e)
                if (adj_nbr[e] == w) { m.set(adj_bidx[e]); break; }
        }
        return m;
    };
    auto independent_add = [&](Bitset mask) {
        for (;;) {
            int32_t lb = mask.leading_bit();
            if (lb < 0) return false;
            if (has_basis[(size_t)lb]) {
                mask ^= basis[(size_t)lb];
            } else {
                basis[(size_t)lb] = std::move(mask);
                has_basis[(size_t)lb] = 1;
                return true;
            }
        }
    };

    std::vector<const std::vector<int32_t>*> chosen;
    for (const auto& ring : cands) {
        if ((int32_t)chosen.size() == target) break;
        if (independent_add(edge_mask(ring))) chosen.push_back(&ring);
    }

    // -- Horton top-up (rank-deficient case) ------------------------------
    std::vector<std::vector<int32_t>> horton;
    if ((int32_t)chosen.size() < target) {
        std::vector<int32_t> stamp((size_t)n_atoms, -1);
        int32_t stamp_id = 0;
        for (int32_t root = 0; root < n_atoms; ++root) {
            std::fill(parent.begin(), parent.end(), -2);
            parent[(size_t)root] = -1;
            queue.clear();
            queue.push_back(root);
            for (size_t head = 0; head < queue.size(); ++head) {
                int32_t v = queue[head];
                for (int32_t e = adj_off[v]; e < adj_off[v + 1]; ++e) {
                    int32_t w = adj_nbr[e];
                    if (parent[(size_t)w] != -2) continue;
                    parent[(size_t)w] = v;
                    queue.push_back(w);
                }
            }
            for (int32_t bi = 0; bi < n_bonds; ++bi) {
                int32_t x = bonds[2 * bi], y = bonds[2 * bi + 1];
                if (parent[(size_t)x] == -2 || parent[(size_t)y] == -2)
                    continue;
                if (parent[(size_t)y] == x || parent[(size_t)x] == y)
                    continue;  // tree edge
                // root-paths excluding the root must be disjoint
                std::vector<int32_t> px, py;
                for (int32_t v = x; v != -1; v = parent[(size_t)v])
                    px.push_back(v);  // x .. root
                for (int32_t v = y; v != -1; v = parent[(size_t)v])
                    py.push_back(v);
                ++stamp_id;
                bool overlap = false;
                for (size_t j = 0; j + 1 < px.size(); ++j)
                    stamp[(size_t)px[j]] = stamp_id;
                for (size_t j = 0; j + 1 < py.size(); ++j)
                    if (stamp[(size_t)py[j]] == stamp_id) { overlap = true; break; }
                if (overlap) continue;
                std::vector<int32_t> ring(px.begin(), px.end() - 1);
                ring.push_back(root);
                for (size_t j = py.size() - 1; j-- > 0;)
                    ring.push_back(py[j]);
                if (ring.size() < 3) continue;
                std::vector<int32_t> key(ring);
                std::sort(key.begin(), key.end());
                if (seen.insert(std::move(key)).second)
                    horton.push_back(std::move(ring));
            }
        }
        std::stable_sort(horton.begin(), horton.end(),
                         [](const std::vector<int32_t>& a,
                            const std::vector<int32_t>& b) {
                             return a.size() < b.size();
                         });
        for (const auto& ring : horton) {
            if ((int32_t)chosen.size() == target) break;
            if (independent_add(edge_mask(ring))) chosen.push_back(&ring);
        }
    }

    // -- emit --------------------------------------------------------------
    if ((int32_t)chosen.size() > max_rings) return 1;
    int32_t pos = 0;
    out_off[0] = 0;
    for (size_t k = 0; k < chosen.size(); ++k) {
        const auto& ring = *chosen[k];
        if (pos + (int32_t)ring.size() > out_cap) return 1;
        std::memcpy(out_atoms + pos, ring.data(),
                    ring.size() * sizeof(int32_t));
        pos += (int32_t)ring.size();
        out_off[k + 1] = pos;
    }
    *out_n_rings = (int32_t)chosen.size();
    return 0;
}

// ---------------------------------------------------------------------------
// ck_canonicalize — fused sanitize + canonical SMILES writer.
//
// Exact port of the STEREO-FREE path of chem/smiles.py sanitize_mol
// (kekulize + valence_errors + perceive_aromaticity, smiles.py:387-658)
// and mol_to_smiles(canonical=True) (canonical_ranks + _generate_smiles,
// smiles.py:665-1117). The Python implementations stay the reference;
// molecules carrying tetrahedral parity or double-bond stereo are never
// serialized to this entry (the ctypes wrapper falls back).
//
// This is the inner loop of retro-template application (reaction.py
// _rewrite step 5 sanitizes + writes every fragment of every outcome;
// the reference outsources the same work to RDKit SanitizeMol +
// MolToSmiles via rdchiral, graph_predictor/model.py:190-228).
//
// Inputs:
//   atoms : n x 6 int32 (z, charge, isotope, explicit_hs(-1 = None),
//           aromatic, atom_map)
//   bonds : m x 4 int32 (a1, a2, order, aromatic)
//   CSR adjacency serialized from Mol._adj in dict-insertion order
//   do_sanitize / do_write : stage toggles
// Outputs:
//   out_atom_arom (n), out_bonds (m x 2: order, aromatic) — the
//   post-sanitize flags, written when do_sanitize
//   out_smiles — NUL-terminated canonical SMILES, written when do_write
//   err_info — [atom_idx, valence*2] on valence error
// Returns 0 ok; 1 kekulization failed; 2 valence error; 3 out_smiles
// buffer too small; -1 malformed input / internal cap exceeded.
// ---------------------------------------------------------------------------

namespace {

// parity: 0 none, 1 = '@' (CCW), 2 = '@@' (CW) — relative to the
// internal reference order (chem/mol.py Atom.parity semantics).
// stereo: 0 none, 1 = cis, 2 = trans with stereo_atoms (sx, sy)
// (chem/mol.py Bond.stereo / stereo_atoms semantics; sx neighbors a1).
struct CkAtom { int32_t z, charge, isotope, ehs, aromatic, map, parity; };
struct CkBond { int32_t a1, a2, order, aromatic, stereo, sx, sy; };

struct CkMol {
    int32_t n, m;
    std::vector<CkAtom> atoms;
    std::vector<CkBond> bonds;
    const int32_t* off;   // CSR: neighbor ranges
    const int32_t* nbr;
    const int32_t* bidx;

    int32_t degree(int32_t i) const { return off[i + 1] - off[i]; }

    // 2x bond-order sum (aromatic bond contributes 3 = 2 x 1.5)
    int32_t bos2(int32_t i) const {
        int32_t s = 0;
        for (int32_t e = off[i]; e < off[i + 1]; ++e) {
            const CkBond& b = bonds[(size_t)bidx[e]];
            s += b.aromatic ? 3 : 2 * b.order;
        }
        return s;
    }

    int32_t bond_between(int32_t a, int32_t b) const {  // -1 when absent
        for (int32_t e = off[a]; e < off[a + 1]; ++e)
            if (nbr[e] == b) return bidx[e];
        return -1;
    }
};

// default_valences port (chem/periodic.py:64-88); fills vals, returns
// count, or -1 for unconstrained (None)
static int ck_default_valences(int32_t z, int32_t charge, int32_t vals[3]) {
    int nbase = 0;
    int32_t base[3];
    switch (z) {
        case 1:  base[0] = 1; nbase = 1; break;
        case 5:  base[0] = 3; nbase = 1; break;
        case 6:  base[0] = 4; nbase = 1; break;
        case 7:  base[0] = 3; nbase = 1; break;
        case 8:  base[0] = 2; nbase = 1; break;
        case 9:  base[0] = 1; nbase = 1; break;
        case 14: base[0] = 4; nbase = 1; break;
        case 15: base[0] = 3; base[1] = 5; nbase = 2; break;
        case 16: base[0] = 2; base[1] = 4; base[2] = 6; nbase = 3; break;
        case 17: base[0] = 1; nbase = 1; break;
        case 33: base[0] = 3; base[1] = 5; nbase = 2; break;
        case 34: base[0] = 2; base[1] = 4; base[2] = 6; nbase = 3; break;
        case 35: base[0] = 1; nbase = 1; break;
        case 53: base[0] = 1; nbase = 1; break;
        default: return -1;
    }
    if (z == 0) return -1;
    if (charge == 0) {
        for (int i = 0; i < nbase; ++i) vals[i] = base[i];
        return nbase;
    }
    const int32_t ac = charge < 0 ? -charge : charge;
    if (z == 7 || z == 15 || z == 8 || z == 16 || z == 34) {
        if (ac != 1) return -1;
        for (int i = 0; i < nbase; ++i)
            vals[i] = std::max(0, base[i] + charge);
        return nbase;
    }
    if (z == 6) {
        if (ac != 1) return -1;
        int32_t mx = base[0];
        for (int i = 1; i < nbase; ++i) mx = std::max(mx, base[i]);
        vals[0] = std::max(0, mx - ac);
        return 1;
    }
    if (z == 5) {
        if (ac != 1) return -1;
        for (int i = 0; i < nbase; ++i) vals[i] = base[i] - charge;
        return nbase;
    }
    if (z == 9 || z == 17 || z == 35 || z == 53) {
        if (charge < 0) { vals[0] = 0; return 1; }
        for (int i = 0; i < nbase; ++i)
            vals[i] = std::max(0, base[i] + charge);
        return nbase;
    }
    return -1;
}

// Mol.implicit_hs port (chem/mol.py:192-208)
static int32_t ck_implicit_hs(const CkMol& M, int32_t i, bool ignore_ehs) {
    const CkAtom& a = M.atoms[(size_t)i];
    if (!ignore_ehs && a.ehs >= 0) return a.ehs;
    if (a.z == 0) return 0;
    int32_t vals[3];
    int nv = ck_default_valences(a.z, a.charge, vals);
    if (nv < 0) return 0;
    int32_t bos_ceil = (M.bos2(i) + 1) / 2;  // ceil(bos - 1e-9)
    for (int k = 0; k < nv; ++k)
        if (vals[k] >= bos_ceil) return vals[k] - bos_ceil;
    return 0;
}

// _needs_pi_double port (smiles.py:445-472)
static bool ck_needs_pi_double(const CkMol& M, int32_t idx) {
    const CkAtom& a = M.atoms[(size_t)idx];
    for (int32_t e = M.off[idx]; e < M.off[idx + 1]; ++e) {
        const CkBond& b = M.bonds[(size_t)M.bidx[e]];
        if (!b.aromatic && b.order == 2) return false;  // exocyclic double
    }
    const int32_t deg = M.degree(idx);
    const int32_t hs = a.ehs;  // -1 = None
    if (a.z == 6) return a.charge == 0;
    if (a.z == 7 || a.z == 15) {
        if (a.charge > 0) return true;
        if (hs > 0 || deg == 3) return false;
        return true;
    }
    if (a.z == 8 || a.z == 16 || a.z == 34) return a.charge > 0;
    if (a.z == 5) return false;
    return true;
}

// kekulize port (smiles.py:387-442): pairwise matching with
// backtracking over aromatic bonds; mutates bond orders/flags in place
// The Python reference kekulize (smiles.py) KeyErrors on an aromatic
// BOND whose endpoint is not an aromatic ATOM (its adjacency dict is
// keyed by aromatic atoms only) — that rejection surfaces as a wrapped
// SmilesError from parse_smiles and a raw KeyError from direct
// sanitize_mol calls. Such input must never be decided natively: the
// sanitize-stage entry points below check this and route the caller
// back to the Python path so behavior stays identical either way.
static bool ck_aromatic_bonds_consistent(const CkMol& M) {
    for (int32_t bi = 0; bi < M.m; ++bi) {
        const CkBond& b = M.bonds[(size_t)bi];
        if (b.aromatic && (!M.atoms[(size_t)b.a1].aromatic ||
                           !M.atoms[(size_t)b.a2].aromatic))
            return false;
    }
    return true;
}

static bool ck_kekulize(CkMol& M) {
    std::vector<int32_t> aro_atoms;
    for (int32_t i = 0; i < M.n; ++i)
        if (M.atoms[(size_t)i].aromatic) aro_atoms.push_back(i);
    if (aro_atoms.empty()) return true;
    std::vector<int32_t> aro_bonds;
    for (int32_t bi = 0; bi < M.m; ++bi)
        if (M.bonds[(size_t)bi].aromatic) aro_bonds.push_back(bi);

    std::vector<uint8_t> needs((size_t)M.n, 0);
    for (int32_t i : aro_atoms)
        needs[(size_t)i] = ck_needs_pi_double(M, i) ? 1 : 0;

    // adjacency restricted to aromatic bonds, in bond-index order
    std::vector<std::vector<int32_t>> kadj((size_t)M.n);
    for (int32_t bi : aro_bonds) {
        kadj[(size_t)M.bonds[(size_t)bi].a1].push_back(M.bonds[(size_t)bi].a2);
        kadj[(size_t)M.bonds[(size_t)bi].a2].push_back(M.bonds[(size_t)bi].a1);
    }

    std::vector<int32_t> order;
    for (int32_t i : aro_atoms)
        if (needs[(size_t)i]) order.push_back(i);
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) {
                         auto cnt = [&](int32_t v) {
                             int32_t c = 0;
                             for (int32_t w : kadj[(size_t)v])
                                 if (needs[(size_t)w]) ++c;
                             return c;
                         };
                         return cnt(a) < cnt(b);
                     });

    std::vector<int32_t> matched((size_t)M.n, -1);
    std::function<bool(size_t)> backtrack = [&](size_t pos) -> bool {
        while (pos < order.size() && matched[(size_t)order[pos]] != -1) ++pos;
        if (pos == order.size()) return true;
        int32_t v = order[pos];
        for (int32_t w : kadj[(size_t)v]) {
            if (needs[(size_t)w] && matched[(size_t)w] == -1) {
                matched[(size_t)v] = w;
                matched[(size_t)w] = v;
                if (backtrack(pos + 1)) return true;
                matched[(size_t)v] = -1;
                matched[(size_t)w] = -1;
            }
        }
        return false;
    };
    if (!backtrack(0)) return false;

    for (int32_t bi : aro_bonds) {
        CkBond& b = M.bonds[(size_t)bi];
        b.order = matched[(size_t)b.a1] == b.a2 ? 2 : 1;
        b.aromatic = 0;
    }
    for (int32_t i : aro_atoms) M.atoms[(size_t)i].aromatic = 0;
    return true;
}

// valence_errors port, first error only (smiles.py:475-488); total is
// 2x to stay integral (all orders are definite post-kekulize)
static bool ck_valence_ok(const CkMol& M, int32_t* err_idx,
                          int32_t* err_total2) {
    for (int32_t i = 0; i < M.n; ++i) {
        const CkAtom& a = M.atoms[(size_t)i];
        int32_t vals[3];
        int nv = ck_default_valences(a.z, a.charge, vals);
        if (nv < 0) continue;
        int32_t mx = vals[0];
        for (int k = 1; k < nv; ++k) mx = std::max(mx, vals[k]);
        const int32_t ehs = a.ehs > 0 ? a.ehs : 0;  // `or 0` semantics
        const int32_t total2 = M.bos2(i) + 2 * ehs;
        if (total2 > 2 * mx) {
            *err_idx = i;
            *err_total2 = total2;
            return false;
        }
    }
    return true;
}

// _pi_electrons port (smiles.py:592-642); -1 encodes Python None
static int32_t ck_pi_electrons(const CkMol& M, int32_t idx,
                               const std::vector<uint8_t>& ring_set,
                               const std::vector<uint8_t>& in_ring_flags) {
    const CkAtom& a = M.atoms[(size_t)idx];
    bool din = false, dout = false, triple = false;
    for (int32_t e = M.off[idx]; e < M.off[idx + 1]; ++e) {
        const CkBond& b = M.bonds[(size_t)M.bidx[e]];
        const int32_t o = M.nbr[e];
        if (b.aromatic || b.order == 2) {
            if (ring_set[(size_t)o]) din = true;
            else if (in_ring_flags[(size_t)o] && M.atoms[(size_t)o].z == 6)
                din = true;  // fusion double into a neighboring ring
            else dout = true;
        }
        if (b.order == 3) triple = true;
    }
    if (triple) return -1;
    const int32_t deg = M.degree(idx);
    const int32_t hs = ck_implicit_hs(M, idx, false);
    const int32_t heavy_h = deg + hs;
    if (a.z == 6) {
        if (din) return 1;
        if (dout) return 0;
        if (a.charge < 0 && heavy_h <= 3) return 2;
        if (a.charge > 0 && heavy_h <= 3) return 0;
        return -1;
    }
    if (a.z == 7 || a.z == 15) {
        if (din) return 1;
        if (heavy_h <= 3 && !dout) return 2;
        if (dout) return 1;
        return -1;
    }
    if (a.z == 8 || a.z == 16 || a.z == 34) {
        if (din) return 1;
        if (deg == 2) return 2;
        return -1;
    }
    if (a.z == 5) return 0;
    return -1;
}

static bool ck_ring_is_aromatic(const CkMol& M,
                                const std::vector<int32_t>& ring,
                                std::vector<uint8_t>& ring_set_scratch,
                                const std::vector<uint8_t>& in_ring_flags) {
    for (int32_t v : ring) ring_set_scratch[(size_t)v] = 1;
    int32_t pi = 0;
    bool ok = true;
    for (int32_t v : ring) {
        int32_t c = ck_pi_electrons(M, v, ring_set_scratch, in_ring_flags);
        if (c < 0) { ok = false; break; }
        pi += c;
    }
    for (int32_t v : ring) ring_set_scratch[(size_t)v] = 0;
    return ok && pi % 4 == 2;
}

// _envelope_cycle port (smiles.py:548-577): perimeter of two rings
// fused along one bond; empty on failure
static std::vector<int32_t> ck_envelope_cycle(
    const std::vector<int32_t>& r1, const std::vector<int32_t>& r2) {
    std::set<std::pair<int32_t, int32_t>> e1, sym;
    auto edges_of = [](const std::vector<int32_t>& ring,
                       std::set<std::pair<int32_t, int32_t>>& out) {
        for (size_t j = 0; j < ring.size(); ++j) {
            int32_t v = ring[j], w = ring[(j + 1) % ring.size()];
            out.insert({std::min(v, w), std::max(v, w)});
        }
    };
    edges_of(r1, e1);
    edges_of(r2, sym);
    for (const auto& e : e1) {
        auto it = sym.find(e);
        if (it != sym.end()) sym.erase(it);
        else sym.insert(e);
    }
    std::map<int32_t, std::vector<int32_t>> adj;
    for (const auto& [v, w] : sym) {
        adj[v].push_back(w);
        adj[w].push_back(v);
    }
    for (const auto& [v, nb] : adj)
        if (nb.size() != 2) return {};
    if (adj.empty()) return {};
    const int32_t start = adj.begin()->first;
    std::vector<int32_t> cycle{start};
    int32_t prev = -1, cur = start;
    while (true) {
        const auto& nb = adj[cur];
        int32_t nxt = nb[0] != prev ? nb[0] : nb[1];
        if (nxt == start) break;
        cycle.push_back(nxt);
        prev = cur;
        cur = nxt;
        if (cycle.size() > adj.size()) return {};
    }
    return cycle.size() == adj.size() ? cycle : std::vector<int32_t>{};
}

// perceive_aromaticity port (smiles.py:491-545)
static int32_t ck_perceive_aromaticity(CkMol& M) {
    // exact SSSR via ck_sssr over the same CSR (identical rings to
    // Mol.smallest_rings; ring topology is order-independent of the
    // kekulized bond orders)
    int32_t n_comp = 0;
    {
        std::vector<uint8_t> seen((size_t)M.n, 0);
        std::vector<int32_t> stack;
        for (int32_t s = 0; s < M.n; ++s) {
            if (seen[(size_t)s]) continue;
            ++n_comp;
            seen[(size_t)s] = 1;
            stack.push_back(s);
            while (!stack.empty()) {
                int32_t v = stack.back();
                stack.pop_back();
                for (int32_t e = M.off[v]; e < M.off[v + 1]; ++e)
                    if (!seen[(size_t)M.nbr[e]]) {
                        seen[(size_t)M.nbr[e]] = 1;
                        stack.push_back(M.nbr[e]);
                    }
            }
        }
    }
    const int32_t target = M.m - M.n + n_comp;
    std::vector<std::vector<int32_t>> rings;
    if (target > 0) {
        std::vector<int32_t> bonds2((size_t)M.m * 2);
        for (int32_t bi = 0; bi < M.m; ++bi) {
            bonds2[(size_t)bi * 2] = M.bonds[(size_t)bi].a1;
            bonds2[(size_t)bi * 2 + 1] = M.bonds[(size_t)bi].a2;
        }
        const int32_t cap = std::max(target * M.n, 1);
        std::vector<int32_t> out_atoms((size_t)cap);
        std::vector<int32_t> out_off((size_t)target + 1);
        int32_t n_rings = 0;
        int32_t rc = ck_sssr(M.n, M.m, bonds2.data(), M.off, M.nbr, M.bidx,
                             target, out_atoms.data(), cap, out_off.data(),
                             target, &n_rings);
        if (rc != 0) return -1;  // caller falls back to Python
        for (int32_t k = 0; k < n_rings; ++k) {
            const size_t a = (size_t)out_off[k], b = (size_t)out_off[k + 1];
            if (b - a >= 5 && b - a <= 7)
                rings.emplace_back(out_atoms.begin() + a,
                                   out_atoms.begin() + b);
        }
    }
    if (rings.empty()) return 0;

    std::vector<uint8_t> in_ring_flags((size_t)M.n, 0);
    {
        std::vector<uint8_t> is_bridge((size_t)M.m, 0);
        compute_bridges(M.n, M.off, M.nbr, M.bidx, is_bridge);
        for (int32_t bi = 0; bi < M.m; ++bi)
            if (!is_bridge[(size_t)bi]) {
                in_ring_flags[(size_t)M.bonds[(size_t)bi].a1] = 1;
                in_ring_flags[(size_t)M.bonds[(size_t)bi].a2] = 1;
            }
    }

    std::vector<uint8_t> scratch((size_t)M.n, 0);
    std::vector<std::vector<int32_t>> winners;
    for (const auto& r : rings)
        if (ck_ring_is_aromatic(M, r, scratch, in_ring_flags))
            winners.push_back(r);

    // fused-pair envelopes (azulene-type nonalternants)
    std::vector<uint8_t> won_atoms((size_t)M.n, 0);
    for (const auto& r : winners)
        for (int32_t v : r) won_atoms[(size_t)v] = 1;
    std::vector<std::pair<int32_t, int32_t>> envelope_bonds;
    for (size_t i = 0; i < rings.size(); ++i) {
        for (size_t j = i + 1; j < rings.size(); ++j) {
            bool ri_won = true, rj_won = true;
            for (int32_t v : rings[i])
                if (!won_atoms[(size_t)v]) { ri_won = false; break; }
            for (int32_t v : rings[j])
                if (!won_atoms[(size_t)v]) { rj_won = false; break; }
            if (ri_won && rj_won) continue;
            std::set<int32_t> ri(rings[i].begin(), rings[i].end());
            std::vector<int32_t> shared;
            for (int32_t v : rings[j])
                if (ri.count(v)) shared.push_back(v);
            if (shared.size() != 2) continue;
            std::sort(shared.begin(), shared.end());
            if (M.bond_between(shared[0], shared[1]) < 0) continue;
            auto env = ck_envelope_cycle(rings[i], rings[j]);
            if (env.empty()) continue;
            if (ck_ring_is_aromatic(M, env, scratch, in_ring_flags)) {
                winners.push_back(env);
                for (const auto& ring : {rings[i], rings[j]})
                    for (size_t k = 0; k < ring.size(); ++k)
                        envelope_bonds.emplace_back(
                            ring[k], ring[(k + 1) % ring.size()]);
            }
        }
    }

    // snapshot for the re-kekulization guard below
    const std::vector<CkAtom> saved_atoms = M.atoms;
    const std::vector<CkBond> saved_bonds = M.bonds;

    // pin non-carbon aromatic H counts BEFORE any flag flips (aromatic
    // bonds contribute 1.5 to bos): the pyrrole-type H is structural —
    // without pinning, the written aromatic form drops it and re-parse
    // kekulization fails or shifts (perceive_aromaticity pin, smiles.py)
    for (const auto& ring : winners)
        for (int32_t v : ring) {
            CkAtom& a = M.atoms[(size_t)v];
            if ((a.z == 7 || a.z == 15) && a.ehs < 0)
                a.ehs = ck_implicit_hs(M, v, false);
        }

    for (const auto& ring : winners) {
        for (int32_t v : ring) M.atoms[(size_t)v].aromatic = 1;
        for (size_t j = 0; j < ring.size(); ++j) {
            int32_t bi = M.bond_between(ring[j],
                                        ring[(j + 1) % ring.size()]);
            if (bi >= 0) M.bonds[(size_t)bi].aromatic = 1;
        }
    }
    for (const auto& [v, w] : envelope_bonds) {
        int32_t bi = M.bond_between(v, w);
        if (bi >= 0) M.bonds[(size_t)bi].aromatic = 1;
    }

    // re-kekulization guard (perceive_aromaticity guard, smiles.py):
    // the aromatic spelling is only legal if the parser's donor rules
    // can kekulize it back; roll back to the kekulé form otherwise
    if (!winners.empty()) {
        CkMol trial = M;   // vectors deep-copy; CSR pointers shared r/o
        if (!ck_kekulize(trial)) {
            M.atoms = saved_atoms;
            M.bonds = saved_bonds;
        }
    }
    return 0;
}

// element symbols (chem/periodic.py SYMBOLS; index = atomic number)
static const char* CK_SYMBOLS[] = {
    "*",
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu",
};
static const int32_t CK_N_SYMBOLS = (int32_t)(sizeof(CK_SYMBOLS) /
                                              sizeof(CK_SYMBOLS[0]));

static bool ck_is_organic_write(int32_t z) {
    // _ORGANIC_WRITE = {B, C, N, O, P, S, F, Cl, Br, I, *}
    switch (z) {
        case 0: case 5: case 6: case 7: case 8: case 9:
        case 15: case 16: case 17: case 35: case 53:
            return true;
        default:
            return false;
    }
}

// implicit-H / lone-pair sentinel in neighbor orderings (chem/mol.py
// H_SLOT); any negative value distinct from atom indices works — parity
// only compares by equality
static const int32_t CK_H_SLOT = -2;

// perm_parity port (chem/mol.py:48-58): 0 when b is an even permutation
// of a, 1 when odd (equality-based element lookup, like the Python)
static int32_t ck_perm_parity(std::vector<int32_t> a,
                              const std::vector<int32_t>& b) {
    int32_t parity = 0;
    for (size_t i = 0; i < a.size(); ++i) {
        if (a[i] == b[i]) continue;
        size_t j = i + 1;
        while (j < a.size() && a[j] != b[i]) ++j;
        std::swap(a[i], a[j]);
        parity ^= 1;
    }
    return parity;
}

// normalize_written_parity port (chem/mol.py:27-45)
static int32_t ck_normalize_written_parity(std::vector<int32_t> written,
                                           bool had_prev, int32_t parity) {
    std::vector<int32_t> explicit_n;
    bool has_sentinel = false;
    for (int32_t e : written) {
        if (e == CK_H_SLOT) has_sentinel = true;
        else explicit_n.push_back(e);
    }
    if (explicit_n.size() == 3 && !has_sentinel) {
        written.insert(written.begin() + (had_prev ? 1 : 0), CK_H_SLOT);
        has_sentinel = true;
    }
    if (written.size() != 4 ||
        (explicit_n.size() != 3 && explicit_n.size() != 4))
        return 0;
    std::sort(explicit_n.begin(), explicit_n.end());
    std::vector<int32_t> internal;
    if (has_sentinel) internal.push_back(CK_H_SLOT);
    internal.insert(internal.end(), explicit_n.begin(), explicit_n.end());
    if (ck_perm_parity(written, internal))
        return parity == 1 ? 2 : 1;
    return parity;
}

// _solve_bond_directions port (smiles.py:994-1094): assign / \ marks
// (+1 = '/' read a1 -> a2) over a minimal set of flanking single bonds,
// plus the constraint-component id of each, solved by 2-coloring.
static void ck_solve_bond_directions(const CkMol& M,
                                     std::map<int32_t, int32_t>& dirmap,
                                     std::map<int32_t, int32_t>& dircomp) {
    struct SBond { int32_t bi, bx, by; };
    std::vector<SBond> stereo;
    for (int32_t bi = 0; bi < M.m; ++bi) {
        const CkBond& b = M.bonds[(size_t)bi];
        if (b.order != 2 || b.aromatic || b.stereo == 0 || b.sx < 0 ||
            b.sy < 0)
            continue;
        const int32_t bx = M.bond_between(b.a1, b.sx);
        const int32_t by = M.bond_between(b.a2, b.sy);
        if (bx < 0 || by < 0) continue;
        if (M.bonds[(size_t)bx].order != 1 || M.bonds[(size_t)by].order != 1)
            continue;
        if (M.bonds[(size_t)bx].aromatic || M.bonds[(size_t)by].aromatic)
            continue;
        stereo.push_back({bi, bx, by});
    }
    if (stereo.empty()) return;

    std::set<int32_t> needed;
    struct Chosen { int32_t bi, cx, cy; };
    std::vector<Chosen> chosen;
    auto pick = [&](int32_t end, int32_t exclude, int32_t pref) {
        for (int32_t e = M.off[end]; e < M.off[end + 1]; ++e) {
            const int32_t w = M.nbr[e], ci = M.bidx[e];
            if (w == exclude) continue;
            const CkBond& cb = M.bonds[(size_t)ci];
            if (cb.order != 1 || cb.aromatic) continue;
            if (needed.count(ci)) return ci;
        }
        return pref;
    };
    for (const SBond& s : stereo) {
        const CkBond& b = M.bonds[(size_t)s.bi];
        const int32_t cx = pick(b.a1, b.a2, s.bx);
        const int32_t cy = pick(b.a2, b.a1, s.by);
        needed.insert(cx);
        needed.insert(cy);
        chosen.push_back({s.bi, cx, cy});
    }

    std::map<int32_t, std::vector<std::pair<int32_t, int32_t>>> relations;
    for (int32_t bi : needed) relations[bi];
    auto other = [&](int32_t bi, int32_t v) {
        const CkBond& b = M.bonds[(size_t)bi];
        return b.a1 == v ? b.a2 : b.a1;
    };
    auto sense = [&](int32_t bond_idx, int32_t frm, int32_t to) {
        const CkBond& bb = M.bonds[(size_t)bond_idx];
        return (bb.a1 == frm && bb.a2 == to) ? 1 : -1;
    };
    for (const Chosen& ch : chosen) {
        const CkBond& b = M.bonds[(size_t)ch.bi];
        const int32_t x = b.sx, y = b.sy;
        const int32_t xp = other(ch.cx, b.a1);
        const int32_t yp = other(ch.cy, b.a2);
        int32_t base = b.stereo == 2 ? 1 : -1;  // trans = +1
        if (xp != x) base = -base;
        if (yp != y) base = -base;
        const int32_t s1 = sense(ch.cx, xp, b.a1);
        const int32_t s2 = sense(ch.cy, b.a2, yp);
        const int32_t sign = base * s1 * s2;
        relations[ch.cx].emplace_back(ch.cy, sign);
        relations[ch.cy].emplace_back(ch.cx, sign);
        const int32_t ends[2] = {b.a1, b.a2};
        for (int32_t end : ends) {
            std::vector<int32_t> at_end;
            for (int32_t e = M.off[end]; e < M.off[end + 1]; ++e) {
                const int32_t ci = M.bidx[e];
                if (needed.count(ci) && M.bonds[(size_t)ci].order == 1)
                    at_end.push_back(ci);
            }
            for (size_t i = 0; i < at_end.size(); ++i)
                for (size_t j = i + 1; j < at_end.size(); ++j) {
                    const int32_t c1 = at_end[i], c2 = at_end[j];
                    const int32_t t1 = sense(c1, other(c1, end), end);
                    const int32_t t2 = sense(c2, other(c2, end), end);
                    const int32_t sg = -t1 * t2;
                    relations[c1].emplace_back(c2, sg);
                    relations[c2].emplace_back(c1, sg);
                }
        }
    }

    for (int32_t root : needed) {  // std::set iterates ascending = sorted
        if (dirmap.count(root)) continue;
        std::map<int32_t, int32_t> comp;
        comp[root] = 1;
        std::vector<int32_t> queue{root};
        bool ok = true;
        while (!queue.empty()) {
            const int32_t u = queue.back();
            queue.pop_back();
            for (const auto& [v, sign] : relations[u]) {
                const int32_t want = comp[u] * sign;
                auto it = comp.find(v);
                if (it != comp.end()) {
                    if (it->second != want) ok = false;
                } else {
                    comp[v] = want;
                    queue.push_back(v);
                }
            }
        }
        if (ok)
            for (const auto& [bi, d] : comp) {
                dirmap[bi] = d;
                dircomp[bi] = root;
            }
    }
}

// _atom_token port (smiles.py:729-767)
static void ck_atom_token(const CkMol& M, int32_t idx, std::string& out,
                          const std::string& chiral = std::string()) {
    const CkAtom& a = M.atoms[(size_t)idx];
    const char* sym = (a.z >= 0 && a.z < CK_N_SYMBOLS) ? CK_SYMBOLS[a.z]
                                                       : "?";
    std::string lower(sym);
    if (a.aromatic)
        for (char& c : lower) c = (char)std::tolower((unsigned char)c);
    bool hs_differ = false;
    if (a.ehs >= 0)
        hs_differ = ck_implicit_hs(M, idx, true) != a.ehs;
    const bool needs_bracket = !chiral.empty() ||
                               !ck_is_organic_write(a.z) || a.charge != 0 ||
                               a.isotope != 0 || a.map != 0 || hs_differ;
    if (a.z == 0 && a.charge == 0 && a.isotope == 0 && a.map == 0) {
        out += '*';
        return;
    }
    if (!needs_bracket) {
        out += lower;
        return;
    }
    out += '[';
    if (a.isotope) out += std::to_string(a.isotope);
    out += lower;
    out += chiral;
    const int32_t hs = a.ehs >= 0 ? a.ehs : ck_implicit_hs(M, idx, false);
    if (hs == 1) out += 'H';
    else if (hs > 1) { out += 'H'; out += std::to_string(hs); }
    if (a.charge == 1) out += '+';
    else if (a.charge == -1) out += '-';
    else if (a.charge > 1) { out += '+'; out += std::to_string(a.charge); }
    else if (a.charge < -1) { out += '-'; out += std::to_string(-a.charge); }
    if (a.map) { out += ':'; out += std::to_string(a.map); }
    out += ']';
}

// _bond_token port (smiles.py:780-786)
static void ck_bond_token(const CkBond& b, bool a1_arom, bool a2_arom,
                          std::string& out) {
    if (b.aromatic) return;
    if (b.order == 1) {
        if (a1_arom && a2_arom) out += '-';
        return;
    }
    out += b.order == 2 ? '=' : '#';
}

static void ck_closure_digit(int32_t num, std::string& out) {
    if (num < 10) { out += (char)('0' + num); return; }
    out += '%';  // f"%{num:02d}": two digits, or all digits when >= 100
    if (num < 100) {
        out += (char)('0' + num / 10);
        out += (char)('0' + num % 10);
    } else {
        out += std::to_string(num);
    }
}

// _generate_smiles + _write_component port (smiles.py:1179-1337) incl.
// directional-bond placeholders (resolved inline: emission order here
// IS the Python token order, so fixing each constraint component's
// free flip at its first-emitted mark matches the Python post-pass)
// and tetrahedral chiral_char
static void ck_write_smiles(const CkMol& M, const std::vector<int32_t>& ranks,
                            std::string& out) {
    const int32_t n = M.n;
    std::vector<uint8_t> visited((size_t)n, 0);
    int32_t ring_counter = 0;
    std::vector<int32_t> free_numbers;

    std::map<int32_t, int32_t> dirmap, dircomp;
    ck_solve_bond_directions(M, dirmap, dircomp);
    std::map<int32_t, int32_t> flip;  // component id -> first raw d
    auto emit_dir = [&](int32_t bi, int32_t frm, int32_t to) {
        int32_t d = dirmap[bi];
        const CkBond& bb = M.bonds[(size_t)bi];
        if (!(bb.a1 == frm && bb.a2 == to)) d = -d;
        auto it = flip.find(dircomp[bi]);
        if (it == flip.end()) {
            flip[dircomp[bi]] = d;
            out += '/';
        } else {
            out += (d * it->second == 1) ? '/' : '\\';
        }
    };

    // fragments(): components keyed by smallest start index, each
    // sorted; then ordered by min rank (ranks are a permutation)
    std::vector<std::vector<int32_t>> comps;
    {
        std::vector<uint8_t> seen((size_t)n, 0);
        std::vector<int32_t> stack;
        for (int32_t s = 0; s < n; ++s) {
            if (seen[(size_t)s]) continue;
            std::vector<int32_t> comp;
            seen[(size_t)s] = 1;
            stack.push_back(s);
            while (!stack.empty()) {
                int32_t v = stack.back();
                stack.pop_back();
                comp.push_back(v);
                for (int32_t e = M.off[v]; e < M.off[v + 1]; ++e)
                    if (!seen[(size_t)M.nbr[e]]) {
                        seen[(size_t)M.nbr[e]] = 1;
                        stack.push_back(M.nbr[e]);
                    }
            }
            std::sort(comp.begin(), comp.end());
            comps.push_back(std::move(comp));
        }
        std::stable_sort(comps.begin(), comps.end(),
                         [&](const std::vector<int32_t>& a,
                             const std::vector<int32_t>& b) {
                             auto mn = [&](const std::vector<int32_t>& c) {
                                 int32_t m = ranks[(size_t)c[0]];
                                 for (int32_t v : c)
                                     m = std::min(m, ranks[(size_t)v]);
                                 return m;
                             };
                             return mn(a) < mn(b);
                         });
    }

    std::vector<int32_t> parent_bond((size_t)n, -1);
    std::vector<std::vector<int32_t>> children((size_t)n);
    std::vector<std::vector<std::pair<int32_t, int32_t>>> closures((size_t)n);
    std::vector<int32_t> order_of((size_t)n, 0);
    std::vector<uint8_t> seen_bonds((size_t)M.m, 0);

    auto nbrs_sorted = [&](int32_t v) {
        std::vector<std::pair<int32_t, int32_t>> nb;  // (w, bidx)
        nb.reserve((size_t)M.degree(v));
        for (int32_t e = M.off[v]; e < M.off[v + 1]; ++e)
            nb.emplace_back(M.nbr[e], M.bidx[e]);
        std::sort(nb.begin(), nb.end(),
                  [&](const auto& a, const auto& b) {
                      return ranks[(size_t)a.first] < ranks[(size_t)b.first];
                  });
        return nb;
    };

    bool first_comp = true;
    for (const auto& comp : comps) {
        if (!first_comp) out += '.';
        first_comp = false;
        int32_t root = comp[0];
        for (int32_t v : comp)
            if (ranks[(size_t)v] < ranks[(size_t)root]) root = v;

        // first pass: tree edges + ring-closure edges via iterative DFS
        parent_bond[(size_t)root] = -1;
        visited[(size_t)root] = 1;
        order_of[(size_t)root] = 0;
        int32_t counter = 1;
        struct Frame {
            int32_t v;
            std::vector<std::pair<int32_t, int32_t>> nb;
            size_t cursor;
        };
        std::vector<Frame> it_stack;
        it_stack.push_back({root, nbrs_sorted(root), 0});
        while (!it_stack.empty()) {
            Frame& top = it_stack.back();
            bool advanced = false;
            while (top.cursor < top.nb.size()) {
                auto [w, bi] = top.nb[top.cursor++];
                if (seen_bonds[(size_t)bi]) continue;
                if (!visited[(size_t)w]) {
                    visited[(size_t)w] = 1;
                    seen_bonds[(size_t)bi] = 1;
                    parent_bond[(size_t)w] = bi;
                    children[(size_t)top.v].push_back(w);
                    order_of[(size_t)w] = counter++;
                    int32_t v2 = w;
                    it_stack.push_back({v2, nbrs_sorted(v2), 0});
                    advanced = true;
                    break;
                } else {
                    seen_bonds[(size_t)bi] = 1;
                    closures[(size_t)top.v].emplace_back(w, bi);
                }
            }
            if (!advanced) it_stack.pop_back();
        }

        // mirror closures onto both endpoints (each closure edge is
        // recorded once, on the atom that encountered it second)
        for (int32_t v : comp)
            for (const auto& [w, bi] : std::vector<std::pair<int32_t, int32_t>>(
                     closures[(size_t)v])) {
                bool present = false;
                for (const auto& [x, xb] : closures[(size_t)w])
                    if (x == v && xb == bi) { present = true; break; }
                if (!present) closures[(size_t)w].emplace_back(v, bi);
            }

        std::map<std::pair<int32_t, int32_t>, int32_t> closure_num;

        std::function<void(int32_t)> emit = [&](int32_t v) {
            const bool a_ar = M.atoms[(size_t)v].aromatic != 0;
            auto cls = closures[(size_t)v];
            std::sort(cls.begin(), cls.end(),
                      [&](const auto& a, const auto& b) {
                          return order_of[(size_t)a.first] <
                                 order_of[(size_t)b.first];
                      });
            // chiral_char port (smiles.py:1266-1290): parity against the
            // emitted neighbor order [parent?, H?, closures, children]
            std::string chiral;
            if (M.atoms[(size_t)v].parity != 0) {
                std::vector<int32_t> emitted;
                const int32_t pb = parent_bond[(size_t)v];
                if (pb >= 0) {
                    const CkBond& b = M.bonds[(size_t)pb];
                    emitted.push_back(b.a1 == v ? b.a2 : b.a1);
                }
                const bool sentinel = M.degree(v) == 3;
                if (sentinel) emitted.push_back(CK_H_SLOT);
                for (const auto& [w, bi] : cls) {
                    (void)bi;
                    emitted.push_back(w);
                }
                for (int32_t w : children[(size_t)v]) emitted.push_back(w);
                if (emitted.size() == 4) {
                    std::vector<int32_t> internal;
                    if (sentinel) internal.push_back(CK_H_SLOT);
                    std::vector<int32_t> nbs;
                    for (int32_t e = M.off[v]; e < M.off[v + 1]; ++e)
                        nbs.push_back(M.nbr[e]);
                    std::sort(nbs.begin(), nbs.end());
                    internal.insert(internal.end(), nbs.begin(), nbs.end());
                    int32_t eff = M.atoms[(size_t)v].parity;
                    if (ck_perm_parity(internal, emitted))
                        eff = eff == 1 ? 2 : 1;
                    chiral = eff == 1 ? "@" : "@@";
                }
            }
            ck_atom_token(M, v, out, chiral);
            for (const auto& [w, bi] : cls) {
                const std::pair<int32_t, int32_t> key{std::min(v, w),
                                                      std::max(v, w)};
                auto it = closure_num.find(key);
                if (it != closure_num.end()) {
                    const int32_t num = it->second;
                    closure_num.erase(it);
                    free_numbers.push_back(num);
                    ck_bond_token(M.bonds[(size_t)bi], a_ar,
                                  M.atoms[(size_t)w].aromatic != 0, out);
                    ck_closure_digit(num, out);
                } else {
                    int32_t num;
                    if (!free_numbers.empty()) {
                        auto mn = std::min_element(free_numbers.begin(),
                                                   free_numbers.end());
                        num = *mn;
                        free_numbers.erase(mn);
                    } else {
                        num = ++ring_counter;
                    }
                    closure_num[key] = num;
                    if (dirmap.count(bi)) {
                        emit_dir(bi, v, w);
                    } else {
                        ck_bond_token(M.bonds[(size_t)bi], a_ar,
                                      M.atoms[(size_t)w].aromatic != 0, out);
                    }
                    ck_closure_digit(num, out);
                }
            }
            const auto& kids = children[(size_t)v];
            for (size_t j = 0; j < kids.size(); ++j) {
                const int32_t w = kids[j];
                const int32_t bi = parent_bond[(size_t)w];
                const bool last = j + 1 == kids.size();
                if (!last) out += '(';
                if (dirmap.count(bi)) {
                    emit_dir(bi, v, w);
                } else {
                    ck_bond_token(M.bonds[(size_t)bi], a_ar,
                                  M.atoms[(size_t)w].aromatic != 0, out);
                }
                emit(w);
                if (!last) out += ')';
            }
        };
        emit(root);
    }
}

// _enumerate_rankings port (smiles.py:1077-1124): all complete
// tie-broken rankings reachable by promoting each member of the minimal
// tied class at every level, capped at `budget` leaves (same truncation
// order: picks ascend by atom index)
static void ck_enumerate_rankings(
    int32_t n, const std::vector<std::vector<int64_t>>& keys,
    const std::vector<std::vector<std::pair<int32_t, int32_t>>>& adj,
    std::vector<std::vector<int32_t>>& results, size_t budget = 64) {
    std::vector<int32_t> start((size_t)n);
    {
        std::vector<std::vector<int64_t>> k = keys;
        ranks_from_keys(k, start);
        refine(n, adj, start);
    }
    std::function<void(const std::vector<int32_t>&)> rec =
        [&](const std::vector<int32_t>& ranks) {
            if (results.size() >= budget) return;
            std::map<int32_t, int32_t> counts;
            for (int32_t r : ranks) counts[r]++;
            int32_t target = -1;
            for (const auto& [r, c] : counts)
                if (c > 1) { target = r; break; }
            if (target < 0) {
                results.push_back(ranks);
                return;
            }
            for (int32_t pick = 0; pick < n; ++pick) {
                if (ranks[(size_t)pick] != target) continue;
                std::vector<std::vector<int64_t>> tb((size_t)n);
                for (int32_t i = 0; i < n; ++i)
                    tb[(size_t)i] = {ranks[(size_t)i], i == pick ? 0 : 1};
                std::vector<int32_t> r2((size_t)n);
                ranks_from_keys(tb, r2);
                refine(n, adj, r2);
                rec(r2);
                if (results.size() >= budget) return;
            }
        };
    rec(start);
}

// canonical_ranks invariants (smiles.py:678-684) + writer, on the
// post-sanitize state — shared by ck_canonicalize and ck_parse_smiles.
// Stereo-bearing molecules take the mol_to_smiles stereo path
// (smiles.py:1156-1177): min string over all automorphic tie-breaks.
static void ck_rank_and_write(const CkMol& M, std::string& s) {
    const int32_t n_atoms = M.n, n_bonds = M.m;
    std::vector<std::vector<int64_t>> keys((size_t)n_atoms);
    std::vector<std::vector<std::pair<int32_t, int32_t>>> radj(
        (size_t)n_atoms);
    for (int32_t bi = 0; bi < n_bonds; ++bi) {
        const CkBond& b = M.bonds[(size_t)bi];
        const int32_t o2 = b.aromatic ? 3 : 2 * b.order;
        radj[(size_t)b.a1].emplace_back(b.a2, o2);
        radj[(size_t)b.a2].emplace_back(b.a1, o2);
    }
    for (int32_t i = 0; i < n_atoms; ++i) {
        const CkAtom& a = M.atoms[(size_t)i];
        keys[(size_t)i] = {a.z, a.charge, a.isotope, a.aromatic,
                           M.degree(i), ck_implicit_hs(M, i, false),
                           M.bos2(i)};
    }
    bool has_stereo = false;
    for (const CkAtom& a : M.atoms)
        if (a.parity) { has_stereo = true; break; }
    if (!has_stereo)
        for (const CkBond& b : M.bonds)
            if (b.stereo) { has_stereo = true; break; }
    if (!has_stereo) {
        std::vector<int32_t> ranks((size_t)n_atoms);
        canonical_rank_core(n_atoms, keys, radj, ranks);
        ck_write_smiles(M, ranks, s);
        return;
    }
    std::vector<std::vector<int32_t>> rankings;
    ck_enumerate_rankings(n_atoms, keys, radj, rankings);
    if (rankings.empty()) {
        std::vector<int32_t> ranks((size_t)n_atoms);
        canonical_rank_core(n_atoms, keys, radj, ranks);
        rankings.push_back(ranks);
    }
    bool first = true;
    for (const auto& ranks : rankings) {
        std::string cand;
        ck_write_smiles(M, ranks, cand);
        if (first || cand < s) s = cand;
        first = false;
    }
}

}  // namespace

int32_t ck_canonicalize(
    int32_t n_atoms, const int32_t* atoms,
    int32_t n_bonds, const int32_t* bonds,
    const int32_t* adj_off, const int32_t* adj_nbr, const int32_t* adj_bidx,
    int32_t do_sanitize, int32_t do_write,
    int32_t* out_atom_arom, int32_t* out_bonds,
    char* out_smiles, int32_t out_cap,
    int32_t* err_info) {
    if (n_atoms <= 0 || n_bonds < 0) return -1;
    CkMol M;
    M.n = n_atoms;
    M.m = n_bonds;
    M.off = adj_off;
    M.nbr = adj_nbr;
    M.bidx = adj_bidx;
    M.atoms.resize((size_t)n_atoms);
    for (int32_t i = 0; i < n_atoms; ++i) {
        const int32_t* a = atoms + (size_t)i * 7;
        M.atoms[(size_t)i] = {a[0], a[1], a[2], a[3], a[4], a[5], a[6]};
    }
    M.bonds.resize((size_t)n_bonds);
    for (int32_t bi = 0; bi < n_bonds; ++bi) {
        const int32_t* b = bonds + (size_t)bi * 7;
        if (b[0] < 0 || b[1] < 0 || b[0] >= n_atoms || b[1] >= n_atoms)
            return -1;
        M.bonds[(size_t)bi] = {b[0], b[1], b[2], b[3], b[4], b[5], b[6]};
    }

    if (do_sanitize) {
        if (!ck_aromatic_bonds_consistent(M)) return -1;
        if (!ck_kekulize(M)) return 1;
        if (!ck_valence_ok(M, &err_info[0], &err_info[1])) return 2;
        if (ck_perceive_aromaticity(M) != 0) return -1;
        // sanitize_mol stereo clearing (smiles.py:816-819): cis/trans
        // only survives on definite non-aromatic double bonds
        for (int32_t bi = 0; bi < n_bonds; ++bi) {
            CkBond& b = M.bonds[(size_t)bi];
            if (b.stereo && (b.aromatic || b.order != 2)) {
                b.stereo = 0;
                b.sx = b.sy = -1;
            }
        }
        for (int32_t i = 0; i < n_atoms; ++i)
            // bit 0: aromatic flag; upper bits: ehs+1 (0 = None) — the
            // perception pin of non-carbon aromatic H counts must flow
            // back to the caller's mol or the Python writer drops [nH]
            out_atom_arom[i] =
                (M.atoms[(size_t)i].aromatic ? 1 : 0) |
                ((M.atoms[(size_t)i].ehs + 1) << 1);
        for (int32_t bi = 0; bi < n_bonds; ++bi) {
            out_bonds[(size_t)bi * 2] = M.bonds[(size_t)bi].order;
            out_bonds[(size_t)bi * 2 + 1] = M.bonds[(size_t)bi].aromatic;
        }
    }

    if (do_write) {
        std::string s;
        ck_rank_and_write(M, s);
        if ((int32_t)s.size() + 1 > out_cap) return 3;
        std::memcpy(out_smiles, s.c_str(), s.size() + 1);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ck_parse_smiles — fused SMILES parse (+ optional sanitize + canonical
// write) in one native call.
//
// Exact port of the STEREO-FREE path of chem/smiles.py parse_smiles
// (_parse_smiles_inner + _parse_bracket_atom + _add_parsed_bond,
// smiles.py:57-314). Any stereo construct (@ in brackets, / or \ bond
// directions) returns CK_PARSE_UNSUPPORTED and the ctypes wrapper falls
// back to the Python parser, which stays the reference implementation
// and the error-message authority (on CK_PARSE_ERROR the wrapper also
// re-parses in Python so the exact SmilesError text is raised).
//
// Combined with do_sanitize/do_write this makes canonical_smiles() a
// single string -> string native call — the per-molecule entry point of
// every ingest boundary (inventory recanonicalization, MolQA records,
// planner is_known) and of _parsed_product in the retro expansion loop.
// The reference gets the same fusion from RDKit's C++ MolFromSmiles +
// MolToSmiles (molecule_utils.py:221-246).
//
// Outputs (when out_atoms/out_bonds non-null): post-sanitize atom rows
// (z, charge, isotope, explicit_hs(-1 = None), aromatic, atom_map) and
// bond rows (a1, a2, order, aromatic) in creation order — the same
// order the Python parser would produce, so a Mol rebuilt from them has
// identical _adj insertion order.
// Returns 0 ok; 1 kekulize; 2 valence (err_info = atom, 2x valence);
// 3 out_smiles too small; 4 parse error; 5 unsupported (stereo);
// -1 caps exceeded.
// ---------------------------------------------------------------------------

namespace {

struct PAtom { int32_t z, charge, isotope, ehs, aromatic, map, parity; };

static int32_t ck_sym_to_z(const char* s, int len) {
    for (int32_t z = 0; z < CK_N_SYMBOLS; ++z) {
        const char* t = CK_SYMBOLS[z];
        int tl = 0;
        while (t[tl]) ++tl;
        if (tl == len && std::strncmp(t, s, (size_t)len) == 0) return z;
    }
    return -1;
}

// AROMATIC_SYMBOLS (periodic.py): {b, c, n, o, p, s, se, as, te}
static bool ck_arom_sym1(char c) {
    return c == 'b' || c == 'c' || c == 'n' || c == 'o' || c == 'p' ||
           c == 's';
}
static bool ck_arom_sym2(char a, char b) {
    return (a == 's' && b == 'e') || (a == 'a' && b == 's') ||
           (a == 't' && b == 'e');
}

static inline bool ck_isdig(char c) { return c >= '0' && c <= '9'; }

// digit accumulation cap: Python parses arbitrary-precision ints, so any
// value that could overflow int32 must fall back to the Python parser
// (returning parse-fallback code 4), never silently wrap
static const int32_t CK_DIGIT_CAP = 100000000;

// _parse_bracket_atom port (smiles.py:57-149); tok = inside of [...]
static int ck_parse_bracket(const char* tok, int n, PAtom* out) {
    int i = 0;
    int32_t isotope = 0;
    while (i < n && ck_isdig(tok[i])) {
        if (isotope > CK_DIGIT_CAP) return 4;
        isotope = isotope * 10 + (tok[i] - '0');
        ++i;
    }
    int32_t aromatic = 0, z = -1;
    if (i < n) {
        const char c = tok[i];
        if (c == '*') {
            z = 0;
            ++i;
        } else if (c >= 'A' && c <= 'Z') {
            if (i + 1 < n && tok[i + 1] >= 'a' && tok[i + 1] <= 'z') {
                z = ck_sym_to_z(tok + i, 2);
                if (z >= 0) {
                    i += 2;
                } else {
                    z = ck_sym_to_z(tok + i, 1);
                    ++i;
                }
            } else {
                z = ck_sym_to_z(tok + i, 1);
                ++i;
            }
        } else if (c >= 'a' && c <= 'z') {
            if (i + 1 < n && ck_arom_sym2(c, tok[i + 1])) {
                char cap[3] = {(char)(c - 'a' + 'A'), tok[i + 1], 0};
                z = ck_sym_to_z(cap, 2);
                i += 2;
                aromatic = 1;
            } else if (ck_arom_sym1(c)) {
                char cap[2] = {(char)(c - 'a' + 'A'), 0};
                z = ck_sym_to_z(cap, 1);
                ++i;
                aromatic = 1;
            }
        }
    }
    if (z < 0) return 4;
    int32_t hs = 0, charge = 0, amap = 0, parity = 0;
    while (i < n) {
        const char c = tok[i];
        if (c == '@') {
            // tetrahedral @ / @@ / @TH1 / @TH2 (smiles.py:98-130);
            // extended classes (@AL/@SP/@TB/@OH) -> Python path
            ++i;
            if (i < n && tok[i] == '@') {
                parity = 2;
                ++i;
            } else if (i + 3 <= n && tok[i] == 'T' && tok[i + 1] == 'H' &&
                       tok[i + 2] == '1') {
                parity = 1;
                i += 3;
            } else if (i + 3 <= n && tok[i] == 'T' && tok[i + 1] == 'H' &&
                       tok[i + 2] == '2') {
                parity = 2;
                i += 3;
            } else if (i + 2 <= n &&
                       ((tok[i] == 'A' && tok[i + 1] == 'L') ||
                        (tok[i] == 'S' && tok[i + 1] == 'P') ||
                        (tok[i] == 'T' && tok[i + 1] == 'B') ||
                        (tok[i] == 'O' && tok[i + 1] == 'H'))) {
                return 5;
            } else {
                parity = 1;  // bare '@'; a trailing 'TH3' etc. errors on
                             // the next loop pass, like the Python parser
            }
            continue;
        }
        if (c == 'H') {
            ++i;
            int32_t cnt = 0;
            while (i < n && ck_isdig(tok[i])) {
                if (cnt > CK_DIGIT_CAP) return 4;
                cnt = cnt * 10 + (tok[i] - '0');
                ++i;
            }
            hs = cnt > 0 ? cnt : 1;  // incl. the H0 -> 1 quirk (parity)
        } else if (c == '+' || c == '-') {
            const int32_t sign = c == '+' ? 1 : -1;
            ++i;
            if (i < n && ck_isdig(tok[i])) {
                int32_t mag = 0;
                while (i < n && ck_isdig(tok[i])) {
                    if (mag > CK_DIGIT_CAP) return 4;
                    mag = mag * 10 + (tok[i] - '0');
                    ++i;
                }
                charge += sign * mag;
            } else {
                charge += sign;
                while (i < n && tok[i] == c) {
                    charge += sign;
                    ++i;
                }
            }
        } else if (c == ':') {
            ++i;
            amap = 0;
            while (i < n && ck_isdig(tok[i])) {
                if (amap > CK_DIGIT_CAP) return 4;
                amap = amap * 10 + (tok[i] - '0');
                ++i;
            }
        } else {
            return 4;
        }
    }
    out->z = z;
    out->charge = charge;
    out->isotope = isotope;
    out->ehs = hs;  // bracket atoms always pin the H count
    out->aromatic = aromatic;
    out->map = amap;
    out->parity = parity;
    return 0;
}

// _parse_smiles_inner port (smiles.py:195-322) incl. tetrahedral
// chirality bookkeeping (worder / had_prev) and directional bonds
// (bond_dirs); extended stereo classes return 5 (Python path)
static int ck_parse_core(const char* text, int32_t len,
                         std::vector<PAtom>& atoms,
                         std::vector<CkBond>& bonds,
                         std::vector<std::vector<int32_t>>& adj,
                         std::map<int32_t, std::vector<int32_t>>& worder,
                         std::set<int32_t>& had_prev,
                         std::map<int32_t, std::pair<int32_t, char>>&
                             bond_dirs) {
    std::vector<int32_t> prev;
    prev.push_back(-1);  // -1 = None
    char pending = 0;
    // cell_pos: slot reserved in the opener's written order when the
    // opener is chiral (the ring partner counts at its digit position —
    // the worder "cell" of the Python parser, smiles.py:262-266)
    struct RingOpen { int32_t atom; char bond; int32_t cell_pos; };
    RingOpen ring[100];
    bool ring_used[100] = {false};
    static const int32_t CK_CELL_PENDING = INT32_MIN;

    auto add_bond = [&](int32_t a1, int32_t a2, char sym) -> int32_t {
        if (a1 == a2) return -4;  // self-bond
        for (int32_t w : adj[(size_t)a1])
            if (w == a2) return -4;  // duplicate bond
        int32_t order, arom;
        if (sym == ':') {
            order = 1;
            arom = 1;
        } else if (sym == 0) {
            order = 1;
            arom = atoms[(size_t)a1].aromatic && atoms[(size_t)a2].aromatic;
        } else {
            order = sym == '=' ? 2 : sym == '#' ? 3 : 1;
            arom = 0;
        }
        bonds.push_back({a1, a2, order, arom});
        adj[(size_t)a1].push_back(a2);
        adj[(size_t)a2].push_back(a1);
        return (int32_t)bonds.size() - 1;
    };

    int32_t i = 0;
    while (i < len) {
        const char c = text[i];
        if (c == ' ' || c == '\t') break;  // title may follow
        if (c == '(') {
            if (prev.back() < 0) return 4;  // branch w/o attachment atom
            prev.push_back(prev.back());
            ++i;
            continue;
        }
        if (c == ')') {
            if (prev.size() <= 1) return 4;  // unbalanced ')'
            prev.pop_back();
            ++i;
            continue;
        }
        if (c == '.') {
            prev.back() = -1;
            pending = 0;
            ++i;
            continue;
        }
        if (c == '-' || c == '=' || c == '#' || c == ':' || c == '/' ||
            c == '\\') {
            if (pending) return 4;  // two bond symbols in a row
            pending = c;
            ++i;
            continue;
        }
        if (ck_isdig(c) || c == '%') {
            int32_t num;
            if (c == '%') {
                if (i + 2 >= len || !ck_isdig(text[i + 1]) ||
                    !ck_isdig(text[i + 2]))
                    return 4;
                num = (text[i + 1] - '0') * 10 + (text[i + 2] - '0');
                i += 3;
            } else {
                num = c - '0';
                ++i;
            }
            const int32_t cur = prev.back();
            if (cur < 0) return 4;  // ring closure w/o current atom
            if (ring_used[num]) {
                ring_used[num] = false;
                const int32_t other = ring[num].atom;
                const char obond = ring[num].bond;
                const char sym = pending ? pending : obond;
                if (other == cur) return 4;  // closure to self
                const int32_t bidx = add_bond(other, cur, sym);
                if (bidx < 0) return -bidx;
                if (pending == '/' || pending == '\\')
                    bond_dirs[bidx] = {cur, pending};
                else if (obond == '/' || obond == '\\')
                    bond_dirs[bidx] = {other, obond};
                if (ring[num].cell_pos >= 0)
                    worder[other][(size_t)ring[num].cell_pos] = cur;
                auto wit = worder.find(cur);
                if (wit != worder.end()) wit->second.push_back(other);
            } else {
                ring_used[num] = true;
                int32_t cell_pos = -1;
                auto wit = worder.find(cur);
                if (wit != worder.end()) {
                    cell_pos = (int32_t)wit->second.size();
                    wit->second.push_back(CK_CELL_PENDING);
                }
                ring[num] = {cur, pending, cell_pos};
            }
            pending = 0;
            continue;
        }

        // atom
        PAtom a{};
        a.ehs = -1;
        if (c == '[') {
            int32_t j = -1;
            for (int32_t k = i + 1; k < len; ++k)
                if (text[k] == ']') { j = k; break; }
            if (j < 0) return 4;  // unclosed '['
            const int rc = ck_parse_bracket(text + i + 1, j - i - 1, &a);
            if (rc) return rc;
            i = j + 1;
        } else if (c == '*') {
            a.z = 0;
            ++i;
        } else if (i + 1 < len && ((c == 'C' && text[i + 1] == 'l') ||
                                   (c == 'B' && text[i + 1] == 'r'))) {
            a.z = c == 'C' ? 17 : 35;
            i += 2;
        } else if (c == 'B') { a.z = 5;  ++i; }
        else if (c == 'C') { a.z = 6;  ++i; }
        else if (c == 'N') { a.z = 7;  ++i; }
        else if (c == 'O') { a.z = 8;  ++i; }
        else if (c == 'P') { a.z = 15; ++i; }
        else if (c == 'S') { a.z = 16; ++i; }
        else if (c == 'F') { a.z = 9;  ++i; }
        else if (c == 'I') { a.z = 53; ++i; }
        else if (ck_arom_sym1(c)) {
            switch (c) {
                case 'b': a.z = 5;  break;
                case 'c': a.z = 6;  break;
                case 'n': a.z = 7;  break;
                case 'o': a.z = 8;  break;
                case 'p': a.z = 15; break;
                default:  a.z = 16; break;  // 's'
            }
            a.aromatic = 1;
            ++i;
        } else {
            return 4;  // unexpected character
        }

        atoms.push_back(a);
        adj.emplace_back();
        const int32_t idx = (int32_t)atoms.size() - 1;
        if (a.parity != 0) {
            std::vector<int32_t>& lst = worder[idx];
            if (prev.back() >= 0) {
                lst.push_back(prev.back());
                had_prev.insert(idx);
            }
            if (a.ehs == 1) lst.push_back(CK_H_SLOT);
        }
        if (prev.back() >= 0) {
            const int32_t bidx = add_bond(prev.back(), idx, pending);
            if (bidx < 0) return -bidx;
            if (pending == '/' || pending == '\\')
                bond_dirs[bidx] = {prev.back(), pending};
            auto wit = worder.find(prev.back());
            if (wit != worder.end()) wit->second.push_back(idx);
        }
        pending = 0;
        prev.back() = idx;
    }

    for (int k = 0; k < 100; ++k)
        if (ring_used[k]) return 4;  // unclosed ring bonds
    if (prev.size() != 1) return 4;  // unbalanced '('
    if (pending) return 4;           // dangling bond symbol
    if (atoms.empty()) return 4;     // no atoms
    return 0;
}

// _finalize_stereo port (smiles.py:359-422): as-written annotations ->
// intrinsic parity / cis-trans. Returns 0, or 5 when a bare @/@@ sits
// on a 2-/5-/6-coordinate center (extended-stereo shorthand — the
// Python path owns chem/extstereo.py).
static int ck_finalize_stereo(
    CkMol& M, const std::map<int32_t, std::vector<int32_t>>& worder,
    const std::set<int32_t>& had_prev,
    const std::map<int32_t, std::pair<int32_t, char>>& bond_dirs) {
    for (const auto& [idx, written] : worder) {
        const int32_t parity = M.atoms[(size_t)idx].parity;
        if (parity && (written.size() == 2 || written.size() == 5 ||
                       written.size() == 6))
            return 5;  // AL/TB/OH shorthand
        M.atoms[(size_t)idx].parity = ck_normalize_written_parity(
            written, had_prev.count(idx) > 0, parity);
    }
    if (bond_dirs.empty()) return 0;
    // normalized direction per directional bond: +1 = '/' read a1 -> a2
    std::map<int32_t, int32_t> ndir;
    for (const auto& [bidx, fa] : bond_dirs) {
        const CkBond& b = M.bonds[(size_t)bidx];
        int32_t d = fa.second == '/' ? 1 : -1;
        if (fa.first != b.a1) d = -d;
        ndir[bidx] = d;
    }
    auto dir_into = [&](int32_t end, int32_t nb) -> int32_t {  // 0 = None
        const int32_t bi = M.bond_between(end, nb);
        if (bi < 0) return 0;
        auto it = ndir.find(bi);
        if (it == ndir.end()) return 0;
        const CkBond& b = M.bonds[(size_t)bi];
        return (b.a1 == nb && b.a2 == end) ? it->second : -it->second;
    };
    for (int32_t bi = 0; bi < M.m; ++bi) {
        CkBond& b = M.bonds[(size_t)bi];
        if (b.order != 2 || b.aromatic) continue;
        const int32_t u = b.a1, v = b.a2;
        std::vector<std::pair<int32_t, int32_t>> ux, vy;
        for (int32_t e = M.off[u]; e < M.off[u + 1]; ++e) {
            const int32_t x = M.nbr[e];
            if (x == v) continue;
            const int32_t d = dir_into(u, x);
            if (d) ux.emplace_back(x, d);
        }
        for (int32_t e = M.off[v]; e < M.off[v + 1]; ++e) {
            const int32_t y = M.nbr[e];
            if (y == u) continue;
            const int32_t d = dir_into(v, y);
            if (d) vy.emplace_back(y, d);
        }
        if (ux.empty() || vy.empty()) continue;
        // conflicting marks on one end (same side twice): drop, permissive
        if (ux.size() == 2 && ux[0].second == ux[1].second) continue;
        if (vy.size() == 2 && vy[0].second == vy[1].second) continue;
        const auto [x, dx] = ux[0];
        const auto [y, dyv] = vy[0];
        b.stereo = dx == -dyv ? 2 : 1;  // trans : cis
        b.sx = x;
        b.sy = y;
    }
    return 0;
}

}  // namespace

int32_t ck_parse_smiles(
    const char* text, int32_t len,
    int32_t do_sanitize, int32_t do_write,
    int32_t* out_atoms, int32_t cap_atoms,
    int32_t* out_bonds, int32_t cap_bonds,
    int32_t* out_counts,
    char* out_smiles, int32_t out_cap,
    int32_t* err_info) {
    if (len <= 0) return 4;  // empty SMILES
    std::vector<PAtom> patoms;
    std::vector<CkBond> pbonds;
    std::vector<std::vector<int32_t>> padj;
    std::map<int32_t, std::vector<int32_t>> worder;
    std::set<int32_t> had_prev;
    std::map<int32_t, std::pair<int32_t, char>> bond_dirs;
    const int prc = ck_parse_core(text, len, patoms, pbonds, padj, worder,
                                  had_prev, bond_dirs);
    if (prc) return prc;
    const int32_t n = (int32_t)patoms.size();
    const int32_t m = (int32_t)pbonds.size();

    // CSR adjacency in bond-creation order == Mol._adj insertion order
    std::vector<int32_t> off((size_t)n + 1, 0);
    std::vector<int32_t> nbr((size_t)(2 * m));
    std::vector<int32_t> bidx((size_t)(2 * m));
    {
        for (int32_t i = 0; i < n; ++i)
            off[(size_t)i + 1] = off[(size_t)i] + (int32_t)padj[(size_t)i].size();
        std::vector<int32_t> cur(off.begin(), off.end() - 1);
        for (int32_t bi = 0; bi < m; ++bi) {
            const CkBond& b = pbonds[(size_t)bi];
            nbr[(size_t)cur[(size_t)b.a1]] = b.a2;
            bidx[(size_t)cur[(size_t)b.a1]++] = bi;
            nbr[(size_t)cur[(size_t)b.a2]] = b.a1;
            bidx[(size_t)cur[(size_t)b.a2]++] = bi;
        }
    }
    CkMol M;
    M.n = n;
    M.m = m;
    M.off = off.data();
    M.nbr = nbr.data();
    M.bidx = bidx.data();
    M.atoms.resize((size_t)n);
    for (int32_t i = 0; i < n; ++i) {
        const PAtom& a = patoms[(size_t)i];
        M.atoms[(size_t)i] = {a.z, a.charge, a.isotope, a.ehs, a.aromatic,
                              a.map, a.parity};
    }
    M.bonds = std::move(pbonds);
    {
        const int frc = ck_finalize_stereo(M, worder, had_prev, bond_dirs);
        if (frc) return frc;
    }

    // arrays are also emitted on sanitize failure (kekulized-so-far
    // state) so the caller can raise the exact SmilesError without
    // re-parsing in Python — only atom identity (z) is read then
    auto emit_arrays = [&]() -> bool {
        if (out_counts) {
            out_counts[0] = n;
            out_counts[1] = m;
        }
        if (out_atoms == nullptr || cap_atoms <= 0) return true;
        if (n > cap_atoms || m > cap_bonds) return false;
        for (int32_t i = 0; i < n; ++i) {
            const CkAtom& a = M.atoms[(size_t)i];
            int32_t* row = out_atoms + (size_t)i * 7;
            row[0] = a.z;
            row[1] = a.charge;
            row[2] = a.isotope;
            row[3] = a.ehs;
            row[4] = a.aromatic;
            row[5] = a.map;
            row[6] = a.parity;
        }
        for (int32_t bi = 0; bi < m; ++bi) {
            const CkBond& b = M.bonds[(size_t)bi];
            int32_t* row = out_bonds + (size_t)bi * 7;
            row[0] = b.a1;
            row[1] = b.a2;
            row[2] = b.order;
            row[3] = b.aromatic;
            row[4] = b.stereo;
            row[5] = b.sx;
            row[6] = b.sy;
        }
        return true;
    };
    if (do_sanitize) {
        if (!ck_aromatic_bonds_consistent(M)) return 4;  // Python decides
        if (!ck_kekulize(M)) { emit_arrays(); return 1; }
        if (!ck_valence_ok(M, &err_info[0], &err_info[1])) {
            emit_arrays();
            return 2;
        }
        if (ck_perceive_aromaticity(M) != 0) return -1;
        // sanitize_mol stereo clearing (smiles.py:816-819)
        for (int32_t bi = 0; bi < m; ++bi) {
            CkBond& b = M.bonds[(size_t)bi];
            if (b.stereo && (b.aromatic || b.order != 2)) {
                b.stereo = 0;
                b.sx = b.sy = -1;
            }
        }
    }
    if (!emit_arrays()) return -1;
    if (do_write) {
        std::string s;
        ck_rank_and_write(M, s);
        if ((int32_t)s.size() + 1 > out_cap) return 3;
        std::memcpy(out_smiles, s.c_str(), s.size() + 1);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ck_apply_template — one full retro-template application in native code.
//
// Exact port of the STEREO-FREE path of chem/reaction.py _apply_cached:
// _combined_matches (disjoint embeddings over per-component matches,
// reaction.py:67-89) + _rewrite (reaction.py:191-305) + per-fragment
// sanitize_and_write, with the same enumeration orders, caps, and
// outcome dedup, so the returned outcome tuple is bit-identical to the
// Python path. Templates or products carrying any chirality are never
// serialized here (the Python wrapper gates and falls back — chirality
// bookkeeping stays in reaction.py, the reference implementation).
//
// This is the planner's host hot loop: ~50 templates per expansion per
// node (retro/model.py top-k). The reference outsources the identical
// work to RDKit C++ via rdchiralRunText (graph_predictor/model.py:193).
//
// prod blob (int32): [n, m, atoms n*6, bonds m*4, off n+1, nbr 2m,
//   bidx 2m] — atoms/bonds as in ck_canonicalize; CSR from Mol._adj.
// tmpl blob (int32):
//   [n_lhs, n_rhs]
//   per LHS comp: [nq, prog_len, n_qbonds] maps[nq] prog[prog_len]
//                 qbonds[3*n_qbonds]
//   per RHS comp: [nq, n_qbonds] atoms[nq*7: map, element(-1 none),
//                 has_charge, charge, has_hcount, hcount,
//                 aromatic_hint(-1/0/1)] qbonds[3*n_qbonds]
// out: outcome strings '\n'-joined, NUL-terminated.
// Returns n_outcomes >= 0, or -1 when the native path cannot decide
// (malformed blob / internal cap) — caller falls back to Python.
// ---------------------------------------------------------------------------

namespace {

struct RAtomSpec {
    int32_t map, element, has_charge, charge, has_hcount, hcount, arom_hint;
};
struct RhsComp {
    std::vector<RAtomSpec> atoms;
    std::vector<std::array<int32_t, 3>> bonds;  // a, b, kind
};
struct LhsComp {
    QueryProg Q;
    std::vector<int32_t> maps;
    std::vector<std::array<int32_t, 3>> bonds;  // a, b, kind (source order)
};

// editable molecular graph mirroring chem/mol.py Mol edit semantics
// (incl. remove_bond swap-remove and _adj dict-insertion order)
struct EMol {
    std::vector<CkAtom> atoms;
    std::vector<CkBond> bonds;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> adj;  // (nbr,bidx)

    int32_t find_edge(int32_t u, int32_t v) const {
        const auto& lst = adj[(size_t)u];
        for (size_t k = 0; k < lst.size(); ++k)
            if (lst[k].first == v) return (int32_t)k;
        return -1;
    }
    int32_t bond_between(int32_t u, int32_t v) const {
        const int32_t k = find_edge(u, v);
        return k < 0 ? -1 : adj[(size_t)u][(size_t)k].second;
    }
    bool add_bond(int32_t u, int32_t v, int32_t order, int32_t arom) {
        if (u == v || find_edge(u, v) >= 0) return false;
        bonds.push_back({u, v, order, arom});
        const int32_t bi = (int32_t)bonds.size() - 1;
        adj[(size_t)u].emplace_back(v, bi);
        adj[(size_t)v].emplace_back(u, bi);
        return true;
    }
    void remove_bond(int32_t u, int32_t v) {
        const int32_t ku = find_edge(u, v);
        const int32_t bi = adj[(size_t)u][(size_t)ku].second;
        adj[(size_t)u].erase(adj[(size_t)u].begin() + ku);
        const int32_t kv = find_edge(v, u);
        adj[(size_t)v].erase(adj[(size_t)v].begin() + kv);
        const int32_t last = (int32_t)bonds.size() - 1;
        if (bi != last) {  // swap-remove, fixing moved bond's adjacency
            const CkBond moved = bonds[(size_t)last];
            bonds[(size_t)bi] = moved;
            for (auto& pr : adj[(size_t)moved.a1])
                if (pr.first == moved.a2) { pr.second = bi; break; }
            for (auto& pr : adj[(size_t)moved.a2])
                if (pr.first == moved.a1) { pr.second = bi; break; }
        }
        bonds.pop_back();
    }
};

// _bond_from_query port (reaction.py:92-105)
static void ck_bond_from_query(int32_t kind, int32_t a1_arom, int32_t a2_arom,
                               int32_t* order, int32_t* arom) {
    if (kind == BK_DOUBLE)        { *order = 2; *arom = 0; }
    else if (kind == BK_TRIPLE)   { *order = 3; *arom = 0; }
    else if (kind == BK_AROMATIC) { *order = 1; *arom = 1; }
    else if (kind == BK_SINGLE)   { *order = 1; *arom = 0; }
    else { *order = 1; *arom = (a1_arom && a2_arom) ? 1 : 0; }
}

// sanitize + canonical write of one EMol fragment (already reindexed).
// Returns 0 ok; 1 chemistry rejection (skip the outcome); -1 internal
// cap (whole call must fall back to Python for exact parity).
static int ck_fragment_smiles(const EMol& F, std::string& out) {
    const int32_t n = (int32_t)F.atoms.size();
    const int32_t m = (int32_t)F.bonds.size();
    std::vector<int32_t> off((size_t)n + 1, 0);
    std::vector<int32_t> nbr((size_t)(2 * m));
    std::vector<int32_t> bidx((size_t)(2 * m));
    int32_t e = 0;
    for (int32_t i = 0; i < n; ++i) {
        off[(size_t)i] = e;
        for (const auto& [w, bi] : F.adj[(size_t)i]) {
            nbr[(size_t)e] = w;
            bidx[(size_t)e] = bi;
            ++e;
        }
    }
    off[(size_t)n] = e;
    CkMol M;
    M.n = n;
    M.m = m;
    M.off = off.data();
    M.nbr = nbr.data();
    M.bidx = bidx.data();
    M.atoms = F.atoms;
    M.bonds = F.bonds;
    if (!ck_aromatic_bonds_consistent(M)) return -1;  // Python decides
    if (!ck_kekulize(M)) return 1;
    int32_t ei, ev;
    if (!ck_valence_ok(M, &ei, &ev)) return 1;
    if (ck_perceive_aromaticity(M) != 0) return -1;
    ck_rank_and_write(M, out);
    return out.empty() ? 1 : 0;
}

// _rewrite port (reaction.py:191-305), chirality-free. emb[ci] points
// at the ci-th LHS component's assignment (query idx -> product atom).
// Returns 0 + outcome; 1 = skip this embedding; -1 = fall back.
static int ck_rewrite_one(const CkMol& P,
                          const std::vector<LhsComp>& lhs,
                          const std::vector<RhsComp>& rhs,
                          const std::vector<const int32_t*>& emb,
                          std::string& outcome) {
    // mol = product.copy(): _adj rebuilt in bonds-list order
    EMol mol;
    mol.atoms = P.atoms;
    mol.adj.resize((size_t)P.n);
    mol.bonds.reserve((size_t)P.m);
    for (int32_t bi = 0; bi < P.m; ++bi) {
        const CkBond& b = P.bonds[(size_t)bi];
        if (!mol.add_bond(b.a1, b.a2, b.order, b.aromatic)) return -1;
    }

    std::map<int32_t, int32_t> map_to_atom;
    std::set<int32_t> matched_atoms;
    for (size_t ci = 0; ci < lhs.size(); ++ci) {
        const int32_t* m = emb[ci];
        for (int32_t qi = 0; qi < lhs[ci].Q.nq; ++qi) {
            matched_atoms.insert(m[qi]);
            const int32_t amap = lhs[ci].maps[(size_t)qi];
            if (amap) map_to_atom[amap] = m[qi];
        }
    }

    // 1. remove bonds covered by the LHS pattern
    for (size_t ci = 0; ci < lhs.size(); ++ci) {
        const int32_t* m = emb[ci];
        for (const auto& [a, b, kind] : lhs[ci].bonds) {
            (void)kind;
            const int32_t u = m[a], v = m[b];
            if (mol.bond_between(u, v) >= 0) mol.remove_bond(u, v);
        }
    }

    // 2. realize RHS atoms
    std::vector<std::vector<int32_t>> rhs_lookup(rhs.size());
    std::set<int32_t> rhs_mapped;
    for (size_t ci = 0; ci < rhs.size(); ++ci) {
        auto& lookup = rhs_lookup[ci];
        lookup.resize(rhs[ci].atoms.size());
        for (size_t qi = 0; qi < rhs[ci].atoms.size(); ++qi) {
            const RAtomSpec& qa = rhs[ci].atoms[qi];
            auto it = qa.map ? map_to_atom.find(qa.map) : map_to_atom.end();
            int32_t idx;
            if (qa.map && it != map_to_atom.end()) {
                idx = it->second;
                CkAtom& atom = mol.atoms[(size_t)idx];
                if (qa.has_charge) atom.charge = qa.charge;
                else if (qa.element >= 0) atom.charge = 0;
                atom.ehs = qa.has_hcount ? qa.hcount : -1;
                rhs_mapped.insert(idx);
            } else {
                if (qa.element < 0) return 1;  // unmapped atom w/o element
                CkAtom atom{qa.element,
                            qa.has_charge ? qa.charge : 0,
                            0,
                            qa.has_hcount ? qa.hcount : -1,
                            qa.arom_hint == 1 ? 1 : 0,
                            0};
                mol.atoms.push_back(atom);
                mol.adj.emplace_back();
                idx = (int32_t)mol.atoms.size() - 1;
            }
            lookup[qi] = idx;
        }
    }

    // 3. add RHS bonds (replace any existing bond between the endpoints)
    for (size_t ci = 0; ci < rhs.size(); ++ci) {
        for (const auto& [a, b, kind] : rhs[ci].bonds) {
            const int32_t u = rhs_lookup[ci][(size_t)a];
            const int32_t v = rhs_lookup[ci][(size_t)b];
            if (mol.bond_between(u, v) >= 0) mol.remove_bond(u, v);
            int32_t order, arom;
            ck_bond_from_query(kind, mol.atoms[(size_t)u].aromatic,
                               mol.atoms[(size_t)v].aromatic, &order, &arom);
            if (!mol.add_bond(u, v, order, arom)) return 1;  // u == v etc.
        }
    }

    // 4. LHS-matched atoms not carried into the RHS are deleted
    // (subgraph over the ascending keep-list, reaction.py:284-289)
    std::vector<int32_t> removed;
    for (int32_t a : matched_atoms)
        if (!rhs_mapped.count(a)) removed.push_back(a);
    if (!removed.empty()) {
        const int32_t n0 = (int32_t)mol.atoms.size();
        std::vector<int32_t> remap((size_t)n0, -1);
        int32_t nn = 0;
        {
            std::set<int32_t> rem(removed.begin(), removed.end());
            for (int32_t i = 0; i < n0; ++i)
                if (!rem.count(i)) remap[(size_t)i] = nn++;
        }
        EMol sub;
        sub.atoms.reserve((size_t)nn);
        sub.adj.resize((size_t)nn);
        for (int32_t i = 0; i < n0; ++i)
            if (remap[(size_t)i] >= 0) sub.atoms.push_back(mol.atoms[(size_t)i]);
        for (const CkBond& b : mol.bonds) {
            const int32_t u = remap[(size_t)b.a1], v = remap[(size_t)b.a2];
            if (u >= 0 && v >= 0 &&
                !sub.add_bond(u, v, b.order, b.aromatic))
                return -1;
        }
        mol = std::move(sub);
    }

    // 5. fragments -> sanitized canonical reactants, sorted + '.'-joined
    const int32_t n = (int32_t)mol.atoms.size();
    std::vector<std::string> pieces;
    {
        std::vector<uint8_t> seen((size_t)n, 0);
        std::vector<int32_t> stack, comp;
        for (int32_t start = 0; start < n; ++start) {
            if (seen[(size_t)start]) continue;
            stack.assign(1, start);
            seen[(size_t)start] = 1;
            comp.clear();
            while (!stack.empty()) {
                const int32_t v = stack.back();
                stack.pop_back();
                comp.push_back(v);
                for (const auto& [w, bi] : mol.adj[(size_t)v]) {
                    (void)bi;
                    if (!seen[(size_t)w]) {
                        seen[(size_t)w] = 1;
                        stack.push_back(w);
                    }
                }
            }
            std::sort(comp.begin(), comp.end());
            // subgraph(comp): atoms in ascending order, bonds in
            // bonds-list order (reaction.py step 5 / mol.py subgraph)
            std::vector<int32_t> remap((size_t)n, -1);
            for (size_t k = 0; k < comp.size(); ++k)
                remap[(size_t)comp[k]] = (int32_t)k;
            EMol frag;
            frag.adj.resize(comp.size());
            frag.atoms.reserve(comp.size());
            for (int32_t v : comp) frag.atoms.push_back(mol.atoms[(size_t)v]);
            for (const CkBond& b : mol.bonds) {
                const int32_t u = remap[(size_t)b.a1], v = remap[(size_t)b.a2];
                if (u >= 0 && v >= 0 &&
                    !frag.add_bond(u, v, b.order, b.aromatic))
                    return -1;
            }
            std::string smi;
            const int rc = ck_fragment_smiles(frag, smi);
            if (rc != 0) return rc;  // 1 = chem rejection, -1 = fallback
            pieces.push_back(std::move(smi));
        }
    }
    if (pieces.empty()) return 1;
    std::sort(pieces.begin(), pieces.end());
    outcome.clear();
    for (size_t k = 0; k < pieces.size(); ++k) {
        if (k) outcome += '.';
        outcome += pieces[k];
    }
    return 0;
}

}  // namespace

int32_t ck_apply_template(
    const int32_t* prod, int32_t prod_len,
    const int32_t* tmpl, int32_t tmpl_len,
    int32_t max_embeddings, int32_t max_matches, int32_t max_outcomes,
    char* out, int32_t out_cap) {
    // -- decode the product blob -------------------------------------------
    if (prod_len < 2) return -1;
    const int32_t n = prod[0], m = prod[1];
    if (n <= 0 || m < 0 ||
        prod_len != 2 + 6 * n + 4 * m + (n + 1) + 4 * m)
        return -1;
    CkMol P;
    P.n = n;
    P.m = m;
    const int32_t* pa = prod + 2;
    const int32_t* pb = pa + 6 * n;
    P.off = pb + 4 * m;
    P.nbr = P.off + (n + 1);
    P.bidx = P.nbr + 2 * m;
    P.atoms.resize((size_t)n);
    for (int32_t i = 0; i < n; ++i)
        P.atoms[(size_t)i] = {pa[6 * i], pa[6 * i + 1], pa[6 * i + 2],
                              pa[6 * i + 3], pa[6 * i + 4], pa[6 * i + 5]};
    P.bonds.resize((size_t)m);
    for (int32_t bi = 0; bi < m; ++bi) {
        const int32_t* b = pb + 4 * bi;
        if (b[0] < 0 || b[1] < 0 || b[0] >= n || b[1] >= n) return -1;
        P.bonds[(size_t)bi] = {b[0], b[1], b[2], b[3]};
    }

    // -- decode the template blob ------------------------------------------
    if (tmpl_len < 2) return -1;
    const int32_t n_lhs = tmpl[0], n_rhs = tmpl[1];
    if (n_lhs <= 0 || n_rhs <= 0) return -1;
    int32_t p = 2;
    std::vector<LhsComp> lhs((size_t)n_lhs);
    for (int32_t c = 0; c < n_lhs; ++c) {
        if (p + 3 > tmpl_len) return -1;
        const int32_t nq = tmpl[p], prog_len = tmpl[p + 1],
                      nqb = tmpl[p + 2];
        p += 3;
        if (nq <= 0 || prog_len < 0 || nqb < 0 ||
            p + nq + prog_len + 3 * nqb > tmpl_len)
            return -1;
        LhsComp& L = lhs[(size_t)c];
        L.maps.assign(tmpl + p, tmpl + p + nq);
        p += nq;
        const int32_t used = ck_build_query(nq, tmpl + p, prog_len, nqb,
                                            tmpl + p + prog_len, L.Q);
        if (used != prog_len) return -1;
        p += prog_len;
        for (int32_t e = 0; e < nqb; ++e) {
            const int32_t a = tmpl[p], b = tmpl[p + 1], k = tmpl[p + 2];
            if (a < 0 || b < 0 || a >= nq || b >= nq) return -1;
            L.bonds.push_back({a, b, k});
            p += 3;
        }
    }
    std::vector<RhsComp> rhs((size_t)n_rhs);
    for (int32_t c = 0; c < n_rhs; ++c) {
        if (p + 2 > tmpl_len) return -1;
        const int32_t nq = tmpl[p], nqb = tmpl[p + 1];
        p += 2;
        if (nq <= 0 || nqb < 0 || p + 7 * nq + 3 * nqb > tmpl_len) return -1;
        RhsComp& R = rhs[(size_t)c];
        R.atoms.resize((size_t)nq);
        for (int32_t qi = 0; qi < nq; ++qi) {
            const int32_t* row = tmpl + p + 7 * qi;
            R.atoms[(size_t)qi] = {row[0], row[1], row[2], row[3],
                                   row[4], row[5], row[6]};
        }
        p += 7 * nq;
        for (int32_t e = 0; e < nqb; ++e) {
            const int32_t a = tmpl[p], b = tmpl[p + 1], k = tmpl[p + 2];
            if (a < 0 || b < 0 || a >= nq || b >= nq) return -1;
            R.bonds.push_back({a, b, k});
            p += 3;
        }
    }
    if (p != tmpl_len) return -1;

    // -- product match context (smarts.py _atom_contexts / _native_mol) ----
    std::vector<uint8_t> is_bridge((size_t)std::max(m, 1), 0);
    if (m > 0) compute_bridges(n, P.off, P.nbr, P.bidx, is_bridge);
    std::vector<int32_t> ctx((size_t)n * 7);
    std::vector<uint64_t> masks((size_t)n, 0);
    std::vector<int32_t> ring_counts((size_t)n, 0);
    std::vector<uint8_t> atom_in_ring((size_t)n, 0);
    for (int32_t bi = 0; bi < m; ++bi)
        if (!is_bridge[(size_t)bi]) {
            atom_in_ring[(size_t)P.bonds[(size_t)bi].a1] = 1;
            atom_in_ring[(size_t)P.bonds[(size_t)bi].a2] = 1;
        }
    {
        // SSSR for ring_sizes / ring_count (target = m - n + components)
        int32_t comps = 0;
        std::vector<uint8_t> seen((size_t)n, 0);
        std::vector<int32_t> stack;
        for (int32_t s = 0; s < n; ++s) {
            if (seen[(size_t)s]) continue;
            ++comps;
            seen[(size_t)s] = 1;
            stack.assign(1, s);
            while (!stack.empty()) {
                const int32_t v = stack.back();
                stack.pop_back();
                for (int32_t e = P.off[v]; e < P.off[v + 1]; ++e)
                    if (!seen[(size_t)P.nbr[e]]) {
                        seen[(size_t)P.nbr[e]] = 1;
                        stack.push_back(P.nbr[e]);
                    }
            }
        }
        const int32_t target = m - n + comps;
        if (target > 0) {
            std::vector<int32_t> bonds2((size_t)(2 * m));
            for (int32_t bi = 0; bi < m; ++bi) {
                bonds2[(size_t)(2 * bi)] = P.bonds[(size_t)bi].a1;
                bonds2[(size_t)(2 * bi) + 1] = P.bonds[(size_t)bi].a2;
            }
            const int32_t rcap = 16 * m + 64;
            std::vector<int32_t> r_atoms((size_t)rcap);
            std::vector<int32_t> r_off((size_t)m + 2);
            int32_t n_rings = 0;
            if (ck_sssr(n, m, bonds2.data(), P.off, P.nbr, P.bidx, target,
                        r_atoms.data(), rcap, r_off.data(), m + 1,
                        &n_rings) != 0)
                return -1;  // cap exceeded: Python decides
            for (int32_t r = 0; r < n_rings; ++r) {
                const int32_t sz = r_off[(size_t)r + 1] - r_off[(size_t)r];
                if (sz >= 64) return -1;  // ring-size mask overflow
                for (int32_t k = r_off[(size_t)r]; k < r_off[(size_t)r + 1];
                     ++k) {
                    masks[(size_t)r_atoms[(size_t)k]] |= (uint64_t)1 << sz;
                    ring_counts[(size_t)r_atoms[(size_t)k]] += 1;
                }
            }
        }
    }
    for (int32_t i = 0; i < n; ++i) {
        const CkAtom& a = P.atoms[(size_t)i];
        int32_t* row = ctx.data() + (size_t)i * 7;
        row[0] = a.z;
        row[1] = a.charge;
        row[2] = a.aromatic;
        row[3] = P.degree(i);
        row[4] = a.ehs >= 0 ? a.ehs : ck_implicit_hs(P, i, false);
        row[5] = atom_in_ring[(size_t)i];
        row[6] = ring_counts[(size_t)i];
    }
    std::vector<int32_t> e_order((size_t)(2 * m)), e_arom((size_t)(2 * m)),
        e_ring((size_t)(2 * m));
    for (int32_t e = 0; e < 2 * m; ++e) {
        const CkBond& b = P.bonds[(size_t)P.bidx[e]];
        e_order[(size_t)e] = b.order;
        e_arom[(size_t)e] = b.aromatic;
        e_ring[(size_t)e] = is_bridge[(size_t)P.bidx[e]] ? 0 : 1;
    }
    const MolView mv{n, ctx.data(), masks.data(), P.off, P.nbr,
                     e_order.data(), e_arom.data(), e_ring.data()};

    // -- per-component matches + disjoint embeddings (reaction.py:67-89) ---
    std::vector<std::vector<int32_t>> per_comp((size_t)n_lhs);
    std::vector<int32_t> per_count((size_t)n_lhs);
    for (int32_t c = 0; c < n_lhs; ++c) {
        per_comp[(size_t)c].resize((size_t)max_matches *
                                   (size_t)lhs[(size_t)c].Q.nq);
        per_count[(size_t)c] = ck_run_match(mv, lhs[(size_t)c].Q,
                                            max_matches,
                                            per_comp[(size_t)c].data());
        if (per_count[(size_t)c] == 0) {
            if (out_cap > 0) out[0] = 0;
            return 0;
        }
    }
    std::vector<std::vector<const int32_t*>> embeddings;
    {
        // itertools.product order: last component varies fastest
        std::vector<int32_t> idx((size_t)n_lhs, 0);
        std::vector<uint8_t> used((size_t)n, 0);
        while ((int32_t)embeddings.size() < max_embeddings) {
            bool ok = true;
            std::fill(used.begin(), used.end(), 0);
            std::vector<const int32_t*> emb((size_t)n_lhs);
            for (int32_t c = 0; c < n_lhs && ok; ++c) {
                const int32_t nq = lhs[(size_t)c].Q.nq;
                const int32_t* a = per_comp[(size_t)c].data() +
                                   (size_t)idx[(size_t)c] * (size_t)nq;
                emb[(size_t)c] = a;
                for (int32_t qi = 0; qi < nq; ++qi) {
                    if (used[(size_t)a[qi]]) { ok = false; break; }
                    used[(size_t)a[qi]] = 1;
                }
            }
            if (ok) embeddings.push_back(std::move(emb));
            int32_t c = n_lhs - 1;
            for (; c >= 0; --c) {
                if (++idx[(size_t)c] < per_count[(size_t)c]) break;
                idx[(size_t)c] = 0;
            }
            if (c < 0) break;
        }
    }

    // -- rewrite each embedding, dedup outcomes (reaction.py:149-164) ------
    std::vector<std::string> outcomes;
    for (const auto& emb : embeddings) {
        std::string outcome;
        const int rc = ck_rewrite_one(P, lhs, rhs, emb, outcome);
        if (rc < 0) return -1;
        if (rc > 0) continue;
        bool dup = false;
        for (const auto& s : outcomes)
            if (s == outcome) { dup = true; break; }
        if (dup) continue;
        outcomes.push_back(std::move(outcome));
        if ((int32_t)outcomes.size() >= max_outcomes) break;
    }

    // -- emit ---------------------------------------------------------------
    int32_t need = 1;
    for (const auto& s : outcomes) need += (int32_t)s.size() + 1;
    if (need > out_cap) return -1;
    char* w = out;
    for (size_t k = 0; k < outcomes.size(); ++k) {
        if (k) *w++ = '\n';
        std::memcpy(w, outcomes[k].data(), outcomes[k].size());
        w += outcomes[k].size();
    }
    *w = 0;
    return (int32_t)outcomes.size();
}

}  // extern "C"
