"""Molecular graph containers.

A ``Mol`` is a mutable graph of ``Atom``s and ``Bond``s with O(1)
neighbor lookup. Bond orders are integers 1/2/3; aromatic bonds carry
``aromatic=True`` (order treated as 1.5 for valence accounting), which
matches the reference's edge-class scheme {1,2,3,4=aromatic}
(constants.py:24 BOND_INDEX).
"""

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .periodic import Z_TO_SYMBOL, default_valences


PARITY_NONE = 0
PARITY_CCW = 1   # '@'  — counterclockwise viewed from the first reference neighbor
PARITY_CW = 2    # '@@' — clockwise

STEREO_CIS = "cis"
STEREO_TRANS = "trans"


H_SLOT = "H"  # sentinel for implicit H / lone pair in neighbor orderings


def normalize_written_parity(written: List, had_prev: bool, parity: int) -> int:
    """Re-express an as-written tetrahedral parity against the internal
    reference order (H/lone-pair sentinel first, then ascending indices).

    `written` is the neighbor order as encountered in the source text
    (atom indices, optionally one H_SLOT). Returns PARITY_NONE when the
    site is not a valid 4-slot tetrahedral center."""
    explicit = [e for e in written if e != H_SLOT]
    has_sentinel = H_SLOT in written
    if len(explicit) == 3 and not has_sentinel:
        written = list(written)
        written.insert(1 if had_prev else 0, H_SLOT)
        has_sentinel = True
    if len(written) != 4 or len(explicit) not in (3, 4):
        return PARITY_NONE
    internal = ([H_SLOT] if has_sentinel else []) + sorted(explicit)
    if perm_parity(written, internal):
        return PARITY_CW if parity == PARITY_CCW else PARITY_CCW
    return parity


def perm_parity(a: Sequence, b: Sequence) -> int:
    """0 if b is an even permutation of a, 1 if odd."""
    a = list(a)
    b = list(b)
    parity = 0
    for i in range(len(a)):
        if a[i] != b[i]:
            j = a.index(b[i], i + 1)
            a[i], a[j] = a[j], a[i]
            parity ^= 1
    return parity


@dataclass
class Atom:
    z: int                      # atomic number; 0 = wildcard '*'
    charge: int = 0
    explicit_hs: Optional[int] = None  # None => implicit from valence model
    aromatic: bool = False
    isotope: int = 0
    atom_map: int = 0           # SMILES atom-map class (templates)
    # Tetrahedral parity (PARITY_*) relative to the INTERNAL reference
    # order: [implicit-H / lone-pair sentinel if <4 explicit neighbors]
    # followed by explicit neighbor atom indices in ascending order.
    # (Analog of RDKit chiral tags the reference gets via
    # Chem.MolFromSmiles — molecule_utils.py:30-35.)
    parity: int = PARITY_NONE
    # Extended (non-tetrahedral) stereo: intrinsic (geom, keys, slots)
    # tuple from chem/extstereo.py, or None. Immutable; cleared whenever
    # the neighborhood it describes is edited (reaction rewriting) or a
    # participating atom is dropped (subgraph).
    ext_stereo: Optional[tuple] = None

    @property
    def symbol(self) -> str:
        return Z_TO_SYMBOL.get(self.z, "?")

    def copy(self) -> "Atom":
        return Atom(self.z, self.charge, self.explicit_hs, self.aromatic,
                    self.isotope, self.atom_map, self.parity,
                    self.ext_stereo)


@dataclass
class Bond:
    a1: int
    a2: int
    order: int = 1              # 1, 2, 3
    aromatic: bool = False
    # Double-bond stereo: stereo_atoms = (x, y) with x a neighbor of a1
    # and y a neighbor of a2; STEREO_CIS = x and y on the same side.
    stereo: Optional[str] = None
    stereo_atoms: Optional[Tuple[int, int]] = None

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1

    def copy(self) -> "Bond":
        return Bond(self.a1, self.a2, self.order, self.aromatic,
                    self.stereo, self.stereo_atoms)

    @property
    def edge_class(self) -> int:
        """Edge class per BOND_INDEX: aromatic=4, else order."""
        return 4 if self.aromatic else self.order

    def valence_contrib(self) -> float:
        return 1.5 if self.aromatic else float(self.order)


class Mol:
    """Small mutable molecular graph."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: List[Dict[int, int]] = []  # atom idx -> {nbr: bond idx}
        self._sssr_cache: Optional[List[List[int]]] = None
        # per-atom SMARTS match contexts (smarts._atom_contexts memo);
        # invalidated together with the ring cache on structural edits
        self._smarts_ctx_cache = None
        # flat-array serialization for the native SMARTS matcher
        # (smarts._native_mol memo; False = structurally unserializable);
        # same invalidation discipline as the ctx cache
        self._native_match_cache = None
        # product blob for the native template engine
        # (reaction._product_blob memo; same invalidation discipline)
        self._native_apply_cache = None

    # -- construction ----------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self._adj.append({})
        self._sssr_cache = None
        self._smarts_ctx_cache = None
        self._native_match_cache = None
        self._native_apply_cache = None
        return len(self.atoms) - 1

    def add_bond(self, a1: int, a2: int, order: int = 1, aromatic: bool = False) -> int:
        if a1 == a2:
            raise ValueError("self-bond")
        if a2 in self._adj[a1]:
            raise ValueError(f"duplicate bond {a1}-{a2}")
        bond = Bond(a1, a2, order, aromatic)
        self.bonds.append(bond)
        idx = len(self.bonds) - 1
        self._adj[a1][a2] = idx
        self._adj[a2][a1] = idx
        self._sssr_cache = None
        self._smarts_ctx_cache = None
        self._native_match_cache = None
        self._native_apply_cache = None
        return idx

    def remove_bond(self, a1: int, a2: int) -> None:
        self._sssr_cache = None
        self._smarts_ctx_cache = None
        self._native_match_cache = None
        self._native_apply_cache = None
        idx = self._adj[a1].pop(a2, None)
        if idx is None:
            raise ValueError(f"no bond {a1}-{a2}")
        self._adj[a2].pop(a1)
        # swap-remove, fixing adjacency of the moved bond
        last = len(self.bonds) - 1
        if idx != last:
            moved = self.bonds[last]
            self.bonds[idx] = moved
            self._adj[moved.a1][moved.a2] = idx
            self._adj[moved.a2][moved.a1] = idx
        self.bonds.pop()

    # -- queries ----------------------------------------------------------
    def n_atoms(self) -> int:
        return len(self.atoms)

    def n_bonds(self) -> int:
        return len(self.bonds)

    def neighbors(self, idx: int) -> List[int]:
        return list(self._adj[idx].keys())

    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        idx = self._adj[a1].get(a2)
        return None if idx is None else self.bonds[idx]

    def bonds_of(self, idx: int) -> List[Bond]:
        return [self.bonds[i] for i in self._adj[idx].values()]

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def bond_order_sum(self, idx: int) -> float:
        return sum(b.valence_contrib() for b in self.bonds_of(idx))

    def implicit_hs(self, idx: int) -> int:
        """Hydrogens implied by the valence model (0 if explicit or unknown)."""
        atom = self.atoms[idx]
        if atom.explicit_hs is not None:
            return atom.explicit_hs
        if atom.z == 0:
            return 0
        allowed = default_valences(atom.z, atom.charge)
        if allowed is None:
            return 0
        import math
        bos = self.bond_order_sum(idx)
        bos_ceil = int(math.ceil(bos - 1e-9))
        for v in allowed:
            if v >= bos_ceil:
                return v - bos_ceil
        return 0

    def total_hs(self, idx: int) -> int:
        return self.implicit_hs(idx)

    def copy(self) -> "Mol":
        m = Mol()
        for a in self.atoms:
            m.add_atom(a.copy())
        for b in self.bonds:
            bi = m.add_bond(b.a1, b.a2, b.order, b.aromatic)
            m.bonds[bi].stereo = b.stereo
            m.bonds[bi].stereo_atoms = b.stereo_atoms
        return m

    # -- fragments ---------------------------------------------------------
    def fragments(self) -> List[List[int]]:
        """Connected components as lists of atom indices."""
        seen: Set[int] = set()
        comps = []
        for start in range(self.n_atoms()):
            if start in seen:
                continue
            stack, comp = [start], []
            seen.add(start)
            while stack:
                v = stack.pop()
                comp.append(v)
                for w in self._adj[v]:
                    if w not in seen:
                        seen.add(w)
                        stack.append(w)
            comps.append(sorted(comp))
        return comps

    def subgraph(self, atom_indices: Iterable[int]) -> "Mol":
        keep = list(atom_indices)
        remap = {old: new for new, old in enumerate(keep)}
        m = Mol()
        for old in keep:
            m.add_atom(self.atoms[old].copy())
        for b in self.bonds:
            if b.a1 in remap and b.a2 in remap:
                bi = m.add_bond(remap[b.a1], remap[b.a2], b.order, b.aromatic)
                if b.stereo is not None and b.stereo_atoms is not None:
                    x, y = b.stereo_atoms
                    if x in remap and y in remap:
                        m.bonds[bi].stereo = b.stereo
                        m.bonds[bi].stereo_atoms = (remap[x], remap[y])
        # re-express tetrahedral parity against the new index order: the
        # internal reference order is sorted-by-index, so renumbering that
        # changes the relative order of an atom's neighbors flips parity
        # by the permutation sign. Drop parity when a neighbor was removed.
        for old, new in remap.items():
            a = m.atoms[new]
            if a.ext_stereo is not None:
                from .extstereo import remap as _ext_remap
                a.ext_stereo = _ext_remap(a.ext_stereo, remap)
            if a.parity == PARITY_NONE:
                continue
            old_nbrs = self.neighbors(old)
            if any(nb not in remap for nb in old_nbrs):
                a.parity = PARITY_NONE
                continue
            mapped = [remap[nb] for nb in sorted(old_nbrs)]
            if perm_parity(mapped, sorted(mapped)):
                a.parity = PARITY_CW if a.parity == PARITY_CCW else PARITY_CCW
        return m

    # -- rings --------------------------------------------------------------
    def ring_info(self) -> List[List[int]]:
        """A cycle basis as atom-index rings (small molecules: fine SSSR proxy).

        Uses recursion-ordered DFS (iterator stack) so every non-tree edge
        is a back edge to an ancestor; each back edge yields one ring by
        walking parent pointers.
        """
        rings: List[List[int]] = []
        n = self.n_atoms()
        parent = [-1] * n
        depth = [-1] * n
        for root in range(n):
            if depth[root] != -1:
                continue
            depth[root] = 0
            it_stack = [(root, -1, iter(self._adj[root].items()))]
            while it_stack:
                v, pe, it = it_stack[-1]
                advanced = False
                for w, bidx in it:
                    if bidx == pe:
                        continue
                    if depth[w] == -1:
                        depth[w] = depth[v] + 1
                        parent[w] = v
                        it_stack.append((w, bidx, iter(self._adj[w].items())))
                        advanced = True
                        break
                    elif depth[w] < depth[v]:
                        ring = []
                        x = v
                        while x != w:
                            ring.append(x)
                            x = parent[x]
                        ring.append(w)
                        rings.append(ring)
                if not advanced:
                    it_stack.pop()
        return rings

    def smallest_rings(self) -> List[List[int]]:
        """Exact SSSR: a minimum cycle basis of size m - n + c.

        Replaces the round-1 smallest-ring-through-each-bond
        approximation (which over-counted bridged systems like
        norbornane and could mislabel fused aromatics). Matches the
        RDKit GetSSSR behavior the reference relies on implicitly in
        every Chem.MolFromSmiles (molecule_utils.py:30-35).

        Candidates are the shortest cycle through every non-bridge bond,
        greedily selected smallest-first subject to GF(2) linear
        independence over edge incidence vectors; a Horton-style
        vertex-rooted sweep tops up the rare rank-deficient case.

        The result is cached until the next structural edit — SMARTS
        matching consults ring context for every template application in
        the planner's host-bound hot loop.
        """
        if self._sssr_cache is not None:
            return self._sssr_cache
        target = self.n_bonds() - self.n_atoms() + len(self.fragments())
        if target <= 0:
            self._sssr_cache = []
            return self._sssr_cache
        from ._native import sssr as _native_sssr
        native = _native_sssr(self, target)
        if native is not None:
            self._sssr_cache = native
            return native
        bridges = self._find_bridges()
        seen = set()
        cands: List[List[int]] = []
        for bi, b in enumerate(self.bonds):
            if bi in bridges:
                continue
            ring = self._shortest_cycle_through(bi)
            if ring is None:
                continue
            key = tuple(sorted(ring))
            if key not in seen:
                seen.add(key)
                cands.append(ring)
        cands.sort(key=len)

        basis: Dict[int, int] = {}  # leading bit -> reduced mask

        def independent_add(mask: int) -> bool:
            while mask:
                lb = mask.bit_length() - 1
                if lb in basis:
                    mask ^= basis[lb]
                else:
                    basis[lb] = mask
                    return True
            return False

        chosen: List[List[int]] = []
        for ring in cands:
            if len(chosen) == target:
                break
            if independent_add(self._ring_edge_mask(ring)):
                chosen.append(ring)
        if len(chosen) < target:
            for ring in sorted(self._horton_cycles(seen), key=len):
                if len(chosen) == target:
                    break
                if independent_add(self._ring_edge_mask(ring)):
                    chosen.append(ring)
        self._sssr_cache = chosen
        return chosen

    def _ring_edge_mask(self, ring: List[int]) -> int:
        mask = 0
        for j, v in enumerate(ring):
            w = ring[(j + 1) % len(ring)]
            bi = self._adj[v].get(w)
            if bi is not None:
                mask |= 1 << bi
        return mask

    def _horton_cycles(self, seen: Set[Tuple[int, ...]]) -> List[List[int]]:
        """Horton candidate cycles: per root vertex, BFS shortest-path
        tree; each non-tree edge (x,y) whose root-paths meet only at the
        root closes a cycle path(root..x)+path(y..root)."""
        from collections import deque

        out: List[List[int]] = []
        n = self.n_atoms()
        for root in range(n):
            prev = {root: -1}
            q = deque([root])
            while q:
                v = q.popleft()
                for w in self._adj[v]:
                    if w not in prev:
                        prev[w] = v
                        q.append(w)

            def path(v: int) -> List[int]:
                p = []
                while v != -1:
                    p.append(v)
                    v = prev[v]
                return p  # v .. root

            for b in self.bonds:
                x, y = b.a1, b.a2
                if x not in prev or y not in prev:
                    continue
                px, py = path(x), path(y)
                if prev.get(y) == x or prev.get(x) == y:
                    continue  # tree edge
                # paths must be disjoint except the shared root
                if set(px[:-1]) & set(py[:-1]):
                    continue
                ring = px[:-1] + [root] + list(reversed(py[:-1]))
                key = tuple(sorted(ring))
                if key not in seen and len(ring) >= 3:
                    seen.add(key)
                    out.append(ring)
        return out

    def _shortest_cycle_through(self, bond_idx: int) -> Optional[List[int]]:
        """BFS shortest path a1->a2 avoiding the bond itself."""
        from collections import deque

        b = self.bonds[bond_idx]
        src, dst = b.a1, b.a2
        prev = {src: -1}
        q = deque([src])
        while q:
            v = q.popleft()
            if v == dst:
                break
            for w, bi in self._adj[v].items():
                if bi == bond_idx or w in prev:
                    continue
                prev[w] = v
                q.append(w)
        if dst not in prev:
            return None
        path = [dst]
        x = prev[dst]
        while x != -1:
            path.append(x)
            x = prev[x]
        return path

    def ring_membership(self) -> List[bool]:
        """True for atoms on any cycle: atoms on non-bridge edges."""
        in_ring = [False] * self.n_atoms()
        bridges = self._find_bridges()
        for i, b in enumerate(self.bonds):
            if i not in bridges:
                in_ring[b.a1] = True
                in_ring[b.a2] = True
        return in_ring

    def ring_bond_membership(self) -> List[bool]:
        """True for bonds on any cycle (non-bridge edges)."""
        bridges = self._find_bridges()
        return [i not in bridges for i in range(self.n_bonds())]

    def _find_bridges(self) -> Set[int]:
        n = self.n_atoms()
        disc = [-1] * n
        low = [0] * n
        timer = [0]
        bridges: Set[int] = set()
        for root in range(n):
            if disc[root] != -1:
                continue
            disc[root] = low[root] = timer[0]; timer[0] += 1
            it_stack = [(root, -1, iter(self._adj[root].items()))]
            while it_stack:
                v, pe, it = it_stack[-1]
                advanced = False
                for w, bidx in it:
                    if bidx == pe:
                        continue
                    if disc[w] == -1:
                        disc[w] = low[w] = timer[0]; timer[0] += 1
                        it_stack.append((w, bidx, iter(self._adj[w].items())))
                        advanced = True
                        break
                    else:
                        low[v] = min(low[v], disc[w])
                if not advanced:
                    it_stack.pop()
                    if it_stack:
                        u = it_stack[-1][0]
                        low[u] = min(low[u], low[v])
                        if low[v] > disc[u]:
                            bridges.add(pe)
        return bridges
