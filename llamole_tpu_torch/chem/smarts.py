"""SMARTS pattern engine: parsing + subgraph matching.

Replaces the slice of rdchiral/RDKit SMARTS functionality the retro
templates exercise (reference: graph_predictor/model.py:24,193
rdchiralRunText). Supported atom primitives — the set observed across
USPTO-50k retro template corpora:

  C/c element symbols (case = aromaticity), #n atomic number,
  a/A aromatic/aliphatic, Hn total-H count, Dn heavy degree,
  Xn total connectivity, R/!R ring membership, +n/-n charge,
  * any atom, :n atom map, with ; & (AND), , (OR), ! (NOT)

Bond primitives: - (single, non-aromatic), =, #, : (aromatic),
~ (any), default = single-or-aromatic. Branches, ring closures.
Stereo (/ \\ @) is parsed and ignored (no stereochemistry in round 1).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .mol import H_SLOT, Mol
from .periodic import SYMBOL_TO_Z


class SmartsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Query atom/bond predicates
# ---------------------------------------------------------------------------

@dataclass
class AtomCtx:
    """Precomputed per-atom facts for predicate evaluation."""
    z: int
    charge: int
    aromatic: bool
    degree: int
    total_h: int
    in_ring: bool
    ring_sizes: frozenset = frozenset()   # SSSR ring sizes through this atom
    ring_count: int = 0                   # number of SSSR rings through it

    @property
    def connectivity(self) -> int:
        return self.degree + self.total_h


# a primitive is (kind, value); evaluation below
Primitive = Tuple[str, int]


def _eval_primitive(p: Primitive, a: AtomCtx) -> bool:
    kind, val = p
    if kind == "any":
        return True
    if kind == "elem":
        return a.z == val
    if kind == "elem_arom":
        return a.z == val and a.aromatic
    if kind == "elem_aliph":
        return a.z == val and not a.aromatic
    if kind == "aromatic":
        return a.aromatic
    if kind == "aliphatic":
        return not a.aromatic
    if kind == "hcount":
        return a.total_h == val
    if kind == "degree":
        return a.degree == val
    if kind == "connectivity":
        return a.connectivity == val
    if kind == "ring":
        return a.in_ring
    if kind == "ring_count":
        return a.ring_count == val
    if kind == "ringsize":
        # r<n>: member of an SSSR ring of size n (r / r0: any ring)
        return a.in_ring if val == 0 else val in a.ring_sizes
    if kind == "charge":
        return a.charge == val
    raise SmartsError(f"unknown primitive {kind}")


@dataclass
class QueryAtom:
    """AND over groups; each group is an OR over alternatives; each
    alternative is an AND-list of (negated, primitive) terms.
    ';'/'&' separate groups, ',' separates alternatives, adjacency
    within an alternative ANDs (e.g. [CH3] = carbon AND 3 hydrogens)."""
    and_groups: List[List[List[Tuple[bool, Primitive]]]] = field(default_factory=list)
    atom_map: int = 0
    # explicit rewrite payload (used by reaction RHS): None = unspecified
    set_charge: Optional[int] = None
    set_hcount: Optional[int] = None
    element: Optional[int] = None          # definite element when unambiguous
    aromatic_hint: Optional[bool] = None
    chiral: int = 0                        # as-written @/@@ (mol.PARITY_*)

    def matches(self, ctx: AtomCtx) -> bool:
        for group in self.and_groups:
            ok = False
            for alternative in group:
                if all((not _eval_primitive(p, ctx)) if neg
                       else _eval_primitive(p, ctx)
                       for neg, p in alternative):
                    ok = True
                    break
            if not ok:
                return False
        return True


@dataclass
class QueryBond:
    kind: str = "default"  # default|single|double|triple|aromatic|any|ring

    def matches(self, order: int, aromatic: bool, in_ring: bool) -> bool:
        if self.kind == "any":
            return True
        if self.kind == "default":
            return aromatic or order == 1
        if self.kind == "single":
            return order == 1 and not aromatic
        if self.kind == "double":
            return order == 2 and not aromatic
        if self.kind == "triple":
            return order == 3
        if self.kind == "aromatic":
            return aromatic
        if self.kind == "ring":
            return in_ring
        raise SmartsError(f"unknown bond kind {self.kind}")


@dataclass
class QueryMol:
    atoms: List[QueryAtom] = field(default_factory=list)
    bonds: List[Tuple[int, int, QueryBond]] = field(default_factory=list)
    # as-written neighbor order per chiral query atom (rdchiral-style
    # template chirality: graph_predictor/model.py:193), mirroring the
    # SMILES parser's tracking so parity can be re-expressed on the
    # matched/realized molecule
    worder: Dict[int, List] = field(default_factory=dict)
    had_prev: Set[int] = field(default_factory=set)

    def adjacency(self) -> List[Dict[int, QueryBond]]:
        adj: List[Dict[int, QueryBond]] = [dict() for _ in self.atoms]
        for a, b, q in self.bonds:
            adj[a][b] = q
            adj[b][a] = q
        return adj


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_TWO_LETTER = ("Cl", "Br", "Si", "Se")
_BOND_CHARS = {"-": "single", "=": "double", "#": "triple",
               ":": "aromatic", "~": "any", "@": "ring",
               "/": "single", "\\": "single"}


def _parse_bracket_query(token: str) -> QueryAtom:
    """Parse one bracket atom expression (no enclosing brackets)."""
    qa = QueryAtom()
    # split on ';' (low-precedence AND); each part may contain ',' (OR),
    # '&' (high AND, treated as separate groups), '!' (NOT)
    for part in token.replace("&", ";").split(";"):
        if not part:
            continue
        group: List[List[Tuple[bool, Primitive]]] = []
        for alt in part.split(","):
            alternative: List[Tuple[bool, Primitive]] = []
            group.append(alternative)
            j = 0
            while j < len(alt):
                neg = False
                while j < len(alt) and alt[j] == "!":
                    neg = not neg
                    j += 1
                if j >= len(alt):
                    break
                c = alt[j]
                if c == ":":
                    qa.atom_map = int(alt[j + 1:])
                    j = len(alt)
                    break
                if c == "#":
                    j += 1
                    num = 0
                    while j < len(alt) and alt[j].isdigit():
                        num = num * 10 + int(alt[j]); j += 1
                    alternative.append((neg, ("elem", num)))
                    if qa.element is None and not neg:
                        qa.element = num
                    continue
                if c == "*":
                    alternative.append((neg, ("any", 0))); j += 1; continue
                if alt[j:j + 2] in _TWO_LETTER:
                    sym = alt[j:j + 2]
                    alternative.append((neg, ("elem_aliph", SYMBOL_TO_Z[sym])))
                    if qa.element is None and not neg:
                        qa.element = SYMBOL_TO_Z[sym]
                        qa.aromatic_hint = False
                    j += 2; continue
                if c == "H":
                    j += 1
                    num = 1
                    if j < len(alt) and alt[j].isdigit():
                        num = int(alt[j]); j += 1
                    alternative.append((neg, ("hcount", num)))
                    if not neg:
                        qa.set_hcount = num
                    continue
                if c == "D":
                    j += 1
                    num = 1
                    if j < len(alt) and alt[j].isdigit():
                        num = int(alt[j]); j += 1
                    alternative.append((neg, ("degree", num)))
                    continue
                if c == "X":
                    j += 1
                    num = 1
                    if j < len(alt) and alt[j].isdigit():
                        num = int(alt[j]); j += 1
                    alternative.append((neg, ("connectivity", num)))
                    continue
                if c == "R":
                    j += 1
                    if j < len(alt) and alt[j].isdigit():
                        n = int(alt[j]); j += 1
                        if n == 0:
                            alternative.append((not neg, ("ring", 0)))
                        else:
                            alternative.append((neg, ("ring_count", n)))
                    else:
                        alternative.append((neg, ("ring", 0)))
                    continue
                if c == "r":
                    j += 1
                    num = 0
                    while j < len(alt) and alt[j].isdigit():
                        num = num * 10 + int(alt[j]); j += 1
                    alternative.append((neg, ("ringsize", num)))
                    continue
                if c in "+-":
                    sign = 1 if c == "+" else -1
                    j += 1
                    repeats = 0
                    while j < len(alt) and alt[j] == c:
                        repeats += 1; j += 1
                    if j < len(alt) and alt[j].isdigit():
                        charge = sign * int(alt[j]); j += 1  # '+0' => 0
                    elif repeats:
                        charge = sign * (repeats + 1)
                    else:
                        charge = sign
                    alternative.append((neg, ("charge", charge)))
                    if not neg:
                        qa.set_charge = charge
                    continue
                if c == "a":
                    alternative.append((neg, ("aromatic", 0))); j += 1; continue
                if c == "A":
                    alternative.append((neg, ("aliphatic", 0))); j += 1; continue
                if c == "@":
                    j += 1
                    if j < len(alt) and alt[j] == "@":
                        qa.chiral = 2
                        j += 1
                    elif alt[j:j + 3] == "TH1":
                        qa.chiral = 1
                        j += 3
                    elif alt[j:j + 3] == "TH2":
                        qa.chiral = 2
                        j += 3
                    else:
                        qa.chiral = 1
                    continue
                if c.isupper():
                    sym = c
                    j += 1
                    # lowercase continuation for rare two-letter elements
                    if j < len(alt) and alt[j].islower() and sym + alt[j] in SYMBOL_TO_Z \
                            and sym + alt[j] not in ("Cl", "Br"):
                        # ambiguous (e.g. 'Sc'): prefer two-letter element
                        sym = sym + alt[j]; j += 1
                    if sym not in SYMBOL_TO_Z:
                        raise SmartsError(f"unknown element {sym!r} in [{token}]")
                    alternative.append((neg, ("elem_aliph", SYMBOL_TO_Z[sym])))
                    if qa.element is None and not neg:
                        qa.element = SYMBOL_TO_Z[sym]
                        qa.aromatic_hint = False
                    continue
                if c.islower():
                    sym = c.upper()
                    if sym not in SYMBOL_TO_Z:
                        raise SmartsError(f"unknown aromatic {c!r} in [{token}]")
                    alternative.append((neg, ("elem_arom", SYMBOL_TO_Z[sym])))
                    if qa.element is None and not neg:
                        qa.element = SYMBOL_TO_Z[sym]
                        qa.aromatic_hint = True
                    j += 1
                    continue
                raise SmartsError(f"bad SMARTS primitive {c!r} in [{token}]")
        group = [alt for alt in group if alt]
        if group:
            qa.and_groups.append(group)
    return qa


def parse_smarts(pattern: str) -> List[QueryMol]:
    """Parse a SMARTS pattern into per-component QueryMols
    ('.'-separated components). Malformed input raises SmartsError
    (never a bare ValueError — template application must be able to
    swallow chemistry failures per graph_predictor/model.py:207-208)."""
    try:
        return _parse_smarts_inner(pattern)
    except SmartsError:
        raise
    except (ValueError, KeyError, IndexError) as e:
        raise SmartsError(f"malformed SMARTS {pattern!r}: {e}") from e


def _parse_smarts_inner(pattern: str) -> List[QueryMol]:
    comps: List[QueryMol] = [QueryMol()]
    qm = comps[0]
    prev: List[Optional[int]] = [None]
    pending: Optional[QueryBond] = None
    ring_open: Dict[int, Tuple[int, Optional[QueryBond], QueryMol,
                               Optional[List[int]]]] = {}
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "(":
            prev.append(prev[-1]); i += 1; continue
        if c == ")":
            prev.pop(); i += 1; continue
        if c == ".":
            if ring_open:
                raise SmartsError("ring closure across components")
            comps.append(QueryMol())
            qm = comps[-1]
            prev = [None]
            pending = None
            i += 1
            continue
        if c in _BOND_CHARS:
            pending = QueryBond(_BOND_CHARS[c])
            i += 1
            continue
        if c.isdigit() or c == "%":
            if c == "%":
                num = int(pattern[i + 1:i + 3]); i += 3
            else:
                num = int(c); i += 1
            cur = prev[-1]
            if num in ring_open:
                other, obond, oqm, ocell = ring_open.pop(num)
                if oqm is not qm:
                    raise SmartsError("ring closure across components")
                qm.bonds.append((other, cur, pending or obond or QueryBond()))
                if ocell is not None:
                    ocell.append(cur)
                if cur in qm.worder:
                    qm.worder[cur].append(other)
            else:
                cell: Optional[List[int]] = None
                if cur in qm.worder:
                    cell = []
                    qm.worder[cur].append(cell)
                ring_open[num] = (cur, pending, qm, cell)
            pending = None
            continue

        qa: Optional[QueryAtom] = None
        if c == "[":
            j = pattern.find("]", i)
            if j < 0:
                raise SmartsError("unclosed '['")
            qa = _parse_bracket_query(pattern[i + 1:j])
            i = j + 1
        elif c == "*":
            qa = QueryAtom(and_groups=[[[(False, ("any", 0))]]])
            i += 1
        elif pattern[i:i + 2] in ("Cl", "Br"):
            sym = pattern[i:i + 2]
            qa = QueryAtom(and_groups=[[[(False, ("elem_aliph", SYMBOL_TO_Z[sym]))]]],
                           element=SYMBOL_TO_Z[sym], aromatic_hint=False)
            i += 2
        elif c.isupper():
            if c not in SYMBOL_TO_Z:
                raise SmartsError(f"unknown element {c!r}")
            qa = QueryAtom(and_groups=[[[(False, ("elem_aliph", SYMBOL_TO_Z[c]))]]],
                           element=SYMBOL_TO_Z[c], aromatic_hint=False)
            i += 1
        elif c.islower():
            sym = c.upper()
            if sym not in SYMBOL_TO_Z:
                raise SmartsError(f"unknown aromatic {c!r}")
            qa = QueryAtom(and_groups=[[[(False, ("elem_arom", SYMBOL_TO_Z[sym]))]]],
                           element=SYMBOL_TO_Z[sym], aromatic_hint=True)
            i += 1
        else:
            raise SmartsError(f"unexpected SMARTS char {c!r} at {i}")

        idx = len(qm.atoms)
        qm.atoms.append(qa)
        if qa.chiral:
            lst: List = []
            if prev[-1] is not None:
                lst.append(prev[-1])
                qm.had_prev.add(idx)
            if qa.set_hcount == 1:
                lst.append(H_SLOT)
            qm.worder[idx] = lst
        if prev[-1] is not None:
            qm.bonds.append((prev[-1], idx, pending or QueryBond()))
            if prev[-1] in qm.worder:
                qm.worder[prev[-1]].append(idx)
        pending = None
        prev[-1] = idx

    if ring_open:
        raise SmartsError("unclosed SMARTS ring bond")
    return comps


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------

def _atom_contexts(mol: Mol) -> List[AtomCtx]:
    # contexts depend only on the mol's structure; the planner applies
    # ~50 templates per product, so memoize on the object (reaction.py
    # caches parsed products, making this a per-product-per-batch cost).
    # Any structural edit goes through copy-then-edit (_rewrite), so a
    # cached mol is never mutated after this runs.
    cached = getattr(mol, "_smarts_ctx_cache", None)
    if cached is not None:
        return cached
    ring = mol.ring_membership()
    sizes: List[Set[int]] = [set() for _ in range(mol.n_atoms())]
    counts = [0] * mol.n_atoms()
    for r in mol.smallest_rings():
        for atom in r:
            sizes[atom].add(len(r))
            counts[atom] += 1
    out = []
    for i, a in enumerate(mol.atoms):
        out.append(AtomCtx(
            z=a.z, charge=a.charge, aromatic=a.aromatic,
            degree=mol.degree(i), total_h=mol.total_hs(i),
            in_ring=ring[i], ring_sizes=frozenset(sizes[i]),
            ring_count=counts[i]))
    try:
        mol._smarts_ctx_cache = out
    except AttributeError:
        pass  # exotic Mol without __dict__ — just skip memoization
    return out


# --- native-matcher serialization (chemkit.cpp ck_match_component) ---------
# Numeric codes shared with the C++ side; keep in sync with chemkit.cpp's
# PrimKind / BondKind enums.
_PRIM_CODE = {"any": 0, "elem": 1, "elem_arom": 2, "elem_aliph": 3,
              "aromatic": 4, "aliphatic": 5, "hcount": 6, "degree": 7,
              "connectivity": 8, "ring": 9, "ring_count": 10,
              "ringsize": 11, "charge": 12}
_BOND_CODE = {"default": 0, "single": 1, "double": 2, "triple": 3,
              "aromatic": 4, "any": 5, "ring": 6}


def _native_mol(mol: Mol):
    """Serialize a Mol for the native matcher: per-atom ctx rows, SSSR
    ring-size bitmasks, and CSR adjacency in `_adj` insertion order (the
    order the Python matcher enumerates candidates in). Memoized on the
    Mol with the same invalidation as the ctx cache. Returns None when
    the mol can't be represented (an SSSR ring of size >= 64)."""
    cached = getattr(mol, "_native_match_cache", None)
    if cached is not None:
        return None if cached is False else cached
    contexts = _atom_contexts(mol)
    n = mol.n_atoms()
    ctx = np.empty((n, 7), np.int32)
    masks = np.zeros(n, np.uint64)
    for i, a in enumerate(contexts):
        ctx[i] = (a.z, a.charge, int(a.aromatic), a.degree,
                  a.total_h, int(a.in_ring), a.ring_count)
        m = 0
        for s in a.ring_sizes:
            if s >= 64:
                try:
                    mol._native_match_cache = False
                except AttributeError:
                    pass
                return None
            m |= 1 << s
        masks[i] = m
    ring_bonds = mol.ring_bond_membership()
    off = np.empty(n + 1, np.int32)
    nbr: List[int] = []
    order: List[int] = []
    arom: List[int] = []
    ring: List[int] = []
    for i in range(n):
        off[i] = len(nbr)
        for j, bidx in mol._adj[i].items():
            b = mol.bonds[bidx]
            nbr.append(j)
            order.append(b.order)
            arom.append(int(b.aromatic))
            ring.append(int(ring_bonds[bidx]))
    off[n] = len(nbr)
    data = (n, np.ascontiguousarray(ctx), masks, off,
            np.asarray(nbr, np.int32), np.asarray(order, np.int32),
            np.asarray(arom, np.int32), np.asarray(ring, np.int32))
    try:
        mol._native_match_cache = data
    except AttributeError:
        pass
    return data


def _native_query(qm: QueryMol):
    """Serialize a QueryMol for the native matcher: a flat predicate
    program (QueryAtom.and_groups walked in order) plus bond triples in
    source order. Memoized on the QueryMol (parsed templates are cached
    and never mutated). Returns None for unserializable queries."""
    cached = getattr(qm, "_native_ser", None)
    if cached is not None:
        return None if cached is False else cached
    prog: List[int] = []
    for qa in qm.atoms:
        prog.append(len(qa.and_groups))
        for group in qa.and_groups:
            prog.append(len(group))
            for alt in group:
                prog.append(len(alt))
                for neg, (kind, val) in alt:
                    code = _PRIM_CODE.get(kind)
                    if code is None:
                        qm._native_ser = False
                        return None
                    prog.extend((1 if neg else 0, code, val))
    qb: List[int] = []
    for a, b, q in qm.bonds:
        code = _BOND_CODE.get(q.kind)
        if code is None:
            qm._native_ser = False
            return None
        qb.extend((a, b, code))
    ser = (np.asarray(prog, np.int32),
           np.asarray(qb, np.int32) if qb else np.empty(0, np.int32),
           len(qm.bonds))
    qm._native_ser = ser
    return ser


def match_component(
    qm: QueryMol, mol: Mol,
    contexts: Optional[List[AtomCtx]] = None,
    max_matches: int = 64,
    use_native: bool = True,
) -> List[Dict[int, int]]:
    """All embeddings of one query component: {query_idx: mol_idx}.

    Dispatches to the native matcher (chemkit.cpp ck_match_component, an
    exact port — same enumeration order and max_matches cutoff) when the
    library is available; the Python path below stays the reference
    implementation (tests/test_native.py asserts identity)."""
    nq = len(qm.atoms)
    if nq == 0:
        return []
    if (use_native and max_matches > 0
            and (contexts is None
                 or contexts is getattr(mol, "_smarts_ctx_cache", None))):
        ms = _native_mol(mol)
        if ms is not None:
            qs = _native_query(qm)
            if qs is not None:
                from ._native import match_component as _ck_match
                res = _ck_match(ms, qs, nq, max_matches)
                if res is not None:
                    return res
    if contexts is None:
        contexts = _atom_contexts(mol)
    adj = qm.adjacency()
    ring_bonds = mol.ring_bond_membership()

    # query traversal order: connected expansion from atom 0
    order: List[int] = [0]
    seen = {0}
    frontier = [0]
    while frontier:
        v = frontier.pop(0)
        for w in adj[v]:
            if w not in seen:
                seen.add(w)
                order.append(w)
                frontier.append(w)
    if len(order) != nq:
        # disconnected query component (shouldn't happen) — append rest
        order.extend(i for i in range(nq) if i not in seen)

    matches: List[Dict[int, int]] = []
    assignment: Dict[int, int] = {}
    used: Set[int] = set()

    def bond_ok(qi: int, mi: int) -> bool:
        for qn, qb in adj[qi].items():
            if qn in assignment:
                mn = assignment[qn]
                bond = mol.bond_between(mi, mn)
                if bond is None:
                    return False
                bidx = None
                # find bond index for ring check
                bidx = mol._adj[mi].get(mn)
                if not qb.matches(bond.order, bond.aromatic,
                                  ring_bonds[bidx] if bidx is not None else False):
                    return False
        return True

    def backtrack(pos: int) -> bool:
        if len(matches) >= max_matches:
            return True
        if pos == len(order):
            matches.append(dict(assignment))
            return len(matches) >= max_matches
        qi = order[pos]
        # candidates: neighbors of already-assigned query neighbors, else all
        anchor = next((qn for qn in adj[qi] if qn in assignment), None)
        cands = (mol.neighbors(assignment[anchor]) if anchor is not None
                 else range(mol.n_atoms()))
        for mi in cands:
            if mi in used:
                continue
            if not qm.atoms[qi].matches(contexts[mi]):
                continue
            assignment[qi] = mi
            if bond_ok(qi, mi):
                used.add(mi)
                if backtrack(pos + 1):
                    used.discard(mi)
                    del assignment[qi]
                    return True
                used.discard(mi)
            del assignment[qi]
        return False

    backtrack(0)
    return matches
