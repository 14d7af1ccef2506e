"""Extended (non-tetrahedral) stereo descriptors: @AL / @SP / @TB / @OH.

OpenSMILES extended-chirality classes for allenal (AL1-AL2),
square-planar (SP1-SP3), trigonal-bipyramidal (TB1-TB20) and octahedral
(OH1-OH30) centers. The reference reads these through RDKit's SMILES
parser (molecule_utils.py:30-35 Chem.MolFromSmiles); here they are
first-party, stored intrinsically on the Mol and re-emitted canonically.

Everything funnels through one geometric core ("place then extract"):

  parse   class number + written neighbor order  ->  slot placement
  store   placement -> orbit-minimal canonical slot tuple (relabel-safe)
  write   intrinsic + emitted neighbor order -> the smallest class
          number whose placement is rotation-equivalent

Slot positions are exact integer vectors on the ideal polyhedron and
the rotation groups are generated by closure at import (sizes asserted:
AL 4, SP 8, TB 6, OH 24), so orientation handedness lives in exactly
one place (the sign convention of `_det3`, anchored by the tetrahedral
@ = anticlockwise-from-first-neighbor rule). Class-number tables follow
the OpenSMILES spec; SP1-3, TB1-2 and OH1-2 (plus the bare @/@@
shorthands that mean them) are the forms that occur in practice and are
anchored by first-principles tests; the exotic TB3+/OH3+ numbering is
self-consistent by construction (round-trip and relabel invariance are
regression-locked — see PARITY.md).

Neighbor "keys" are atom indices (int) or an implicit-H / lone-pair
sentinel ("H", anchor_atom_idx); for the central geometries the anchor
is the center itself, for allenes it is the terminal atom carrying the
implicit substituent.
"""

from typing import Dict, List, Optional, Sequence, Tuple

Key = object          # int atom index or ("H", anchor) sentinel tuple
Vec = Tuple[int, int, int]

GEOMS = ("AL", "SP", "TB", "OH")

N_SLOTS = {"AL": 4, "SP": 4, "TB": 5, "OH": 6}
N_CLASSES = {"AL": 2, "SP": 3, "TB": 20, "OH": 30}

# Ideal integer slot coordinates.
#   AL: end-A substituents in the xz-plane, end-B in the yz-plane
#   SP: square, anticlockwise as seen from +z
#   TB: axial top, three equatorial anticlockwise from the top, axial
#       bottom
#   OH: +z, -z, then the equator anticlockwise as seen from +z
_SLOTS: Dict[str, Tuple[Vec, ...]] = {
    "AL": ((1, 0, 1), (-1, 0, 1), (0, 1, -1), (0, -1, -1)),
    "SP": ((1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0)),
    "TB": ((0, 0, 1), (2, 0, 0), (-1, 2, 0), (-1, -2, 0), (0, 0, -1)),
    "OH": ((0, 0, 1), (0, 0, -1),
           (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0)),
}

# Rotation-group generators as slot permutations p (slot i -> p[i]):
#   AL: 180deg about the main axis; 180deg about the bisecting C2 axis
#   SP: quarter turn; 180deg flip about the P0-P2 in-plane axis
#   TB: equatorial third turn; 180deg flip about the axis through E0
#   OH: quarter turn about +z; quarter turn about +x
_GENERATORS = {
    "AL": [(1, 0, 3, 2), (2, 3, 0, 1)],
    "SP": [(1, 2, 3, 0), (0, 3, 2, 1)],
    "TB": [(0, 2, 3, 1, 4), (4, 1, 3, 2, 0)],
    "OH": [(0, 1, 3, 4, 5, 2), (5, 3, 2, 0, 4, 1)],
}


def _closure(gens: List[Tuple[int, ...]], n: int) -> List[Tuple[int, ...]]:
    group = {tuple(range(n))}
    frontier = list(group)
    while frontier:
        nxt = []
        for p in frontier:
            for g in gens:
                q = tuple(g[p[i]] for i in range(n))
                if q not in group:
                    group.add(q)
                    nxt.append(q)
        frontier = nxt
    return sorted(group)


_GROUPS = {geom: _closure(_GENERATORS[geom], N_SLOTS[geom])
           for geom in GEOMS}
assert tuple(len(_GROUPS[g]) for g in GEOMS) == (4, 8, 6, 24)


def _det3(a: Vec, b: Vec, c: Vec) -> int:
    return (a[0] * (b[1] * c[2] - b[2] * c[1])
            - a[1] * (b[0] * c[2] - b[2] * c[0])
            + a[2] * (b[0] * c[1] - b[1] * c[0]))


def _sub(a: Vec, b: Vec) -> Vec:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _handed(p1: Vec, p2: Vec, p3: Vec, p4: Vec) -> int:
    """+1 when p2,p3,p4 run anticlockwise viewed from p1 toward the
    center ('@' handedness), -1 clockwise. Anchored by the tetrahedral
    convention: first neighbor at +z, remaining three anticlockwise in
    the lower plane gives a negative row-determinant."""
    d = _det3(_sub(p2, p1), _sub(p3, p1), _sub(p4, p1))
    return 1 if d < 0 else -1


def key_sort(k: Key):
    """Deterministic total order over neighbor keys: atom indices
    ascending, then sentinels by anchor."""
    if isinstance(k, tuple):
        return (1, k[1])
    return (0, k)


# ---------------------------------------------------------------------------
# Class tables (OpenSMILES)
# ---------------------------------------------------------------------------

# TB: (a, b, sense) — written positions (1-based) of the two axial
# neighbors; sense +1 = '@': viewed from the neighbor at position a
# toward the one at position b, the remaining three in written order
# run anticlockwise.
_TB_TABLE: Dict[int, Tuple[int, int, int]] = {
    1: (1, 5, 1), 2: (1, 5, -1), 3: (1, 4, 1), 4: (1, 4, -1),
    5: (1, 3, 1), 6: (1, 3, -1), 7: (1, 2, 1), 8: (1, 2, -1),
    9: (2, 5, 1), 10: (2, 4, 1), 11: (2, 5, -1), 12: (2, 4, -1),
    13: (2, 3, 1), 14: (2, 3, -1), 15: (3, 5, 1), 16: (3, 4, 1),
    17: (4, 5, 1), 18: (4, 5, -1), 19: (3, 4, -1), 20: (3, 5, -1),
}

# OH: (t, shape, sense) — written position (1-based) trans to the
# first-written neighbor (the viewing axis), the shape the four
# remaining neighbors trace on the equatorial square in written order
# (U = perimeter walk, Z = zig-zag, 4 = crossing), and the rotation
# sense of that walk viewed from the first neighbor (+1 = '@' =
# anticlockwise).
_OH_TABLE: Dict[int, Tuple[int, str, int]] = {
    1: (6, "U", 1), 2: (6, "U", -1), 3: (5, "U", 1), 4: (4, "U", 1),
    5: (3, "U", 1), 6: (2, "U", 1), 7: (6, "Z", 1), 8: (6, "Z", -1),
    9: (5, "Z", 1), 10: (4, "Z", 1), 11: (3, "Z", 1), 12: (2, "Z", 1),
    13: (6, "4", 1), 14: (6, "4", -1), 15: (5, "4", 1), 16: (5, "U", -1),
    17: (4, "U", -1), 18: (3, "U", -1), 19: (2, "U", -1), 20: (5, "Z", -1),
    21: (4, "Z", -1), 22: (3, "Z", -1), 23: (2, "Z", -1), 24: (5, "4", -1),
    25: (4, "4", 1), 26: (4, "4", -1), 27: (3, "4", 1), 28: (3, "4", -1),
    29: (2, "4", 1), 30: (2, "4", -1),
}
assert len(set(_OH_TABLE.values())) == 30 and len(set(_TB_TABLE.values())) == 20

# SP: 0-based written position of the neighbor trans to the
# first-written one (SP1 = U, SP2 = 4, SP3 = Z).
_SP_TRANS_OF_FIRST = {1: 2, 2: 1, 3: 3}

# Equatorial square fillings, per shape and sense, as the E-slot order
# the four non-axis neighbors occupy in written order. E slots are
# anticlockwise viewed from the axis start; '@' (+1) walks the first
# rotational step anticlockwise.
_SQUARE_FILL = {
    ("U", 1): (0, 1, 2, 3), ("U", -1): (0, 3, 2, 1),
    ("Z", 1): (0, 1, 3, 2), ("Z", -1): (0, 3, 1, 2),
    ("4", 1): (0, 2, 1, 3), ("4", -1): (0, 2, 3, 1),
}


# ---------------------------------------------------------------------------
# Place: class number + written order -> slot assignment
# ---------------------------------------------------------------------------

def _assign_from_class(geom: str, num: int, written: Sequence[Key],
                       al_ends: Optional[Dict] = None,
                       ) -> Optional[Dict[Key, int]]:
    """Slot assignment {key: slot index} for `written` (neighbor keys in
    as-written order) under class `geom`+`num`. None when the class
    number is out of range or the written list is inconsistent."""
    if not (1 <= num <= N_CLASSES[geom]) or len(written) != N_SLOTS[geom]:
        return None
    if len(set(written)) != len(written):
        return None
    if geom == "SP":
        tpos = _SP_TRANS_OF_FIRST[num]
        rest = [w for i, w in enumerate(written) if i not in (0, tpos)]
        return {written[0]: 0, written[tpos]: 2, rest[0]: 1, rest[1]: 3}
    if geom == "TB":
        a, b, sense = _TB_TABLE[num]
        eq = [w for i, w in enumerate(written, start=1) if i not in (a, b)]
        order = (1, 2, 3) if sense == 1 else (1, 3, 2)
        asg = {written[a - 1]: 0, written[b - 1]: 4}
        for w, s in zip(eq, order):
            asg[w] = s
        return asg
    if geom == "OH":
        t, shape, sense = _OH_TABLE[num]
        mid = [w for i, w in enumerate(written, start=1) if i not in (1, t)]
        asg = {written[0]: 0, written[t - 1]: 1}
        for w, e in zip(mid, _SQUARE_FILL[(shape, sense)]):
            asg[w] = 2 + e
        return asg
    # AL: the two slots of each end hold that end's substituents; the
    # free choice on the far end is fixed by the class handedness.
    if al_ends is None:
        return None
    end0 = al_ends.get(written[0])
    near = [w for w in written if al_ends.get(w) == end0]
    far = [w for w in written if al_ends.get(w) not in (end0, None)]
    if len(near) != 2 or len(far) != 2:
        return None
    sense = 1 if num == 1 else -1
    for flip in (False, True):
        f = [far[1], far[0]] if flip else far
        asg = {near[0]: 0, near[1]: 1, f[0]: 2, f[1]: 3}
        pos = [_SLOTS["AL"][asg[w]] for w in written]
        if _handed(*pos) == sense:
            return asg
    return None


# ---------------------------------------------------------------------------
# Extract: slot assignment <-> relabel-safe intrinsic form
# ---------------------------------------------------------------------------

def _canon(geom: str, asg: Dict[Key, int]) -> Tuple[Tuple[Key, ...],
                                                    Tuple[int, ...]]:
    """Orbit-minimal representation: keys sorted by `key_sort`, slots =
    the lexicographically least image under the rotation group."""
    keys = tuple(sorted(asg, key=key_sort))
    base = tuple(asg[k] for k in keys)
    best = min(tuple(g[s] for s in base) for g in _GROUPS[geom])
    return keys, best


def intrinsic_from_written(geom: str, num: int, written: Sequence[Key],
                           al_ends: Optional[Dict] = None,
                           ) -> Optional[Tuple]:
    """Parse side: ext_stereo tuple (geom, keys, slots) or None."""
    asg = _assign_from_class(geom, num, written, al_ends)
    if asg is None:
        return None
    keys, slots = _canon(geom, asg)
    return (geom, keys, slots)


def class_from_emitted(ext: Tuple, emitted: Sequence[Key],
                       al_ends: Optional[Dict] = None) -> Optional[int]:
    """Write side: the smallest class number whose placement of
    `emitted` is rotation-equivalent to the stored intrinsic form."""
    geom, keys, slots = ext
    if tuple(sorted(emitted, key=key_sort)) != keys:
        return None
    want = (keys, slots)
    for num in range(1, N_CLASSES[geom] + 1):
        asg = _assign_from_class(geom, num, emitted, al_ends)
        if asg is not None and _canon(geom, asg) == want:
            return num
    return None


def remap(ext: Tuple, mapping: Dict[int, int]) -> Optional[Tuple]:
    """Re-express an intrinsic form after an atom renumbering (subgraph
    extraction). None when any participating atom was dropped."""
    geom, keys, slots = ext
    new: Dict[Key, int] = {}
    for k, s in zip(keys, slots):
        if isinstance(k, tuple):
            a = mapping.get(k[1])
            nk: Key = ("H", a)
        else:
            a = mapping.get(k)
            nk = a
        if a is None:
            return None
        new[nk] = s
    keys2, slots2 = _canon(geom, new)
    return (geom, keys2, slots2)


# ---------------------------------------------------------------------------
# Allene frame perception
# ---------------------------------------------------------------------------

def allene_frame(mol, center: int) -> Optional[Tuple]:
    """Perceive the cumulated system through `center`.

    Returns (terminals, subs_of, ends) where terminals = (t_left,
    t_right), subs_of maps each terminal to its substituent key list
    (explicit atoms by index, plus at most one ("H", t) sentinel), and
    ends maps every substituent key to its terminal. None when `center`
    is not the hub of an axially-chiral (even-double-bond-count)
    cumulene with at least one explicit substituent per end."""
    nbrs = mol.neighbors(center)
    if len(nbrs) != 2:
        return None
    for b in mol.bonds_of(center):
        if b.order != 2 or b.aromatic:
            return None

    def walk(start: int) -> Optional[Tuple[int, int, int]]:
        prev, cur, steps = center, start, 1
        while True:
            cn = mol.neighbors(cur)
            bs = mol.bonds_of(cur)
            if len(cn) == 2 and all(b.order == 2 and not b.aromatic
                                    for b in bs):
                nxt = cn[0] if cn[1] == prev else cn[1]
                if nxt == prev:
                    return None
                prev, cur, steps = cur, nxt, steps + 1
                if steps > mol.n_atoms():
                    return None  # cyclic cumulene: give up
                continue
            return cur, steps, prev

    left = walk(nbrs[0])
    right = walk(nbrs[1])
    if left is None or right is None:
        return None
    (t1, s1, c1), (t2, s2, c2) = left, right
    if t1 == t2 or (s1 + s2) % 2 != 0:
        return None  # odd bond count = planar (cis/trans), not axial
    subs_of: Dict[int, List[Key]] = {}
    ends: Dict[Key, int] = {}
    for t, chain_nbr in ((t1, c1), (t2, c2)):
        subs: List[Key] = [n for n in mol.neighbors(t) if n != chain_nbr]
        if len(subs) == 1:
            subs.append(("H", t))
        if len(subs) != 2:
            return None  # 0 explicit (CH2 end: not stereogenic) or >2
        subs_of[t] = subs
        for s in subs:
            ends[s] = t
    return (t1, t2), subs_of, ends


def allene_written_order(subs_of: Dict[int, List[Key]],
                         pos_of: Optional[Dict[int, int]] = None,
                         ) -> List[Key]:
    """Substituents in appearance order: an explicit substituent at its
    own position, an implicit H / lone pair immediately after its
    terminal atom (OpenSMILES implicit-neighbor position rule).
    `pos_of` maps atom index -> position; the parser uses atom indices
    directly (= appearance order), the writer passes DFS emission
    order."""
    def pos(k: Key) -> float:
        a = k[1] if isinstance(k, tuple) else k
        p = pos_of[a] if pos_of is not None else a
        return p + 0.5 if isinstance(k, tuple) else float(p)

    out: List[Key] = []
    for subs in subs_of.values():
        out.extend(subs)
    out.sort(key=pos)
    return out
