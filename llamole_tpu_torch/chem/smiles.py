"""SMILES reader/writer with sanitization.

Functional replacement for the RDKit entry points the reference uses
(Chem.MolFromSmiles / Chem.MolToSmiles / Chem.SanitizeMol — see
molecule_utils.py:221-246). Scope: the organic/USPTO molecule subset —
organic-subset atoms, bracket atoms with isotope/charge/H-count/atom-map,
aromatic lowercase forms, ring closures (incl. %nn), branches, dots,
tetrahedral chirality (@ / @@, incl. implicit-H and lone-pair sites),
double-bond cis/trans via directional bonds (/ \\), and the extended
chirality classes @AL/@SP/@TB/@OH (allene-axial, square-planar,
trigonal-bipyramidal, octahedral — chem/extstereo.py), incl. the bare
@/@@ shorthands on 2-/5-/6-coordinate centers.

Sanitization = kekulize (assign alternating orders to aromatic systems)
+ valence check + aromaticity re-perception. Canonicalization uses
invariant refinement (Weisfeiler-Lehman style) with tie-breaking, so
equal graphs yield equal strings (canonical within this library; not
byte-identical to RDKit's canonical form).
"""

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .mol import (
    Atom,
    Bond,
    Mol,
    PARITY_CCW,
    PARITY_CW,
    PARITY_NONE,
    STEREO_CIS,
    STEREO_TRANS,
    H_SLOT,
    normalize_written_parity,
    perm_parity,
)
from .periodic import (
    AROMATIC_SYMBOLS,
    ORGANIC_SUBSET,
    SYMBOL_TO_Z,
    default_valences,
)


class SmilesError(ValueError):
    pass


_TWO_LETTER_ORGANIC = ("Cl", "Br")
_BOND_ORDERS = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1}


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_H_SLOT = H_SLOT  # canonical sentinel lives in mol.py (shared with smarts)


def _parse_bracket_atom(token: str) -> Tuple[Atom, int]:
    """Parse the inside of [...] (without the brackets). Returns (atom, n_hs).
    Tetrahedral chirality (@ / @@ / @TH1 / @TH2) lands in atom.parity as
    the AS-WRITTEN parity; parse_smiles re-expresses it against the
    internal reference order once neighbor order is known."""
    i = 0
    n = len(token)
    isotope = 0
    while i < n and token[i].isdigit():
        isotope = isotope * 10 + int(token[i])
        i += 1
    # element symbol (possibly aromatic lowercase, possibly two letters)
    aromatic = False
    sym = None
    if i < n:
        if token[i] == "*":
            sym = "*"
            i += 1
        elif token[i].isupper():
            if i + 1 < n and token[i].islower() is False and token[i + 1].islower() and token[i:i + 2] in SYMBOL_TO_Z:
                sym = token[i:i + 2]
                i += 2
            else:
                sym = token[i]
                i += 1
        elif token[i].islower():
            if i + 1 < n and token[i:i + 2] in AROMATIC_SYMBOLS:
                sym = token[i:i + 2].capitalize()
                i += 2
                aromatic = True
            elif token[i] in AROMATIC_SYMBOLS:
                sym = token[i].upper()
                i += 1
                aromatic = True
    if sym is None or sym not in SYMBOL_TO_Z:
        raise SmilesError(f"bad bracket atom: [{token}]")
    atom = Atom(z=SYMBOL_TO_Z[sym], aromatic=aromatic, isotope=isotope)
    hs = 0
    charge = 0
    while i < n:
        c = token[i]
        if c == "@":
            i += 1
            if i < n and token[i] == "@":
                atom.parity = PARITY_CW
                i += 1
            elif token[i:i + 3] == "TH1":
                atom.parity = PARITY_CCW
                i += 3
            elif token[i:i + 3] == "TH2":
                atom.parity = PARITY_CW
                i += 3
            elif token[i:i + 2] in ("AL", "SP", "TB", "OH"):
                # non-tetrahedral chirality class: record as-written, to
                # be resolved against neighbor order by _finalize_stereo
                geom = token[i:i + 2]
                i += 2
                num = 0
                while i < n and token[i].isdigit():
                    num = num * 10 + int(token[i])
                    i += 1
                num = num or 1
                from .extstereo import N_CLASSES
                if num > N_CLASSES[geom]:
                    raise SmilesError(f"bad chirality class @{geom}{num}")
                atom.ext_stereo = ("RAW", geom, num)
            else:
                atom.parity = PARITY_CCW
        elif c == "H":
            i += 1
            cnt = 0
            while i < n and token[i].isdigit():
                cnt = cnt * 10 + int(token[i])
                i += 1
            hs = cnt if cnt > 0 else 1
        elif c in "+-":
            sign = 1 if c == "+" else -1
            i += 1
            if i < n and token[i].isdigit():
                mag = 0
                while i < n and token[i].isdigit():
                    mag = mag * 10 + int(token[i])
                    i += 1
                charge += sign * mag
            else:
                charge += sign
                while i < n and token[i] == c:
                    charge += sign
                    i += 1
        elif c == ":":
            i += 1
            amap = 0
            while i < n and token[i].isdigit():
                amap = amap * 10 + int(token[i])
                i += 1
            atom.atom_map = amap
        else:
            raise SmilesError(f"bad bracket char {c!r} in [{token}]")
    atom.charge = charge
    atom.explicit_hs = hs
    return atom, hs


def parse_smiles(text: str, sanitize: bool = True) -> Mol:
    """Parse SMILES into a Mol. Raises SmilesError on malformed input;
    sanitize=True additionally kekulizes + valence-checks (raises).

    Stereo support: tetrahedral @/@@ is re-expressed against the
    internal reference order (mol.Atom.parity); directional bonds / \\
    become cis/trans annotations on the flanked double bond
    (mol.Bond.stereo). Parity with RDKit's MolFromSmiles stereo
    perception the reference relies on (molecule_utils.py:30-35).

    Input dispatches to the fused chemkit parser (ck_parse_smiles —
    bit-identical port incl. tetrahedral parity and cis/trans,
    differential-fuzzed in tests/test_native_canonicalize.py); the
    Python body below stays the reference implementation and handles
    extended stereo classes (@AL/@SP/@TB/@OH), parse errors (exact
    error text), and the no-native fallback."""
    from ._native import parse as _native_parse

    res = _native_parse(text, sanitize=sanitize)
    if res is not None:
        if res[0] == "ok":
            return _mol_from_parse_arrays(res[1], res[2])
        # sanitize-stage rejection (trusted native stages) — raise the
        # exact error text the Python path would produce
        if res[0] == "kekulize":
            raise SmilesError("kekulization failed")
        if res[0] == "valence" and res[2] is not None:
            from .periodic import Z_TO_SYMBOL
            idx, total2 = res[1]
            v = total2 / 2
            raise SmilesError(
                f"Explicit valence for atom # {idx} "
                f"{Z_TO_SYMBOL.get(res[2][idx][0], '?')}, {v:g}, "
                f"is greater than permitted")
    try:
        return _parse_smiles_inner(text, sanitize)
    except SmilesError:
        raise
    except (ValueError, KeyError, IndexError) as e:
        # malformed input must surface as SmilesError only — the public
        # contract is canonical_smiles -> None, never a raw exception
        raise SmilesError(f"malformed SMILES {text!r}: {e}") from e


def _parse_smiles_inner(text: str, sanitize: bool) -> Mol:
    if not isinstance(text, str) or len(text) == 0:
        raise SmilesError("empty SMILES")
    mol = Mol()
    prev: List[Optional[int]] = [None]  # branch stack of attachment atoms
    pending_bond: Optional[str] = None
    # ring_open: number -> (atom, bond symbol at open, worder cell or None)
    ring_open: Dict[int, Tuple[int, Optional[str], Optional[List[int]]]] = {}
    worder: Dict[int, List] = {}   # chiral atoms: as-written neighbor order
    had_prev: Set[int] = set()     # chiral atoms written after a neighbor
    bond_dirs: Dict[int, Tuple[int, str]] = {}  # bond -> (from_atom, / or \)
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c in " \t":
            break  # SMILES ends at whitespace (title may follow)
        if c == "(":
            if prev[-1] is None:
                raise SmilesError("branch with no attachment atom")
            prev.append(prev[-1])
            i += 1
            continue
        if c == ")":
            if len(prev) <= 1:
                raise SmilesError("unbalanced ')'")
            prev.pop()
            i += 1
            continue
        if c == ".":
            prev[-1] = None
            pending_bond = None
            i += 1
            continue
        if c in _BOND_ORDERS:
            if pending_bond is not None:
                raise SmilesError("two bond symbols in a row")
            pending_bond = c
            i += 1
            continue
        if c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not (text[i + 1].isdigit() and text[i + 2].isdigit()):
                    raise SmilesError("bad %ring closure")
                num = int(text[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            cur = prev[-1]
            if cur is None:
                raise SmilesError("ring closure with no current atom")
            if num in ring_open:
                other, obond, ocell = ring_open.pop(num)
                sym = pending_bond or obond
                if other == cur:
                    raise SmilesError("ring closure to self")
                bidx = _add_parsed_bond(mol, other, cur, sym)
                if pending_bond in ("/", "\\"):
                    bond_dirs[bidx] = (cur, pending_bond)
                elif obond in ("/", "\\"):
                    bond_dirs[bidx] = (other, obond)
                if ocell is not None:
                    ocell.append(cur)
                if cur in worder:
                    worder[cur].append(other)
            else:
                cell: Optional[List[int]] = None
                if cur in worder:
                    cell = []
                    worder[cur].append(cell)
                ring_open[num] = (cur, pending_bond, cell)
            pending_bond = None
            continue

        # atom
        atom: Optional[Atom] = None
        if c == "[":
            j = text.find("]", i)
            if j < 0:
                raise SmilesError("unclosed '['")
            atom, _ = _parse_bracket_atom(text[i + 1:j])
            i = j + 1
        elif c == "*":
            atom = Atom(z=0)
            i += 1
        elif text[i:i + 2] in _TWO_LETTER_ORGANIC:
            atom = Atom(z=SYMBOL_TO_Z[text[i:i + 2]])
            i += 2
        elif c.isupper() and c in SYMBOL_TO_Z and c in ORGANIC_SUBSET:
            atom = Atom(z=SYMBOL_TO_Z[c])
            i += 1
        elif c.islower() and c in AROMATIC_SYMBOLS:
            atom = Atom(z=SYMBOL_TO_Z[c.upper()], aromatic=True)
            i += 1
        else:
            raise SmilesError(f"unexpected character {c!r} at {i}")

        idx = mol.add_atom(atom)
        if atom.parity != 0 or atom.ext_stereo is not None:
            lst: List = []
            if prev[-1] is not None:
                lst.append(prev[-1])
                had_prev.add(idx)
            if atom.explicit_hs == 1:
                lst.append(_H_SLOT)
            worder[idx] = lst
        if prev[-1] is not None:
            bidx = _add_parsed_bond(mol, prev[-1], idx, pending_bond)
            if pending_bond in ("/", "\\"):
                bond_dirs[bidx] = (prev[-1], pending_bond)
            if prev[-1] in worder:
                worder[prev[-1]].append(idx)
        pending_bond = None
        prev[-1] = idx

    if ring_open:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_open)}")
    if len(prev) != 1:
        raise SmilesError("unbalanced '('")
    if pending_bond is not None:
        raise SmilesError("dangling bond symbol")
    if mol.n_atoms() == 0:
        raise SmilesError("no atoms")
    _finalize_stereo(mol, worder, had_prev, bond_dirs)
    if sanitize:
        sanitize_mol(mol)
    return mol


def _mol_from_parse_arrays(atoms, bonds) -> Mol:
    """Rebuild a Mol from ck_parse_smiles output rows. Bond rows are in
    creation order, so _adj insertion order matches the Python parser's."""
    mol = Mol()
    mol_atoms = mol.atoms
    adj = mol._adj
    for z, charge, isotope, ehs, aromatic, amap, parity in atoms:
        mol_atoms.append(Atom(z, charge, None if ehs < 0 else ehs,
                              bool(aromatic), isotope, amap, parity))
        adj.append({})
    mol_bonds = mol.bonds
    for k, (a1, a2, order, aromatic, stereo, sx, sy) in enumerate(bonds):
        b = Bond(a1, a2, order, bool(aromatic))
        if stereo:
            b.stereo = STEREO_TRANS if stereo == 2 else STEREO_CIS
            b.stereo_atoms = (sx, sy)
        mol_bonds.append(b)
        adj[a1][a2] = k
        adj[a2][a1] = k
    return mol


def _add_parsed_bond(mol: Mol, a1: int, a2: int, sym: Optional[str]) -> int:
    # Mol.add_bond raises raw ValueError on self/duplicate bonds (e.g.
    # the ring closure in 'c1c1...' re-bonds adjacent atoms); surface
    # those as SmilesError so malformed input never escapes the
    # public-API contract (canonical_smiles -> None, never raises)
    try:
        if sym == ":":
            return mol.add_bond(a1, a2, 1, aromatic=True)
        if sym is None:
            aro = mol.atoms[a1].aromatic and mol.atoms[a2].aromatic
            return mol.add_bond(a1, a2, 1, aromatic=aro)
        return mol.add_bond(a1, a2, _BOND_ORDERS[sym], aromatic=False)
    except ValueError as e:
        raise SmilesError(str(e)) from e


def _finalize_stereo(
    mol: Mol,
    worder: Dict[int, List],
    had_prev: Set[int],
    bond_dirs: Dict[int, Tuple[int, str]],
) -> None:
    """Convert as-written stereo annotations into intrinsic graph stereo.

    Tetrahedral: parity was recorded relative to the as-written neighbor
    order [prev?, H?, then neighbors in written order, ring partners at
    their digit position]; re-express it against the internal reference
    order (H/lone-pair sentinel first, then ascending atom indices).

    Double bonds: / \\ directions on flanking single bonds determine
    cis/trans. Convention: dir(x->u) == dir(v->y) => trans(x, y)."""
    for idx, lst in worder.items():
        a = mol.atoms[idx]
        written: List = []
        for e in lst:
            if isinstance(e, list):
                written.extend(e)  # resolved ring partner (len 1)
            else:
                written.append(e)
        raw = a.ext_stereo
        a.ext_stereo = None
        if raw is not None:
            # explicit @AL/@SP/@TB/@OH class from the bracket atom
            _finalize_ext(mol, idx, raw[1], raw[2], written, idx in had_prev)
            a.parity = PARITY_NONE
            continue
        if a.parity and len(written) == 2:
            # bare @/@@ on a 2-coordinate atom: allene-center shorthand
            _finalize_ext(mol, idx, "AL", 1 if a.parity == PARITY_CCW else 2,
                          written, idx in had_prev)
            a.parity = PARITY_NONE
            continue
        if a.parity and len(written) in (5, 6):
            # bare @/@@ shorthand on 5-/6-coordinate centers = TB1/2, OH1/2
            _finalize_ext(mol, idx, "TB" if len(written) == 5 else "OH",
                          1 if a.parity == PARITY_CCW else 2,
                          written, idx in had_prev)
            a.parity = PARITY_NONE
            continue
        a.parity = normalize_written_parity(written, idx in had_prev, a.parity)

    if not bond_dirs:
        return
    # normalized direction per directional bond: +1 = '/' read a1 -> a2
    ndir: Dict[int, int] = {}
    for bidx, (from_atom, sym) in bond_dirs.items():
        b = mol.bonds[bidx]
        d = 1 if sym == "/" else -1
        if from_atom != b.a1:
            d = -d
        ndir[bidx] = d

    def dir_into(end: int, nbr: int) -> Optional[int]:
        """dir(nbr -> end) for a directional single bond, else None."""
        bi = mol._adj[end].get(nbr)
        if bi is None or bi not in ndir:
            return None
        b = mol.bonds[bi]
        return ndir[bi] if (b.a1, b.a2) == (nbr, end) else -ndir[bi]

    for b in mol.bonds:
        if b.order != 2 or b.aromatic:
            continue
        u, v = b.a1, b.a2
        ux = [(x, dir_into(u, x)) for x in mol.neighbors(u) if x != v]
        vy = [(y, dir_into(v, y)) for y in mol.neighbors(v) if y != u]
        ux = [(x, d) for x, d in ux if d is not None]
        vy = [(y, d) for y, d in vy if d is not None]
        if not ux or not vy:
            continue
        # conflicting marks on one end (same side twice) => drop, permissive
        if len(ux) == 2 and ux[0][1] == ux[1][1]:
            continue
        if len(vy) == 2 and vy[0][1] == vy[1][1]:
            continue
        x, dx = ux[0]
        y, dyv = vy[0]
        # dir(v->y) = -dir(y->v)
        b.stereo = STEREO_TRANS if dx == -dyv else STEREO_CIS
        b.stereo_atoms = (x, y)


def _finalize_ext(mol: Mol, idx: int, geom: str, num: int,
                  written: List, had_prev_flag: bool) -> None:
    """Resolve an as-written extended-stereo class against the neighbor
    order into the intrinsic form (chem/extstereo.py). Invalid or
    non-stereogenic sites are dropped silently, matching the permissive
    handling of malformed tetrahedral/cis-trans marks above."""
    from . import extstereo as _ext

    a = mol.atoms[idx]
    if geom == "AL":
        frame = _ext.allene_frame(mol, idx)
        if frame is None:
            return
        _terminals, subs_of, ends = frame
        order = _ext.allene_written_order(subs_of)
        a.ext_stereo = _ext.intrinsic_from_written("AL", num, order, ends)
        return
    nslots = _ext.N_SLOTS[geom]
    keys: List = [("H", idx) if e == _H_SLOT else e for e in written]
    if len(keys) == nslots - 1 and not any(isinstance(k, tuple) for k in keys):
        # implicit H / lone pair takes the written position of the atom
        # itself (same rule as tetrahedral normalize_written_parity)
        keys.insert(1 if had_prev_flag else 0, ("H", idx))
    if len(keys) != nslots:
        return
    explicit = [k for k in keys if not isinstance(k, tuple)]
    if (len(set(explicit)) != len(explicit)
            or set(explicit) != set(mol.neighbors(idx))
            or len(keys) - len(explicit) > 1):
        return
    a.ext_stereo = _ext.intrinsic_from_written(geom, num, keys)


# ---------------------------------------------------------------------------
# Sanitization: kekulize + valence check + aromatic re-perception
# ---------------------------------------------------------------------------

def kekulize(mol: Mol) -> None:
    """Assign definite orders (1/2) to aromatic bonds, in place.

    Aromatic atoms needing one double bond are matched pairwise along
    aromatic bonds (perfect matching with backtracking). Atoms whose
    lone pair provides the pi electrons (pyrrole N, furan O, [nH],
    c with negative charge, exocyclic =O, ...) are excluded from the
    matching. Raises SmilesError when no valid assignment exists.
    """
    aro_atoms = [i for i, a in enumerate(mol.atoms) if a.aromatic]
    if not aro_atoms:
        return
    aro_bonds = [(bi, b) for bi, b in enumerate(mol.bonds) if b.aromatic]

    needs_double: Dict[int, bool] = {}
    for i in aro_atoms:
        needs_double[i] = _needs_pi_double(mol, i)

    # adjacency restricted to aromatic bonds between atoms needing doubles
    adj: Dict[int, List[int]] = {i: [] for i in aro_atoms}
    for _, b in aro_bonds:
        adj[b.a1].append(b.a2)
        adj[b.a2].append(b.a1)

    cand = [i for i in aro_atoms if needs_double[i]]
    matched: Dict[int, int] = {}

    order = sorted(cand, key=lambda i: len([w for w in adj[i] if needs_double.get(w, False)]))

    def backtrack(pos: int) -> bool:
        while pos < len(order) and order[pos] in matched:
            pos += 1
        if pos == len(order):
            return True
        v = order[pos]
        for w in adj[v]:
            if needs_double.get(w, False) and w not in matched:
                matched[v] = w
                matched[w] = v
                if backtrack(pos + 1):
                    return True
                del matched[v]
                del matched[w]
        return False

    if not backtrack(0):
        raise SmilesError("kekulization failed")

    for _, b in aro_bonds:
        if matched.get(b.a1) == b.a2:
            b.order = 2
        else:
            b.order = 1
        b.aromatic = False
    for i in aro_atoms:
        mol.atoms[i].aromatic = False


def _needs_pi_double(mol: Mol, idx: int) -> bool:
    """Does this aromatic atom contribute a double bond (vs a lone pair)?"""
    a = mol.atoms[idx]
    # exocyclic double bond (e.g. quinone C=O) consumes the pi slot
    for b in mol.bonds_of(idx):
        if not b.aromatic and b.order == 2:
            return False
    deg = mol.degree(idx)
    hs = a.explicit_hs if a.explicit_hs is not None else None
    if a.z == 6:  # c
        if a.charge != 0:
            return False  # carbanion lone pair / carbocation empty orbital
        return True
    if a.z == 7 or a.z == 15:  # n, p
        if a.charge > 0:
            # pyridinium [n+H] with 2 ring bonds: lone pair used for H/charge → still double
            return True
        # neutral n: [nH] or 3-connected n (pyrrole-type) → lone pair donor
        if (hs is not None and hs > 0) or deg == 3:
            return False
        return True
    if a.z in (8, 16, 34):  # o, s, se
        if a.charge > 0:
            return True
        return False
    if a.z == 5:  # b
        return False
    return True


def valence_errors(mol: Mol) -> List[Tuple[int, float]]:
    """Atoms whose bond-order sum + explicit Hs exceeds the max allowed
    valence. Returns [(atom_idx, observed_valence), ...]."""
    errors = []
    for i, a in enumerate(mol.atoms):
        allowed = default_valences(a.z, a.charge)
        if allowed is None:
            continue
        bos = mol.bond_order_sum(i)
        ehs = a.explicit_hs or 0
        total = bos + ehs
        if total > max(allowed) + 1e-6:
            errors.append((i, total))
    return errors


def perceive_aromaticity(mol: Mol) -> None:
    """Mark atoms/bonds aromatic for planar rings satisfying Hückel 4n+2.

    Operates on a kekulized mol. Simple-ring based (cycle basis rings of
    size 5-7), with fused-ring iteration: keeps looping until no new ring
    can be aromatized (handles naphthalene-style fusion).
    """
    rings = [r for r in mol.smallest_rings() if 5 <= len(r) <= 7]
    if not rings:
        return
    in_ring_flags = mol.ring_membership()
    # evaluate every ring against the pure kekulized structure first, then
    # mark — marking mid-loop would corrupt neighboring rings' pi counts
    # (e.g. a bridgehead N lone pair misread as a double).
    winners = [r for r in rings if _ring_is_aromatic(mol, r, in_ring_flags)]

    # Fused-pair envelopes (azulene-type nonalternants): Hückel can hold
    # on the shared perimeter of two fused rings when neither ring passes
    # alone. RDKit's default aromaticity model covers these via ring
    # systems; we check pairs sharing exactly one bond.
    won_atoms = {i for r in winners for i in r}
    envelope_bonds: List[Tuple[int, int]] = []
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            ri, rj = set(rings[i]), set(rings[j])
            if ri <= won_atoms and rj <= won_atoms:
                continue
            shared = ri & rj
            if len(shared) != 2:
                continue
            b = mol.bond_between(*sorted(shared))
            if b is None:
                continue
            env = _envelope_cycle(mol, rings[i], rings[j])
            if env is None:
                continue
            if _ring_is_aromatic(mol, env, in_ring_flags):
                winners.append(env)
                # the fusion bond is part of the aromatic system too
                envelope_bonds.extend(
                    (v, w) for ring in (rings[i], rings[j])
                    for v, w in zip(ring, ring[1:] + ring[:1]))

    # snapshot for the re-kekulization guard below
    saved_atoms = [(a.aromatic, a.explicit_hs) for a in mol.atoms]
    saved_bonds = [b.aromatic for b in mol.bonds]

    # Pin non-carbon aromatic H counts BEFORE any flag flips: aromatic
    # bonds contribute 1.5 to the valence sum, so the pyrrole-type H is
    # only derivable from the still-kekulized orders. Without pinning,
    # the written aromatic form drops the structural H ([nH]/[pH]), and
    # re-parsing treats the atom as pyridine-type — kekulization then
    # fails (c1ccnc1 from C1=CC=CN1) or shifts the double bonds onto a
    # different molecule. RDKit pins numExplicitHs at aromatization the
    # same way. Carbons stay implicit: their aromatic H is recovered by
    # kekulization.
    for ring in winners:
        for idx in ring:
            a = mol.atoms[idx]
            if a.z in (7, 15) and a.explicit_hs is None:
                a.explicit_hs = mol.implicit_hs(idx)

    for ring in winners:
        for idx in ring:
            mol.atoms[idx].aromatic = True
        for j, v in enumerate(ring):
            w = ring[(j + 1) % len(ring)]
            b = mol.bond_between(v, w)
            if b is not None:
                b.aromatic = True
    for v, w in envelope_bonds:
        b = mol.bond_between(v, w)
        if b is not None:
            b.aromatic = True

    # Re-kekulization guard: the written aromatic form is only legal if
    # the parser's donor rules can kekulize it back (exotic
    # heteroaromatics — e.g. a deg-3 ring P that in truth held a double
    # bond — defeat them). When the trial fails, roll back to the
    # kekulé spelling, which always round-trips. All-or-nothing: these
    # systems are vanishingly rare and correctness beats a prettier
    # spelling for any co-resident normal ring.
    trial = mol.copy()
    try:
        kekulize(trial)
    except SmilesError:
        for a, (arom, ehs) in zip(mol.atoms, saved_atoms):
            a.aromatic = arom
            a.explicit_hs = ehs
        for b, arom in zip(mol.bonds, saved_bonds):
            b.aromatic = arom


def _envelope_cycle(mol: Mol, r1: List[int], r2: List[int]) -> Optional[List[int]]:
    """Perimeter cycle of two rings fused along exactly one bond, as an
    ordered atom list; None if the symmetric difference is not a single
    simple cycle."""
    def edges(ring: List[int]) -> Set[Tuple[int, int]]:
        out = set()
        for j, v in enumerate(ring):
            w = ring[(j + 1) % len(ring)]
            out.add((min(v, w), max(v, w)))
        return out

    sym = edges(r1) ^ edges(r2)
    adj: Dict[int, List[int]] = {}
    for v, w in sym:
        adj.setdefault(v, []).append(w)
        adj.setdefault(w, []).append(v)
    if any(len(nb) != 2 for nb in adj.values()):
        return None
    start = next(iter(adj))
    cycle = [start]
    prev, cur = None, start
    while True:
        nxt = adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
        if nxt == start:
            break
        cycle.append(nxt)
        prev, cur = cur, nxt
        if len(cycle) > len(adj):
            return None
    return cycle if len(cycle) == len(adj) else None


def _ring_is_aromatic(mol: Mol, ring: List[int], in_ring_flags: List[bool]) -> bool:
    """Hückel check for one ring of a kekulized mol."""
    rset = set(ring)
    pi = 0
    for idx in ring:
        contrib = _pi_electrons(mol, idx, rset, in_ring_flags)
        if contrib is None:
            return False
        pi += contrib
    return pi % 4 == 2


def _pi_electrons(mol: Mol, idx: int, ring: Set[int], in_ring_flags: List[bool]) -> Optional[int]:
    """Pi electrons atom contributes to the ring system, None if sp3/blocked."""
    a = mol.atoms[idx]
    double_in_ring = False
    double_out_ring = False
    triple = False
    for b in mol.bonds_of(idx):
        o = b.other(idx)
        if b.aromatic or b.order == 2:
            if o in ring:
                double_in_ring = True
            elif in_ring_flags[o] and mol.atoms[o].z == 6:
                # fusion double into a neighboring ring (naphthalene-style):
                # still one pi electron in this ring's system
                double_in_ring = True
            else:
                double_out_ring = True
        if b.order == 3:
            triple = True
    if triple:
        return None
    deg = mol.degree(idx)
    hs = mol.total_hs(idx)
    heavy_h = deg + hs
    if a.z == 6:
        if double_in_ring:
            return 1
        if double_out_ring:
            return 0  # exocyclic C=O etc: contributes empty/filled orbital
        if a.charge < 0 and heavy_h <= 3:
            return 2
        if a.charge > 0 and heavy_h <= 3:
            return 0
        return None  # sp3 carbon
    if a.z in (7, 15):
        if double_in_ring:
            return 1
        if heavy_h <= 3 and not double_out_ring:
            return 2  # pyrrole-type lone pair
        if double_out_ring:
            return 1
        return None
    if a.z in (8, 16, 34):
        if double_in_ring:
            return 1
        if deg == 2:
            return 2
        return None
    if a.z == 5:  # boron: empty p orbital
        return 0
    return None


def _raise_native_canonicalize_error(mol: Mol, result) -> None:
    """Map a ck_canonicalize error result to the exact SmilesError the
    Python path raises (kekulize / sanitize_mol message parity)."""
    kind, payload = result
    if kind == "kekulize":
        raise SmilesError("kekulization failed")
    idx, total2 = payload
    v = total2 / 2
    raise SmilesError(
        f"Explicit valence for atom # {idx} {mol.atoms[idx].symbol}, {v:g}, is greater than permitted"
    )


def sanitize_mol(mol: Mol) -> None:
    """Kekulize, valence-check, re-perceive aromaticity. Raises SmilesError.

    Stereo-free molecules dispatch to the fused chemkit kernel
    (ck_canonicalize, bit-identical port — tests/test_native_canonicalize.py);
    the Python body below is the reference implementation."""
    from ._native import canonicalize as _native_canonicalize

    res = _native_canonicalize(mol, sanitize=True, write=False)
    if res is not None:
        if res[0] != "ok":
            _raise_native_canonicalize_error(mol, res)
        return
    kekulize(mol)
    errs = valence_errors(mol)
    if errs:
        i, v = errs[0]
        raise SmilesError(
            f"Explicit valence for atom # {i} {mol.atoms[i].symbol}, {v:g}, is greater than permitted"
        )
    perceive_aromaticity(mol)
    for b in mol.bonds:
        if b.stereo is not None and (b.aromatic or b.order != 2):
            b.stereo = None
            b.stereo_atoms = None


def sanitize_and_write(mol: Mol) -> str:
    """Fused sanitize_mol + mol_to_smiles(canonical=True) — ONE native
    call (one serialization pass) on the stereo-free hot path of retro
    template rewriting (reaction.py _rewrite step 5; the reference does
    the same via RDKit SanitizeMol + MolToSmiles inside rdchiral,
    graph_predictor/model.py:190-228). Raises SmilesError like
    sanitize_mol. The mol's flags are NOT updated on the native path —
    callers must treat the mol as consumed."""
    from ._native import canonicalize as _native_canonicalize

    res = _native_canonicalize(mol, sanitize=True, write=True,
                               apply_flags=False)
    if res is not None:
        if res[0] != "ok":
            _raise_native_canonicalize_error(mol, res)
        return res[1]
    sanitize_mol(mol)
    return mol_to_smiles(mol)


# ---------------------------------------------------------------------------
# Canonical ranking + writer
# ---------------------------------------------------------------------------

def canonical_ranks(mol: Mol, use_native: bool = True) -> List[int]:
    """Canonical atom ranks via invariant refinement with tie-breaking.

    Dispatches to the chemkit C++ kernel when built (exact same
    algorithm; outputs bit-identical — tests/test_native.py)."""
    n = mol.n_atoms()
    if n == 0:
        return []
    if use_native:
        from ._native import wl_ranks
        ranks = wl_ranks(mol)
        if ranks is not None:
            return ranks
    invariants = []
    for i, a in enumerate(mol.atoms):
        invariants.append((
            a.z, a.charge, a.isotope, int(a.aromatic),
            mol.degree(i), mol.total_hs(i),
            int(round(mol.bond_order_sum(i) * 2)),
        ))
    ranks = _ranks_from_keys(invariants)
    ranks = _refine(mol, ranks)
    # tie-break deterministically
    while True:
        counts: Dict[int, int] = {}
        for r in ranks:
            counts[r] = counts.get(r, 0) + 1
        tied = [r for r, c in counts.items() if c > 1]
        if not tied:
            break
        target = min(tied)
        # pick the lowest atom index in the tied class, promote it
        pick = min(i for i in range(n) if ranks[i] == target)
        keys = [(ranks[i], 0 if i == pick else 1) for i in range(n)]
        ranks = _ranks_from_keys(keys)
        ranks = _refine(mol, ranks)
    return ranks


def _ranks_from_keys(keys: Sequence) -> List[int]:
    order = sorted(set(keys))
    lookup = {k: r for r, k in enumerate(order)}
    return [lookup[k] for k in keys]


def _refine(mol: Mol, ranks: List[int]) -> List[int]:
    n = mol.n_atoms()
    while True:
        keys = []
        for i in range(n):
            nbrs = sorted(
                (int(round(mol.bonds[bidx].valence_contrib() * 2)), ranks[w])
                for w, bidx in mol._adj[i].items()
            )
            keys.append((ranks[i], tuple(nbrs)))
        new_ranks = _ranks_from_keys(keys)
        if new_ranks == ranks:
            return ranks
        ranks = new_ranks


_ORGANIC_WRITE = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}


def _atom_token(mol: Mol, idx: int, chiral: str = "") -> str:
    a = mol.atoms[idx]
    sym = a.symbol
    lower = sym.lower() if a.aromatic else sym
    needs_bracket = (
        bool(chiral)
        or sym not in _ORGANIC_WRITE
        or a.charge != 0
        or a.isotope != 0
        or a.atom_map != 0
        or (a.explicit_hs is not None and _hs_differ(mol, idx))
    )
    if sym == "*" and a.charge == 0 and a.isotope == 0 and a.atom_map == 0:
        return "*"
    if not needs_bracket:
        return lower
    parts = ["["]
    if a.isotope:
        parts.append(str(a.isotope))
    parts.append(lower)
    if chiral:
        parts.append(chiral)
    hs = a.explicit_hs if a.explicit_hs is not None else mol.implicit_hs(idx)
    if hs == 1:
        parts.append("H")
    elif hs > 1:
        parts.append(f"H{hs}")
    if a.charge == 1:
        parts.append("+")
    elif a.charge == -1:
        parts.append("-")
    elif a.charge > 1:
        parts.append(f"+{a.charge}")
    elif a.charge < -1:
        parts.append(f"-{-a.charge}")
    if a.atom_map:
        parts.append(f":{a.atom_map}")
    parts.append("]")
    return "".join(parts)


def _hs_differ(mol: Mol, idx: int) -> bool:
    """Would dropping the explicit H count change the implied count?"""
    a = mol.atoms[idx]
    saved = a.explicit_hs
    a.explicit_hs = None
    implied = mol.implicit_hs(idx)
    a.explicit_hs = saved
    return implied != (saved or 0)


def _bond_token(bond: Bond, a1_arom: bool, a2_arom: bool) -> str:
    if bond.aromatic:
        return ""
    if bond.order == 1:
        # single bond between two aromatic atoms must be explicit
        return "-" if (a1_arom and a2_arom) else ""
    return {2: "=", 3: "#"}[bond.order]


def _solve_bond_directions(mol: Mol) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Assign / \\ marks encoding every double-bond cis/trans annotation.

    Returns ({bond_idx: d}, {bond_idx: component_id}) over a minimal set
    of flanking single bonds, with d = +1 meaning '/' when the bond is
    read a1 -> a2. Constraints: trans(x, y) across u=v means
    dir(x->u) == dir(v->y); two single bonds at the same double-bond end
    point to opposite sides. Solved per connected constraint component
    by BFS 2-coloring; the writer canonicalizes the free global flip per
    component so the first emitted mark is always '/'."""
    stereo: List[Tuple[Bond, int, int]] = []
    for b in mol.bonds:
        if b.order != 2 or b.aromatic or not b.stereo or not b.stereo_atoms:
            continue
        x, y = b.stereo_atoms
        bx = mol._adj[b.a1].get(x)
        by = mol._adj[b.a2].get(y)
        if bx is None or by is None:
            continue
        if mol.bonds[bx].order != 1 or mol.bonds[by].order != 1:
            continue
        if mol.bonds[bx].aromatic or mol.bonds[by].aromatic:
            continue
        stereo.append((b, bx, by))
    if not stereo:
        return {}, {}

    needed: Set[int] = set()
    chosen: List[Tuple[Bond, int, int]] = []
    for b, bx, by in stereo:
        def pick(end: int, exclude: int, pref: int) -> int:
            cands = [bi for w, bi in mol._adj[end].items() if w != exclude
                     and mol.bonds[bi].order == 1 and not mol.bonds[bi].aromatic]
            for ci in cands:
                if ci in needed:
                    return ci
            return pref
        cx = pick(b.a1, b.a2, bx)
        cy = pick(b.a2, b.a1, by)
        needed.add(cx)
        needed.add(cy)
        chosen.append((b, cx, cy))

    # relations: d[u] * d[v] = sign
    relations: Dict[int, List[Tuple[int, int]]] = {bi: [] for bi in needed}

    def sense(bond_idx: int, frm: int, to: int) -> int:
        """+1 when d[bond_idx] directly encodes dir(frm->to)."""
        bb = mol.bonds[bond_idx]
        return 1 if (bb.a1, bb.a2) == (frm, to) else -1

    for b, cx, cy in chosen:
        x, y = b.stereo_atoms
        xp = mol.bonds[cx].other(b.a1)
        yp = mol.bonds[cy].other(b.a2)
        base = 1 if b.stereo == STEREO_TRANS else -1
        if xp != x:
            base = -base
        if yp != y:
            base = -base
        s1 = sense(cx, xp, b.a1)   # dir(xp -> a1)
        s2 = sense(cy, b.a2, yp)   # dir(a2 -> yp)
        sign = base * s1 * s2
        relations[cx].append((cy, sign))
        relations[cy].append((cx, sign))
        # sibling constraints at each end of this double bond
        for end in (b.a1, b.a2):
            at_end = [bi for w, bi in mol._adj[end].items()
                      if bi in needed and mol.bonds[bi].order == 1]
            for i in range(len(at_end)):
                for j in range(i + 1, len(at_end)):
                    c1, c2 = at_end[i], at_end[j]
                    t1 = sense(c1, mol.bonds[c1].other(end), end)
                    t2 = sense(c2, mol.bonds[c2].other(end), end)
                    s = -t1 * t2
                    relations[c1].append((c2, s))
                    relations[c2].append((c1, s))

    out: Dict[int, int] = {}
    comp_of: Dict[int, int] = {}
    for root in sorted(needed):
        if root in out:
            continue
        comp = {root: 1}
        queue = [root]
        ok = True
        while queue:
            u = queue.pop()
            for v, sign in relations[u]:
                want = comp[u] * sign
                if v in comp:
                    if comp[v] != want:
                        ok = False
                else:
                    comp[v] = want
                    queue.append(v)
        if ok:
            out.update(comp)
            for bi in comp:
                comp_of[bi] = root
    return out, comp_of


def _enumerate_rankings(mol: Mol, budget: int = 64) -> List[List[int]]:
    """All complete tie-broken rankings reachable by promoting each member
    of the minimal tied class at every level (capped at `budget` leaves).

    Needed for stereo canonicalization: a graph automorphism can map a
    molecule onto itself while flipping how chirality is EMITTED (e.g.
    the two ring arms of trans-1,4-disubstituted cyclohexane), so a
    single arbitrary tie-break is not labeling-independent. Enumerating
    the whole tied class and taking the lexicographically smallest
    output string is, because the class itself is canonical.

    Known limitation: if the branch count exceeds `budget` (automorphism
    group > 64 on a stereo-bearing molecule — e.g. a highly symmetric
    macrocycle with one center), the explored subset is truncated in
    atom-index order and canonicality across relabelings is no longer
    guaranteed (RDKit's canonical ranker handles this exactly; PARITY.md
    divergence 4 covers canonical-form differences)."""
    n = mol.n_atoms()
    invariants = []
    for i, a in enumerate(mol.atoms):
        invariants.append((
            a.z, a.charge, a.isotope, int(a.aromatic),
            mol.degree(i), mol.total_hs(i),
            int(round(mol.bond_order_sum(i) * 2)),
        ))
    start = _refine(mol, _ranks_from_keys(invariants))
    results: List[List[int]] = []

    def rec(ranks: List[int]) -> None:
        if len(results) >= budget:
            return
        counts: Dict[int, int] = {}
        for r in ranks:
            counts[r] = counts.get(r, 0) + 1
        tied = [r for r, c in counts.items() if c > 1]
        if not tied:
            results.append(ranks)
            return
        target = min(tied)
        for pick in [i for i in range(n) if ranks[i] == target]:
            keys = [(ranks[i], 0 if i == pick else 1) for i in range(n)]
            rec(_refine(mol, _ranks_from_keys(keys)))
            if len(results) >= budget:
                return

    rec(start)
    return results or [canonical_ranks(mol)]


def _ext_mark(mol: Mol, v: int, ext: tuple, parent_bond, closures,
              children, order_of) -> str:
    """Chirality token ('@SP1', '@TB14', ...) for an extended-stereo
    center, derived from the DFS emission order the surrounding writer
    is about to produce. Stale descriptors (graph edited since parse)
    fail the key check inside class_from_emitted and emit nothing."""
    from . import extstereo as _ext_mod

    geom, keys, _slots = ext
    if geom == "AL":
        frame = _ext_mod.allene_frame(mol, v)
        if frame is None:
            return ""
        _t, subs_of, ends = frame
        emitted = _ext_mod.allene_written_order(subs_of, pos_of=order_of)
        num = _ext_mod.class_from_emitted(ext, emitted, ends)
        return f"@AL{num}" if num else ""
    emitted: List = []
    pb = parent_bond.get(v)
    if pb is not None:
        emitted.append(mol.bonds[pb].other(v))
    if ("H", v) in keys:
        emitted.append(("H", v))
    for w, _b in sorted(closures.get(v, []), key=lambda t: order_of[t[0]]):
        emitted.append(w)
    emitted.extend(children.get(v, []))
    num = _ext_mod.class_from_emitted(ext, emitted)
    return f"@{geom}{num}" if num else ""


def mol_to_smiles(mol: Mol, canonical: bool = True) -> str:
    """Write SMILES. With canonical=True, traversal order is fixed by
    canonical ranks so identical graphs produce identical strings; for
    stereo-bearing molecules all automorphic tie-breaks are tried and
    the smallest string wins (see _enumerate_rankings)."""
    n = mol.n_atoms()
    if n == 0:
        return ""
    if not canonical:
        return _generate_smiles(mol, list(range(n)))
    # native path: handles tetrahedral parity + cis/trans (incl. the
    # automorphic tie-break enumeration); declines on extended stereo
    from ._native import canonicalize as _native_canonicalize
    res = _native_canonicalize(mol, sanitize=False, write=True)
    if res is not None and res[0] == "ok":
        return res[1]
    has_stereo = any(a.parity or a.ext_stereo is not None
                     for a in mol.atoms) or any(
        b.stereo for b in mol.bonds)
    if not has_stereo:
        return _generate_smiles(mol, canonical_ranks(mol))
    return min(_generate_smiles(mol, ranks)
               for ranks in _enumerate_rankings(mol))


def _generate_smiles(mol: Mol, ranks: List[int]) -> str:
    n = mol.n_atoms()
    dirmap, dircomp = _solve_bond_directions(mol)

    visited = [False] * n
    ring_closures: Dict[int, List[Tuple[int, str]]] = {i: [] for i in range(n)}
    ring_counter = [0]
    free_numbers: List[int] = []

    # discover ring-closure bonds via DFS (per component)
    tokens: List = []
    for ci, comp in enumerate(sorted(mol.fragments(),
                                     key=lambda c: min(ranks[i] for i in c))):
        root = min(comp, key=lambda i: ranks[i])
        if ci:
            tokens.append(".")
        tokens.extend(_write_component(mol, root, ranks, visited, ring_counter,
                                       free_numbers, dirmap, dircomp))
    # resolve directional placeholders: the global flip per constraint
    # component is free — fix it so the first emitted mark is '/'
    flip: Dict[int, int] = {}
    out: List[str] = []
    for tok in tokens:
        if isinstance(tok, tuple):
            d, comp_id = tok
            f = flip.setdefault(comp_id, d)
            out.append("/" if d * f == 1 else "\\")
        else:
            out.append(tok)
    return "".join(out)


def _write_component(mol, root, ranks, visited, ring_counter, free_numbers,
                     dirmap: Dict[int, int], dircomp: Dict[int, int]) -> List:
    # First pass: find tree edges + ring closure edges via iterative DFS
    parent_bond: Dict[int, Optional[int]] = {root: None}
    children: Dict[int, List[int]] = {}
    closures: Dict[int, List[Tuple[int, Bond]]] = {}
    stack = [root]
    visited[root] = True
    order_of: Dict[int, int] = {root: 0}
    counter = [1]
    seen_bonds: Set[int] = set()

    def nbrs_sorted(v: int) -> List[Tuple[int, int]]:
        return sorted(mol._adj[v].items(), key=lambda kv: ranks[kv[0]])

    # recursive DFS with explicit stack holding iterators
    it_stack = [(root, iter(nbrs_sorted(root)))]
    while it_stack:
        v, it = it_stack[-1]
        advanced = False
        for w, bidx in it:
            if bidx in seen_bonds:
                continue
            if not visited[w]:
                visited[w] = True
                seen_bonds.add(bidx)
                parent_bond[w] = bidx
                children.setdefault(v, []).append(w)
                order_of[w] = counter[0]
                counter[0] += 1
                it_stack.append((w, iter(nbrs_sorted(w))))
                advanced = True
                break
            else:
                seen_bonds.add(bidx)
                closures.setdefault(v, []).append((w, mol.bonds[bidx]))
        if not advanced:
            it_stack.pop()

    # ring-closure numbering: assign when first endpoint written
    closure_num: Dict[Tuple[int, int], int] = {}

    def closure_digit(num: int) -> str:
        return str(num) if num < 10 else f"%{num:02d}"

    out: List = []  # str tokens + (d, comp_id) directional placeholders

    def dirtok(bidx: int, frm: int, to: int) -> Tuple[int, int]:
        d = dirmap[bidx]
        bb = mol.bonds[bidx]
        if (bb.a1, bb.a2) != (frm, to):
            d = -d
        return (d, dircomp[bidx])

    def chiral_char(v: int) -> str:
        a = mol.atoms[v]
        if a.ext_stereo is not None:
            return _ext_mark(mol, v, a.ext_stereo, parent_bond, closures,
                             children, order_of)
        if a.parity == 0:
            return ""
        emitted: List = []
        pb = parent_bond.get(v)
        if pb is not None:
            emitted.append(mol.bonds[pb].other(v))
        nbrs = mol.neighbors(v)
        sentinel = len(nbrs) == 3
        if sentinel:
            emitted.append(_H_SLOT)
        for w, _b in sorted(closures.get(v, []), key=lambda t: order_of[t[0]]):
            emitted.append(w)
        emitted.extend(children.get(v, []))
        if len(emitted) != 4:
            return ""
        internal = ([_H_SLOT] if sentinel else []) + sorted(nbrs)
        eff = a.parity
        if perm_parity(internal, emitted):
            eff = PARITY_CW if eff == PARITY_CCW else PARITY_CCW
        return "@" if eff == PARITY_CCW else "@@"

    def emit(v: int) -> None:
        a_ar = mol.atoms[v].aromatic
        out.append(_atom_token(mol, v, chiral_char(v)))
        # ring closures at v
        for w, bond in sorted(closures.get(v, []), key=lambda t: order_of[t[0]]):
            key = (min(v, w), max(v, w))
            if key in closure_num:
                num = closure_num.pop(key)
                free_numbers.append(num)
                tok = _bond_token(bond, a_ar, mol.atoms[w].aromatic)
                out.append(tok + closure_digit(num))
            else:
                if free_numbers:
                    num = min(free_numbers)
                    free_numbers.remove(num)
                else:
                    ring_counter[0] += 1
                    num = ring_counter[0]
                closure_num[key] = num
                bidx = mol._adj[v].get(w)
                if bidx in dirmap:
                    out.append(dirtok(bidx, v, w))
                    out.append(closure_digit(num))
                else:
                    tok = _bond_token(bond, a_ar, mol.atoms[w].aromatic)
                    out.append(tok + closure_digit(num))
        kids = children.get(v, [])
        for j, w in enumerate(kids):
            bidx = parent_bond[w]
            bond = mol.bonds[bidx]
            last = j == len(kids) - 1
            if not last:
                out.append("(")
            if bidx in dirmap:
                out.append(dirtok(bidx, v, w))
            else:
                out.append(_bond_token(bond, a_ar, mol.atoms[w].aromatic))
            emit(w)
            if not last:
                out.append(")")

    # mirror closures both directions (closure recorded on later-visited atom)
    for v, lst in list(closures.items()):
        for w, bond in lst:
            closures.setdefault(w, [])
            if (v, bond) not in closures[w]:
                closures[w].append((v, bond))

    emit(root)
    return out


def canonical_smiles(text: str) -> Optional[str]:
    """Parse + sanitize + write canonical SMILES; None when invalid
    (parity with molecule_utils.py:239 mol2smiles semantics).

    Stereo-free input is ONE native call (ck_parse_smiles with
    sanitize+write) — no Python Mol is ever built. This is the
    per-molecule entry point of every ingest boundary (recanonicalize)
    and of planner membership checks."""
    from ._native import parse as _native_parse

    res = _native_parse(text, sanitize=True, write=True, want_mol=False)
    if res is not None:
        if res[0] == "ok":
            return res[3]
        return None  # kekulize/valence rejection (trusted native stages)
    # fallback (stereo / parse error / no native): the Python parser is
    # called directly — parse_smiles would re-attempt the native parse
    # that just declined. Sanitization faults surface as raw
    # KeyError/ValueError/IndexError from the reference implementations
    # (e.g. kekulize on an aromatic bond to a non-aromatic atom); the
    # public contract here is None, never an exception.
    try:
        mol = _parse_smiles_inner(text, sanitize=False)
        return sanitize_and_write(mol)
    except (SmilesError, ValueError, KeyError, IndexError, OverflowError):
        return None


def recanonicalize(text: str) -> str:
    """Re-spell an EXTERNALLY-sourced SMILES in this package's canonical
    form, falling back to the stripped raw string when it doesn't parse.

    Every ingest boundary (building-block inventory, MolQA records,
    user-supplied targets) must pass through here so string-membership
    checks (planner is_known, '(available)' annotation) hit regardless
    of the writer's canonicalization convention — the reference gets one
    canonical space for free because all its assets flow through RDKit
    (graph_predictor/model.py:190-228 canonicalizes proposals;
    loader.py:279-284 loads available.csv.gz already RDKit-canonical)."""
    s = text.strip()
    canon = canonical_smiles(s)
    return canon if canon is not None else s
