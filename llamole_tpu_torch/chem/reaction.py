"""Retro reaction-template application (rdchiral-lite).

Replaces rdchiralRunText(template, product_smiles) as used by the
reference retro predictor (graph_predictor/model.py:193): a retro
template is written `product_pattern >> reactant_patterns`; applying it
to a product SMILES yields candidate reactant sets.

Algorithm (standard template rewriting, no stereochemistry):
  1. match every LHS component into the product (disjoint embeddings)
  2. copy the product; remove bonds the LHS pattern covers between
     mapped atoms
  3. realize the RHS: mapped atoms reuse product atoms (charge/H updated
     from explicit RHS specs), unmapped RHS atoms are created fresh,
     RHS bonds added
  4. fragments of the edited graph = reactants; sanitize + canonicalize

Outcomes are deduped canonical '.'-joined reactant strings, matching the
shape the planner's expansion consumes (graph_predictor/model.py:190-228).
"""

import functools
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .mol import Atom, Mol, PARITY_NONE, H_SLOT, normalize_written_parity
from .smarts import QueryBond, QueryMol, SmartsError, match_component, _atom_contexts, parse_smarts
from .smiles import SmilesError, parse_smiles, sanitize_and_write


def _query_parity_on_mol(comp: QueryMol, qi: int, qmap: Dict[int, int]) -> int:
    """Re-express a template atom's @/@@ against the molecule's internal
    reference order, mapping the template's as-written neighbor order
    through the embedding (rdchiral template-chirality semantics,
    graph_predictor/model.py:193)."""
    lst = comp.worder.get(qi)
    if lst is None:
        return PARITY_NONE
    written: List = []
    for e in lst:
        if isinstance(e, list):
            if len(e) != 1:
                return PARITY_NONE
            written.append(qmap[e[0]])
        elif e == H_SLOT:
            written.append(H_SLOT)
        else:
            written.append(qmap[e])
    return normalize_written_parity(
        written, qi in comp.had_prev, comp.atoms[qi].chiral)


class ReactionError(ValueError):
    pass


def _split_reaction(template: str) -> Tuple[str, str]:
    parts = template.split(">>")
    if len(parts) != 2:
        # A>B>C form: agents in the middle
        parts3 = template.split(">")
        if len(parts3) == 3:
            return parts3[0], parts3[2]
        raise ReactionError(f"not a two-sided reaction SMARTS: {template!r}")
    return parts[0], parts[1]


def _combined_matches(
    lhs: Sequence[QueryMol], mol: Mol, max_embeddings: int = 32,
) -> List[Dict[int, Dict[int, int]]]:
    """Disjoint embeddings of all LHS components: [{comp_idx: {q: m}}]."""
    contexts = _atom_contexts(mol)
    per_comp = [match_component(c, mol, contexts) for c in lhs]
    if any(not m for m in per_comp):
        return []
    out = []
    for combo in itertools.product(*per_comp):
        used: Set[int] = set()
        ok = True
        for m in combo:
            vals = set(m.values())
            if used & vals:
                ok = False
                break
            used |= vals
        if ok:
            out.append({i: m for i, m in enumerate(combo)})
            if len(out) >= max_embeddings:
                break
    return out


def _bond_from_query(qb: QueryBond, a1_aromatic: bool, a2_aromatic: bool
                     ) -> Tuple[int, bool]:
    if qb.kind == "double":
        return 2, False
    if qb.kind == "triple":
        return 3, False
    if qb.kind == "aromatic":
        return 1, True
    if qb.kind == "single":
        return 1, False
    # default / any: single, aromatic when both ends are aromatic
    if a1_aromatic and a2_aromatic:
        return 1, True
    return 1, False


@functools.lru_cache(maxsize=8192)
def _parsed_template(template: str):
    """Template library entries repeat across every expansion (topk=50
    drawn from a fixed table) — parse each spelling once. QueryMol
    patterns are read-only through matching/rewrite."""
    lhs_str, rhs_str = _split_reaction(template)
    return parse_smarts(lhs_str), parse_smarts(rhs_str)


@functools.lru_cache(maxsize=2048)
def _parsed_product(smiles: str) -> Mol:
    """One parse per product per expansion batch instead of one per
    template (the 50-template steady state re-parsed the same product
    50x — measured 32% of host expansion time). Matching only reads the
    Mol; _rewrite deep-copies before editing, so sharing is safe."""
    return parse_smiles(smiles, sanitize=True)


def apply_retro_template(
    template: str, product_smiles: str, max_outcomes: int = 16,
) -> List[str]:
    """Returns deduped reactant-set SMILES ('.'-joined); [] when the
    template does not apply. Never raises on chemistry failures —
    parity with the reference's swallow-per-template behavior
    (graph_predictor/model.py:207-208). Results are deterministic, so
    repeated (template, product) pairs — common across the interleaved
    trees of a batched eval — resolve from a bounded cache."""
    return list(_apply_cached(template, product_smiles, max_outcomes))


@functools.lru_cache(maxsize=8192)
def _template_blob(template: str) -> Optional[np.ndarray]:
    """Serialize a parsed template for ck_apply_template (layout in
    chemkit.cpp). None = native-ineligible (chirality anywhere, or an
    unserializable SMARTS primitive) — the Python path handles it."""
    from .smarts import _BOND_CODE, _native_query

    try:
        lhs, rhs = _parsed_template(template)
    except (SmartsError, ReactionError):
        return None
    for qm in (*lhs, *rhs):
        for qa in qm.atoms:
            if qa.chiral:
                return None
    parts: List[int] = [len(lhs), len(rhs)]
    for comp in lhs:
        if not comp.atoms:
            return None
        q = _native_query(comp)
        if q is None:
            return None
        prog, qb, nqb = q
        parts += [len(comp.atoms), len(prog), nqb]
        parts += [qa.atom_map for qa in comp.atoms]
        parts += prog.tolist()
        parts += qb.tolist()
    for comp in rhs:
        if not comp.atoms:
            return None
        bonds: List[int] = []
        for a, b, q in comp.bonds:
            code = _BOND_CODE.get(q.kind)
            if code is None:
                return None
            bonds += [a, b, code]
        parts += [len(comp.atoms), len(comp.bonds)]
        for qa in comp.atoms:
            parts += [
                qa.atom_map,
                -1 if qa.element is None else qa.element,
                0 if qa.set_charge is None else 1,
                qa.set_charge or 0,
                0 if qa.set_hcount is None else 1,
                qa.set_hcount or 0,
                -1 if qa.aromatic_hint is None else int(qa.aromatic_hint),
            ]
        parts += bonds
    try:
        return np.asarray(parts, np.int32)
    except OverflowError:
        return None  # field beyond int32 (huge atom map): Python path


def _product_blob(mol: Mol) -> Optional[np.ndarray]:
    """Serialize a product Mol for ck_apply_template; memoized on the
    Mol (shared across the ~50 templates of one expansion). None when
    the mol carries stereo (native path is chirality-free)."""
    cached = getattr(mol, "_native_apply_cache", None)
    if cached is not None:
        return None if cached is False else cached
    for a in mol.atoms:
        if a.parity or a.ext_stereo is not None:
            mol._native_apply_cache = False
            return None
    for b in mol.bonds:
        if b.stereo is not None:
            mol._native_apply_cache = False
            return None
    n, m = mol.n_atoms(), mol.n_bonds()
    parts: List[int] = [n, m]
    for a in mol.atoms:
        parts += [a.z, a.charge, a.isotope,
                  -1 if a.explicit_hs is None else a.explicit_hs,
                  int(a.aromatic), a.atom_map]
    for b in mol.bonds:
        parts += [b.a1, b.a2, b.order, int(b.aromatic)]
    off: List[int] = []
    nbr: List[int] = []
    bidx: List[int] = []
    e = 0
    for i in range(n):
        off.append(e)
        for w, be in mol._adj[i].items():
            nbr.append(w)
            bidx.append(be)
            e += 1
    off.append(e)
    try:
        blob = np.asarray(parts + off + nbr + bidx, np.int32)
    except OverflowError:
        mol._native_apply_cache = False  # field beyond int32 (huge map)
        return None
    mol._native_apply_cache = blob
    return blob


@functools.lru_cache(maxsize=32768)
def _apply_cached(template: str, product_smiles: str,
                  max_outcomes: int) -> Tuple[str, ...]:
    try:
        lhs, rhs = _parsed_template(template)
        if (not any(c.atoms for c in lhs)) or (not any(c.atoms for c in rhs)):
            return ()
        product = _parsed_product(product_smiles)
    except (SmartsError, SmilesError, ReactionError):
        return ()

    # native fast path: chirality-free template x stereo-free product
    # runs match + rewrite + fragment canonicalization in ONE chemkit
    # call (bit-identical; tests/test_native_apply.py fuzzes parity)
    from ._native import apply_template as _native_apply, available

    if available():
        tb = _template_blob(template)
        if tb is not None:
            pb = _product_blob(product)
            if pb is not None:
                res = _native_apply(pb, tb, 32, 64, max_outcomes)
                if res is not None:
                    return res

    return _apply_python(lhs, rhs, product, max_outcomes)


def _apply_python(lhs, rhs, product: Mol, max_outcomes: int
                  ) -> Tuple[str, ...]:
    """Pure-Python template application — the reference implementation
    for the native fast path above, and the only path for chirality-
    bearing templates/products."""
    embeddings = _combined_matches(lhs, product)
    outcomes: List[str] = []
    seen: Set[str] = set()
    for emb in embeddings:
        if not _chirality_compatible(lhs, product, emb):
            continue
        try:
            outcome = _rewrite(product, lhs, rhs, emb)
        except Exception:
            continue
        if outcome and outcome not in seen:
            seen.add(outcome)
            outcomes.append(outcome)
            if len(outcomes) >= max_outcomes:
                break
    return tuple(outcomes)


def _chirality_compatible(lhs: Sequence[QueryMol], product: Mol,
                          embedding: Dict[int, Dict[int, int]]) -> bool:
    """LHS chirality filter: a template atom with a definite @/@@ must
    not contradict a definite parity on the matched product atom
    (unspecified on either side matches, rdchiral-permissive)."""
    for ci, comp in enumerate(lhs):
        m = embedding[ci]
        for qi, qa in enumerate(comp.atoms):
            if not qa.chiral:
                continue
            ap = product.atoms[m[qi]].parity
            if ap == PARITY_NONE:
                continue
            # parity comparison is only meaningful when the template
            # names every explicit neighbor of the matched atom
            nq = len([e for e in comp.worder.get(qi, []) if e != H_SLOT])
            if nq != product.degree(m[qi]):
                continue
            qp = _query_parity_on_mol(comp, qi, m)
            if qp != PARITY_NONE and qp != ap:
                return False
    return True


def _rewrite(product: Mol, lhs: Sequence[QueryMol], rhs: Sequence[QueryMol],
             embedding: Dict[int, Dict[int, int]]) -> Optional[str]:
    mol = product.copy()

    # map-number -> product atom index (via the LHS embedding)
    map_to_atom: Dict[int, int] = {}
    matched_atoms: Set[int] = set()
    for ci, comp in enumerate(lhs):
        m = embedding[ci]
        for qi, qa in enumerate(comp.atoms):
            matched_atoms.add(m[qi])
            if qa.atom_map:
                map_to_atom[qa.atom_map] = m[qi]

    # 1. remove bonds covered by the LHS pattern, remembering what was
    # there so net-unchanged bonds re-added by the RHS don't count as
    # edits (rdchiral-style chirality preservation for untouched atoms)
    removed_bonds: Dict[Tuple[int, int], Tuple[int, bool]] = {}
    for ci, comp in enumerate(lhs):
        m = embedding[ci]
        for a, b, _ in comp.bonds:
            u, v = m[a], m[b]
            bond = mol.bond_between(u, v)
            if bond is not None:
                removed_bonds[(min(u, v), max(u, v))] = (bond.order, bond.aromatic)
                mol.remove_bond(u, v)

    # 2. realize RHS atoms
    rhs_atom_to_mol: List[Dict[int, int]] = []
    rhs_mapped_atoms: Set[int] = set()
    for comp in rhs:
        lookup: Dict[int, int] = {}
        for qi, qa in enumerate(comp.atoms):
            if qa.atom_map and qa.atom_map in map_to_atom:
                idx = map_to_atom[qa.atom_map]
                atom = mol.atoms[idx]
                if qa.set_charge is not None:
                    atom.charge = qa.set_charge
                elif qa.element is not None:
                    atom.charge = 0  # bracket atom with no charge resets it
                if qa.set_hcount is not None:
                    atom.explicit_hs = qa.set_hcount
                else:
                    atom.explicit_hs = None  # recompute implicitly
                if qa.aromatic_hint is not None and not atom.aromatic:
                    atom.aromatic = False  # keep product aromaticity otherwise
                rhs_mapped_atoms.add(idx)
            else:
                if qa.element is None:
                    raise ReactionError("unmapped RHS atom without element")
                atom = Atom(z=qa.element,
                            charge=qa.set_charge or 0,
                            explicit_hs=qa.set_hcount,
                            aromatic=bool(qa.aromatic_hint))
                idx = mol.add_atom(atom)
            lookup[qi] = idx
        rhs_atom_to_mol.append(lookup)

    # 3. add RHS bonds
    changed_atoms: Set[int] = set()
    for comp, lookup in zip(rhs, rhs_atom_to_mol):
        for a, b, qb in comp.bonds:
            u, v = lookup[a], lookup[b]
            key = (min(u, v), max(u, v))
            existing = mol.bond_between(u, v)
            if existing is not None:
                removed_bonds[key] = (existing.order, existing.aromatic)
                mol.remove_bond(u, v)
            order, aromatic = _bond_from_query(
                qb, mol.atoms[u].aromatic, mol.atoms[v].aromatic)
            mol.add_bond(u, v, order, aromatic)
            if removed_bonds.pop(key, None) != (order, aromatic):
                changed_atoms.add(u)
                changed_atoms.add(v)
    # bonds removed and never re-added are net edits too
    for (u, v) in removed_bonds:
        changed_atoms.add(u)
        changed_atoms.add(v)
    # chirality at edited centers is no longer trustworthy unless the
    # template re-specifies it below
    for idx in changed_atoms:
        mol.atoms[idx].parity = PARITY_NONE
        mol.atoms[idx].ext_stereo = None
    for comp, lookup in zip(rhs, rhs_atom_to_mol):
        for qi, qa in enumerate(comp.atoms):
            if not qa.chiral:
                continue
            nq = len([e for e in comp.worder.get(qi, []) if e != H_SLOT])
            if nq != mol.degree(lookup[qi]):
                continue  # template doesn't name every neighbor
            p = _query_parity_on_mol(comp, qi, lookup)
            if p != PARITY_NONE:
                mol.atoms[lookup[qi]].parity = p

    # 4. LHS-matched atoms not carried into the RHS are deleted outright
    # (RDKit RunReactants semantics; their bonds vanish with them)
    removed = matched_atoms - rhs_mapped_atoms
    if removed:
        keep = [i for i in range(mol.n_atoms()) if i not in removed]
        mol = mol.subgraph(keep)

    # 5. fragments -> sanitized canonical reactants
    frags = mol.fragments()
    pieces: List[str] = []
    for frag in frags:
        sub = mol.subgraph(frag)
        try:
            smi = sanitize_and_write(sub)
        except SmilesError:
            return None
        if not smi:
            return None
        pieces.append(smi)
    if not pieces:
        return None
    return ".".join(sorted(pieces))


# rdchiral-compatible alias
def rdchiral_run_text(template: str, product_smiles: str) -> List[str]:
    return apply_retro_template(template, product_smiles)
