"""Dense-graph -> molecule assembly with correction fallbacks.

Behavioral counterpart of the reference's graph_to_smiles pipeline
(src/model/graph_decoder/molecule_utils.py:49-210):

  build          — atoms + upper-triangular bonds, +1 formal charge fix for
                   N/O/S one past their valence (molecule_utils.py:144-160)
  correct_mol    — repeatedly decrement the highest-order bond at the first
                   over-valent atom (molecule_utils.py:166-210)
  connect_fragments — greedy single-bond stitching of disconnected pieces
                   (molecule_utils.py:283-352)
  largest fragment + polymer '*' check (molecule_utils.py:39-47, 72-88)
"""

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import profiling
from .mol import Atom, Mol
from .periodic import CORRECTION_VALENCY, SYMBOL_TO_Z, max_allowed_valence
from .smiles import (SmilesError, canonical_smiles, mol_to_smiles,
                     parse_smiles, sanitize_and_write, sanitize_mol)

_rng = random.Random(0)

# graph_to_smiles counts each graph's terminal outcome as the counter
# assemble.<outcome> (utils/profiling.py): ok / write_failed /
# reparse_failed / fragment_too_small / polymer_reject / exception, and the
# non-terminal correction_failed (correct_mol gave up and the raw build
# went on through the cascade)


def build_molecule(
    atom_types: Sequence[int], edge_types: np.ndarray, atom_decoder: Sequence[str]
) -> Mol:
    """Assemble a Mol from sampled class indices.

    atom_types: [n] indices into atom_decoder (symbols).
    edge_types: [n, n] edge classes (0 none, 1/2/3 orders, 4 aromatic).
    """
    mol = Mol()
    for t in atom_types:
        sym = atom_decoder[int(t)]
        mol.add_atom(Atom(z=SYMBOL_TO_Z.get(sym, 0), aromatic=False))
    n = len(atom_types)
    edge_types = np.asarray(edge_types)
    for i in range(n):
        for j in range(i + 1, n):
            cls = int(edge_types[i, j])
            if cls <= 0:
                continue
            if cls == 4:
                mol.add_bond(i, j, 1, aromatic=True)
            else:
                mol.add_bond(i, j, min(cls, 3), aromatic=False)
            # formal-charge rescue: N/O/S exactly one over valence -> +1
            # (parity: molecule_utils.py:144-160)
            for idx in (i, j):
                a = mol.atoms[idx]
                if a.z in (7, 8, 16) and a.charge == 0:
                    v = mol.bond_order_sum(idx)
                    limit = CORRECTION_VALENCY.get(a.z)
                    if limit is not None and abs(v - (limit + 1)) < 0.26:
                        a.charge = 1
    return mol


def _first_valence_error(mol: Mol) -> Optional[Tuple[int, float]]:
    """Over-valent atom check on a copy-kekulized view.

    Aromatic bonds count 1.5; an atom fails when floor of its bond-order
    sum exceeds the max allowed valence for (element, charge).
    """
    for i, a in enumerate(mol.atoms):
        limit = max_allowed_valence(a.z, a.charge)
        if limit is None:
            continue
        total = mol.bond_order_sum(i) + (a.explicit_hs or 0)
        if total > limit + 1e-6:
            return i, total
    return None


def correct_mol(mol: Mol, connection: bool = False) -> Optional[Mol]:
    """Iteratively fix over-valent atoms by decrementing their
    highest-order non-aromatic bond; optionally connect fragments first.
    Returns a corrected copy or None when uncorrectable."""
    mol = mol.copy()
    guard = 0
    while True:
        guard += 1
        if guard > 4 * (mol.n_bonds() + 1):
            return None
        if connection:
            connected = connect_fragments(mol)
            if connected is None:
                return None
            mol = connected
        err = _first_valence_error(mol)
        if err is None:
            return mol
        idx, _ = err
        bonds = sorted(
            mol.bonds_of(idx),
            key=lambda b: (b.aromatic, -b.order),
        )
        fixed = False
        for b in bonds:
            if b.aromatic:
                continue  # aromatic bonds are not decremented (parity: queue[-1][1]==12 bail)
            if b.order > 1:
                b.order -= 1
            else:
                mol.remove_bond(b.a1, b.a2)
            fixed = True
            break
        if not fixed:
            return None


def connect_fragments(mol: Mol) -> Optional[Mol]:
    """Stitch disconnected fragments with single bonds between atoms that
    still have free valence. Returns None when impossible."""
    comps = mol.fragments()
    if len(comps) < 2:
        return mol
    combined = mol.subgraph(comps[0])
    for comp in comps[1:]:
        frag = mol.subgraph(comp)
        a1 = _atoms_with_free_valence(combined)
        a2 = _atoms_with_free_valence(frag)
        done = False
        for i in a1:
            for j in a2:
                trial = _try_join(combined, frag, i, j)
                if trial is not None:
                    combined = trial
                    done = True
                    break
            if done:
                break
        if not done:
            return None
    return combined


def _atoms_with_free_valence(mol: Mol) -> List[int]:
    out = []
    for i, a in enumerate(mol.atoms):
        if a.z <= 1:
            continue
        limit = max_allowed_valence(a.z, a.charge)
        if limit is None or mol.bond_order_sum(i) + (a.explicit_hs or 0) + 1 <= limit:
            out.append(i)
    return out


def _try_join(base: Mol, frag: Mol, i: int, j: int) -> Optional[Mol]:
    m = base.copy()
    offset = m.n_atoms()
    for a in frag.atoms:
        m.add_atom(a.copy())
    for b in frag.bonds:
        m.add_bond(b.a1 + offset, b.a2 + offset, b.order, b.aromatic)
    m.add_bond(i, j + offset, 1)
    if _first_valence_error(m) is None:
        return m
    return None


def mol_to_valid_smiles(mol: Mol) -> Optional[str]:
    """Sanitize + canonical write; None on failure. One fused native
    call on the stereo-free path (the copy is discarded, so the
    flags-not-updated contract of sanitize_and_write is moot)."""
    try:
        return sanitize_and_write(mol.copy())
    except SmilesError:
        return None


def check_polymer(smiles: str) -> bool:
    """'*' attachment points must yield a valid monomer when replaced by H
    (parity: molecule_utils.py:39-47)."""
    if "*" not in smiles:
        return True
    try:
        mol = parse_smiles(smiles, sanitize=False)
    except SmilesError:
        return False
    for a in mol.atoms:
        if a.z == 0:
            a.z = 1
            a.explicit_hs = 0
    try:
        sanitize_mol(mol)
        return True
    except SmilesError:
        return False


def graph_to_smiles(
    molecule_list: Sequence[Tuple[Sequence[int], np.ndarray]],
    atom_decoder: Sequence[str],
) -> List[Optional[str]]:
    """Convert sampled (atom_types, edge_types) graphs to SMILES with the
    reference's correction + largest-fragment + polymer-check cascade
    (molecule_utils.py:49-111)."""
    out: List[Optional[str]] = []
    for atom_types, edge_types in molecule_list:
        try:
            mol_init = build_molecule(atom_types, edge_types, atom_decoder)
            mol_conn = None
            for connection in (True, False):
                mol_conn = correct_mol(mol_init, connection=connection)
                if mol_conn is not None:
                    break
            if mol_conn is None:
                mol_conn = mol_init
                profiling.count("assemble.correction_failed")
            smiles = mol_to_valid_smiles(mol_conn)
            if not smiles:
                # last resort: write without sanitize (parity: raw MolToSmiles)
                try:
                    smiles = mol_to_smiles(mol_conn)
                except Exception:
                    smiles = None
            if not smiles:
                profiling.count("assemble.write_failed")
                out.append(None)
                continue
            try:
                mol = parse_smiles(smiles, sanitize=True)
            except SmilesError:
                profiling.count("assemble.reparse_failed")
                out.append(None)
                continue
            frags = mol.fragments()
            largest = max(frags, key=len)
            # single fragment: the subgraph is the whole mol and smiles
            # is already its canonical sanitize+write — skip the rework
            largest_smiles = (smiles if len(frags) == 1
                              else mol_to_valid_smiles(mol.subgraph(largest)))
            if largest_smiles and len(largest_smiles) > 1:
                if check_polymer(largest_smiles):
                    profiling.count("assemble.ok")
                    out.append(largest_smiles)
                else:
                    profiling.count("assemble.polymer_reject")
                    out.append(None)
            elif check_polymer(smiles):
                profiling.count("assemble.ok")
                out.append(smiles)
            else:
                # reaching here = the largest fragment was unusable AND
                # the whole-molecule spelling failed the polymer check;
                # classify by what blocked the largest-fragment path
                # (a polymer_reject arm here would be unreachable — the
                # usable-largest branch above owns that check)
                profiling.count("assemble.write_failed" if not largest_smiles
                                else "assemble.fragment_too_small")
                out.append(None)
        except Exception:
            profiling.count("assemble.exception")
            out.append(None)
    return out


def check_valid(smiles: Optional[str]) -> bool:
    """Parse+sanitize+rewrite round trip (parity: molecule_utils.py:212-219).
    One fused native call on the stereo-free path."""
    if not smiles:
        return False
    return bool(canonical_smiles(smiles))
