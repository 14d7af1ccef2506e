"""Morgan (ECFP-style) bit fingerprints.

Feature source for the neural cost model (reference:
graph_predictor/model.py:375-385 uses RDKit GetMorganFingerprintAsBitVect
radius 2, 2048 bits). Same construction — iterative neighborhood hashing
folded into a fixed-width bit vector — with our own hash, so bits are
internally consistent but not RDKit-bit-identical (the cost MLP is
trained against these features, not RDKit's).
"""

from typing import List, Optional

import numpy as np

from .mol import Mol
from .smiles import SmilesError, parse_smiles

_MASK = (1 << 61) - 1


def _mix(*vals: int) -> int:
    h = 0xCBF29CE484222325
    for v in vals:
        v &= _MASK
        while True:
            h ^= v & 0xFF
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            v >>= 8
            if v == 0:
                break
        h ^= 0xFF
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def morgan_fingerprint(
    smiles_or_mol, radius: int = 2, n_bits: int = 2048,
    use_native: bool = True,
) -> Optional[np.ndarray]:
    """ECFP-like fingerprint as a bool vector; None for invalid input.

    Dispatches to the chemkit C++ kernel when built (bit-identical to
    the Python path — tests/test_native.py)."""
    if isinstance(smiles_or_mol, Mol):
        mol = smiles_or_mol
    else:
        try:
            mol = parse_smiles(str(smiles_or_mol), sanitize=True)
        except SmilesError:
            return None

    if use_native:
        from ._native import morgan_bits
        bits = morgan_bits(mol, radius, n_bits)
        if bits is not None:
            return bits

    n = mol.n_atoms()
    ring = mol.ring_membership()
    ids: List[int] = []
    for i, a in enumerate(mol.atoms):
        ids.append(
            _mix(
                a.z,
                a.charge + 16,
                mol.degree(i),
                mol.total_hs(i),
                int(round(mol.bond_order_sum(i) * 2)),
                int(ring[i]),
                int(a.aromatic),
            )
        )
    bits = set(ids)
    for _ in range(radius):
        new_ids = list(ids)
        for i in range(n):
            env = sorted(
                (int(round(mol.bonds[bidx].valence_contrib() * 2)), ids[w])
                for w, bidx in mol._adj[i].items()
            )
            flat = [ids[i]]
            for order, nid in env:
                flat.extend((order, nid))
            new_ids[i] = _mix(*flat)
        ids = new_ids
        bits.update(ids)

    arr = np.zeros(n_bits, dtype=bool)
    for b in bits:
        arr[b % n_bits] = True
    return arr
