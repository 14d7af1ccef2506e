"""Element data and the valence model.

Covers the elements that occur in MolQA/USPTO molecule corpora; exotic
elements parse in bracket form with an unconstrained valence.
"""

from typing import Dict, List, Optional

# fmt: off
SYMBOLS = [
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
]
# fmt: on

# '*' wildcard gets atomic number 0
SYMBOL_TO_Z: Dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}
Z_TO_SYMBOL: Dict[int, str] = {i: s for i, s in enumerate(SYMBOLS)}

# Default valence lists (RDKit-style). An atom with no explicit H count
# gets implicit hydrogens filling up to the smallest listed valence that
# covers its bond-order sum. Elements not listed are unconstrained (-1).
DEFAULT_VALENCES: Dict[int, List[int]] = {
    1: [1],            # H
    5: [3],            # B
    6: [4],            # C
    7: [3],            # N
    8: [2],            # O
    9: [1],            # F
    14: [4],           # Si
    15: [3, 5],        # P
    16: [2, 4, 6],     # S
    17: [1],           # Cl
    33: [3, 5],        # As
    34: [2, 4, 6],     # Se
    35: [1],           # Br
    53: [1],           # I
}

# Organic subset: atoms writable without brackets in SMILES.
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}

# Elements that may carry the aromatic (lowercase) flag in SMILES.
AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

# Max-valence table used by the molecule-correction loop
# (parity with molecule_utils.py:35 ATOM_VALENCY).
CORRECTION_VALENCY: Dict[int, int] = {6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1, 35: 1, 53: 1}

# Electronegative enough to hold a negative charge etc. — used by
# aromaticity electron counting.
_PI_DONORS = {7, 8, 16, 15, 34}  # N, O, S, P, Se can donate a lone pair


def default_valences(z: int, charge: int = 0) -> Optional[List[int]]:
    """Allowed total valences for element ``z`` at ``charge``.

    Returns None when the element is unconstrained (metals, wildcard).
    Charge shifts follow the usual isoelectronic rule for the common
    organic elements: N+ behaves like C (4), O- like F (1), etc.
    """
    base = DEFAULT_VALENCES.get(z)
    if base is None or z == 0:
        return None
    if charge == 0:
        return list(base)
    if z in (7, 15):  # N, P cations gain a bond; anions lose one
        return [max(0, v + charge) for v in base] if abs(charge) == 1 else None
    if z in (8, 16, 34):  # O, S, Se
        return [max(0, v + charge) for v in base] if abs(charge) == 1 else None
    if z == 6:  # carbanion / carbocation both trivalent
        return [max(0, max(base) - abs(charge))] if abs(charge) == 1 else None
    if z == 5:  # B- is tetravalent
        return [v - charge for v in base] if abs(charge) == 1 else None
    if z in (9, 17, 35, 53):
        if charge < 0:
            return [0]
        return [max(0, v + charge) for v in base]
    return None


def max_allowed_valence(z: int, charge: int = 0) -> Optional[int]:
    vals = default_valences(z, charge)
    if vals is None:
        return None
    return max(vals)
