"""SMILES -> dense padded tensors for the JAX graph models.

The reference featurizes through PyG sparse Data objects
(mmsupervised.py:55-135, modeling_llamole.py:720-760) and densifies
inside the model (diffusion_utils.py:111-124 to_dense). TPU-first, we
featurize straight to dense padded arrays on the host:

  atom type  = atomic_num - 2 (wildcard '*' -> 117), heavy atoms only
  edge class = BOND_INDEX {none:0, single:1, double:2, triple:3, aromatic:4}

A GraphSample is one molecule; batching pads to [B, N] / [B, N, N] with a
node-count mask, ready for jnp.asarray.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.constants import ATOM_TYPE_OFFSET, WILDCARD_ATOM_TYPE
from .mol import Mol
from .smiles import SmilesError, parse_smiles


@dataclass
class GraphSample:
    """One molecule as dense arrays (unpadded)."""

    atom_types: np.ndarray  # [n] int32, atomic_num - 2 (117 for '*')
    edge_classes: np.ndarray  # [n, n] int32, symmetric, 0 diag
    n_nodes: int

    @classmethod
    def from_mol(cls, mol: Mol) -> "GraphSample":
        heavy = [i for i, a in enumerate(mol.atoms) if a.z != 1]
        remap = {old: new for new, old in enumerate(heavy)}
        n = len(heavy)
        atom_types = np.zeros(n, dtype=np.int32)
        for old, new in remap.items():
            a = mol.atoms[old]
            atom_types[new] = WILDCARD_ATOM_TYPE if a.z == 0 else a.z - ATOM_TYPE_OFFSET
        edges = np.zeros((n, n), dtype=np.int32)
        for b in mol.bonds:
            if b.a1 in remap and b.a2 in remap:
                i, j = remap[b.a1], remap[b.a2]
                edges[i, j] = edges[j, i] = b.edge_class
        return cls(atom_types=atom_types, edge_classes=edges, n_nodes=n)


def smiles_to_graph(smiles: str, sanitize: bool = True) -> Optional[GraphSample]:
    """Parse + featurize; None for invalid SMILES
    (parity: modeling_llamole.py:720-760 smiles_to_graph)."""
    try:
        mol = parse_smiles(smiles, sanitize=sanitize)
    except SmilesError:
        return None
    if mol.n_atoms() == 0:
        return None
    return GraphSample.from_mol(mol)


def pad_graph_batch(
    samples: Sequence[GraphSample], max_nodes: int
) -> Dict[str, np.ndarray]:
    """Pad a list of GraphSamples to dense [B,N]/[B,N,N] arrays.

    Returns dict with 'atom_types' [B,N] i32, 'edge_classes' [B,N,N] i32,
    'node_mask' [B,N] bool. Graphs larger than max_nodes are truncated
    (callers bucket upstream so this is a safety valve).
    """
    bsz = len(samples)
    atom_types = np.zeros((bsz, max_nodes), dtype=np.int32)
    edge_classes = np.zeros((bsz, max_nodes, max_nodes), dtype=np.int32)
    node_mask = np.zeros((bsz, max_nodes), dtype=bool)
    for b, g in enumerate(samples):
        n = min(g.n_nodes, max_nodes)
        atom_types[b, :n] = g.atom_types[:n]
        edge_classes[b, :n, :n] = g.edge_classes[:n, :n]
        node_mask[b, :n] = True
    return {
        "atom_types": atom_types,
        "edge_classes": edge_classes,
        "node_mask": node_mask,
    }
