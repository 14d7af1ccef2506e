"""GraphDiT configuration + dataset statistics.

Re-declared from llamole_tpu/models/graphdit/config.py: that package's
__init__ imports JAX, and its config module imports PyYAML, which the
card's machine lacks. model_config.yaml is written and read here by
first-party code (utils/flat_yaml.py) for the flat mapping GraphDiTConfig
holds.
tests/test_torch_configs.py keeps the fields of both declarations equal.
"""

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ...utils.flat_yaml import dump_flat_yaml, load_flat_yaml

@dataclass
class GraphDiTConfig:
    max_n_nodes: int = 50
    hidden_size: int = 1024
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    drop_condition: float = 0.01
    Xdim: int = 16
    Edim: int = 5
    ydim: int = 10
    text_dim: int = 768
    diffusion_steps: int = 500
    # reverse steps taken at sampling time; < diffusion_steps strides the
    # schedule (llamole_tpu graphdit/config.py note)
    sampling_steps: Optional[int] = None
    noise_schedule: str = "cosine"
    guide_scale: float = 2.0
    lambda_train: Sequence[float] = (1.0, 5.0)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "GraphDiTConfig":
        with open(path) as f:
            raw = load_flat_yaml(f.read())
        raw.update(overrides)
        sched = raw.get("diffusion_noise_schedule", "cosine")
        if sched != "cosine":
            raise ValueError(
                f"unsupported diffusion_noise_schedule {sched!r} in "
                f"{path}: only 'cosine' is implemented")
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in raw.items() if k in names})

    def to_yaml(self, path: str) -> None:
        d = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in self.__dict__.items()}
        with open(path, "w") as f:
            f.write(dump_flat_yaml(d))


@dataclass
class DataInfo:
    """Dataset statistics backing the marginal transition model."""

    active_atoms: List[str]          # symbols, aligned with active_index order
    max_n_nodes: int
    n_nodes_dist: np.ndarray         # [max_n_nodes+1] histogram
    node_types: np.ndarray           # [118] atom-type mass (index = z-2 code)
    edge_types: np.ndarray           # [5] bond-class mass
    transition_E: np.ndarray         # [118, 118, 5] atom-pair bond counts
    valencies: Optional[np.ndarray] = None

    @property
    def active_index(self) -> np.ndarray:
        return np.nonzero(np.asarray(self.node_types) > 0)[0]

    @classmethod
    def load(cls, path: str) -> "DataInfo":
        meta_file = (path if path.endswith(".json")
                     else os.path.join(path, "data.meta.json"))
        with open(meta_file) as f:
            meta = json.load(f)
        return cls(
            active_atoms=meta["active_atoms"],
            max_n_nodes=int(meta["max_node"]),
            n_nodes_dist=np.asarray(meta["n_atoms_per_mol_dist"], np.float64),
            node_types=np.asarray(meta["atom_type_dist"], np.float64),
            edge_types=np.asarray(meta["bond_type_dist"], np.float64),
            transition_E=np.asarray(meta["transition_E"], np.float64),
            valencies=np.asarray(meta.get("valencies", []), np.float64),
        )

    def save(self, path: str) -> None:
        """<path>/data.meta.json, the layout `load` reads."""
        os.makedirs(path, exist_ok=True)
        meta = {
            "active_atoms": list(self.active_atoms),
            "max_node": int(self.max_n_nodes),
            "n_atoms_per_mol_dist": np.asarray(self.n_nodes_dist).tolist(),
            "bond_type_dist": np.asarray(self.edge_types).tolist(),
            "transition_E": np.asarray(self.transition_E).tolist(),
            "atom_type_dist": np.asarray(self.node_types).tolist(),
            "valencies": (np.asarray(self.valencies).tolist()
                          if self.valencies is not None else []),
        }
        with open(os.path.join(path, "data.meta.json"), "w") as f:
            json.dump(meta, f)

    def marginals(self):
        """Normalized (x_marginals[dx], e_marginals[de], xe[dx,de], ex[de,dx])."""
        act = self.active_index
        x_marg = np.asarray(self.node_types, dtype=np.float64)[act]
        x_marg = x_marg / x_marg.sum()
        e_marg = np.asarray(self.edge_types, dtype=np.float64)
        e_marg = e_marg / e_marg.sum()
        te = np.asarray(self.transition_E, dtype=np.float64)[act][:, act]
        xe = te.sum(axis=1)  # [dx, 5]
        ex = xe.T.copy()     # [5, dx]

        def _norm_rows(m):
            s = m.sum(axis=-1, keepdims=True)
            # classes unseen in the corpus get a uniform row
            uniform = np.full_like(m, 1.0 / m.shape[-1])
            return np.where(s > 0, m / np.clip(s, 1e-12, None), uniform)

        return x_marg, e_marg, _norm_rows(xe), _norm_rows(ex)


def build_data_info_from_smiles(
    smiles_list: Sequence[str], max_n_nodes: Optional[int] = None
) -> DataInfo:
    """DataInfo statistics from a molecule corpus (host side)."""
    from ...chem.featurize import smiles_to_graph
    from ...chem.periodic import Z_TO_SYMBOL
    from ...utils.constants import (ATOM_TYPE_OFFSET,
                                             WILDCARD_ATOM_TYPE)

    node_types = np.zeros(118, dtype=np.float64)
    edge_types = np.zeros(5, dtype=np.float64)
    transition_E = np.zeros((118, 118, 5), dtype=np.float64)
    sizes: List[int] = []
    for smi in smiles_list:
        g = smiles_to_graph(smi)
        if g is None:
            continue
        sizes.append(g.n_nodes)
        for t in g.atom_types:
            node_types[int(t)] += 1
        n = g.n_nodes
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                cls = int(g.edge_classes[i, j])
                edge_types[cls] += 1
                transition_E[int(g.atom_types[i]), int(g.atom_types[j]),
                             cls] += 1
    if not sizes:
        raise ValueError("no valid molecules in corpus")
    max_n = max_n_nodes or max(sizes)
    hist = np.zeros(max_n + 1, dtype=np.float64)
    for s in sizes:
        hist[min(s, max_n)] += 1
    symbols = ["*" if code == WILDCARD_ATOM_TYPE
               else Z_TO_SYMBOL.get(int(code) + ATOM_TYPE_OFFSET, "*")
               for code in np.nonzero(node_types > 0)[0]]
    return DataInfo(
        active_atoms=symbols,
        max_n_nodes=max_n,
        n_nodes_dist=hist,
        node_types=node_types,
        edge_types=edge_types,
        transition_E=transition_E,
    )
