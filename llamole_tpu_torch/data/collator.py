"""Batch collation: token padding + dense graph batching with
precomputed scatter indices.

The reference collator (src/data/collator.py:31-165) builds three PyG
sparse batches and lets the model find token positions with nonzero()
at step time. TPU-first, the collator does all dynamic-shape work on
the host and hands the device fixed-shape arrays:

  tokens:        input_ids / attention_mask / labels       [B, L]
  molecule bank: atom_types [M, N], edge_classes [M, N, N],
                 node_mask [M, N], graph_valid [M],
                 mol_rows/mol_cols [M]  (token position of the m-th
                 <molecule> occurrence, row-major over the batch)
  design:        design_graph_index [B] (index into the bank of each
                 sequence's first molecule; -1 = none),
                 design_start_pos [B] (-1 = none)
  retro:         retro bank [R, N(,N)] + retro_rows/retro_cols [R],
                 retro_labels [R], retro_valid [R]
  properties:    [B, 10] float (NO_LABEL_INDEX = absent)

M, R, L, N are padded to caller-fixed maxima so every training step
compiles once.
"""

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np

from ..chem.featurize import GraphSample
from ..utils.constants import IGNORE_INDEX, NO_LABEL_INDEX


@dataclass
class SeqGraphCollator:
    tokenizer: Any
    mol_id_to_graph: Dict[int, GraphSample]
    max_len: int
    max_nodes: int
    max_graphs: int              # molecule-bank capacity per batch
    max_retro: int               # retro-product capacity per batch
    mol_token: str = "<molecule>"
    design_start_token: str = "<design_start>"
    retro_start_token: str = "<retro_start>"
    pad_to_multiple_of: int = 8

    def __post_init__(self):
        self.mol_token_id = self.tokenizer.token_to_id(self.mol_token)
        self.design_start_id = self.tokenizer.token_to_id(self.design_start_token)
        self.retro_start_id = self.tokenizer.token_to_id(self.retro_start_token)

    def _pad_len(self, longest: int) -> int:
        m = self.pad_to_multiple_of
        return min(self.max_len, ((longest + m - 1) // m) * m)

    def __call__(self, features: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        bsz = len(features)
        length = self._pad_len(max(len(f["input_ids"]) for f in features))
        pad_id = self.tokenizer.pad_token_id

        input_ids = np.full((bsz, length), pad_id, np.int32)
        attention_mask = np.zeros((bsz, length), np.int32)
        labels = np.full((bsz, length), IGNORE_INDEX, np.int32)
        properties = np.full((bsz, 10), float(NO_LABEL_INDEX), np.float32)

        n = self.max_nodes
        bank_atoms = np.zeros((self.max_graphs, n), np.int32)
        bank_edges = np.zeros((self.max_graphs, n, n), np.int32)
        bank_mask = np.zeros((self.max_graphs, n), bool)
        bank_valid = np.zeros(self.max_graphs, bool)
        mol_rows = np.zeros(self.max_graphs, np.int32)
        mol_cols = np.zeros(self.max_graphs, np.int32)

        design_graph_index = np.full(bsz, -1, np.int32)
        design_start_pos = np.full(bsz, -1, np.int32)

        retro_atoms = np.zeros((self.max_retro, n), np.int32)
        retro_edges = np.zeros((self.max_retro, n, n), np.int32)
        retro_mask = np.zeros((self.max_retro, n), bool)
        retro_rows = np.zeros(self.max_retro, np.int32)
        retro_cols = np.zeros(self.max_retro, np.int32)
        retro_labels = np.full(self.max_retro, NO_LABEL_INDEX, np.int32)
        retro_valid = np.zeros(self.max_retro, bool)

        def put_graph(bank_a, bank_e, bank_m, slot: int, g: GraphSample):
            k = min(g.n_nodes, n)
            bank_a[slot, :k] = g.atom_types[:k]
            bank_e[slot, :k, :k] = g.edge_classes[:k, :k]
            bank_m[slot, :k] = True

        m_used = 0
        r_used = 0
        for b, f in enumerate(features):
            ids = list(f["input_ids"])[:length]
            input_ids[b, :len(ids)] = ids
            attention_mask[b, :len(ids)] = 1
            labs = list(f.get("labels", []))[:length]
            labels[b, :len(labs)] = labs
            props = f.get("molecule_properties")
            if props is not None:
                properties[b, :len(props)] = [
                    float(NO_LABEL_INDEX) if p is None else float(p) for p in props]

            # molecule bank, in token order
            mol_ids = list(f.get("molecule_ids", []))
            positions = [i for i, t in enumerate(ids) if t == self.mol_token_id]
            for pos_idx, (tok_pos, mol_id) in enumerate(zip(positions, mol_ids)):
                if m_used >= self.max_graphs:
                    break
                g = self.mol_id_to_graph.get(mol_id)
                if g is None:
                    continue
                put_graph(bank_atoms, bank_edges, bank_mask, m_used, g)
                bank_valid[m_used] = True
                mol_rows[m_used] = b
                mol_cols[m_used] = tok_pos
                if pos_idx == 0:
                    design_graph_index[b] = m_used
                m_used += 1

            ds = [i for i, t in enumerate(ids) if t == self.design_start_id]
            if ds:
                design_start_pos[b] = ds[0]

            # retro products (one per <retro_start>, aligned by order)
            r_positions = [i for i, t in enumerate(ids) if t == self.retro_start_id]
            r_ids = list(f.get("retro_product_ids", []))
            r_labels = list(f.get("retro_labels", []))
            for tok_pos, mol_id, lab in zip(r_positions, r_ids, r_labels):
                if r_used >= self.max_retro:
                    break
                g = self.mol_id_to_graph.get(mol_id)
                if g is None or lab == NO_LABEL_INDEX or lab == IGNORE_INDEX:
                    continue
                put_graph(retro_atoms, retro_edges, retro_mask, r_used, g)
                retro_rows[r_used] = b
                retro_cols[r_used] = tok_pos
                retro_labels[r_used] = lab
                retro_valid[r_used] = True
                r_used += 1

        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
            "molecule_properties": properties,
            "mol_atoms": bank_atoms, "mol_edges": bank_edges,
            "mol_node_mask": bank_mask, "mol_valid": bank_valid,
            "mol_rows": mol_rows, "mol_cols": mol_cols,
            "design_graph_index": design_graph_index,
            "design_start_pos": design_start_pos,
            "retro_atoms": retro_atoms, "retro_edges": retro_edges,
            "retro_node_mask": retro_mask, "retro_rows": retro_rows,
            "retro_cols": retro_cols, "retro_labels": retro_labels,
            "retro_valid": retro_valid,
        }
