"""AND-OR search tree nodes for retrosynthesis planning.

Semantics follow Retro* (Chen et al. 2020) as used by the reference
planner (src/model/planner/mol_node.py, reaction_node.py — itself
adapted from github.com/binghong-ml/retro_star):

  molecule node (OR): value = min over child reactions' values
  reaction node (AND): value = cost + Σ child molecule values
  v_target(n): estimated total route cost through n given the whole tree
  succ_value: cost of the best *proven* route through the node

Host-side pure Python — the search is latency-bound on the expansion
policy (LLM + predictor), not on tree bookkeeping.
"""

import math
from typing import List, Optional, Set

INF = math.inf


class MoleculeNode:
    __slots__ = ("smiles", "pred_value", "value", "succ_value", "parent",
                 "depth", "is_known", "children", "succ", "open", "id")

    def __init__(self, smiles: str, init_value: float,
                 parent: Optional["ReactionNode"] = None,
                 is_known: bool = False, zero_known_value: bool = True):
        self.smiles = smiles
        self.pred_value = init_value
        self.value = init_value
        self.succ_value = INF
        self.parent = parent
        self.depth = parent.depth if parent is not None else 0
        self.is_known = is_known
        self.children: List["ReactionNode"] = []
        self.succ = is_known
        self.open = not is_known
        self.id = -1
        if is_known:
            if zero_known_value:
                self.value = 0.0
            self.succ_value = self.value
        if parent is not None:
            parent.children.append(self)

    def v_self(self) -> float:
        return self.value

    def v_target(self) -> float:
        return self.value if self.parent is None else self.parent.v_target()

    def init_values(self, no_child: bool = False) -> float:
        """Close the node after expansion; returns the value delta."""
        assert self.open and (no_child or self.children)
        new_value = INF
        self.succ = False
        for rxn in self.children:
            new_value = min(new_value, rxn.v_self())
            self.succ = self.succ or rxn.succ
        delta = new_value - self.value
        self.value = new_value
        if self.succ:
            for rxn in self.children:
                self.succ_value = min(self.succ_value, rxn.succ_value)
        self.open = False
        return delta

    def backup(self, succ: bool) -> None:
        assert not self.is_known
        new_value = INF
        for rxn in self.children:
            new_value = min(new_value, rxn.v_self())
        new_succ = self.succ or succ
        updated = (self.value != new_value) or (self.succ != new_succ)
        new_succ_value = INF
        if new_succ:
            for rxn in self.children:
                new_succ_value = min(new_succ_value, rxn.succ_value)
            updated = updated or (self.succ_value != new_succ_value)
        delta = new_value - self.value
        self.value = new_value
        self.succ = new_succ
        self.succ_value = new_succ_value
        if updated and self.parent is not None:
            self.parent.backup(delta, exclude_mol=self.smiles)

    def ancestor_smiles(self) -> Set[str]:
        if self.parent is None:
            return {self.smiles}
        out = self.parent.parent.ancestor_smiles()
        out.add(self.smiles)
        return out


class ReactionNode:
    __slots__ = ("parent", "depth", "cost", "template", "analysis_tokens",
                 "children", "value", "succ_value", "target_value", "succ",
                 "open", "id")

    def __init__(self, parent: MoleculeNode, cost: float,
                 template: Optional[str], analysis_tokens):
        self.parent = parent
        self.depth = parent.depth + 1
        self.cost = cost
        self.template = template
        self.analysis_tokens = analysis_tokens
        self.children: List[MoleculeNode] = []
        self.value: float = INF
        self.succ_value: float = INF
        self.target_value: float = INF
        self.succ: Optional[bool] = None
        self.open = True
        self.id = -1
        parent.children.append(self)

    def v_self(self) -> float:
        return self.value

    def v_target(self) -> float:
        return self.target_value

    def init_values(self) -> None:
        assert self.open
        self.value = self.cost
        self.succ = True
        for mol in self.children:
            self.value += mol.value
            self.succ = self.succ and mol.succ
        if self.succ:
            self.succ_value = self.cost + sum(m.succ_value for m in self.children)
        self.target_value = (self.parent.v_target() - self.parent.v_self()
                             + self.value)
        self.open = False

    def backup(self, delta: float, exclude_mol: Optional[str] = None) -> None:
        self.value += delta
        self.target_value += delta
        self.succ = all(m.succ for m in self.children)
        if self.succ:
            self.succ_value = self.cost + sum(m.succ_value for m in self.children)
        if delta != 0:
            assert exclude_mol is not None
            self._propagate(delta, exclude=exclude_mol)
        self.parent.backup(self.succ)

    def _propagate(self, delta: float, exclude: Optional[str] = None) -> None:
        if exclude is None:
            self.target_value += delta
        for mol in self.children:
            if exclude is None or mol.smiles != exclude:
                for grandchild in mol.children:
                    grandchild._propagate(delta)
