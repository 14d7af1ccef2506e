"""Synthesis route container + serialization
(parity: src/model/planner/syn_route.py:6-88)."""

import math
from typing import Any, Dict, List, Optional, Tuple


class SynthesisRoute:
    def __init__(self, target_smiles: str, succ_value: float,
                 search_status: float):
        self.target_smiles = target_smiles
        self.mols: List[str] = [target_smiles]
        self.values: List[Optional[float]] = [None]
        self.templates: List[Optional[str]] = [None]
        self.parents: List[int] = [-1]
        self.children: List[Optional[List[int]]] = [None]
        self.costs: Dict[int, float] = {}
        self.analysis: Dict[int, Any] = {}
        self.succ_value = succ_value
        self.total_cost = 0.0
        self.length = 0
        self.optimal = succ_value <= search_status

    def set_value(self, smiles: str, value: float) -> None:
        self.values[self.mols.index(smiles)] = value

    def add_reaction(self, smiles: str, value: float, template: Optional[str],
                     analysis, reactants: List[str], cost: float) -> None:
        parent_id = self.mols.index(smiles)
        self.total_cost += cost
        self.length += 1
        self.values[parent_id] = value
        self.templates[parent_id] = template
        self.children[parent_id] = []
        self.costs[parent_id] = cost
        self.analysis[parent_id] = analysis
        for r in reactants:
            self.mols.append(r)
            self.values.append(None)
            self.templates.append(None)
            self.parents.append(parent_id)
            self.children.append(None)
            self.children[parent_id].append(len(self.mols) - 1)

    def _serialize_step(self, idx: int) -> Tuple[str, float, Any, Optional[str]]:
        kids = self.children[idx]
        reaction = (self.mols[idx] + ">>"
                    + ".".join(self.mols[k] for k in kids))
        score = math.exp(-self.costs[idx])
        return reaction, score, self.analysis[idx], self.templates[idx]

    def get_reaction_list(self):
        """Returns (reactions, templates, costs, analysis_list), root first
        (syn_route.py:70-86)."""
        reactions, scores, analyses, templates = [], [], [], []
        for idx in range(len(self.mols)):
            if self.children[idx] is not None:
                r, s, a, t = self._serialize_step(idx)
                reactions.append(r)
                scores.append(s)
                analyses.append(a)
                templates.append(t)
        return reactions, templates, scores, analyses
