"""Retro*-style best-first AND-OR search
(parity: src/model/planner/molstar.py:9-76, mol_tree.py:10-129).

Dependency-injected exactly like the reference: expand_fn(smiles) ->
{"reactants": [..], "scores": [..], "templates": [..], "analysis": ..}
and value_fn(smiles, parent_reaction) -> float. The composite model
supplies both; unit tests use fakes (the one mockable seam, SURVEY §4d).
"""

import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger
from .nodes import INF, MoleculeNode, ReactionNode
from .route import SynthesisRoute

logger = get_logger(__name__)

# LLAMOLE_PLANNER_TRACE=1: per-round stderr timing of the multi-target
# search (expand/value wall split, item/fresh counts) — the tool that
# attributes Phase-2 planning-wall overruns to a stage instead of a guess
_TRACE = bool(os.environ.get("LLAMOLE_PLANNER_TRACE"))


class SearchTree:
    def __init__(self, target: str, known_mols, value_fn,
                 zero_known_value: bool = True,
                 value_cache: Optional[Dict[str, float]] = None):
        self.target = target
        self.known_mols = known_mols
        self.value_fn = value_fn
        self.zero_known_value = zero_known_value
        self.mol_nodes: List[MoleculeNode] = []
        self.reaction_nodes: List[ReactionNode] = []
        self.search_status = 0.0
        # value estimates depend only on the molecule (the LLM likert
        # prompt and CostMLP fingerprints are target-independent), so
        # concurrent searches may share one cache
        self.value_cache: Dict[str, float] = (
            value_cache if value_cache is not None else {})
        self.root = self._add_mol(target, None)
        self.succ = self.root.succ and False  # target-in-stock still searches
        if target in known_mols:
            logger.info("target is already purchasable; searching for a route anyway")

    def _add_mol(self, smiles: str, parent: Optional[ReactionNode]) -> MoleculeNode:
        if smiles in self.known_mols and self.zero_known_value:
            # MoleculeNode overwrites a known mol's value with 0.0 —
            # calling value_fn here was a sequential b1 LLM forward per
            # purchasable reactant (measured: the dominant Phase-2
            # per-round host stall on inventory-rich expansions)
            init_value = 0.0
        elif smiles in self.value_cache:
            init_value = self.value_cache[smiles]
        else:
            init_value = self.value_fn(smiles, parent)
            self.value_cache[smiles] = init_value
        node = MoleculeNode(
            smiles,
            init_value=init_value,
            parent=parent,
            is_known=smiles in self.known_mols,
            zero_known_value=self.zero_known_value)
        self.mol_nodes.append(node)
        node.id = len(self.mol_nodes)
        return node

    def next_open(self) -> Optional[MoleculeNode]:
        best = self.open_frontier(1)
        return best[0] if best else None

    def open_frontier(self, width: int) -> List[MoleculeNode]:
        """Up to `width` best open nodes by v_target (ascending)."""
        open_nodes = [(m.v_target(), i, m)
                      for i, m in enumerate(self.mol_nodes) if m.open]
        open_nodes.sort(key=lambda t: (t[0], t[1]))
        if open_nodes:
            self.search_status = open_nodes[0][0]
        return [m for _, _, m in open_nodes[:width]]

    def expand(self, node: MoleculeNode,
               reactant_lists: Optional[Sequence[Sequence[str]]],
               costs: Optional[Sequence[float]],
               templates: Optional[Sequence[Optional[str]]],
               analysis) -> bool:
        assert not node.is_known and not node.children
        if costs is None:  # expansion produced nothing
            node.init_values(no_child=True)
            if node.parent:
                node.parent.backup(INF, exclude_mol=node.smiles)
            return self.succ

        ancestors = node.ancestor_smiles()
        for cost, reactants, template in zip(costs, reactant_lists, templates):
            assert cost >= 0
            if any(r in ancestors for r in reactants):
                continue  # cycle
            rxn = ReactionNode(node, float(cost), template, analysis)
            for r in reactants:
                self._add_mol(r, rxn)
            rxn.init_values()
            self.reaction_nodes.append(rxn)
            rxn.id = len(self.reaction_nodes)

        if not node.children:
            node.init_values(no_child=True)
            if node.parent:
                node.parent.backup(INF, exclude_mol=node.smiles)
            return self.succ

        delta = node.init_values()
        if node.parent:
            node.parent.backup(delta, exclude_mol=node.smiles)
        if not self.succ and self.root.succ:
            logger.info("synthesis route found for %s", self.target)
            self.succ = True
        return self.succ

    def best_route(self) -> Optional[SynthesisRoute]:
        if not self.succ:
            return None
        route = SynthesisRoute(self.root.smiles, self.root.succ_value,
                               self.search_status)
        queue = deque([self.root])
        while queue:
            mol = queue.popleft()
            if mol.is_known:
                route.set_value(mol.smiles, mol.succ_value)
                continue
            best = None
            for rxn in mol.children:
                if rxn.succ and (best is None or rxn.succ_value < best.succ_value):
                    best = rxn
            assert best is not None and best.succ_value == mol.succ_value
            reactants = [c.smiles for c in best.children]
            queue.extend(best.children)
            route.add_reaction(mol.smiles, mol.succ_value, best.template,
                               best.analysis_tokens, reactants, best.cost)
        return route


def retro_star_search(
    target_smiles: str,
    known_mols,
    expand_fn: Callable[[str], Optional[Dict]],
    value_fn: Callable[[str, Optional[ReactionNode]], float],
    iterations: int = 100,
    max_time: float = 300.0,
    expansion_width: int = 1,
    batch_expand_fn: Optional[Callable[[List[str]], List[Optional[Dict]]]] = None,
    batch_value_fn: Optional[Callable[[List[str]], List[float]]] = None,
    decide: Optional[Callable[[Any], Any]] = None,
) -> Tuple[bool, Optional[SynthesisRoute], int]:
    """Returns (success, best_route, iterations_used).

    decide: on a mesh every rank runs this search in lockstep (each
    expansion is a collective), so the one decision a rank's own clock
    would make, stopping at the wall, is rank 0's: decide(value) returns
    rank 0's value on every rank (parallel/comm.py broadcast_object).
    The rest (the iteration budget, the frontier, the early stops) follows
    from the gathered results and the sorted orders here, alike on every
    rank.

    With expansion_width > 1 the search expands the W best open nodes per
    iteration via batch_expand_fn, amortizing device latency across the
    frontier (the reference scores one node at a time — SURVEY §7.7; the
    divergence changes expansion order, so parity is route success rate,
    not identical routes). batch_value_fn pre-scores all newly proposed
    reactant molecules in one call.
    """
    tree = SearchTree(target_smiles, known_mols, value_fn)
    start = time.time()
    used = 0
    if not tree.succ:
        for used in range(1, iterations + 1):
            stop = time.time() - start > max_time
            if decide is not None:
                stop = decide(stop)
            if stop:
                break
            nodes = tree.open_frontier(max(1, expansion_width))
            if not nodes:
                break

            if batch_expand_fn is not None and len(nodes) > 1:
                results = batch_expand_fn([n.smiles for n in nodes])
            else:
                results = [expand_fn(n.smiles) for n in nodes]

            # pre-score all fresh reactant molecules in one device call
            if batch_value_fn is not None:
                fresh = []
                for res in results:
                    if res:
                        for r in res.get("reactants", []):
                            for smi in set(r.split(".")):
                                if (smi not in tree.value_cache
                                        and smi not in tree.known_mols):
                                    fresh.append(smi)
                fresh = sorted(set(fresh))
                if fresh:
                    for smi, val in zip(fresh, batch_value_fn(fresh)):
                        tree.value_cache[smi] = float(val)

            done = False
            for node, result in zip(nodes, results):
                if not node.open:
                    continue  # a sibling expansion already closed it
                if result is not None and len(result.get("scores", [])) > 0:
                    scores = np.asarray(result["scores"], dtype=np.float64)
                    costs = -np.log(np.clip(scores, 1e-3, 1.0))
                    reactant_lists = [sorted(set(r.split(".")))
                                      for r in result["reactants"]]
                    done = tree.expand(node, reactant_lists, costs.tolist(),
                                       result["templates"], result["analysis"])
                    if done:
                        break
                else:
                    tree.expand(node, None, None, None, None)
            if done:
                break
            if tree.succ and tree.root.succ_value <= tree.search_status:
                break  # proven optimal

    route = tree.best_route() if tree.succ else None
    return tree.succ, route, used


def retro_star_search_multi(
    targets: Sequence[str],
    known_mols,
    batch_expand_fn: Callable[[List[Tuple[str, str]]], List[Optional[Dict]]],
    value_fn: Callable[[str, Optional[ReactionNode]], float],
    iterations: int = 100,
    max_time: float = 300.0,
    total_width: int = 8,
    batch_value_fn: Optional[Callable[[List[str]], List[float]]] = None,
    min_iters_per_target: int = 0,
    max_time_hard: Optional[float] = None,
    decide: Optional[Callable[[Any], Any]] = None,
) -> Dict[str, Tuple[bool, Optional[SynthesisRoute], int]]:
    """Interleaved Retro* over MANY targets sharing one device batch.

    The single-target search (above) batches its own frontier; Phase-2
    eval still ran one search per molecule sequentially, leaving the
    device idle while each tree's host bookkeeping ran. Here every
    iteration gathers up to `total_width` open nodes ACROSS all active
    trees into ONE batch_expand_fn call (items are (target, smiles)
    pairs so the caller can attach per-target design text), and value
    estimates share a single cache (they depend only on the molecule).

    Per-tree semantics match retro_star_search: same expansion rules,
    same proven-optimal early stop, per-tree iteration cap; `max_time`
    bounds the whole batch — all trees are active from t=0.
    composite.retrosynthesize_batch chooses the scaling: its default
    shared mode passes max_planning_time UNSCALED (one concurrent
    per-molecule wall); its share_planning_wall=False parity mode
    deliberately scales by unique-target count (reference engine
    budget). Change neither without updating
    test_batch_planning_wall_is_concurrent (it asserts both).
    Returns {target: (succ, route, iterations_used)}; duplicate targets
    collapse to one search.

    min_iters_per_target > 0 adds an EFFORT FLOOR to the shared wall:
    when the wall expires, trees that received fewer than that many
    expansions (and are neither finished nor iteration-capped) keep
    running in overtime — overtime rounds serve ONLY the lagging trees,
    so the floor is reached as fast as the width allows — bounded by
    max_time_hard (default max_time * n_targets, the reference's
    sequential engine budget, eval/workflow.py:172-173). This closes
    the shared-wall divergence where a large batch starves individual
    trees below the reference's delivered per-molecule effort.

    decide: as retro_star_search's; the wall's two decisions (overtime,
    stop) are rank 0's.
    """
    uniq = list(dict.fromkeys(targets))
    shared_cache: Dict[str, float] = {}
    # pre-score every root in ONE device call — building the trees
    # would otherwise trigger a sequential value_fn forward per target,
    # exactly the serialized idling this scheduler exists to remove
    if batch_value_fn is not None and uniq:
        for smi, val in zip(uniq, batch_value_fn(list(uniq))):
            shared_cache[smi] = float(val)
    trees = {t: SearchTree(t, known_mols, value_fn,
                           value_cache=shared_cache) for t in uniq}
    iters_used = {t: 0 for t in uniq}
    finished = {t: False for t in uniq}
    start = time.time()
    hard = (max_time_hard if max_time_hard is not None
            else max_time * max(1, len(uniq)))

    while True:
        elapsed = time.time() - start
        overtime = elapsed > max_time
        stop = overtime and (min_iters_per_target <= 0 or elapsed > hard)
        if decide is not None:
            overtime, stop = decide((overtime, stop))
        if stop:
            break
        active = []
        for t in uniq:
            if finished[t]:
                continue
            tr = trees[t]
            if iters_used[t] >= iterations:
                finished[t] = True
            elif tr.succ and tr.root.succ_value <= tr.search_status:
                finished[t] = True  # proven optimal
            elif overtime and iters_used[t] >= min_iters_per_target:
                continue  # past the wall: only lagging trees run
            else:
                active.append(t)
        if not active:
            break

        # total_width is a HARD cap on the device batch (it sizes the
        # expansion decode; exceeding it scales HBM with target count).
        # When active trees outnumber it, serve the least-served trees
        # this round — the iters_used sort round-robins across rounds.
        per = max(1, total_width // len(active))
        items: List[Tuple[str, MoleculeNode]] = []
        for t in sorted(active, key=lambda t: iters_used[t]):
            room = total_width - len(items)
            if room <= 0:
                break
            nodes = trees[t].open_frontier(min(per, room))
            if nodes:
                items.extend((t, n) for n in nodes)
            else:
                finished[t] = True  # no open nodes left
        if not items:
            continue

        t_exp = time.time()
        results = batch_expand_fn([(t, n.smiles) for t, n in items])
        t_exp = time.time() - t_exp

        t_val = time.time()
        n_fresh = 0
        if batch_value_fn is not None:
            fresh = sorted({
                smi
                for res in results if res
                for r in res.get("reactants", [])
                for smi in set(r.split("."))
                if smi not in shared_cache and smi not in known_mols})
            n_fresh = len(fresh)
            if fresh:
                for smi, val in zip(fresh, batch_value_fn(fresh)):
                    shared_cache[smi] = float(val)
        t_val = time.time() - t_val
        if _TRACE:
            import sys as _sys
            print(f"# planner round: {len(items)} items expand "
                  f"{t_exp:.1f}s, {n_fresh} fresh value {t_val:.1f}s, "
                  f"t={time.time() - start:.1f}/{max_time:.0f}s",
                  file=_sys.stderr, flush=True)

        counted = set()
        for (t, node), result in zip(items, results):
            if finished[t] or not node.open:
                continue
            if t not in counted:
                iters_used[t] += 1
                counted.add(t)
            tr = trees[t]
            if result is not None and len(result.get("scores", [])) > 0:
                scores = np.asarray(result["scores"], dtype=np.float64)
                costs = -np.log(np.clip(scores, 1e-3, 1.0))
                reactant_lists = [sorted(set(r.split(".")))
                                  for r in result["reactants"]]
                if tr.expand(node, reactant_lists, costs.tolist(),
                             result["templates"], result["analysis"]):
                    finished[t] = True
            else:
                tr.expand(node, None, None, None, None)

    return {t: (trees[t].succ,
                trees[t].best_route() if trees[t].succ else None,
                iters_used[t]) for t in uniq}


# reference-compatible alias (molstar.py:9 signature)
def molstar(target_mol, target_mol_id, starting_mols, expand_fn, value_fn,
            iterations, viz=False, viz_dir=None, max_time=300):
    return retro_star_search(target_mol, starting_mols, expand_fn, value_fn,
                             iterations=iterations, max_time=max_time)
