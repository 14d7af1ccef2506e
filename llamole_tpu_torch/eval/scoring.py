"""Generation-quality scores for the MolQA summary (counterpart of
llamole_tpu/eval/scoring.py): uniqueness, novelty against the gold
molecules, BLEU-4 / ROUGE against the gold responses, and FGD, the
Frechet distance between GraphCLIP-embedding Gaussians of the generated
and the gold molecules (the encoder runs kernel B on the card), and the
property oracle's per-channel fidelity of the generated molecules.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..chem.featurize import pad_graph_batch, smiles_to_graph
from ..chem.smiles import canonical_smiles
from ..data.aligner import extract_all_smiles
from ..utils.constants import MOL_PROPERTIES

from .metric import compute_text_metrics


def generation_set_metrics(results: List[Dict[str, Any]],
                           records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """uniqueness (distinct canonical / valid), novelty (distinct not among
    the gold molecules; None without gold outputs), text metrics against
    the gold responses (None likewise)."""
    canon = []
    for r in results:
        smi = r.get("llm_smiles")
        can = canonical_smiles(smi) if smi else None
        if can:
            canon.append(can)
    distinct = set(canon)
    out: Dict[str, Any] = {
        "uniqueness": len(distinct) / len(canon) if canon else None}
    gold_mols, gold_texts, preds = set(), [], []
    for rec, res in zip(records, results):
        gold = rec.get("output")
        if not gold:
            continue
        for s in extract_all_smiles(gold):
            can = canonical_smiles(s)
            if can:
                gold_mols.add(can)
        gold_texts.append(gold)
        preds.append(res.get("llm_response", ""))
    out["novelty"] = (sum(1 for c in distinct if c not in gold_mols)
                      / len(distinct) if distinct and gold_mols else None)
    out["text_metrics"] = (compute_text_metrics(preds, gold_texts)
                           if gold_texts else None)
    return out


@torch.no_grad()
def embed_molecules(encoder, smiles_list: List[str],
                    chunk: int = 128) -> np.ndarray:
    """[M, H] GraphCLIP embeddings of the parseable molecules (canonical
    spelling; unparseable inputs dropped), `chunk` graphs per call padded
    to the chunk's node count rounded up to 8."""
    graphs = []
    for s in smiles_list:
        can = canonical_smiles(s) if s else None
        g = smiles_to_graph(can) if can else None
        if g is not None:
            graphs.append(g)
    if not graphs:
        return np.zeros((0, 0), np.float32)
    dev = encoder.atom_encoder.device
    outs = []
    for start in range(0, len(graphs), chunk):
        part = graphs[start:start + chunk]
        n = ((max(g.n_nodes for g in part) + 7) // 8) * 8
        padded = pad_graph_batch(part, n)
        outs.append(encoder(
            torch.as_tensor(padded["atom_types"], device=dev),
            torch.as_tensor(padded["edge_classes"], device=dev),
            torch.as_tensor(padded["node_mask"], device=dev)
        ).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Frechet distance between two Gaussians; trace(sqrtm(C1 C2)) from
    the eigenvalues of the PSD product."""
    eig = np.linalg.eigvals(cov1 @ cov2)
    tr_covmean = float(np.sum(np.sqrt(np.clip(eig.real, 0.0, None))))
    return float(np.sum((mu1 - mu2) ** 2) + np.trace(cov1)
                 + np.trace(cov2) - 2.0 * tr_covmean)


def frechet_graphclip_distance(encoder, generated: List[str],
                               reference: List[str],
                               min_samples: int = 2) -> Optional[float]:
    """FGD of the generated against the reference molecules; None when
    either set has fewer than min_samples embeddable molecules."""
    a = embed_molecules(encoder, generated)
    b = embed_molecules(encoder, reference)
    if a.shape[0] < min_samples or b.shape[0] < min_samples:
        return None
    eps = 1e-6 * np.eye(a.shape[1])   # keeps small-sample covariances PSD
    return frechet_distance(a.mean(0), np.cov(a, rowvar=False) + eps,
                            b.mean(0), np.cov(b, rowvar=False) + eps)


def oracle_property_metrics(oracle_path: str, results: List[Dict[str, Any]],
                            device=None) -> Dict[str, Any]:
    """Generated molecules against their requested conditions through the
    trained oracle (loaded on `device`, the CPU by default): accuracy at
    0.5 for the binary channels, MAE in raw units for the continuous
    ones. Only records that requested a channel count for it."""
    from ..models.oracle import BINARY_CHANNELS, PropertyOracle

    oracle = PropertyOracle.from_pretrained(oracle_path, device=device)
    preds = oracle.predict_smiles([r.get("llm_smiles") or ""
                                   for r in results])
    per_channel: Dict[str, List] = {p: [] for p in MOL_PROPERTIES}
    for r, pred in zip(results, preds):
        if pred is None:
            continue
        for name, want in (r.get("property") or {}).items():
            if name in per_channel:
                per_channel[name].append(
                    (float(pred[MOL_PROPERTIES.index(name)]), float(want)))

    acc: Dict[str, float] = {}
    mae: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    binary_names = {MOL_PROPERTIES[c] for c in BINARY_CHANNELS}
    for name, pairs in per_channel.items():
        if not pairs:
            continue
        counts[name] = len(pairs)
        p = np.asarray([x for x, _ in pairs])
        w = np.asarray([y for _, y in pairs])
        if name in binary_names:
            acc[name] = float(((p > 0.5) == (w > 0.5)).mean())
        else:
            mae[name] = float(np.abs(p - w).mean())
    return {"property_accuracy": acc or None,
            "property_mae": mae or None,
            "property_scored_counts": counts or None}
