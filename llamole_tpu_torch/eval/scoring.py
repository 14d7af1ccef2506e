"""Generation-quality scores for the MolQA summary (counterpart of
llamole_tpu/eval/scoring.py): uniqueness, novelty against the gold
molecules, BLEU-4 / ROUGE against the gold responses, and FGD, the
Frechet distance between GraphCLIP-embedding Gaussians of the generated
and the gold molecules (the encoder runs kernel B on the card).
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llamole_tpu.chem.featurize import pad_graph_batch, smiles_to_graph
from llamole_tpu.chem.smiles import canonical_smiles
from llamole_tpu.data.aligner import extract_all_smiles

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


def oracle_property_metrics(oracle_path: str, results) -> Dict[str, Any]:
    raise NotImplementedError(
        f"property-oracle scoring ({oracle_path}) needs the oracle model "
        "and its checkpoint file, neither ported to llamole_tpu_torch yet "
        "(ROADMAP.md)")
