"""Graph-module pretraining (counterpart of llamole_tpu/train/pretrain.py).

Given a MolQA-format corpus (data/synthetic.write_corpus writes one)
these loops train, each saving in the JAX package's pretrained layout so
the loader (and the JAX package) reads the output directory:

  * GraphDiT: denoising CE over noised molecule graphs, property
    conditioning from the records, text dropped (NaN -> the learned null
    embedding)
  * GraphPredictor: reaction-template classification on (product graph,
    label) pairs from the records' retro annotations
  * PropertyOracle: masked BCE + MSE on the records' property labels
  * GraphCLIP: symmetric InfoNCE between the GIN graph tower and a hashed
    bag-of-words text tower over each record's prose
  * CostMLP: fingerprint -> route steps still to go

The GIN modules (predictor, oracle trunk, GraphCLIP) run kernel B forward
and kernel C backward in every layer on the card. As in the JAX package:
the batches come from random.Random(seed) on the host; the optimizer is
optax.adamw(lr) (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
leaf, no clipping), computed by train/optimizers.AccumulatingAdamW; the
learning rate is constant, except GraphDiT's warmup-cosine schedule. The
weights are drawn from a torch.Generator seeded `seed` (the JAX package
draws from PRNGKey(seed): same distributions, other values), and so is
GraphDiT's noise. Each function returns the JAX metrics (first / final
loss over 20 steps) plus every step's loss under "losses".
"""

import json
import math
import os
import random
import re
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..chem.featurize import GraphSample, pad_graph_batch, smiles_to_graph
from ..data.aligner import extract_all_smiles, extract_retro_products
from ..models.graphclip.model import GraphCLIP, GraphCLIPConfig
from ..ops.nn import dense, gelu, init_dense_
from ..utils.constants import MOL_PROPERTIES, NO_LABEL_INDEX
from ..utils.logging import get_logger
from .optimizers import AccumulatingAdamW, warmup_cosine_decay_schedule

logger = get_logger(__name__)

# optax.adamw's defaults
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8


def _load_corpus(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return json.load(f)


def _device(device) -> torch.device:
    from ..serve import resolve_device
    return resolve_device(device)


def _init(module: nn.Module, seed: int, **kwargs) -> None:
    """The module's initial weights, drawn on its device from a generator
    seeded `seed` (the module's reset_parameters)."""
    dev = next(module.parameters()).device
    module.reset_parameters(torch.Generator(device=dev).manual_seed(seed),
                            **kwargs)


def _adamw(module: nn.Module, schedule: Callable[[int], float]
           ) -> AccumulatingAdamW:
    """optax.adamw(schedule) over every parameter of `module`: a leaf
    without a gradient still decays (its gradient counts as zero)."""
    return AccumulatingAdamW(dict(module.named_parameters()), schedule,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
                             max_grad_norm=math.inf)


def _step(opt: AccumulatingAdamW, loss_fn: Callable[[], torch.Tensor]):
    """One optimizer step on loss_fn(); returns the loss (a host float)
    and whatever else loss_fn returned."""
    for p in opt.params.values():
        p.grad = None
    out = loss_fn()
    loss, aux = (out if isinstance(out, tuple) else (out, None))
    loss.backward()
    opt.accumulate()
    return float(loss.detach()), aux


def _graph_tensors(graphs: List[GraphSample], n: int, device):
    padded = pad_graph_batch(graphs, n)
    return tuple(torch.from_numpy(padded[k]).to(device)
                 for k in ("atom_types", "edge_classes", "node_mask"))


def _metrics(losses: List[float], **extra) -> Dict[str, Any]:
    return {"final_loss": float(np.mean(losses[-20:])),
            "first_loss": float(np.mean(losses[:20])), **extra,
            "losses": list(losses)}


def _log(what: str, step: int, steps: int, losses: List[float]) -> None:
    if (step + 1) % max(steps // 10, 1) == 0:
        logger.info("%s pretrain step %d/%d loss %.4f", what, step + 1,
                    steps, np.mean(losses[-20:]))


def _molecule_rows(records) -> List[Tuple[GraphSample, np.ndarray]]:
    """(graph, property vector) per designed molecule."""
    rows = []
    for rec in records:
        smiles = extract_all_smiles(rec.get("output", ""))
        if not smiles:
            continue
        g = smiles_to_graph(smiles[0])
        if g is None:
            continue
        props = np.full(10, float(NO_LABEL_INDEX), np.float32)
        for i, name in enumerate(MOL_PROPERTIES):
            if name in (rec.get("property") or {}):
                props[i] = float(rec["property"][name])
        rows.append((g, props))
    return rows


def _retro_rows(records) -> List[Tuple[GraphSample, int]]:
    """(product graph, template label) per labelled retro step."""
    rows = []
    for rec in records:
        products = extract_retro_products(rec.get("output", ""))
        labels = rec.get("retro") or []
        for smi, lab in zip(products, labels):
            if lab is None:
                continue
            g = smiles_to_graph(smi)
            if g is not None:
                rows.append((g, int(lab)))
    return rows


def _bucket(rows) -> int:
    """The largest graph's node count rounded up to 8."""
    n = max(g.n_nodes for g, _ in rows)
    return ((n + 7) // 8) * 8


def pretrain_graphdit(
    corpus_path: str, output_dir: str, *, hidden_size: int = 256,
    depth: int = 6, num_heads: int = 8, diffusion_steps: int = 100,
    batch_size: int = 32, steps: int = 500, learning_rate: float = 2e-4,
    seed: int = 0, max_n_nodes: Optional[int] = None, device="cuda",
) -> Dict[str, Any]:
    """Train a GraphDiT from scratch on a MolQA corpus and save it
    (model.msgpack + model_config.yaml + data.meta.json), so that
    graph_decoder_path can point at output_dir."""
    from ..models.graphdit import GraphDiT, GraphDiTConfig
    from ..models.graphdit.config import build_data_info_from_smiles

    device = _device(device)
    records = _load_corpus(corpus_path)
    all_smiles = sorted({s for rec in records
                         for s in extract_all_smiles(rec.get("output", ""))})
    info = build_data_info_from_smiles(all_smiles, max_n_nodes=max_n_nodes)
    cfg = GraphDiTConfig(hidden_size=hidden_size, depth=depth,
                         num_heads=num_heads, diffusion_steps=diffusion_steps,
                         guide_scale=2.0)
    model = GraphDiT(cfg, info, device=device)
    _init(model.denoiser, seed)
    rows = _molecule_rows(records)
    if not rows:
        raise ValueError("no trainable molecules in corpus")
    n = cfg.max_n_nodes

    opt = _adamw(model.denoiser, warmup_cosine_decay_schedule(
        learning_rate, max(steps // 20, 1), steps))
    noise = torch.Generator(device=device).manual_seed(seed)
    shuffler = random.Random(seed)
    txt = torch.full((batch_size, cfg.text_dim), float("nan"), device=device)
    losses: List[float] = []
    for step in range(steps):
        batch = [rows[shuffler.randrange(len(rows))]
                 for _ in range(batch_size)]
        atoms, edges, mask = _graph_tensors([g for g, _ in batch], n, device)
        props = torch.from_numpy(np.stack([p for _, p in batch])).to(device)
        loss, _ = _step(opt, lambda: model.loss(noise, atoms, edges, mask,
                                                props, txt, train=True))
        losses.append(loss)
        _log("graphdit", step, steps, losses)

    model.save_pretrained(output_dir)
    metrics = _metrics(losses)
    logger.info("graphdit pretraining done: final %.4f first %.4f",
                metrics["final_loss"], metrics["first_loss"])
    return metrics


def pretrain_predictor(
    corpus_path: str, output_dir: str, *, hidden_size: int = 128,
    num_layer: int = 3, batch_size: int = 32, steps: int = 300,
    learning_rate: float = 1e-3, seed: int = 0,
    label_to_template: Optional[Dict[int, str]] = None,
    available: Optional[List[str]] = None, device="cuda",
) -> Dict[str, Any]:
    """Train the retro template classifier on (product, label) pairs.
    Labels are remapped to a dense range and label_to_template (saved
    with the model) follows the remap. The corpus sidecars
    <base>.templates.json (label -> template) and <base>.inventory.json
    (the purchasable leaves, saved as available.csv.gz) fill the two
    when they are not given."""
    from ..models.retro import GraphPredictor, GraphPredictorConfig

    device = _device(device)
    base = os.path.splitext(corpus_path)[0]
    if label_to_template is None and os.path.exists(base + ".templates.json"):
        with open(base + ".templates.json") as f:
            label_to_template = {int(k): v for k, v in json.load(f).items()}
        logger.info("predictor: %d templates from corpus sidecar",
                    len(label_to_template))
    if available is None and os.path.exists(base + ".inventory.json"):
        with open(base + ".inventory.json") as f:
            available = json.load(f)
        logger.info("predictor: %d-block inventory from corpus sidecar",
                    len(available))

    rows = _retro_rows(_load_corpus(corpus_path))
    if not rows:
        raise ValueError("no labeled retro steps in corpus")
    raw_labels = sorted({lab for _, lab in rows})
    remap = {lab: i for i, lab in enumerate(raw_labels)}
    rows = [(g, remap[lab]) for g, lab in rows]
    n = _bucket(rows)

    cfg = GraphPredictorConfig(num_layer=num_layer, hidden_size=hidden_size,
                               out_dim=len(raw_labels))
    l2t = {remap[lab]: (label_to_template or {}).get(lab, "")
           for lab in raw_labels}
    model = GraphPredictor(cfg, label_to_template=l2t, available=available,
                           device=device)
    _init(model, seed)
    opt = _adamw(model, lambda count: learning_rate)

    def loss_fn(atoms, edges, mask, labels):
        logits = model(atoms, edges, mask, None)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()

    shuffler = random.Random(seed)
    losses: List[float] = []
    for step in range(steps):
        batch = [rows[shuffler.randrange(len(rows))]
                 for _ in range(batch_size)]
        graph = _graph_tensors([g for g, _ in batch], n, device)
        labels = torch.tensor([lab for _, lab in batch], device=device)
        loss, _ = _step(opt, lambda: loss_fn(*graph, labels))
        losses.append(loss)
        _log("predictor", step, steps, losses)

    model.save_pretrained(output_dir)
    metrics = _metrics(losses)
    logger.info("predictor pretraining done: final %.4f first %.4f",
                metrics["final_loss"], metrics["first_loss"])
    return metrics


def pretrain_property_oracle(
    corpus_path: str, output_dir: str, *, num_layer: int = 3,
    hidden_size: int = 128, batch_size: int = 32, steps: int = 300,
    learning_rate: float = 1e-3, seed: int = 0, device="cuda",
) -> Dict[str, Any]:
    """Train the property oracle (models/oracle.py) on the corpus'
    molecule / property labels: BCE on the binary channels, MSE on the
    standardised continuous ones. eval reads the saved directory through
    ModelArguments.property_oracle_path."""
    from ..models.oracle import (CONTINUOUS_CHANNELS, PropertyOracle,
                                 PropertyOracleConfig)

    device = _device(device)
    rows = [(g, p) for g, p in _molecule_rows(_load_corpus(corpus_path))
            if np.any(p > float(NO_LABEL_INDEX) + 1.0)]
    if not rows:
        raise ValueError("no property-labeled molecules in corpus")
    n = _bucket(rows)

    # continuous-channel standardisation from the observed labels, only
    # where a channel has enough of them for a stable scale
    y_mean = np.zeros(len(MOL_PROPERTIES), np.float32)
    y_std = np.ones(len(MOL_PROPERTIES), np.float32)
    labels = np.stack([p for _, p in rows])
    for c in CONTINUOUS_CHANNELS:
        vals = labels[:, c][labels[:, c] > float(NO_LABEL_INDEX) + 1.0]
        if vals.size >= 8:
            y_mean[c] = float(vals.mean())
            y_std[c] = float(max(vals.std(), 0.05))

    model = PropertyOracle(PropertyOracleConfig(
        num_layer=num_layer, hidden_size=hidden_size), device=device)
    _init(model, seed, y_mean=y_mean, y_std=y_std)
    opt = _adamw(model, lambda count: learning_rate)

    shuffler = random.Random(seed)
    losses: List[float] = []
    for step in range(steps):
        batch = [rows[shuffler.randrange(len(rows))]
                 for _ in range(min(batch_size, len(rows)))]
        graph = _graph_tensors([g for g, _ in batch], n, device)
        targets = torch.from_numpy(np.stack([p for _, p in batch])
                                   ).to(device)
        loss, _ = _step(opt, lambda: model.loss(*graph, targets))
        losses.append(loss)
        _log("oracle", step, steps, losses)

    model.save_pretrained(output_dir)
    metrics = _metrics(losses)
    logger.info("property-oracle pretraining done: final %.4f first %.4f",
                metrics["final_loss"], metrics["first_loss"])
    return metrics


# -- GraphCLIP contrastive pretraining ----------------------------------

_MOL_SPAN_RE = re.compile(r"<mol_start>.*?<mol_end>", re.DOTALL)
_SPECIAL_TOKEN_RE = re.compile(r"<[a-z_]+>")
_WORD_RE = re.compile(r"[a-z0-9]+")


def hash_text_features(texts: List[str], dim: int) -> np.ndarray:
    """[len(texts), dim] L2-normalised hashed bag-of-words features
    (lowercased unigrams + bigrams, crc32: stable across processes)."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        words = _WORD_RE.findall(text.lower())
        grams = words + [f"{a}_{b}" for a, b in zip(words, words[1:])]
        for g in grams:
            out[i, zlib.crc32(g.encode()) % dim] += 1.0
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.clip(norm, 1e-12, None)


class TextTower(nn.Module):
    """The hashed-feature text tower: fc1 -> GELU -> fc2 (the JAX
    {"fc1", "fc2"} dense tree)."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, hidden, device=device)


def apply_text_tower(text: TextTower, feats: torch.Tensor) -> torch.Tensor:
    """Hashed BoW features -> unit-norm embeddings in the graph-tower
    space."""
    x = dense(feats, text.fc1.weight, text.fc1.bias)
    x = dense(gelu(x), text.fc2.weight, text.fc2.bias)
    norm = x.float().norm(dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12)


class ClipPair(nn.Module):
    """GraphCLIP pretraining's parameters: the graph tower, the text
    tower and the learnable temperature (the JAX {"graph", "text",
    "logit_scale"} tree)."""

    def __init__(self, cfg: GraphCLIPConfig, text_hash_dim: int,
                 device=None):
        super().__init__()
        self.graph = GraphCLIP(cfg, device=device)
        self.text = TextTower(text_hash_dim, cfg.hidden_size, device=device)
        self.logit_scale = nn.Parameter(torch.zeros((), device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.graph.reset_parameters(generator)
        init_dense_(self.text.fc1, generator)
        init_dense_(self.text.fc2, generator)
        self.logit_scale.fill_(float(np.float32(np.log(1.0 / 0.07))))


def _smiles_like(token: str) -> bool:
    """A raw SMILES / reaction token in prose: a reaction arrow, or a
    token that parses and is not a plain lowercase word."""
    from ..chem.smiles import canonical_smiles

    if ">>" in token:
        return True
    if token.islower() and token.isalpha():
        return False
    return canonical_smiles(token) is not None


def _strip_molecule_text(text: str) -> str:
    """Drop SMILES spans, special tokens and free-standing SMILES tokens:
    only natural language reaches the text tower."""
    text = _SPECIAL_TOKEN_RE.sub(" ", _MOL_SPAN_RE.sub(" ", text))
    kept = []
    for tok in text.split():
        bare = tok.strip(".,:;!?()")
        if bare and _smiles_like(bare):
            continue
        kept.append(tok)
    return " ".join(kept)


def _clip_rows(records) -> List[Tuple[GraphSample, str]]:
    """(graph, description) per record: the designed molecule, spelt
    canonically and deduplicated (in-batch negatives are then true
    negatives), with the record's stripped prose."""
    from ..chem.smiles import canonical_smiles

    rows: List[Tuple[GraphSample, str]] = []
    seen = set()
    for rec in records:
        out = rec.get("output", "")
        smiles = extract_all_smiles(out)
        if not smiles:
            continue
        can = canonical_smiles(smiles[0])
        if can is None or can in seen:
            continue
        g = smiles_to_graph(can)
        if g is None:
            continue
        seen.add(can)
        text = " ".join(filter(None, [rec.get("instruction", ""),
                                      rec.get("input", ""), out]))
        rows.append((g, _strip_molecule_text(text)))
    return rows


def pretrain_graphclip(
    corpus_path: str, output_dir: str, *, num_layer: int = 5,
    hidden_size: int = 300, text_hash_dim: int = 4096, batch_size: int = 16,
    steps: int = 300, learning_rate: float = 1e-3, seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Contrastive graph <-> text pretraining of the GraphCLIP encoder:
    symmetric InfoNCE with in-batch negatives and a learnable temperature
    (capped at 100; no gradient past the cap). The graph tower saves in
    the pretrained layout; the text tower and the hash settings save
    beside it (text_tower.msgpack, clip_config.json)."""
    from ..utils.serialization import save_pytree
    from ..weights import jax_tree_of

    device = _device(device)
    rows = _clip_rows(_load_corpus(corpus_path))
    if len(rows) < 2:
        raise ValueError("need >= 2 distinct molecules for contrastive "
                         "pretraining")
    batch_size = min(batch_size, len(rows))
    n = _bucket(rows)

    model = ClipPair(GraphCLIPConfig(num_layer=num_layer,
                                     hidden_size=hidden_size),
                     text_hash_dim, device=device)
    _init(model, seed)
    opt = _adamw(model, lambda count: learning_rate)
    cap = math.log(100.0)

    def loss_fn(atoms, edges, mask, feats):
        g = model.graph(atoms, edges, mask).float()
        t = apply_text_tower(model.text, feats).float()
        scale = torch.exp(model.logit_scale.clamp(max=cap))
        logits = scale * g @ t.T
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = (F.cross_entropy(logits, labels)
                + F.cross_entropy(logits.T, labels)) / 2.0
        return loss, (logits.argmax(-1) == labels).float().mean()

    feats_all = hash_text_features([t for _, t in rows], text_hash_dim)
    shuffler = random.Random(seed)
    order: List[int] = []
    losses: List[float] = []
    accs: List[torch.Tensor] = []
    for step in range(steps):
        # epoch-shuffled walk: every in-batch pair is a distinct molecule
        if len(order) < batch_size:
            fresh = list(range(len(rows)))
            shuffler.shuffle(fresh)
            order = fresh
        idx = [order.pop() for _ in range(batch_size)]
        graph = _graph_tensors([rows[i][0] for i in idx], n, device)
        feats = torch.from_numpy(feats_all[idx]).to(device)
        loss, acc = _step(opt, lambda: loss_fn(*graph, feats))
        losses.append(loss)
        accs.append(acc.detach())
        _log("graphclip", step, steps, losses)

    model.graph.save_pretrained(output_dir)
    tree = jax_tree_of(model)
    save_pytree({"text": tree["text"], "logit_scale": tree["logit_scale"]},
                os.path.join(output_dir, "text_tower.msgpack"))
    with open(os.path.join(output_dir, "clip_config.json"), "w") as f:
        json.dump({"text_hash_dim": text_hash_dim,
                   "hash_scheme": "crc32-word12gram-v1"}, f, indent=2)
    metrics = _metrics(losses, final_batch_retrieval_acc=float(
        torch.stack(accs[-20:]).mean()))
    logger.info("graphclip pretraining done: final %.4f first %.4f",
                metrics["final_loss"], metrics["first_loss"])
    return metrics


_AVAILABLE_RE = re.compile(r"([^\s,:]+) \(available\)")


def _cost_rows(records) -> List[Tuple[str, float]]:
    """(smiles, cost) pairs: explicit {"smiles", "cost"} records as they
    are; from MolQA records, each retro step's product at its remaining
    route length (the Retro* cost-to-go) and every '(available)' reactant
    at 0."""
    rows: List[Tuple[str, float]] = []
    for rec in records:
        if "smiles" in rec and "cost" in rec:
            rows.append((str(rec["smiles"]), float(rec["cost"])))
            continue
        out = rec.get("output", "")
        products = extract_retro_products(out)
        n = len(products)
        for k, smi in enumerate(products):
            rows.append((smi, float(n - k)))
        for smi in _AVAILABLE_RE.findall(out):
            rows.append((smi, 0.0))
    return rows


def pretrain_cost_mlp(
    corpus_path: str, output_dir: str, *, n_layers: int = 1,
    fp_dim: int = 2048, latent_dim: int = 128, batch_size: int = 64,
    steps: int = 200, learning_rate: float = 1e-3, seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Train the fingerprint -> synthesis-cost regressor on the
    first-party Morgan bits and save it with COST_FEATURE_SCHEME."""
    from ..chem.fingerprint import morgan_fingerprint
    from ..models.retro import CostMLP

    device = _device(device)
    X, y = [], []
    for s, c in _cost_rows(_load_corpus(corpus_path)):
        fp = morgan_fingerprint(s, radius=2, n_bits=fp_dim)
        if fp is not None:
            X.append(np.asarray(fp, np.float32))
            y.append(c)
    if not X:
        raise ValueError("no featurizable (smiles, cost) pairs in corpus")
    X = torch.from_numpy(np.stack(X)).to(device)
    y = torch.from_numpy(np.asarray(y, np.float32)).to(device)

    model = CostMLP(n_layers=n_layers, fp_dim=fp_dim, latent_dim=latent_dim,
                    device=device)
    _init(model, seed)
    opt = _adamw(model, lambda count: learning_rate)

    def loss_fn(xb, yb):
        pred = model(xb).reshape(-1).float()
        return torch.mean((pred - yb) ** 2)

    shuffler = random.Random(seed)
    n = X.shape[0]
    losses: List[float] = []
    for step in range(steps):
        idx = torch.tensor([shuffler.randrange(n)
                            for _ in range(min(batch_size, n))],
                           device=device)
        loss, _ = _step(opt, lambda: loss_fn(X[idx], y[idx]))
        losses.append(loss)
        _log("cost-mlp", step, steps, losses)

    model.save_pretrained(output_dir)
    metrics = _metrics(losses)
    logger.info("cost-mlp pretraining done: final %.4f first %.4f",
                metrics["final_loss"], metrics["first_loss"])
    return metrics
