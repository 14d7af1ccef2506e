"""Retro predictor and cost model (counterpart of
llamole_tpu/models/retro/model.py).

GraphPredictor: a text-conditioned GIN classifying reaction templates.
Per layer an AdaLN adapter (SiLU -> Linear(text, 3H) -> shift / scale /
gate) modulates a non-affine LayerNorm of the GINConv output (kernel B),
with virtual-node feedback between layers; add pool, then the
fc1 -> LN -> GELU -> fc2 decoder over `out_dim` template labels.
`sample_templates` applies the top-k templates to the product on the host
(chem/reaction.py) exactly as the JAX package does.

CostMLP: Morgan fingerprint -> Linear(2048, 128) -> ReLU -> Linear(128, 1)
-> softplus.

Both read and write the JAX package's directories: model.msgpack,
model_config.json, label_to_template.csv.gz and available.csv.gz for the
predictor; cost_model.msgpack and cost_config.json for the cost model.
"""

import csv
import gzip
import json
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...chem import recanonicalize

from ...ops.gin import (GINConv, NormMLP, dense_graph_inputs,
                        full_f32_matmuls, masked_add_pool, masked_max_pool)
from ...ops.nn import gelu, init_dense_, layer_norm
from ...weights import load_module, save_module
from ..graphclip.model import NUM_ATOM_CODES


@dataclass
class GraphPredictorConfig:
    num_layer: int = 5
    hidden_size: int = 300
    drop_ratio: float = 0.0
    out_dim: int = 100          # number of reaction-template labels
    text_input_size: int = 768


class GraphPredictor(nn.Module):
    """Parameters are uninitialised until `reset_parameters(generator)` or
    `load_state_dict` fills them. `available` (the purchasable inventory)
    is re-spelled through recanonicalize, deduplicated in order."""

    def __init__(self, cfg: GraphPredictorConfig,
                 label_to_template: Optional[Dict[int, str]] = None,
                 available: Optional[List[str]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if cfg.num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        self.cfg = cfg
        self.label_to_template = label_to_template or {}
        if available is not None:
            available = list(dict.fromkeys(recanonicalize(s)
                                           for s in available))
        self.available = available
        self.text_input_size = cfg.text_input_size
        h, t = cfg.hidden_size, cfg.text_input_size
        meta = torch.device("meta")
        self.atom_encoder = nn.Parameter(torch.empty(
            NUM_ATOM_CODES, h, dtype=dtype, device=meta))
        self.virtualnode = nn.Parameter(torch.empty(h, dtype=dtype,
                                                    device=meta))
        self.text_dropping = nn.Parameter(torch.empty(1, t, dtype=dtype,
                                                      device=meta))
        self.convs = nn.ModuleList(GINConv(h, dtype, meta)
                                   for _ in range(cfg.num_layer))
        self.adapters = nn.ModuleList(
            nn.Linear(t, 3 * h, dtype=dtype, device=meta)
            for _ in range(cfg.num_layer))
        self.vn_mlps = nn.ModuleList(NormMLP(h, 4 * h, h, dtype, meta)
                                     for _ in range(cfg.num_layer - 1))
        self.decoder = NormMLP(h, 4 * h, cfg.out_dim, dtype, meta)
        self.to_empty(device=device or torch.device("cpu"))

    @property
    def device(self) -> torch.device:
        return self.atom_encoder.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1) embeddings, zero virtual node, zero AdaLN
        adapters (identity gates), GIN and MLP inits."""
        self.atom_encoder.normal_(generator=generator)
        self.virtualnode.zero_()
        self.text_dropping.normal_(generator=generator)
        for conv in self.convs:
            conv.reset_parameters(generator)
        for ada in self.adapters:
            ada.weight.zero_()
            ada.bias.zero_()
        for mlp in self.vn_mlps:
            mlp.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, atom_codes, edge_classes, node_mask,
                c: Optional[torch.Tensor]) -> torch.Tensor:
        """Template logits [B, out_dim]; c = text condition [B, text] or
        None for the learned dropped-text embedding."""
        dtype = self.atom_encoder.dtype
        b = atom_codes.shape[0]
        mask_f = node_mask.to(dtype)[..., None]
        edges, adj = dense_graph_inputs(edge_classes, node_mask, dtype)
        if c is None:
            c = self.text_dropping[0][None, :].expand(b, -1)
        c = F.silu(c.to(dtype))
        h_prev = self.atom_encoder[atom_codes.long()] * mask_f
        vn = self.virtualnode[None, :].expand(b, -1)
        last = self.cfg.num_layer - 1
        for layer, (conv, ada) in enumerate(zip(self.convs, self.adapters)):
            h_in = h_prev + vn[:, None, :] * mask_f
            shift, scale, gate = ada(c).chunk(3, dim=-1)     # [B, H] each
            h = layer_norm(conv(h_in, edges, adj))           # non-affine
            h = h * (1.0 + scale[:, None, :]) + shift[:, None, :]
            if layer < last:
                h = gelu(h)
            h = gate[:, None, :] * h + h_in
            if layer < last:
                vn = vn + self.vn_mlps[layer](masked_max_pool(h_in,
                                                              node_mask))
            h_prev = h
        g = masked_add_pool(h_prev * mask_f, node_mask)
        with full_f32_matmuls():
            return self.decoder(g)

    def template_probs(self, atom_codes, edge_classes, node_mask,
                       c: Optional[torch.Tensor]) -> torch.Tensor:
        """softmax over the template labels, f32."""
        logits = self(atom_codes, edge_classes, node_mask, c)
        return torch.softmax(logits.float(), dim=-1)

    @torch.no_grad()
    def sample_templates(self, product_graph, c: Optional[torch.Tensor],
                         product_smiles: str, topk: int = 10
                         ) -> Tuple[List[str], List[float], List[str]]:
        """Top-k template labels -> apply each to the product -> merged
        reactant proposals: per-outcome score split, duplicates merged by
        sorted reactant key, scores normalised (the JAX host logic)."""
        from ...chem.reaction import apply_retro_template

        k = product_graph.n_nodes
        n = ((k + 7) // 8) * 8   # the JAX bucket: same padded shape
        atoms = np.zeros((1, n), np.int64)
        atoms[0, :k] = product_graph.atom_types
        edges = np.zeros((1, n, n), np.int32)
        edges[0, :k, :k] = product_graph.edge_classes
        mask = np.zeros((1, n), bool)
        mask[0, :k] = True
        dev = self.device
        if c is not None and c.dim() == 1:
            c = c[None, :]
        probs = self.template_probs(
            torch.from_numpy(atoms).to(dev), torch.from_numpy(edges).to(dev),
            torch.from_numpy(mask).to(dev),
            None if c is None else c.to(dev))[0].cpu().numpy()
        k = min(topk, probs.shape[0])
        top_idx = np.argsort(-probs)[:k]

        reactants_d = defaultdict(list)
        for idx in top_idx:
            template = self.label_to_template.get(int(idx))
            if template is None:
                continue
            outcomes = apply_retro_template(template, product_smiles)
            if not outcomes:
                continue
            outcomes = sorted(outcomes)
            for reactant in outcomes:
                key = ".".join(sorted(reactant.strip().split(".")))
                reactants_d[key].append(
                    (float(probs[idx]) / len(outcomes), template))
        if not reactants_d:
            return [], [], []

        merged = []
        for reactant, entries in reactants_d.items():
            scores, templates = zip(*entries)
            merged.append((reactant, sum(scores), templates[0]))
        merged.sort(key=lambda item: item[1], reverse=True)
        reactants, scores, templates = map(list, zip(*merged))
        total = sum(scores)
        return reactants, [s / total for s in scores], templates

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        save_module(self, os.path.join(output_dir, "model.msgpack"))
        with open(os.path.join(output_dir, "model_config.json"), "w") as f:
            json.dump({"num_layer": self.cfg.num_layer,
                       "hidden_size": self.cfg.hidden_size,
                       "drop_ratio": self.cfg.drop_ratio,
                       "num_task": self.cfg.out_dim,
                       "text_input_size": self.cfg.text_input_size},
                      f, indent=2)
        if self.label_to_template:
            with gzip.open(os.path.join(output_dir,
                                        "label_to_template.csv.gz"),
                           "wt") as f:
                f.write("rule_label,retro_templates\n")
                for k, v in self.label_to_template.items():
                    f.write(f'{k},"{v}"\n')
        if self.available is not None:
            with gzip.open(os.path.join(output_dir, "available.csv.gz"),
                           "wt") as f:
                f.write("smiles\n")
                for smi in self.available:
                    f.write(smi + "\n")

    @classmethod
    def from_pretrained(cls, model_dir: str,
                        device=None) -> "GraphPredictor":
        """The inventory is re-canonicalised on load (__init__)."""
        with open(os.path.join(model_dir, "model_config.json")) as f:
            raw = json.load(f)
        cfg = GraphPredictorConfig(
            num_layer=raw.get("num_layer", 5),
            hidden_size=raw.get("hidden_size", 300),
            drop_ratio=raw.get("drop_ratio", 0.0),
            out_dim=raw.get("num_task", raw.get("out_dim", 100)),
            text_input_size=raw.get("text_input_size", 768))
        l2t = {}
        l2t_path = os.path.join(model_dir, "label_to_template.csv.gz")
        if os.path.exists(l2t_path):
            with gzip.open(l2t_path, "rt") as f:
                for row in csv.DictReader(f):
                    l2t[int(row["rule_label"])] = row["retro_templates"]
        available = None
        av_path = os.path.join(model_dir, "available.csv.gz")
        if os.path.exists(av_path):
            with gzip.open(av_path, "rt") as f:
                available = [row["smiles"] for row in csv.DictReader(f)]
        model = cls(cfg, l2t, available, device=device)
        return load_module(model, os.path.join(model_dir, "model.msgpack"))


# provenance marker of CostMLP checkpoints: the first-party Morgan bits
# (chem/fingerprint.py) are not RDKit's, so a cost model is only valid
# with the feature scheme it was trained on (the JAX package's value)
COST_FEATURE_SCHEME = "llamole-tpu-morgan-r2-v1"


class CostMLP(nn.Module):
    """Fingerprint -> synthesis-cost regressor."""

    def __init__(self, n_layers: int = 1, fp_dim: int = 2048,
                 latent_dim: int = 128, dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers, self.fp_dim, self.latent_dim = (n_layers, fp_dim,
                                                      latent_dim)
        dims = [fp_dim] + [latent_dim] * n_layers + [1]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, dtype=dtype, device=device)
            for i, o in zip(dims[:-1], dims[1:]))

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            init_dense_(layer, generator)

    def forward(self, fps: torch.Tensor) -> torch.Tensor:
        x = fps.to(self.layers[0].weight.dtype)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return torch.log1p(torch.exp(self.layers[-1](x)))   # softplus

    @torch.no_grad()
    def estimate_cost(self, smiles: str) -> float:
        from ...chem.fingerprint import morgan_fingerprint
        fp = morgan_fingerprint(smiles, radius=2, n_bits=self.fp_dim)
        if fp is None:
            raise ValueError(f"Invalid SMILES string: {smiles}")
        fps = torch.as_tensor(np.asarray(fp[None, :]), dtype=torch.float32,
                              device=self.device)
        return float(self(fps).reshape(()))

    @torch.no_grad()
    def estimate_costs(self, smiles_list) -> List[float]:
        """One device call for all fingerprints; invalid SMILES cost 0."""
        from ...chem.fingerprint import morgan_fingerprint
        fps, rows = [], []
        for i, s in enumerate(smiles_list):
            fp = morgan_fingerprint(s, radius=2, n_bits=self.fp_dim)
            if fp is not None:
                fps.append(fp)
                rows.append(i)
        out = [0.0] * len(smiles_list)
        if fps:
            vals = self(torch.as_tensor(np.asarray(fps), dtype=torch.float32,
                                        device=self.device))
            for i, v in zip(rows, vals.reshape(-1).cpu().numpy()):
                out[i] = float(v)
        return out

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        save_module(self, os.path.join(output_dir, "cost_model.msgpack"))
        with open(os.path.join(output_dir, "cost_config.json"), "w") as f:
            json.dump({"n_layers": self.n_layers, "fp_dim": self.fp_dim,
                       "latent_dim": self.latent_dim,
                       "feature_scheme": COST_FEATURE_SCHEME}, f, indent=2)

    @classmethod
    def from_pretrained(cls, model_dir: str, device=None) -> "CostMLP":
        """Refuses a checkpoint without this package's feature scheme:
        RDKit-feature weights would give wrong costs silently."""
        cfg_path = os.path.join(model_dir, "cost_config.json")
        raw = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
        scheme = raw.get("feature_scheme")
        if scheme != COST_FEATURE_SCHEME:
            raise ValueError(
                f"cost model at {model_dir} was trained on feature scheme "
                f"{scheme!r}, not the first-party Morgan bits "
                f"({COST_FEATURE_SCHEME!r}); retrain it with "
                "llamole_tpu_torch.train.pretrain.pretrain_cost_mlp")
        model = cls(n_layers=raw.get("n_layers", 1),
                    fp_dim=raw.get("fp_dim", 2048),
                    latent_dim=raw.get("latent_dim", 128), device=device)
        return load_module(model, os.path.join(model_dir,
                                               "cost_model.msgpack"))
