"""The property oracle (counterpart of llamole_tpu/models/oracle.py): a
GraphCLIP trunk (its pre-projection `encode`, kernel B in every GIN
layer) and a linear head over the 10 MolQA property channels, BBBP / HIV
/ BACE binary and CO2 / N2 / O2 / FFV / TC / SC / SA continuous
(utils.constants.MOL_PROPERTIES order).

Continuous targets are standardised with corpus statistics that ride the
parameter tree (y_mean / y_std, out of the loss's gradient); predictions
come back in raw property units, binary channels as probabilities.
Trained by train/pretrain.pretrain_property_oracle; eval/scoring reads it
through ModelArguments.property_oracle_path.
"""

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.nn import init_dense_
from ..utils.constants import MOL_PROPERTIES, NO_LABEL_INDEX
from ..weights import load_module, save_module
from .graphclip.model import GraphCLIP, GraphCLIPConfig

BINARY_CHANNELS: Tuple[int, ...] = (0, 1, 2)        # BBBP, HIV, BACE
CONTINUOUS_CHANNELS: Tuple[int, ...] = tuple(range(3, 10))
_N = len(MOL_PROPERTIES)


@dataclass
class PropertyOracleConfig:
    num_layer: int = 3
    hidden_size: int = 128


class PropertyOracle(nn.Module):
    """[B, N] atom codes + [B, N, N] edge classes -> [B, 10] predictions,
    in f32. Parameters are uninitialised until `reset_parameters` or
    `load_state_dict` fills them."""

    def __init__(self, cfg: PropertyOracleConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = GraphCLIP(GraphCLIPConfig(num_layer=cfg.num_layer,
                                               hidden_size=cfg.hidden_size),
                               device=device)
        self.head = nn.Linear(cfg.hidden_size, _N, device=device)
        self.y_mean = nn.Parameter(torch.zeros(_N, device=device))
        self.y_std = nn.Parameter(torch.ones(_N, device=device))
        self.register_buffer("_binary", torch.zeros(_N, dtype=torch.bool,
                                                    device=device),
                             persistent=False)
        self._binary[list(BINARY_CHANNELS)] = True

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, y_mean=None,
                         y_std=None) -> None:
        """The JAX init: the GraphCLIP init, a xavier head, and the given
        standardisation (zeros / ones when absent)."""
        self.trunk.reset_parameters(generator)
        init_dense_(self.head, generator)
        self.y_mean.copy_(torch.as_tensor(
            np.zeros(_N) if y_mean is None else y_mean, dtype=torch.float32))
        self.y_std.copy_(torch.as_tensor(
            np.ones(_N) if y_std is None else y_std, dtype=torch.float32))

    def _raw(self, atom_codes, edge_classes, node_mask) -> torch.Tensor:
        feats = self.trunk.encode(atom_codes, edge_classes, node_mask)
        return self.head(feats).float()                      # [B, 10]

    def forward(self, atom_codes, edge_classes, node_mask) -> torch.Tensor:
        raw = self._raw(atom_codes, edge_classes, node_mask)
        out = raw * self.y_std[None, :] + self.y_mean[None, :]
        return torch.where(self._binary[None, :], torch.sigmoid(raw), out)

    def loss(self, atom_codes, edge_classes, node_mask,
             targets: torch.Tensor) -> torch.Tensor:
        """Masked multi-task loss: BCE with logits on the labelled binary
        channels, MSE on the standardised labelled continuous ones.
        NO_LABEL_INDEX and NaN mark an absent label."""
        raw = self._raw(atom_codes, edge_classes, node_mask)
        targets = targets.float()
        labeled = (targets > float(NO_LABEL_INDEX) + 1.0) & torch.isfinite(
            targets)
        safe = torch.where(labeled, targets, 0.0)
        y = safe.clamp(0.0, 1.0)
        bce = (raw.clamp_min(0.0) - raw * y
               + torch.log1p(torch.exp(-raw.abs())))
        # the statistics are dataset constants: out of the gradient
        z = ((safe - self.y_mean.detach()[None, :])
             / self.y_std.detach()[None, :].clamp_min(1e-6))
        mse = (raw - z) ** 2
        per = torch.where(labeled, torch.where(self._binary[None, :], bce,
                                               mse), 0.0)
        return per.sum() / labeled.sum().clamp_min(1.0)

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        save_module(self, os.path.join(output_dir, "model.msgpack"))
        with open(os.path.join(output_dir, "model_config.json"), "w") as f:
            json.dump({"oracle_num_layer": self.cfg.num_layer,
                       "oracle_hidden_size": self.cfg.hidden_size,
                       "properties": list(MOL_PROPERTIES)}, f, indent=2)

    @classmethod
    def from_pretrained(cls, model_dir: str,
                        device=None) -> "PropertyOracle":
        with open(os.path.join(model_dir, "model_config.json")) as f:
            raw = json.load(f)
        if raw.get("properties") != list(MOL_PROPERTIES):
            raise ValueError(
                f"oracle at {model_dir} was trained for channels "
                f"{raw.get('properties')}; this build expects "
                f"{list(MOL_PROPERTIES)}")
        model = cls(PropertyOracleConfig(
            num_layer=raw.get("oracle_num_layer", 3),
            hidden_size=raw.get("oracle_hidden_size", 128)),
            device=device)
        return load_module(model, os.path.join(model_dir, "model.msgpack"))

    @torch.no_grad()
    def predict_smiles(self, smiles_list: List[str]
                       ) -> List[Optional[np.ndarray]]:
        """Per-molecule [10] predictions; None where a SMILES does not
        parse. Featurises through the canonical spelling."""
        from ..chem.featurize import pad_graph_batch, smiles_to_graph
        from ..chem.smiles import canonical_smiles

        graphs, where = [], []
        for i, s in enumerate(smiles_list):
            can = canonical_smiles(s) if s else None
            g = smiles_to_graph(can) if can else None
            if g is not None:
                graphs.append(g)
                where.append(i)
        out: List[Optional[np.ndarray]] = [None] * len(smiles_list)
        if not graphs:
            return out
        n = max(g.n_nodes for g in graphs)
        padded = pad_graph_batch(graphs, ((n + 7) // 8) * 8)
        dev = self.device
        preds = self(torch.from_numpy(padded["atom_types"]).to(dev),
                     torch.from_numpy(padded["edge_classes"]).to(dev),
                     torch.from_numpy(padded["node_mask"]).to(dev))
        preds = preds.cpu().numpy()
        for row, i in enumerate(where):
            out[i] = preds[row]
        return out
