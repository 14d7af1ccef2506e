"""GraphDiT: the multi-conditional discrete graph diffusion decoder
(llamole_tpu/models/graphdit/api.py: the training loss and the sampler).

  * classifier-free guidance runs as ONE denoiser call per step on a
    doubled batch whose second half carries NaN conditioning, which the
    embedders read as "dropped" (api.py:118-135)
  * the reverse loop is a Python loop over the strided time grid,
    computed with numpy exactly as the JAX sampler does (api.py:179-185)
  * graphs collapse to SMILES on the host through chem/

save_pretrained / from_pretrained read and write the JAX package's
directory: model.msgpack (the denoiser tree), model_config.yaml and
data.meta.json.
"""

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...chem.assemble import check_valid as _check_valid
from ...chem.assemble import graph_to_smiles as _graph_to_smiles
from ...utils import profiling
from ...utils.constants import NO_LABEL_INDEX

from ...weights import load_module, save_module
from .config import DataInfo, GraphDiTConfig
from .denoiser import Denoiser
from .diffusion import (NoiseSchedule, TransitionParts, apply_noise,
                        one_hot_graph, posterior_unnormalized,
                        sample_discrete_features, sample_limit_dist,
                        sample_n_nodes, train_loss)


def time_grid(timesteps: int, sampling_steps: Optional[int]) -> np.ndarray:
    """T = t_0 > t_1 > ... > t_n = 0; the sampler steps (t_k, t_k+1)."""
    n_steps = max(1, min(sampling_steps or timesteps, timesteps))
    return np.unique(np.round(np.linspace(timesteps, 0, n_steps + 1))
                     .astype(np.int32))[::-1].copy()


class GraphDiT(nn.Module):
    """Denoiser parameters live in `self.denoiser`; the schedule and the
    transition parts are plain f32 tensors on `device`."""

    def __init__(self, cfg: GraphDiTConfig, data_info: DataInfo,
                 dtype=torch.float32, device=None):
        super().__init__()
        cfg.Xdim = len(data_info.active_atoms)
        cfg.max_n_nodes = data_info.max_n_nodes
        self.cfg = cfg
        self.data_info = data_info
        self.denoiser = Denoiser(cfg, dtype, device)
        self.schedule = NoiseSchedule.create(cfg.diffusion_steps, device)
        self.parts = TransitionParts.from_data_info(data_info, device)
        self.atom_decoder = list(data_info.active_atoms)
        hist = np.asarray(data_info.n_nodes_dist, dtype=np.float64)
        self._nodes_hist = torch.tensor(hist / max(hist.sum(), 1e-12),
                                        dtype=torch.float32, device=device)
        self.text_input_size = cfg.text_dim
        self._active_index = torch.as_tensor(
            np.asarray(data_info.active_index), dtype=torch.long,
            device=device)

    def codes_to_onehot(self, atom_codes, edge_classes, node_mask):
        """118-space atom codes -> active-space one-hot X (atoms outside
        the active set are all-zero rows, which the CE ignores) and the
        masked one-hot E, both f32."""
        X = (atom_codes.long()[..., None]
             == self._active_index[None, None, :]).float()
        X = X * node_mask[..., None]
        pair = (node_mask[:, :, None] & node_mask[:, None, :])[..., None]
        E = torch.nn.functional.one_hot(edge_classes.long(),
                                        self.cfg.Edim).float() * pair
        return X, E

    def loss(self, generator: Optional[torch.Generator], atom_codes,
             edge_classes, node_mask, properties, text_emb,
             train: bool = True, noisy=None, rows=None,
             count=None) -> torch.Tensor:
        """lambda-weighted node / edge CE of the denoiser on one noise
        level per graph. properties [B, ydim] (NO_LABEL_INDEX = absent),
        text_emb [B, text_dim]. noisy: a given {"t", "X_t", "E_t"} draw in
        place of apply_noise's (a test seam: the JAX package's draw can be
        fed to both). rows = (offset, total), data parallelism: the graphs
        (atom_codes, edge_classes, node_mask, noisy) are the whole
        batch's, properties and text_emb this rank's rows offset..; the
        noise is drawn for the whole batch and this rank's rows kept, and
        count (a function of the local count) gives the CE's normaliser
        over every rank's rows."""
        y = torch.where(properties == NO_LABEL_INDEX, float("nan"),
                        properties.float())
        X, E = self.codes_to_onehot(atom_codes, edge_classes, node_mask)
        if noisy is None:
            noisy = apply_noise(generator, X, E, node_mask, self.schedule,
                                self.parts, train=train)
        if rows is not None:
            mine = slice(rows[0], rows[0] + text_emb.shape[0])
            X, E, node_mask = X[mine], E[mine], node_mask[mine]
            noisy = {k: v[mine] for k, v in noisy.items()}
        pred_X, pred_E = self.denoiser(noisy["X_t"], noisy["E_t"], node_mask,
                                       y, text_emb, noisy["t"], train=train,
                                       generator=generator, rows=rows)
        return train_loss(pred_X, pred_E, X, E, tuple(self.cfg.lambda_train),
                          count)

    @torch.no_grad()
    def sample(self, generator: torch.Generator, y: torch.Tensor,
               text_emb: torch.Tensor, rows=None):
        """Full reverse diffusion. y [B, ydim] f32 (NaN = absent),
        text_emb [B, text_dim] -> (atom_idx [B,N] active-space,
        edge_cls [B,N,N], n_nodes [B]). rows = (idx, total), data
        parallelism: y and text_emb are the rows idx ([B] long, places in
        the whole batch of `total` rows); every draw is made for the
        whole batch and these rows kept (diffusion.py), so each row's
        sample equals the run without a mesh."""
        cfg, sched = self.cfg, self.schedule
        dev = self._nodes_hist.device
        b, n = y.shape[0], cfg.max_n_nodes
        if rows is None:
            n_nodes = sample_n_nodes(generator, self._nodes_hist, b)
            node_mask = (torch.arange(n, device=dev)[None, :]
                         < n_nodes[:, None])
            Xc, Ec = sample_limit_dist(generator, self.parts, node_mask)
        else:
            idx, total = rows
            n_all = sample_n_nodes(generator, self._nodes_hist, total)
            mask_all = torch.arange(n, device=dev)[None, :] < n_all[:, None]
            Xc, Ec = sample_limit_dist(generator, self.parts, mask_all)
            n_nodes, node_mask = n_all[idx], mask_all[idx]
            Xc, Ec = Xc[idx], Ec[idx]
        X, E = one_hot_graph(Xc, Ec, cfg.Xdim, cfg.Edim, node_mask)

        use_cfg = cfg.guide_scale is not None and cfg.guide_scale != 1
        if use_cfg:
            # doubled batch: [conditioned || unconditioned (NaN)]
            m2 = torch.cat([node_mask, node_mask], 0)
            y2 = torch.cat([y, torch.full_like(y, float("nan"))], 0)
            txt2 = torch.cat([text_emb, torch.full_like(text_emb,
                                                        float("nan"))], 0)

        def to_probs(X_t, E_t, lX, lE, beta_t, a_s, a_t):
            pX = torch.softmax(lX.float(), -1)
            pE = torch.softmax(lE.float(), -1)
            uX, uE = posterior_unnormalized(X_t, E_t, pX, pE, beta_t, a_s,
                                            a_t, self.parts)
            uX = torch.where(uX.sum(-1, keepdim=True) == 0.0, 1e-5, uX)
            uE = torch.where(uE.sum(-1, keepdim=True) == 0.0, 1e-5, uE)
            return (uX / uX.sum(-1, keepdim=True),
                    uE / uE.sum(-1, keepdim=True))

        grid = time_grid(sched.timesteps, cfg.sampling_steps)
        T = np.float32(sched.timesteps)
        for t_int, s_int in zip(grid[:-1].tolist(), grid[1:].tolist()):
            profiling.count("graphdit.reverse_steps")
            with profiling.span("graphdit.step", dev):
                a_s = sched.alphas_bar[s_int].expand(b)
                a_t = sched.alphas_bar[t_int].expand(b)
                # effective one-jump noise t -> s: exact when s = t-1
                beta_t = 1.0 - a_t / a_s.clamp_min(1e-12)
                t_norm = torch.full((b,), float(np.float32(t_int) / T),
                                    dtype=torch.float32, device=dev)
                if use_cfg:
                    lX, lE = self.denoiser(torch.cat([X, X], 0),
                                           torch.cat([E, E], 0), m2, y2,
                                           txt2, torch.cat([t_norm, t_norm],
                                                           0))
                    prob_X, prob_E = to_probs(X, E, lX[:b], lE[:b], beta_t,
                                              a_s, a_t)
                    un_X, un_E = to_probs(X, E, lX[b:], lE[b:], beta_t, a_s,
                                          a_t)
                    g = cfg.guide_scale
                    prob_X = un_X * (prob_X / un_X.clamp_min(1e-5)) ** g
                    prob_E = un_E * (prob_E / un_E.clamp_min(1e-5)) ** g
                    prob_X = prob_X / prob_X.sum(-1, keepdim=True).clamp_min(
                        1e-5)
                    prob_E = prob_E / prob_E.sum(-1, keepdim=True).clamp_min(
                        1e-5)
                else:
                    lX, lE = self.denoiser(X, E, node_mask, y, text_emb,
                                           t_norm)
                    prob_X, prob_E = to_probs(X, E, lX, lE, beta_t, a_s, a_t)
                Xs, Es = sample_discrete_features(generator, prob_X, prob_E,
                                                  node_mask, rows)
                X, E = one_hot_graph(Xs, Es, cfg.Xdim, cfg.Edim, node_mask)

        atom_idx = torch.argmax(X, dim=-1)
        edge_cls = torch.argmax(E, dim=-1)
        pair = node_mask[:, :, None] & node_mask[:, None, :]
        return atom_idx, torch.where(pair, edge_cls, 0), n_nodes

    def generate(self, generator: torch.Generator, properties: torch.Tensor,
                 text_emb: torch.Tensor, rows=None) -> List[Optional[str]]:
        """Sample molecules and assemble SMILES on the host. properties
        [B, ydim]: NO_LABEL_INDEX or NaN = absent channel. rows: this
        rank's rows of a data-parallel batch (sample)."""
        y = torch.where(properties == NO_LABEL_INDEX, float("nan"),
                        properties.float())
        atom_idx, edge_cls, n_nodes = self.sample(generator, y, text_emb,
                                                  rows)
        with profiling.span("graphdit.fetch"):   # waits for the sampler
            atom_idx = atom_idx.cpu().numpy()
            edge_cls = edge_cls.cpu().numpy()
            n_nodes = n_nodes.cpu().numpy()
        mols = [(atom_idx[i, :int(k)], edge_cls[i, :int(k), :int(k)])
                for i, k in enumerate(n_nodes)]
        with profiling.span("graphdit.assemble"):
            return _graph_to_smiles(mols, self.atom_decoder)

    def check_valid(self, smiles: Optional[str]) -> bool:
        return _check_valid(smiles)

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        save_module(self.denoiser, os.path.join(output_dir, "model.msgpack"))
        self.cfg.to_yaml(os.path.join(output_dir, "model_config.yaml"))
        self.data_info.save(output_dir)

    @classmethod
    def from_pretrained(cls, model_dir: str, device=None) -> "GraphDiT":
        cfg = GraphDiTConfig.from_yaml(os.path.join(model_dir,
                                                    "model_config.yaml"))
        model = cls(cfg, DataInfo.load(model_dir), device=device)
        load_module(model.denoiser, os.path.join(model_dir, "model.msgpack"))
        return model
