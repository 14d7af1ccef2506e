"""Discrete graph diffusion math (counterpart of
llamole_tpu/models/graphdit/diffusion.py).

The joint transition Q = a*I + (1-a)*U over [x || e_1..e_n] is applied in
the factored form of the JAX package: with S = sum_j e_j,

    (vU)_X  = x.u_x  + S.u_ex
    (vU)_Ej = x.u_xe + S.u_e        (identical for every j)

The transition products run in full f32 as broadcast multiply-sums,
never through a matmul that TF32 could round (the JAX side asks for
Precision.HIGHEST for the same reason). Random draws take an explicit
torch.Generator; categorical sampling is Gumbel-max over log-probs, the
same law as jax.random.categorical (the bits differ, so tests compare
distributions). apply_noise and train_loss are the training half
(diffusion.py apply_noise / train_loss).

`rows` (idx, total), data parallelism: the draw is made for all `total`
rows of the whole batch, as the run without a mesh makes it, and the
rows `idx` (this rank's rows' places in it) are kept.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import DataInfo


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    ac = np.cos(0.5 * np.pi * ((x / steps) + s) / (1 + s)) ** 2
    ac = ac / ac[0]
    alphas = ac[1:] / ac[:-1]
    return (1.0 - alphas).squeeze()


@dataclass
class NoiseSchedule:
    betas: torch.Tensor       # [T+1] f32
    alphas_bar: torch.Tensor  # [T+1] f32
    timesteps: int

    @classmethod
    def create(cls, timesteps: int, device=None) -> "NoiseSchedule":
        betas = np.clip(cosine_beta_schedule(timesteps), 0.0, 1.0)
        alphas_bar = np.exp(np.cumsum(np.log(np.clip(1.0 - betas, 1e-30,
                                                     None))))
        return cls(
            betas=torch.tensor(betas, dtype=torch.float32, device=device),
            alphas_bar=torch.tensor(alphas_bar, dtype=torch.float32,
                                    device=device),
            timesteps=timesteps,
        )


@dataclass
class TransitionParts:
    """The four block generators of U (all f32)."""

    u_x: torch.Tensor   # [dx, dx] rows = x_marginals
    u_e: torch.Tensor   # [de, de] rows = e_marginals
    u_xe: torch.Tensor  # [dx, de]
    u_ex: torch.Tensor  # [de, dx]

    @classmethod
    def from_data_info(cls, info: DataInfo, device=None) -> "TransitionParts":
        x_marg, e_marg, xe, ex = info.marginals()
        dx, de = len(x_marg), len(e_marg)

        def t(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32,
                                device=device)

        return cls(u_x=t(np.tile(x_marg[None, :], (dx, 1))),
                   u_e=t(np.tile(e_marg[None, :], (de, 1))),
                   u_xe=t(xe), u_ex=t(ex))

    def transpose(self) -> "TransitionParts":
        """Parts of U^T (block-transpose swaps the off-diagonal tiles)."""
        return TransitionParts(u_x=self.u_x.T, u_e=self.u_e.T,
                               u_xe=self.u_ex.T, u_ex=self.u_xe.T)

    def limit_dist(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.u_x[0], self.u_e[0]


def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v [..., k] @ m [k, d] as an f32 multiply-sum (no TF32 path)."""
    return (v.unsqueeze(-1) * m).sum(dim=-2)


def apply_Q(X, E, coef, parts: TransitionParts):
    """(X || E) @ (coef*I + (1-coef)*U) in factored form.

    X [B, N, dx], E [B, N, N, de], coef [B] -> (out_X, out_E) f32."""
    coef = coef.reshape(-1, 1, 1).float()
    Xf = X.float()
    Ef = E.float()
    S = Ef.sum(dim=2)                                      # [B, N, de]
    mix_x = _vecmat(Xf, parts.u_x) + _vecmat(S, parts.u_ex)  # [B, N, dx]
    mix_e = _vecmat(Xf, parts.u_xe) + _vecmat(S, parts.u_e)  # [B, N, de]
    out_X = coef * Xf + (1.0 - coef) * mix_x
    c4 = coef[..., None]
    out_E = c4 * Ef + (1.0 - c4) * mix_e[:, :, None, :]
    return out_X, out_E


def posterior_unnormalized(X_t, E_t, pred_X, pred_E, beta_t, alpha_s_bar,
                           alpha_t_bar, parts: TransitionParts):
    """Unnormalized p(z_s | z_t, x0 ~ pred) per class:
    (X_t Qt^T) * (pred Qsb) / clamp(X_t Qtb^T, 1e-5)."""
    tparts = parts.transpose()
    left_X, left_E = apply_Q(X_t, E_t, 1.0 - beta_t, tparts)
    right_X, right_E = apply_Q(pred_X, pred_E, alpha_s_bar, parts)
    den_X, den_E = apply_Q(X_t, E_t, alpha_t_bar, tparts)
    prob_X = left_X * right_X / den_X.clamp_min(1e-5)
    prob_E = left_E * right_E / den_E.clamp_min(1e-5)
    return prob_X, prob_E


def categorical(generator: torch.Generator, logits: torch.Tensor,
                rows=None) -> torch.Tensor:
    """One draw per row of `logits` [..., K] (Gumbel-max)."""
    if rows is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    else:
        idx, total = rows
        u = torch.rand((total, *logits.shape[1:]), generator=generator,
                       device=logits.device)[idx]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_discrete_features(generator, probX, probE, node_mask,
                             rows=None):
    """Categorical node/edge sampling with masking and upper-triangle
    symmetrization. probX [B, N, dx], probE [B, N, N, de] (unnormalized
    ok), node_mask [B, N] bool -> (X [B, N], E [B, N, N]) int64."""
    n = probX.shape[1]
    dx, de = probX.shape[-1], probE.shape[-1]
    probX = torch.where(node_mask[..., None], probX, 1.0 / dx)
    X = categorical(generator, torch.log(probX.clamp_min(1e-5)), rows)

    pair = node_mask[:, :, None] & node_mask[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=probX.device)[None]
    valid = pair & ~eye
    probE = torch.where(valid[..., None], probE, 1.0 / de)
    E = categorical(generator, torch.log(probE.clamp_min(1e-5)), rows)
    upper = torch.triu(E, diagonal=1)
    E = upper + upper.transpose(1, 2)

    X = torch.where(node_mask, X, 0)
    E = torch.where(valid, E, 0)
    return X, E


def sample_limit_dist(generator, parts: TransitionParts, node_mask,
                      rows=None):
    """z_T ~ the limit distribution."""
    b, n = node_mask.shape
    x_lim, e_lim = parts.limit_dist()
    probX = x_lim.expand(b, n, x_lim.shape[0])
    probE = e_lim.expand(b, n, n, e_lim.shape[0])
    return sample_discrete_features(generator, probX, probE, node_mask,
                                    rows)


def one_hot_graph(X, E, dx: int, de: int, node_mask,
                  dtype=torch.float32):
    Xh = F.one_hot(X, dx).to(dtype) * node_mask[..., None]
    pair = (node_mask[:, :, None] & node_mask[:, None, :])[..., None]
    Eh = F.one_hot(E, de).to(dtype) * pair
    return Xh, Eh


def sample_n_nodes(generator, hist: torch.Tensor, batch: int,
                   rows=None) -> torch.Tensor:
    """Node counts drawn from the training histogram [max_n + 1]."""
    logits = torch.log(hist.clamp_min(1e-30))
    return categorical(generator, logits.expand(batch, -1), rows)


def apply_noise(generator, X, E, node_mask, schedule: NoiseSchedule,
                parts: TransitionParts, train: bool = True):
    """t ~ U{0 (train) or 1 (eval) .. T} per graph and z_t ~ q(z_t | z_0):
    {"t_int" [B], "t" [B] f32 (t_int / T), "X_t", "E_t"} (one-hot f32)."""
    lowest = 0 if train else 1
    t_int = torch.randint(lowest, schedule.timesteps + 1, (X.shape[0],),
                          generator=generator, device=X.device)
    probX, probE = apply_Q(X, E, schedule.alphas_bar[t_int], parts)
    Xt, Et = sample_discrete_features(generator, probX, probE, node_mask)
    Xh, Eh = one_hot_graph(Xt, Et, X.shape[-1], E.shape[-1], node_mask)
    return {"t_int": t_int, "t": t_int.float() / schedule.timesteps,
            "X_t": Xh, "E_t": Eh}


def _masked_ce(pred, true, count=None):
    """Mean CE over the rows with any one-hot mass (the rest are padding).
    count: a function of the local count giving the normaliser (data
    parallelism: the count over every rank's rows)."""
    pred = pred.reshape(-1, pred.shape[-1]).float()
    true = true.reshape(-1, true.shape[-1]).float()
    mask = (true != 0.0).any(dim=-1)
    target = true.argmax(dim=-1)
    nll = -torch.log_softmax(pred, dim=-1).gather(1, target[:, None])[:, 0]
    nll = torch.where(mask, nll, 0.0)
    n = mask.sum()
    return nll.sum() / (n if count is None else count(n)).clamp_min(1)


def train_loss(pred_X, pred_E, true_X, true_E, lambda_train,
               count=None) -> torch.Tensor:
    """lambda-weighted node + edge CE over valid rows."""
    return (lambda_train[0] * _masked_ce(pred_X, true_X, count)
            + lambda_train[1] * _masked_ce(pred_E, true_E, count))
