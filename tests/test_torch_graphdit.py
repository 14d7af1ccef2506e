"""llamole_tpu_torch GraphDiT against llamole_tpu's (f32, CPU).

JAX parameters reach the port through llamole_tpu_torch.weights; inputs
come from seeded numpy. Sampled graphs cannot match bit for bit
(jax.random vs torch.Generator), so the sampler is compared by the
histograms of what it draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.graphdit.denoiser import apply_denoiser
from llamole_tpu.models.graphdit import diffusion as jdiff
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.graphdit import diffusion as tdiff
from llamole_tpu_torch.weights import state_dict_of

CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
          "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "c1cc[nH]c1"]


def _perturb(tree, seed, scale=0.2):
    """Every leaf + noise, so zero-initialised AdaLN gates open and the
    attention path reaches the logits."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


def _pair(max_n=12, steps=8, **kw):
    cfg = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=steps,
               text_dim=16, **kw)
    jm = JaxGraphDiT(JaxDiTConfig(**cfg), jax_data_info(CORPUS, max_n))
    params = _perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = GraphDiT(GraphDiTConfig(**cfg), build_data_info_from_smiles(
        CORPUS, max_n))
    tm.denoiser.load_state_dict(state_dict_of(params))
    return jm, params, tm


def _graph_inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    n = cfg.max_n_nodes
    n_nodes = rng.integers(1, n + 1, size=b)
    mask = np.arange(n)[None, :] < n_nodes[:, None]
    X = np.eye(cfg.Xdim, dtype=np.float32)[rng.integers(0, cfg.Xdim, (b, n))]
    E = np.eye(cfg.Edim, dtype=np.float32)[rng.integers(0, cfg.Edim,
                                                        (b, n, n))]
    X = X * mask[..., None]
    E = E * (mask[:, :, None] & mask[:, None, :])[..., None]
    return X, E, mask


def test_denoiser_logits_match_jax():
    jm, params, tm = _pair()
    cfg = jm.cfg
    b = 4
    X, E, mask = _graph_inputs(cfg, b, seed=2)
    rng = np.random.default_rng(3)
    y = rng.normal(size=(b, cfg.ydim)).astype(np.float32)
    y[0, :] = np.nan          # fully unconditioned row
    y[1:, ::3] = np.nan       # some absent channels
    txt = rng.normal(size=(b, cfg.text_dim)).astype(np.float32)
    txt[2] = np.nan           # dropped text condition
    t = rng.random(b).astype(np.float32)
    for unconditioned in (False, True):
        want = apply_denoiser(params, cfg, *map(jnp.asarray,
                                                (X, E, mask, y, txt, t)),
                              unconditioned=unconditioned)
        with torch.no_grad():
            got = tm.denoiser(*map(torch.from_numpy, (X, E, mask, y, txt, t)),
                              unconditioned=unconditioned)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_transition_products_match_jax():
    jm, _, tm = _pair()
    cfg = jm.cfg
    b = 3
    X, E, mask = _graph_inputs(cfg, b, seed=4)
    rng = np.random.default_rng(5)
    pX = rng.dirichlet(np.ones(cfg.Xdim), size=(b, cfg.max_n_nodes))
    pE = rng.dirichlet(np.ones(cfg.Edim),
                       size=(b, cfg.max_n_nodes, cfg.max_n_nodes))
    pX, pE = pX.astype(np.float32), pE.astype(np.float32)
    coef = rng.random(b).astype(np.float32)
    beta, a_s, a_t = (rng.random(b).astype(np.float32) for _ in range(3))

    want = jdiff.apply_Q(jnp.asarray(X), jnp.asarray(E), jnp.asarray(coef),
                         jm.parts)
    got = tdiff.apply_Q(torch.from_numpy(X), torch.from_numpy(E),
                        torch.from_numpy(coef), tm.parts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)

    want = jdiff.posterior_unnormalized(
        *map(jnp.asarray, (X, E, pX, pE, beta, a_s, a_t)), jm.parts)
    got = tdiff.posterior_unnormalized(
        *map(torch.from_numpy, (X, E, pX, pE, beta, a_s, a_t)), tm.parts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _histograms(atom_idx, edge_cls, n_nodes, dx, de):
    atoms = np.zeros(dx)
    bonds = np.zeros(de)
    for a, e, k in zip(atom_idx, edge_cls, n_nodes):
        k = int(k)
        atoms += np.bincount(a[:k], minlength=dx)
        iu = np.triu_indices(k, 1)
        bonds += np.bincount(e[:k, :k][iu], minlength=de)
    return atoms, bonds


def test_sampler_histograms_match_jax():
    """Same params, 1024 graphs each: atom- and bond-type histograms
    agree within total variation TV_BOUND. The noise floor -- the
    expected TV between two independent M-sample histograms of the same
    law p, sum_k sqrt(p_k (1 - p_k) / (pi M)) -- is asserted to be at
    most a third of the bound."""
    TV_BOUND = 0.1
    B = 1024
    jm, params, tm = _pair(max_n=8, steps=10)
    cfg = jm.cfg
    rng = np.random.default_rng(6)
    y = rng.normal(size=(B, cfg.ydim)).astype(np.float32)
    y[:, 1::2] = np.nan
    txt = rng.normal(size=(B, cfg.text_dim)).astype(np.float32)

    ja, je, jn = map(np.asarray, jm._sample_jit(
        params, jax.random.PRNGKey(7), jnp.asarray(y), jnp.asarray(txt)))
    ta, te, tn = (a.numpy() for a in tm.sample(
        torch.Generator().manual_seed(7), torch.from_numpy(y),
        torch.from_numpy(txt)))
    for j_h, t_h in zip(_histograms(ja, je, jn, cfg.Xdim, cfg.Edim),
                        _histograms(ta, te, tn, cfg.Xdim, cfg.Edim)):
        m = j_h.sum()
        p = j_h / m
        floor = float(np.sum(np.sqrt(p * (1 - p) / (np.pi * m))))
        assert floor <= TV_BOUND / 3, floor
        tv = 0.5 * float(np.abs(p - t_h / t_h.sum()).sum())
        assert tv < TV_BOUND, (tv, floor)
