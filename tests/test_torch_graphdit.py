"""llamole_tpu_torch GraphDiT against llamole_tpu's (f32, CPU).

JAX parameters reach the port through llamole_tpu_torch.weights; inputs
come from seeded numpy. Sampled graphs cannot match bit for bit
(jax.random vs torch.Generator), so the sampler is compared by the
histograms of what it draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models here run faster on one thread, and the suite runs
    several test workers side by side on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

def test_denoiser_train_path_never_reaches_kernel_a_and_matches_jax(
        monkeypatch):
    """train=True runs the JAX package's unfused block (split heads, qk
    LayerNorm, masked_attention, merge): the kernel-A wrapper, which has
    no backward, is never reached, and one block's output and its
    gradient with respect to the condition c equal
    _block_apply(fused_attention=False) within 1e-5."""
    from llamole_tpu.models.graphdit.denoiser import _block_apply
    from llamole_tpu_torch.models.graphdit import denoiser as tden

    def refuse(*args, **kwargs):
        raise AssertionError("fused_block_attention reached with train=True")

    monkeypatch.setattr(tden, "fused_block_attention", refuse)
    jm, params, tm = _pair()
    cfg = jm.cfg
    rng = np.random.default_rng(11)
    b, n, h = 3, cfg.max_n_nodes, cfg.hidden_size
    x = rng.normal(size=(b, n, h)).astype(np.float32)
    c = rng.normal(size=(b, h)).astype(np.float32)
    w = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([[3], [n], [7]])

    def j_out(c_):
        return _block_apply(params["blocks"][0], jnp.asarray(x), c_,
                            jnp.asarray(mask), cfg.num_heads,
                            fused_attention=False)

    want = np.asarray(j_out(jnp.asarray(c)))
    want_dc = np.asarray(jax.grad(
        lambda c_: jnp.sum(j_out(c_) * w))(jnp.asarray(c)))
    ct = torch.from_numpy(c).requires_grad_()
    got = tm.denoiser.blocks[0](torch.from_numpy(x), ct,
                                torch.from_numpy(mask), train=True)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ct.grad.numpy(), want_dc, atol=1e-5,
                               rtol=1e-5)
    # the whole denoiser in train mode stays off the kernel too
    X, E, gmask = _graph_inputs(cfg, 2, seed=12)
    y = rng.normal(size=(2, cfg.ydim)).astype(np.float32)
    txt = rng.normal(size=(2, cfg.text_dim)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    lx, _ = tm.denoiser(*map(torch.from_numpy, (X, E, gmask, y, txt, t)),
                        train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(lx).all()
    with pytest.raises(AssertionError, match="reached"):
        tm.denoiser(*map(torch.from_numpy, (X, E, gmask, y, txt, t)))


def _mol_bank(smiles, n):
    from llamole_tpu.chem.featurize import pad_graph_batch, smiles_to_graph
    bank = pad_graph_batch([smiles_to_graph(s) for s in smiles], n)
    return bank["atom_types"], bank["edge_classes"], bank["node_mask"]


def test_graphdit_loss_matches_jax_on_jax_noise():
    """GraphDiT.loss(train=False) with JAX's apply_noise draw fed through
    `noisy`: the loss (1e-5 rel) and its gradient with respect to the
    text condition (1e-4)."""
    jm, params, tm = _pair()
    cfg = jm.cfg
    atoms, edges, mask = _mol_bank(["CCO", "c1ccncc1", "CC(=O)O"],
                                   cfg.max_n_nodes)
    mask[2] = False                      # a row with no design graph
    rng = np.random.default_rng(13)
    props = rng.normal(size=(3, cfg.ydim)).astype(np.float32)
    props[0, ::2] = -1                   # NO_LABEL_INDEX: absent
    txt = rng.normal(size=(3, cfg.text_dim)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    args = tuple(map(jnp.asarray, (atoms, edges, mask, props)))

    def j_loss(txt_):
        return jm.loss(params, key, *args, txt_, train=False)

    want, want_dt = jax.value_and_grad(j_loss)(jnp.asarray(txt))
    k_noise, _ = jax.random.split(key)
    X, E = jm.codes_to_onehot(*args[:3])
    noisy = jdiff.apply_noise(k_noise, X, E, args[2], jm.schedule, jm.parts,
                              train=False)
    noisy = {k: torch.from_numpy(np.array(noisy[k]))
             for k in ("t", "X_t", "E_t")}
    tt = torch.from_numpy(txt).requires_grad_()
    got = tm.loss(None, *map(torch.from_numpy, (atoms, edges, mask, props)),
                  tt, train=False, noisy=noisy)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_dt),
                               atol=1e-4)


def test_apply_noise_timesteps_and_marginals():
    """t ~ U{0..T} in training and U{1..T} in eval; per noise level the
    empirical node and edge classes of z_t follow apply_Q's
    probabilities (one graph drawn 6000 times, each per-t frequency
    within 5 standard errors + 0.01)."""
    _, _, tm = _pair(steps=4)
    T = tm.schedule.timesteps
    atoms, edges, mask = _mol_bank(["CC(=O)Oc1ccccc1"], tm.cfg.max_n_nodes)
    atoms, edges, mask = (torch.from_numpy(a) for a in (atoms, edges, mask))
    X, E = tm.codes_to_onehot(atoms, edges, mask)
    reps = 6000
    Xb, Eb = X.expand(reps, -1, -1), E.expand(reps, -1, -1, -1)
    mb = mask.expand(reps, -1)
    gen = torch.Generator().manual_seed(0)
    for train, lowest in ((True, 0), (False, 1)):
        noisy = tdiff.apply_noise(gen, Xb, Eb, mb, tm.schedule, tm.parts,
                                  train=train)
        t_int = noisy["t_int"]
        assert set(t_int.tolist()) == set(range(lowest, T + 1))
        torch.testing.assert_close(noisy["t"], t_int.float() / T)
    k = int(mask.sum())
    for t in range(lowest, T + 1):
        rows = t_int == t
        count = int(rows.sum())
        pX, pE = tdiff.apply_Q(X, E, tm.schedule.alphas_bar[t].reshape(1),
                               tm.parts)
        for emp, p in ((noisy["X_t"][rows][:, :k].mean(0), pX[0, :k]),
                       (noisy["E_t"][rows][:, :k, :k].mean(0),
                        pE[0, :k, :k])):
            off_diag = ~torch.eye(k, dtype=torch.bool)
            if emp.dim() == 3:
                emp, p = emp[off_diag], p[off_diag]
            p = p / p.sum(-1, keepdim=True)
            se = torch.sqrt(p * (1 - p) / count)
            assert bool(((emp - p).abs() <= 5 * se + 0.01).all()), t


def test_condition_dropout_and_property_noise_rates():
    """train=True: each property channel and the text drop to their null
    embeddings with probability drop_condition (within 4 standard
    errors), and every property embedding (dropped ones too) carries
    N(0, 1) noise, while the text embedding carries none."""
    _, _, tm = _pair()
    den = tm.denoiser
    rng = np.random.default_rng(14)
    b, p = 4000, 0.25
    y = torch.from_numpy(rng.normal(size=(b, den.cfg.ydim)).astype(
        np.float32))
    txt = torch.from_numpy(rng.normal(size=(b, den.cfg.text_dim)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        t_emb = den.txt_embedder(txt, False, torch.float32, True, p, gen)
        null = den.txt_embedder.null_embedding[0]
        dropped = (t_emb == null).all(dim=1)
        kept = torch.isclose(t_emb, den.txt_embedder.linear(txt)).all(dim=1)
        assert bool((dropped ^ kept).all())
        assert abs(float(dropped.float().mean()) - p) < 4 * np.sqrt(
            p * (1 - p) / b)

        one = y[:, :1].clone()
        ye = den.y_embedder
        clean = _one_channel(ye, one, False, p, gen)     # no drop, no noise
        null = ye.null_embedding[0]
        noisy = _one_channel(ye, one, True, p, gen)
        d_null = (noisy - null).norm(dim=1)
        d_clean = (noisy - clean).norm(dim=1)
        drop = d_null < d_clean
        assert abs(float(drop.float().mean()) - p) < 4 * np.sqrt(
            p * (1 - p) / b)
        resid = torch.where(drop[:, None], noisy - null, noisy - clean)
        assert abs(float(resid.mean())) < 0.01
        assert abs(float(resid.std()) - 1.0) < 0.01


def _one_channel(embedder, y, train, p, gen):
    """The property embedder over its first channel alone."""
    mlps = embedder.mlps
    embedder.mlps = mlps[:1]
    try:
        return embedder(y, False, torch.float32, train, p, gen)
    finally:
        embedder.mlps = mlps


def test_int8_denoiser_matches_jax_and_refuses_autograd():
    """quantize_denoiser_params on both packages (the JAX package's
    test_int8_quantized_denoiser): the port's int8 leaves equal JAX's bit
    for bit through the bridge; its logits are within 0.05 of JAX's int8
    logits and of its own dense ones, relative to the largest logit
    (tests/test_graphdit.py's bound); the sampler runs on it; and a
    forward under autograd raises (the quantizer has no gradient)."""
    from llamole_tpu.models.graphdit.denoiser import (
        quantize_denoiser_params as jax_quantize)
    from llamole_tpu_torch.models.graphdit.denoiser import (
        quantize_denoiser_params)

    jm, params, tm = _pair()
    cfg = jm.cfg
    b = 3
    X, E, mask = _graph_inputs(cfg, b, seed=4)
    rng = np.random.default_rng(5)
    y = rng.normal(size=(b, cfg.ydim)).astype(np.float32)
    txt = rng.normal(size=(b, cfg.text_dim)).astype(np.float32)
    t = rng.random(b).astype(np.float32)
    inputs = (X, E, mask, y, txt, t)
    qparams = jax.tree.map(np.asarray, jax_quantize(params))
    want = apply_denoiser(qparams, cfg, *map(jnp.asarray, inputs))
    with torch.no_grad():
        dense = tm.denoiser(*map(torch.from_numpy, inputs))
    quantize_denoiser_params(tm.denoiser)
    ours = tm.denoiser.state_dict()
    theirs = state_dict_of(qparams)
    assert set(ours) == set(theirs)
    for name, v in theirs.items():
        assert torch.equal(ours[name], v), name
    assert tm.denoiser.blocks[0].attn.qkv.w_q.dtype == torch.int8
    with torch.no_grad():
        got = tm.denoiser(*map(torch.from_numpy, inputs))
    for g, w, d in zip(got, want, dense):
        w = np.asarray(w)
        rel = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-9)
        assert rel < 0.05, rel
        rel = (g - d).abs().max().item() / (d.abs().max().item() + 1e-9)
        assert rel < 0.05, rel
    props = torch.full((2, cfg.ydim), float("nan"))
    smiles = tm.generate(torch.Generator().manual_seed(0), props,
                         torch.zeros(2, cfg.text_dim))
    assert len(smiles) == 2
    with pytest.raises(RuntimeError, match="no gradient"):
        tm.denoiser(*map(torch.from_numpy, inputs))
