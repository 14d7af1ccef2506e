"""Kernel B's function and the GIN modules of llamole_tpu_torch against the
JAX reference: gin_aggregate, GINConv, GraphCLIP, GraphPredictor and
CostMLP, with the same seeded numpy inputs and the JAX params bridged
through llamole_tpu_torch.weights (f32 on the CPU, atol 1e-4, the JAX
kernel's contract in tests/test_pallas.py). The kernel itself runs only on
a CUDA card (tests/test_torch_kernels.py); on the CPU the wrapper runs its
plain version, which is what these tests pin.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.chem.featurize import smiles_to_graph
from llamole_tpu.models.graphclip.model import GraphCLIP as JaxCLIP
from llamole_tpu.models.graphclip.model import GraphCLIPConfig as JaxCLIPCfg
from llamole_tpu.models.loader import _FALLBACK_TEMPLATES as JAX_TEMPLATES
from llamole_tpu.models.loader import make_fallback_predictor as jax_predictor
from llamole_tpu.models.retro.model import CostMLP as JaxCostMLP
from llamole_tpu.ops.gin import gin_conv_apply, gin_conv_init
from llamole_tpu_torch.chem.featurize import \
    smiles_to_graph as torch_smiles_to_graph
from llamole_tpu_torch.models.graphclip import GraphCLIP, GraphCLIPConfig
from llamole_tpu_torch.models.loader import (_FALLBACK_TEMPLATES,
                                             make_fallback_predictor)
from llamole_tpu_torch.models.retro import CostMLP
from llamole_tpu_torch.ops.gin import (GINConv, masked_add_pool,
                                       masked_max_pool)
from llamole_tpu_torch.ops.gin_aggregate import (
    gin_aggregate, gin_aggregate_backward, gin_aggregate_backward_reference,
    gin_aggregate_reference)
from llamole_tpu_torch.weights import cost_mlp_state_dict, state_dict_of

# the package re-exports the function under the module's name
jax_gin_mod = importlib.import_module("llamole_tpu.ops.pallas.gin_aggregate")
ATOL = 1e-4
MOLS = ["CC(=O)OCC", "c1ccncc1", "CC(N)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _graphs(b, n, h, seed=0, symmetric=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, h)).astype(np.float32)
    edges = rng.integers(0, 5, (b, n, n)).astype(np.int32)
    if symmetric:
        edges = np.triu(edges, 1)
        edges = edges + edges.transpose(0, 2, 1)
    adj = (edges > 0).astype(np.float32)
    table = rng.normal(size=(5, h)).astype(np.float32)
    return x, edges, adj, table


@pytest.mark.parametrize("b,n,h", [(3, 11, 40), (2, 17, 64), (1, 9, 33)])
def test_gin_aggregate_matches_jax_pallas_on_symmetric_graphs(b, n, h):
    x, e, a, t = _graphs(b, n, h)
    got = gin_aggregate(_t(x), _t(e), _t(a), _t(t)).numpy()
    want = np.asarray(jax_gin_mod.gin_aggregate(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(a), jnp.asarray(t),
        use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("b,n,h", [(3, 11, 40), (2, 7, 17)])
def test_gin_aggregate_matches_jax_reference_on_asymmetric_graphs(b, n, h):
    x, e, a, t = _graphs(b, n, h, seed=1, symmetric=False)
    got = gin_aggregate(_t(x), _t(e), _t(a), _t(t)).numpy()
    want = np.asarray(jax_gin_mod.gin_aggregate(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(a), jnp.asarray(t),
        use_pallas=False))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_gin_aggregate_empty_graph_is_zero():
    out = gin_aggregate(torch.zeros(1, 4, 8),
                        torch.zeros(1, 4, 4, dtype=torch.int32),
                        torch.zeros(1, 4, 4), torch.ones(5, 8))
    assert torch.equal(out, torch.zeros(1, 4, 8))


def test_gin_wrapper_on_cpu_is_plain_and_uncounted():
    x, e, a, t = map(_t, _graphs(2, 6, 8, seed=2))
    before = gin_aggregate.launches
    out = gin_aggregate(x, e, a, t)
    assert gin_aggregate.launches == before
    assert torch.equal(out, gin_aggregate_reference(x, e, a, t))
    # bf16 rounds once, after the f32 sum
    out16 = gin_aggregate(x.bfloat16(), e, a.bfloat16(), t.bfloat16())
    assert out16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unsupported device"):
        gin_aggregate(x.to("meta"), e.to("meta"), a.to("meta"),
                      t.to("meta"))


def _grad(b, n, h, seed):
    return np.random.default_rng(seed).normal(size=(b, n, h)).astype(
        np.float32)


@pytest.mark.parametrize("b,n,h", [(2, 9, 24), (3, 11, 40)])
def test_gin_backward_matches_jax_kernel_and_reference(b, n, h):
    """Kernel C's plain version against the JAX kernel (interpret mode)
    and its jnp backward, on symmetric graphs, atol = rtol = 1e-4."""
    x, e, a, t = _graphs(b, n, h, seed=3)
    g = _grad(b, n, h, 4)
    dx, dt = gin_aggregate_backward(_t(x), _t(e), _t(a), _t(t), _t(g))
    args = tuple(map(jnp.asarray, (x, e, a, t)))
    pal_dx, pal_dt = jax_gin_mod._gin_bwd_pallas(*args, jnp.asarray(g),
                                                  interpret=True)
    ref_dx, _, _, ref_dt = jax_gin_mod._gin_bwd_jnp(args, jnp.asarray(g))
    for want_dx, want_dt in ((pal_dx, pal_dt), (ref_dx, ref_dt)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(want_dt),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("b,n,h", [(2, 9, 24), (3, 11, 40)])
def test_gin_backward_matches_jax_reference_on_directed_graphs(b, n, h):
    """Directed graphs: only the jnp backward is general (the Pallas
    kernel reads rows as columns)."""
    x, e, a, t = _graphs(b, n, h, seed=5, symmetric=False)
    g = _grad(b, n, h, 6)
    dx, dt = gin_aggregate_backward(_t(x), _t(e), _t(a), _t(t), _t(g))
    args = tuple(map(jnp.asarray, (x, e, a, t)))
    ref_dx, _, _, ref_dt = jax_gin_mod._gin_bwd_jnp(args, jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(ref_dt), atol=ATOL,
                               rtol=ATOL)


def test_gin_autograd_function_gradcheck():
    """The autograd.Function on the CPU (plain forward, plain backward)
    in float64, against finite differences; the backward is also what
    autograd through the plain forward gives."""
    x, e, a, t = _graphs(2, 6, 5, seed=7, symmetric=False)
    x = _t(x).double().requires_grad_()
    t = _t(t).double().requires_grad_()
    e, a = _t(e), _t(a).double()
    assert torch.autograd.gradcheck(
        lambda x_, t_: gin_aggregate(x_, e, a, t_), (x, t))
    g = torch.randn(2, 6, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(gin_aggregate_reference(x, e, a, t), (x, t),
                               g)
    got = torch.autograd.grad(gin_aggregate(x, e, a, t), (x, t), g)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=1e-12, atol=1e-12)
    before = gin_aggregate_backward.launches
    gin_aggregate_backward_reference(x.detach(), e, a, t.detach(), g)
    gin_aggregate(x, e, a, t).sum().backward()
    assert gin_aggregate_backward.launches == before   # CPU: uncounted


def _padded_bank(last, rows=12, n=24, h=32, seed=8):
    """A bank shaped like training's, cut to (12, 24, 32): MOLS featurized
    by the port in the last (or the first) rows and empty graphs in the
    rest, as run_mmsft's collator fills its banks; x, the table and an
    output gradient from a seeded numpy generator."""
    graphs = [torch_smiles_to_graph(s) for s in MOLS]
    edges = np.zeros((rows, n, n), np.int32)
    mask = np.zeros((rows, n), bool)
    for r, g in enumerate(graphs, rows - len(graphs) if last else 0):
        edges[r, :g.n_nodes, :g.n_nodes] = g.edge_classes
        mask[r, :g.n_nodes] = True
    adj = ((edges > 0) & mask[:, :, None] & mask[:, None, :]).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    x, g = (rng.normal(size=(rows, n, h)).astype(np.float32)
            for _ in range(2))
    table = rng.normal(size=(5, h)).astype(np.float32)
    return x, edges, adj, table, g, mask


BANK_TOL = 1e-5


@pytest.mark.parametrize("last", [True, False], ids=["last", "first"])
def test_gin_aggregate_matches_jax_on_a_padded_bank(last):
    """The port's gin_aggregate (the plain path on the CPU) against the
    JAX kernel in interpret mode and _gin_reference on a mostly empty
    bank, f32 within 1e-5; the empty graphs give exact zeros."""
    x, e, a, t, _, mask = _padded_bank(last)
    got = gin_aggregate(_t(x), _t(e), _t(a), _t(t)).numpy()
    args = tuple(map(jnp.asarray, (x, e, a, t)))
    for want in (jax_gin_mod._gin_aggregate_pallas(*args, interpret=True),
                 jax_gin_mod._gin_reference(*args)):
        np.testing.assert_allclose(got, np.asarray(want), atol=BANK_TOL,
                                   rtol=BANK_TOL)
    assert not got[~mask.any(axis=1)].any()


@pytest.mark.parametrize("last", [True, False], ids=["last", "first"])
def test_gin_backward_matches_jax_on_a_padded_bank(last):
    """Autograd through the port's gin_aggregate (the plain backward on
    the CPU) against _gin_bwd_jnp and the JAX backward kernel in interpret
    mode on the same bank, f32 within 1e-5."""
    x, e, a, t, g, _ = _padded_bank(last)
    xt, tt = _t(x).requires_grad_(), _t(t).requires_grad_()
    gin_aggregate(xt, _t(e), _t(a), tt).backward(_t(g))
    args = tuple(map(jnp.asarray, (x, e, a, t)))
    ref_dx, _, _, ref_dt = jax_gin_mod._gin_bwd_jnp(args, jnp.asarray(g))
    pal_dx, pal_dt = jax_gin_mod._gin_bwd_pallas(*args, jnp.asarray(g),
                                                  interpret=True)
    for want_dx, want_dt in ((ref_dx, ref_dt), (pal_dx, pal_dt)):
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                                   atol=BANK_TOL, rtol=BANK_TOL)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_dt),
                                   atol=BANK_TOL, rtol=BANK_TOL)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Route llamole_tpu's GIN layers through the Pallas kernel in
    interpret mode (the JAX package's own CPU path to its kernel)."""
    monkeypatch.setattr(jax_gin_mod, "gin_aggregate", functools.partial(
        jax_gin_mod.gin_aggregate, use_pallas=True, interpret=True))


def test_gin_conv_matches_jax(interpret_pallas):
    x, e, a, _ = _graphs(2, 9, 24, seed=3)
    params = _np(gin_conv_init(jax.random.PRNGKey(0), 24))
    params["eps"] = np.float32(0.25)
    conv = GINConv(24)
    conv.load_state_dict(state_dict_of(params))
    with torch.no_grad():
        got = conv(_t(x), _t(e), _t(a)).numpy()
    want = np.asarray(gin_conv_apply(params, jnp.asarray(x), jnp.asarray(e),
                                     jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pools_match_jax():
    from llamole_tpu.ops import gin as jgin
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    mask = rng.random((3, 5)) > 0.4
    mask[:, 0] = True
    for ours, theirs in ((masked_add_pool, jgin.masked_add_pool),
                         (masked_max_pool, jgin.masked_max_pool)):
        np.testing.assert_allclose(
            ours(_t(x), _t(mask)).numpy(),
            np.asarray(theirs(jnp.asarray(x), jnp.asarray(mask))), atol=1e-5)


def _mol_batch(smiles, n=None):
    graphs = [smiles_to_graph(s) for s in smiles]
    n = n or ((max(g.n_nodes for g in graphs) + 7) // 8) * 8
    atoms = np.zeros((len(graphs), n), np.int32)
    edges = np.zeros((len(graphs), n, n), np.int32)
    mask = np.zeros((len(graphs), n), bool)
    for i, g in enumerate(graphs):
        atoms[i, :g.n_nodes] = g.atom_types
        edges[i, :g.n_nodes, :g.n_nodes] = g.edge_classes
        mask[i, :g.n_nodes] = True
    return atoms, edges, mask


def test_graphclip_matches_jax(interpret_pallas, tmp_path):
    jm = JaxCLIP(JaxCLIPCfg(num_layer=3, hidden_size=32))
    params = _np(jm.init(jax.random.PRNGKey(1)))
    params["virtualnode"] = np.random.default_rng(5).normal(
        size=32).astype(np.float32)
    tm = GraphCLIP(GraphCLIPConfig(num_layer=3, hidden_size=32))
    tm.load_state_dict(state_dict_of(params))
    atoms, edges, mask = _mol_batch(MOLS)
    with torch.no_grad():
        feats = tm.encode(_t(atoms), _t(edges), _t(mask)).numpy()
        emb = tm(_t(atoms), _t(edges), _t(mask)).numpy()
    j_in = [jnp.asarray(a) for a in (atoms, edges, mask)]
    np.testing.assert_allclose(feats, np.asarray(jm.encode(params, *j_in)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(emb, np.asarray(jm(params, *j_in)), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    # the JAX package's saved directory loads in the port, bit for bit
    jm.save_pretrained(params, str(tmp_path / "graph_encoder"))
    loaded = GraphCLIP.from_pretrained(str(tmp_path / "graph_encoder"))
    assert loaded.cfg == tm.cfg
    with torch.no_grad():
        np.testing.assert_array_equal(
            loaded(_t(atoms), _t(edges), _t(mask)).numpy(), emb)


@pytest.fixture(scope="module")
def predictors():
    jm = jax_predictor(num_layer=3, hidden_size=32, out_dim=16,
                       text_input_size=24)
    params = _np(jm.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(6)
    for ada in params["adapters"]:   # open the zero-initialised AdaLN gates
        ada["w"] = rng.normal(size=ada["w"].shape).astype(np.float32) * 0.2
        ada["b"] = rng.normal(size=ada["b"].shape).astype(np.float32) * 0.2
    tm = make_fallback_predictor(3, 32, 16, 24)
    tm.load_state_dict(state_dict_of(params))
    return jm, params, tm


@pytest.mark.parametrize("with_text", [False, True])
def test_graph_predictor_logits_match_jax(predictors, interpret_pallas,
                                          with_text):
    jm, params, tm = predictors
    atoms, edges, mask = _mol_batch(MOLS)
    c = (np.random.default_rng(7).normal(size=(len(MOLS), 24))
         .astype(np.float32) if with_text else None)
    with torch.no_grad():
        got = tm(_t(atoms), _t(edges), _t(mask),
                 None if c is None else _t(c)).numpy()
    want = np.asarray(jm(params, jnp.asarray(atoms), jnp.asarray(edges),
                         jnp.asarray(mask),
                         None if c is None else jnp.asarray(c)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_sample_templates_and_inventory_match_jax(predictors):
    jm, params, tm = predictors
    assert _FALLBACK_TEMPLATES == JAX_TEMPLATES
    assert tm.available == jm.available
    c = np.random.default_rng(8).normal(size=24).astype(np.float32)
    for smi in ("CC(=O)OCC", "CC(=O)NCC", "c1ccccc1"):
        got = tm.sample_templates(torch_smiles_to_graph(smi), _t(c), smi,
                                  topk=16)
        want = jm.sample_templates(params, smiles_to_graph(smi),
                                   jnp.asarray(c), smi, topk=16)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_cost_mlp_matches_jax():
    jm = JaxCostMLP(n_layers=2, fp_dim=64, latent_dim=16)
    params = _np(jm.init(jax.random.PRNGKey(3)))
    tm = CostMLP(n_layers=2, fp_dim=64, latent_dim=16)
    tm.load_state_dict(cost_mlp_state_dict(params))
    smiles = ["CCO", "not a molecule", "c1ccccc1C(=O)O"]
    np.testing.assert_allclose(tm.estimate_costs(smiles),
                               jm.estimate_costs(params, smiles), atol=1e-5)
    np.testing.assert_allclose(tm.estimate_cost("CCO"),
                               jm.estimate_cost(params, "CCO"), atol=1e-5)
    with pytest.raises(ValueError, match="Invalid SMILES"):
        tm.estimate_cost("not a molecule")


# kernel C past the staged body's 161 nodes: one large molecule widens a
# whole pretraining bank
LARGE = "OC" + "C" * 159 + "N"   # 162 heavy atoms


def test_gin_backward_plain_matches_jax_past_161_nodes():
    """The plain C (what the CPU runs, and what the card's second body is
    held to) at N = 170 against the JAX jnp backward, on sparse
    molecule-like graphs (~3 bonds a node), atol = rtol = 1e-5."""
    b, n, h = 2, 170, 16
    rng = np.random.default_rng(12)
    bonded = np.triu(rng.random((b, n, n)) < 3.0 / n, 1)
    edges = (bonded * rng.integers(1, 5, (b, n, n))).astype(np.int32)
    edges = edges + edges.transpose(0, 2, 1)
    adj = (edges > 0).astype(np.float32)
    x = rng.normal(size=(b, n, h)).astype(np.float32)
    table = rng.normal(size=(5, h)).astype(np.float32)
    g = _grad(b, n, h, 13)
    dx, dt = gin_aggregate_backward(_t(x), _t(edges), _t(adj), _t(table),
                                    _t(g))
    want_dx, _, _, want_dt = jax_gin_mod._gin_bwd_jnp(
        tuple(map(jnp.asarray, (x, edges, adj, table))), jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(want_dt), atol=1e-5,
                               rtol=1e-5)


def test_gin_backward_body_routes_by_n():
    from llamole_tpu_torch.ops.gin_aggregate import (
        GIN_BWD_MAX_NODES, GIN_BWD_SMEM_MAX_NODES, gin_backward_body,
        gin_backward_shared_bytes)
    from llamole_tpu_torch.ops.cuda_lib import MAX_SHARED_BYTES
    assert (GIN_BWD_SMEM_MAX_NODES, GIN_BWD_MAX_NODES) == (161, 1292)
    assert [gin_backward_body(n) for n in (1, 161, 162, 512, 1292)] == [
        "smem", "smem", "global", "global", "global"]
    # each body's largest N is the last whose block fits shared memory
    for body, n in (("smem", 161), ("global", 1292)):
        assert gin_backward_shared_bytes(n, body) <= MAX_SHARED_BYTES
        assert gin_backward_shared_bytes(n + 1, body) > MAX_SHARED_BYTES
    # the second body keeps the masks alone: 32 KB of them at N = 512
    assert gin_backward_shared_bytes(512, "global") == 4 * (512 * 16
                                                            + 8 * 5 * 128)


def test_both_packages_size_the_bank_by_a_162_atom_molecule(tmp_path,
                                                            monkeypatch):
    """GraphCLIP's pretraining bank in both packages is the largest
    molecule rounded up to 8: 168 for a corpus holding one of 162 atoms,
    past the staged body, so the port's steps take the second body."""
    import json

    import llamole_tpu.train.pretrain as jax_pretrain
    import llamole_tpu_torch.train.pretrain as torch_pretrain
    from llamole_tpu_torch.ops.gin_aggregate import gin_backward_body

    assert torch_smiles_to_graph(LARGE).n_nodes == 162
    records = [{"instruction": f"Design molecule {i}.", "input": "",
                "output": f"It is <mol_start>{s}<mol_end>.", "property": {},
                "retro": []}
               for i, s in enumerate(MOLS + [LARGE])]
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(records))

    class Padded(Exception):
        pass

    seen = {}

    def capture(key):
        def pad(graphs, n, *args, **kwargs):
            seen[key] = n
            raise Padded
        return pad

    monkeypatch.setattr(jax_pretrain, "pad_graph_batch", capture("jax"))
    monkeypatch.setattr(torch_pretrain, "_graph_tensors", capture("torch"))
    with pytest.raises(Padded):
        jax_pretrain.pretrain_graphclip(str(corpus), str(tmp_path / "j"),
                                        num_layer=2, hidden_size=16,
                                        steps=1)
    with pytest.raises(Padded):
        torch_pretrain.pretrain_graphclip(str(corpus), str(tmp_path / "t"),
                                          num_layer=2, hidden_size=16,
                                          steps=1, device="cpu")
    assert seen == {"jax": 168, "torch": 168}
    assert gin_backward_body(seen["torch"]) == "global"
