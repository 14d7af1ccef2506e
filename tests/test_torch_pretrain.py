"""The port's offline learned-weights stack against the JAX package's, on
the CPU at small sizes (GIN 2 x 32, GraphDiT 32 x 2, 4-8 steps, a
24-record corpus):

  (a) write_corpus: the same bytes and sidecars for the same seed and size
  (b) validate_molqa: the same report
  (c) the msgpack codec against flax.serialization (bf16, 0-d and chunked
      leaves), both ways
  (d) every module's directory, written by one package and read by the
      other: the same weights, forwards within 1e-5
  (e) the predictor, GraphCLIP, oracle and CostMLP pretraining loops from
      JAX's init: every step's loss within 1e-4 relative, the saved trees
      within 1e-5
  (f) GraphDiT pretraining: finite, falling loss; GraphDiT.loss on JAX's
      noise draw within 1e-5 of JAX's
  (h) oracle_property_metrics on a trained oracle: JAX's numbers
"""

import contextlib
import filecmp
import gzip
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from llamole_tpu.data import synthetic as jsynth
from llamole_tpu.data.validate import validate_molqa as jax_validate
from llamole_tpu.eval.scoring import \
    oracle_property_metrics as jax_oracle_metrics
from llamole_tpu.models import oracle as joracle
from llamole_tpu.models.graphclip.model import GraphCLIP as JaxCLIP
from llamole_tpu.models.graphclip.model import GraphCLIPConfig as JaxCLIPCfg
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit import diffusion as jdiff
from llamole_tpu.models.graphdit.config import \
    build_data_info_from_smiles as jax_data_info
from llamole_tpu.models.graphdit.denoiser import apply_denoiser
from llamole_tpu.models.retro import CostMLP as JaxCostMLP
from llamole_tpu.models.retro import GraphPredictor as JaxPredictor
from llamole_tpu.models.retro import GraphPredictorConfig as JaxPredCfg
from llamole_tpu.ops.nn import dense_init
from llamole_tpu.train import pretrain as jpre
from llamole_tpu.utils.serialization import load_pytree as jax_load
from llamole_tpu_torch.chem.featurize import pad_graph_batch, smiles_to_graph
from llamole_tpu_torch.data import synthetic as tsynth
from llamole_tpu_torch.data.validate import validate_molqa
from llamole_tpu_torch.eval.scoring import oracle_property_metrics
from llamole_tpu_torch.models.graphclip.model import GraphCLIP
from llamole_tpu_torch.models.graphdit import GraphDiT
from llamole_tpu_torch.models.oracle import PropertyOracle
from llamole_tpu_torch.models.retro import CostMLP, GraphPredictor
from llamole_tpu_torch.train import pretrain as tpre
from llamole_tpu_torch.utils import serialization as tser
from llamole_tpu_torch.weights import jax_tree_of, state_dict_of

MOLS = ["CC(=O)OCC", "c1ccncc1", "CC(N)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
        "not a molecule"]
TOL = 1e-5            # forwards and saved trees (f32)
LOSS_RTOL = 1e-4      # per-step losses of the pretraining loops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's 24-record corpus, and the JAX package's beside it."""
    d = tmp_path_factory.mktemp("corpus")
    ours = tsynth.write_corpus(str(d / "port" / "train.json"), 24, seed=0)
    theirs = jsynth.write_corpus(str(d / "jax" / "train.json"), 24, seed=0)
    return d, ours, theirs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _host(tree):
    """A port tree (torch leaves, bf16 included) as float-exact numpy."""
    return jax.tree.map(
        lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)
                   and t.dtype == torch.bfloat16
                   else t.numpy() if isinstance(t, torch.Tensor) else t),
        tree)


def _assert_trees_close(got, want, tol=0.0):
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        if isinstance(w, str):
            assert g == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if tol:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=tol,
                                       atol=tol)
        else:
            assert g.dtype == w.dtype or w.dtype.name == "bfloat16"
            np.testing.assert_array_equal(g.astype(np.float64),
                                          w.astype(np.float64))


def _same_file(a, b) -> bool:
    """Equal bytes; a .gz by its content (its header holds the mtime)."""
    if str(a).endswith(".gz"):
        with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
            return fa.read() == fb.read()
    return filecmp.cmp(a, b, shallow=False)


# -- (a), (b) corpus and preflight --------------------------------------------

def test_write_corpus_is_byte_identical_to_jax(corpus):
    d, ours, theirs = corpus
    assert ours == theirs
    names = sorted(os.listdir(d / "jax"))
    assert names == ["train.inventory.json", "train.json",
                     "train.templates.json"]
    assert sorted(os.listdir(d / "port")) == names
    for name in names:
        assert filecmp.cmp(d / "port" / name, d / "jax" / name,
                           shallow=False), name


def test_validate_molqa_report_equals_jax(corpus, tmp_path):
    d = corpus[0]
    path = str(d / "port" / "train.json")
    assert validate_molqa(path, cutoff_len=256) == jax_validate(
        path, cutoff_len=256)
    bad = tmp_path / "bad.json"
    bad.write_text('[{"output": "<mol_start>C1CC<mol_end>"}, 3, '
                   '{"instruction": "x", "output": "none", "retro": [1]}]')
    assert validate_molqa(str(bad)) == jax_validate(str(bad))


# -- (c) the msgpack codec ---------------------------------------------------

def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "dense": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "b": np.zeros(5, np.float32)},
        "layers": [{"scale": rng.normal(size=3).astype(np.float32)},
                   {"eps": np.asarray(0.25, np.float32)}],      # 0-d leaf
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(4, 6)),
                                       jnp.bfloat16)),
        "codes": np.arange(12, dtype=np.int32).reshape(3, 4),
        "mask": np.asarray([True, False, True]),
        "scalar": np.float32(1.5), "count": 70000, "neg": -40, "x": 0.5,
        "none": None, "flag": True, "name": "llamole" * 6, "empty": [],
    }


def _as_port_leaves(tree):
    """numpy leaves -> torch (bf16 through its bit pattern)."""
    def conv(a):
        if isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a.copy())
        return a
    return jax.tree.map(conv, tree)


def test_port_written_msgpack_restores_in_flax(tmp_path):
    tree = _codec_tree()
    tser.save_pytree(_as_port_leaves(tree), str(tmp_path / "t.msgpack"))
    data = (tmp_path / "t.msgpack").read_bytes()
    back = flax_ser.msgpack_restore(data)
    assert back["bf16"].dtype.name == "bfloat16"
    assert back["layers"][1]["eps"].shape == ()
    # np.float32 scalars travel as numpy scalars, 0-d arrays as 0-d arrays
    _assert_trees_close(back, flax_ser.msgpack_restore(
        flax_ser.msgpack_serialize(tree)))
    # and the bytes are flax's own
    assert data == flax_ser.msgpack_serialize(tree)


def test_flax_written_msgpack_loads_in_the_port(tmp_path):
    tree = _codec_tree()
    (tmp_path / "t.msgpack").write_bytes(flax_ser.msgpack_serialize(tree))
    got = tser.load_pytree(str(tmp_path / "t.msgpack"))
    assert got["bf16"].dtype == torch.bfloat16
    assert got["layers"][1]["eps"].shape == ()
    assert got["scalar"].shape == () and got["scalar"].dtype == torch.float32
    want = dict(tree, scalar=np.asarray(tree["scalar"]))
    _assert_trees_close(_host(got), jax.tree.map(
        lambda a: (np.asarray(a, np.float32) if isinstance(a, np.ndarray)
                   and a.dtype.name == "bfloat16" else a), want))


@pytest.mark.parametrize("writer", ["flax", "port"])
def test_chunked_leaves_round_trip(tmp_path, monkeypatch, writer):
    """Leaves past MAX_CHUNK_SIZE (made small here) travel as
    __msgpack_chunked_array__ maps; each package reads the other's."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.normal(size=(10, 7)).astype(np.float32),
            "nested": {"wide": rng.normal(size=(33,)).astype(np.float64)},
            "listed": [rng.normal(size=(40,)).astype(np.float32)],
            "small": np.ones(3, np.float32)}
    path = str(tmp_path / "c.msgpack")
    if writer == "flax":
        with open(path, "wb") as f:
            f.write(flax_ser.msgpack_serialize(tree))
        with open(path, "rb") as f:
            assert b"__msgpack_chunked_array__" in f.read()
        _assert_trees_close(_host(tser.load_pytree(path)), tree)
    else:
        tser.save_pytree(_as_port_leaves(tree), path)
        with open(path, "rb") as f:
            data = f.read()
        assert b"__msgpack_chunked_array__" in data
        assert data == flax_ser.msgpack_serialize(tree)
        _assert_trees_close(flax_ser.msgpack_restore(data), tree)


# -- (d) directories, both ways ----------------------------------------------

def _graphs(smiles=MOLS[:4]):
    gs = [smiles_to_graph(s) for s in smiles]
    n = ((max(g.n_nodes for g in gs) + 7) // 8) * 8
    p = pad_graph_batch(gs, n)
    return p["atom_types"], p["edge_classes"], p["node_mask"]


def _perturb(tree, seed, scale=0.1):
    """Every leaf + noise: zero-initialised gates open, virtual nodes and
    eps move off zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.normal(
        size=np.shape(a))).astype(np.asarray(a).dtype), tree)


CORPUS_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
                 "CC(N)C(=O)O", "COC", "c1cc[nH]c1"]


def _jax_module(kind):
    """(JAX model, perturbed params) of each module at a small size."""
    key = jax.random.PRNGKey(4)
    if kind == "graphdit":
        m = JaxGraphDiT(JaxDiTConfig(hidden_size=32, depth=2, num_heads=4,
                                     diffusion_steps=8, text_dim=16),
                        jax_data_info(CORPUS_SMILES, 12))
    elif kind == "graphclip":
        m = JaxCLIP(JaxCLIPCfg(num_layer=2, hidden_size=32))
    elif kind == "predictor":
        m = JaxPredictor(JaxPredCfg(num_layer=2, hidden_size=32, out_dim=6,
                                    text_input_size=16),
                         label_to_template={0: "[C:1]-[OH;D1:2]>>[C:1]=[O:2]",
                                            3: "[c:1]-[Br;D1:2]>>[c:1].[Br:2]"},
                         available=["OCC", "C1=CC=CC=C1", "CC(=O)O"])
    elif kind == "cost_mlp":
        m = JaxCostMLP(fp_dim=64, latent_dim=16)
    else:
        m = joracle.PropertyOracle(joracle.PropertyOracleConfig(
            num_layer=2, hidden_size=32))
    params = _perturb(_np(m.init(key)), 5)
    if kind == "oracle":
        params["y_std"] = np.abs(params["y_std"]) + 0.5
    return m, params


_PORT = {"graphdit": GraphDiT, "graphclip": GraphCLIP,
         "predictor": GraphPredictor, "cost_mlp": CostMLP,
         "oracle": PropertyOracle}


def _forwards(kind, jm, params, tm):
    """(port output, JAX output) of each module on the same inputs."""
    rng = np.random.default_rng(9)
    if kind == "graphdit":
        cfg = jm.cfg
        b, n = 3, cfg.max_n_nodes
        X = np.eye(cfg.Xdim, dtype=np.float32)[rng.integers(0, cfg.Xdim,
                                                            (b, n))]
        E = np.eye(cfg.Edim, dtype=np.float32)[rng.integers(0, cfg.Edim,
                                                            (b, n, n))]
        mask = np.arange(n)[None, :] < np.array([[5], [12], [2]])
        X, E = X * mask[..., None], E * (mask[:, :, None]
                                         & mask[:, None, :])[..., None]
        y = rng.normal(size=(b, cfg.ydim)).astype(np.float32)
        txt = rng.normal(size=(b, cfg.text_dim)).astype(np.float32)
        t = rng.random(b).astype(np.float32)
        args = (X, E, mask, y, txt, t)
        want = apply_denoiser(params, cfg, *map(jnp.asarray, args))
        with torch.no_grad():
            got = tm.denoiser(*map(torch.from_numpy, args))
        return ([g.numpy() for g in got], [np.asarray(w) for w in want])
    if kind == "cost_mlp":
        fps = (rng.random((4, 64)) < 0.2).astype(np.float32)
        with torch.no_grad():
            got = tm(torch.from_numpy(fps)).numpy()
        return got, np.asarray(jm(params, jnp.asarray(fps)))
    atoms, edges, mask = _graphs()
    t_in = tuple(map(torch.from_numpy, (atoms, edges, mask)))
    j_in = tuple(map(jnp.asarray, (atoms, edges, mask)))
    if kind == "predictor":
        c = rng.normal(size=(4, 16)).astype(np.float32)
        with torch.no_grad():
            got = tm(*t_in, torch.from_numpy(c)).numpy()
        return got, np.asarray(jm(params, *j_in, jnp.asarray(c)))
    with torch.no_grad():
        got = tm(*t_in).numpy()
    return got, np.asarray(jm(params, *j_in))


@pytest.mark.parametrize("kind", list(_PORT))
def test_jax_written_directory_loads_in_the_port(kind, tmp_path):
    jm, params = _jax_module(kind)
    jm.save_pretrained(params, str(tmp_path))
    tm = _PORT[kind].from_pretrained(str(tmp_path))
    module = tm.denoiser if kind == "graphdit" else tm
    _assert_trees_close(_host(jax_tree_of(module)), params)
    got, want = _forwards(kind, jm, params, tm)
    np.testing.assert_allclose(np.concatenate([np.ravel(g) for g in got]),
                               np.concatenate([np.ravel(w) for w in want]),
                               rtol=TOL, atol=TOL)
    if kind == "predictor":
        assert tm.label_to_template == jm.label_to_template
        assert tm.available == jm.available
    if kind == "oracle":
        for g, w in zip(tm.predict_smiles(MOLS),
                        jm.predict_smiles(params, MOLS)):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", list(_PORT))
def test_port_written_directory_loads_in_jax(kind, tmp_path):
    jm, params = _jax_module(kind)
    jm.save_pretrained(params, str(tmp_path / "jax"))
    tm = _PORT[kind].from_pretrained(str(tmp_path / "jax"))
    tm.save_pretrained(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith((".json", ".yaml", ".gz")):
            assert _same_file(tmp_path / "jax" / name,
                              tmp_path / "port" / name), name
    jm2, params2 = type(jm).from_pretrained(str(tmp_path / "port"))
    _assert_trees_close(params2, params)
    got, want = _forwards(kind, jm2, params2, tm)
    np.testing.assert_allclose(np.concatenate([np.ravel(g) for g in got]),
                               np.concatenate([np.ravel(w) for w in want]),
                               rtol=TOL, atol=TOL)
    if kind == "predictor":
        assert jm2.label_to_template == tm.label_to_template
        assert jm2.available == tm.available
    if kind == "oracle":
        for g, w in zip(tm.predict_smiles(MOLS),
                        jm2.predict_smiles(params2, MOLS)):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_cost_mlp_refuses_a_foreign_feature_scheme(tmp_path):
    jm, params = _jax_module("cost_mlp")
    jm.save_pretrained(params, str(tmp_path))
    (tmp_path / "cost_config.json").write_text(
        '{"n_layers": 1, "fp_dim": 64, "latent_dim": 16, '
        '"feature_scheme": "rdkit-morgan"}')
    with pytest.raises(ValueError, match="feature scheme"):
        CostMLP.from_pretrained(str(tmp_path))


# -- (e) pretraining trajectories from JAX's init ----------------------------

@contextlib.contextmanager
def _jax_step_losses():
    """Every step's loss of a JAX pretraining loop of <= 20 steps,
    recovered exactly enough from the running means it logs each step
    (the log record's arguments, before any formatting)."""
    means = []

    class Grab(logging.Handler):
        def emit(self, record):
            if "pretrain step" in str(record.msg):
                means.append(float(record.args[2]))

    logger = logging.getLogger("llamole_tpu.train.pretrain")
    handler = Grab()
    logger.addHandler(handler)
    out = []
    try:
        yield out
    finally:
        logger.removeHandler(handler)
    out += [k * m - (k - 1) * prev for k, (m, prev) in
            enumerate(zip(means, [0.0] + means[:-1]), start=1)]


def _jax_init(kind, module, seed, kw):
    """JAX's initial tree for the port module `module`, drawn exactly as
    the JAX pretraining loop draws it."""
    key = jax.random.PRNGKey(seed)
    if kind == "predictor":
        c = module.cfg
        return JaxPredictor(JaxPredCfg(
            num_layer=c.num_layer, hidden_size=c.hidden_size,
            out_dim=c.out_dim, text_input_size=c.text_input_size)).init(key)
    if kind == "oracle":
        return joracle.PropertyOracle(joracle.PropertyOracleConfig(
            module.cfg.num_layer, module.cfg.hidden_size)).init(key, **kw)
    if kind == "cost_mlp":
        return JaxCostMLP(n_layers=len(module.layers) - 1,
                          fp_dim=module.fp_dim,
                          latent_dim=module.layers[0].out_features).init(key)
    cfg = module.graph.cfg
    k_graph, k1, k2 = jax.random.split(key, 3)
    hidden, hash_dim = cfg.hidden_size, module.text.fc1.in_features
    return {"graph": JaxCLIP(JaxCLIPCfg(num_layer=cfg.num_layer,
                                        hidden_size=hidden)).init(k_graph),
            "text": {"fc1": dense_init(k1, hash_dim, hidden),
                     "fc2": dense_init(k2, hidden, hidden)},
            "logit_scale": jnp.asarray(np.log(1.0 / 0.07), jnp.float32)}


_TRAJECTORIES = {
    "predictor": (tpre.pretrain_predictor, jpre.pretrain_predictor,
                  dict(hidden_size=32, num_layer=2, steps=6, batch_size=8),
                  "model.msgpack"),
    "graphclip": (tpre.pretrain_graphclip, jpre.pretrain_graphclip,
                  dict(hidden_size=32, num_layer=2, steps=6, batch_size=8,
                       text_hash_dim=128), "model.msgpack"),
    "oracle": (tpre.pretrain_property_oracle,
               jpre.pretrain_property_oracle,
               dict(hidden_size=32, num_layer=2, steps=6, batch_size=8),
               "model.msgpack"),
    "cost_mlp": (tpre.pretrain_cost_mlp, jpre.pretrain_cost_mlp,
                 dict(steps=6, batch_size=16), "cost_model.msgpack"),
}


@pytest.mark.parametrize("kind", list(_TRAJECTORIES))
def test_pretraining_trajectory_matches_jax(kind, corpus, tmp_path,
                                            monkeypatch):
    ours, theirs, kw, weight_file = _TRAJECTORIES[kind]
    path = str(corpus[0] / "port" / "train.json")

    def init_from_jax(module, seed, **init_kw):
        tree = _np(_jax_init(kind, module, seed, init_kw))
        module.load_state_dict(state_dict_of(tree))

    monkeypatch.setattr(tpre, "_init", init_from_jax)
    got = ours(path, str(tmp_path / "port"), seed=3, device="cpu", **kw)
    with _jax_step_losses() as want:
        jax_metrics = theirs(path, str(tmp_path / "jax"), seed=3, **kw)
    assert len(got["losses"]) == len(want) == kw["steps"]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["final_loss"], jax_metrics["final_loss"],
                               rtol=LOSS_RTOL)
    _assert_trees_close(jax_load(str(tmp_path / "port" / weight_file)),
                        jax_load(str(tmp_path / "jax" / weight_file)), TOL)
    if kind == "graphclip":
        _assert_trees_close(
            jax_load(str(tmp_path / "port" / "text_tower.msgpack")),
            jax_load(str(tmp_path / "jax" / "text_tower.msgpack")), TOL)
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith((".json", ".gz")):
            assert _same_file(tmp_path / "jax" / name,
                              tmp_path / "port" / name), name


def test_text_tower_helpers_match_jax():
    text = ("The designed molecule is: <mol_start>CCO<mol_end>. It needs "
            "CC(=O)O (available) and CCO>>CC=O, a cons balanced route.")
    assert tpre._strip_molecule_text(text) == jpre._strip_molecule_text(text)
    texts = ["an alcohol with a ring", "", "ring ring ester"]
    np.testing.assert_array_equal(tpre.hash_text_features(texts, 64),
                                  jpre.hash_text_features(texts, 64))
    recs = [{"output": "x CC(=O)O (available), CCN (available)",
             "smiles": "CCO", "cost": 2.0},
            {"output": "<retro_start>step CC(=O)OCC (available)"}]
    assert tpre._cost_rows(recs) == jpre._cost_rows(recs)


# -- (f) GraphDiT ------------------------------------------------------------

def test_graphdit_pretraining_loss_falls(corpus, tmp_path):
    path = str(corpus[0] / "port" / "train.json")
    m = tpre.pretrain_graphdit(path, str(tmp_path), hidden_size=32, depth=2,
                               num_heads=4, diffusion_steps=12, steps=16,
                               batch_size=8, learning_rate=2e-3, seed=0,
                               device="cpu")
    losses = m["losses"]
    assert len(losses) == 16 and np.all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    # the saved directory reads back in the JAX package
    jm, params = JaxGraphDiT.from_pretrained(str(tmp_path))
    assert jm.cfg.hidden_size == 32 and jm.cfg.max_n_nodes == \
        GraphDiT.from_pretrained(str(tmp_path)).cfg.max_n_nodes


def test_graphdit_loss_on_jax_noise_matches(tmp_path):
    """A JAX-written GraphDiT directory, loaded in the port: its loss on
    JAX's apply_noise draw (through `noisy`) within 1e-5 of JAX's."""
    jm, params = _jax_module("graphdit")
    jm.save_pretrained(params, str(tmp_path))
    tm = GraphDiT.from_pretrained(str(tmp_path))
    cfg = jm.cfg
    smiles = ["CCO", "c1ccncc1", "CC(=O)O"]
    bank = pad_graph_batch([smiles_to_graph(s) for s in smiles],
                           cfg.max_n_nodes)
    atoms, edges, mask = (bank["atom_types"], bank["edge_classes"],
                          bank["node_mask"])
    rng = np.random.default_rng(2)
    props = rng.normal(size=(3, cfg.ydim)).astype(np.float32)
    props[0, ::2] = -1
    txt = np.full((3, cfg.text_dim), np.nan, np.float32)
    key = jax.random.PRNGKey(7)
    args = tuple(map(jnp.asarray, (atoms, edges, mask, props)))
    want = jm.loss(params, key, *args, jnp.asarray(txt), train=False)
    k_noise, _ = jax.random.split(key)
    X, E = jm.codes_to_onehot(*args[:3])
    noisy = jdiff.apply_noise(k_noise, X, E, args[2], jm.schedule, jm.parts,
                              train=False)
    noisy = {k: torch.from_numpy(np.array(noisy[k]))
             for k in ("t", "X_t", "E_t")}
    with torch.no_grad():
        got = tm.loss(None, *map(torch.from_numpy,
                                 (atoms, edges, mask, props, txt)),
                      train=False, noisy=noisy)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)


# -- (h) oracle metrics ------------------------------------------------------

def test_oracle_property_metrics_equal_jax_on_a_trained_oracle(corpus,
                                                               tmp_path):
    path = str(corpus[0] / "port" / "train.json")
    tpre.pretrain_property_oracle(path, str(tmp_path), hidden_size=32,
                                  num_layer=2, steps=4, batch_size=8,
                                  device="cpu")
    results = [{"llm_smiles": s, "property": p} for s, p in zip(
        MOLS + ["CCN", None], [{"HIV": 1.0, "SA": 3.1}, {"BBBP": 0.0},
                               {"SA": 2.0, "FFV": 0.4}, {"BACE": 1.0},
                               {"HIV": 0.0}, {"SC": 1.5}, {"SA": 1.0}])]
    got = oracle_property_metrics(str(tmp_path), results)
    want = jax_oracle_metrics(str(tmp_path), results)
    assert got.keys() == want.keys()
    assert got["property_scored_counts"] == want["property_scored_counts"]
    assert got["property_accuracy"] == want["property_accuracy"]
    assert got["property_mae"].keys() == want["property_mae"].keys()
    for k, v in want["property_mae"].items():
        np.testing.assert_allclose(got["property_mae"][k], v, rtol=TOL)
