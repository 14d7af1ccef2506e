"""The custom optimizer chain of llamole_tpu_torch (GaLore, LoRA+, BAdam)
against llamole_tpu's create_optimizer (f32, CPU).

One trainable bundle in the JAX layout (three connectors, a 2-layer
rank-4 LoRA with DoRA magnitudes on the attention projections) and a
sequence of 8 gradient bundles, all drawn from a seeded numpy generator,
go through JAX's optax chain and the port's CustomAdamW (the port's
tensors bridged by weights.trainable_state_dict). The connector kernels
are eligible for GaLore at rank 4 (in <= out, in > out and in == out);
the LoRA factors are not (min(shape) = 4). GaLore's basis comes from an
SVD whose singular-vector signs differ between torch and jnp, so the
trajectories are compared while no refresh follows the first one, and
past a refresh once JAX's state (its basis) is loaded into the port.

On a mesh (gloo ranks: parallel/dryrun.py launch of
tests/torch_ep_sp_worker.py) the whole chain with GaLore at rank 2 (the
LoRA factors project too), refreshing every 3 updates, runs 4 updates
past a refresh on tp:2 (each 2-D leaf a DTensor sharded on alternating
sides), ZeRO-1 dp:2, both at once on tp:2,dp:2, and beside pp:2 (each
layer's leaves on their stage); its parameters equal the mesh-less
port's within 1e-5 relative, its bases the mesh-less ones up to a sign
per basis vector (1e-5), its moments within 1e-4 relative (GaLore's
joined from the ranks' parts; where a rank holds part of the basis's
side the projected gradient is a sum of the ranks' partial products,
rounded in another order), and its state dict has the mesh-less one's
layout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from llamole_tpu.config import FinetuningArguments as JaxFinetuningArguments
from llamole_tpu.config import TrainingArguments as JaxTrainingArguments
from llamole_tpu.train.trainer import create_optimizer as jax_optimizer
from llamole_tpu.utils.serialization import load_state as jax_load_state
from llamole_tpu.utils.serialization import save_state as jax_save_state
from llamole_tpu_torch.config import FinetuningArguments, TrainingArguments
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.train.optimizers import (CustomAdamW, create_optimizer,
                                               galore_basis)
from llamole_tpu_torch.train.trainer import load_optax_state, optax_state
from llamole_tpu_torch.utils.serialization import (load_state, save_state,
                                                   to_state_dict)
from llamole_tpu_torch.weights import trainable_state_dict

RTOL = 1e-5      # max |port - JAX| over a leaf, relative to max |JAX|
GRADS = 8
LORA_RANK = 4

CHAINS = {
    "galore": dict(use_galore=True, galore_rank=4, galore_update_interval=100,
                   galore_scale=0.25),
    "loraplus": dict(loraplus_lr_ratio=16.0),
    "badam": dict(use_badam=True, badam_n_blocks=3, badam_switch_interval=1,
                  badam_start_block=1),
    "all": dict(use_galore=True, galore_rank=4, galore_update_interval=100,
                galore_scale=0.25, loraplus_lr_ratio=16.0, use_badam=True,
                badam_n_blocks=3, badam_switch_interval=1),
}
# (weight decay, clipping norm, accumulation): "all" takes every part
TRAINING = {"galore": (0.0, 1e9, 1), "loraplus": (0.0, 1e9, 1),
            "badam": (0.0, 1e9, 1), "all": (0.01, 1.0, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bundle(rng, scale=1.0):
    """A trainable bundle in the JAX layout (numpy f32)."""
    def arr(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    h, r = 24, LORA_RANK
    conn = {"graph_to_lm": {"w": arr(12, h), "b": arr(h)},         # in < out
            "lm_to_graph_decoder": {"w": arr(h, 10), "b": arr(10)},  # in > out
            "lm_to_graph_predictor": {"w": arr(h, h), "b": arr(h)}}  # tie
    layers = []
    for _ in range(2):
        attn = {n: {"a": arr(h, r), "b": arr(r, h), "m": arr(h)}
                for n in ("q", "k", "v", "o")}
        mlp = {"gate": {"a": arr(h, r), "b": arr(r, 32)},
               "up": {"a": arr(h, r), "b": arr(r, 32)},
               "down": {"a": arr(32, r), "b": arr(r, h)}}
        layers.append({"attn": attn, "mlp": mlp})
    return {"connectors": conn, "lora": {"layers": layers}}


def _training_args(cls, chain):
    wd, clip, accumulation = TRAINING[chain]
    return cls(learning_rate=1e-2, lr_scheduler_type="constant",
               weight_decay=wd, max_grad_norm=clip,
               gradient_accumulation_steps=accumulation)


def _jax(chain, params, **over):
    ft = JaxFinetuningArguments(**{**CHAINS[chain], **over})
    tx, _ = jax_optimizer(_training_args(JaxTrainingArguments, chain), 10,
                          ft)
    return tx


def _port(chain, params, **over):
    values = trainable_state_dict(params)
    tensors = {n: torch.nn.Parameter(torch.from_numpy(np.array(v)))
               for n, v in values.items()}
    opt, _ = create_optimizer(_training_args(TrainingArguments, chain), 10,
                              tensors,
                              FinetuningArguments(**{**CHAINS[chain],
                                                     **over}))
    assert isinstance(opt, CustomAdamW)
    return opt


def _jax_steps(tx, state, params, grads):
    j_params = jax.tree.map(jnp.asarray, params)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, j_params)
        j_params = optax.apply_updates(j_params, upd)
    return state, jax.tree.map(np.asarray, j_params)


def _port_steps(opt, grads):
    for g in grads:
        values = trainable_state_dict(g)
        for name, p in opt.params.items():
            p.grad = values[name]
        opt.accumulate()


def _assert_params(opt, j_params):
    want = trainable_state_dict(j_params)
    assert set(want) == set(opt.params)
    for name, p in opt.params.items():
        w = want[name].numpy()
        err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
        assert err <= RTOL, (name, err)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    params = _bundle(rng)
    grads = [_bundle(rng, 0.5) for _ in range(GRADS)]
    return params, grads


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_matches_jax(data, chain):
    """GaLore alone, LoRA+ alone, BAdam alone, and all three with weight
    decay, clipping and accumulation 2: the parameters after each window
    of 8 gradient bundles equal JAX's within 1e-5 relative (GaLore
    refreshes once, at the first update); every leaf moved."""
    params, grads = data
    tx = _jax(chain, params)
    state = tx.init(jax.tree.map(jnp.asarray, params))
    opt = _port(chain, params)
    k = TRAINING[chain][2]
    for i in range(0, GRADS, 2 * k):
        window = grads[i:i + 2 * k]
        state, j_params = _jax_steps(tx, state, j_params if i else params,
                                     window)
        _port_steps(opt, window)
        _assert_params(opt, j_params)
    start = trainable_state_dict(params)
    for name, p in opt.params.items():
        assert not torch.equal(p.detach(), start[name]), name


def test_chain_selections():
    """GaLore takes the connector kernels and no LoRA factor; LoRA+
    scales the adapters' B and nothing named b elsewhere; BAdam deals the
    leaves round-robin in jax.tree.flatten order of the bundle tree."""
    params = _bundle(np.random.default_rng(1))
    opt = _port("all", params)
    assert opt.galore_names == {f"connectors.{n}.weight" for n in (
        "graph_to_lm", "lm_to_graph_decoder", "lm_to_graph_predictor")}
    assert opt.lora_b == {n for n in opt.params if n.endswith("lora_b")}
    order = sorted(opt.block, key=lambda n: _flatten_index(opt, n))
    assert [opt.block[n] for n in order] == [i % 3 for i in range(len(order))]
    assert order[0] == "connectors.graph_to_lm.bias"      # b before w
    assert order[2].startswith("connectors.lm_to_graph_decoder")
    assert order[6] == "llm.layers.0.attn.k.lora_a"        # k, o, q, v


def _flatten_index(opt, name):
    """The leaf's index in jax.tree.flatten of the bundle tree."""
    tree = opt._tree({n: torch.zeros(()) for n in opt.params},
                     set(opt.params), False)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: 0, tree))[0]
    keys = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in flat]
    return keys.index(tuple(opt.paths[name][0]))


def test_galore_basis_is_jax_up_to_signs():
    """galore_basis spans JAX project_matrix's subspace column for column
    (each singular vector up to its sign), on both sides and the tie."""
    rng = np.random.default_rng(2)
    for shape in ((12, 24), (24, 10), (16, 16)):
        g = rng.normal(size=shape).astype(np.float32)
        got = galore_basis(torch.from_numpy(g), 4).numpy()
        m, n = shape
        u, _, vt = np.linalg.svd(g.astype(np.float64), full_matrices=False)
        want = u[:, :4] if m <= n else vt[:4].T
        signs = np.sign(np.sum(got * want, axis=0))
        np.testing.assert_allclose(got, want * signs, atol=1e-5)


def test_galore_past_a_refresh_with_jax_basis(data):
    """GaLore refreshing every 3 updates: updates 1-3 equal JAX's; the
    refresh at update 4 draws a basis whose signs may differ, so JAX's
    state after it (basis and moments) is loaded into the port, and
    updates 5-6 again equal JAX's."""
    params, grads = data
    tx = _jax("galore", params, galore_update_interval=3)
    state = tx.init(jax.tree.map(jnp.asarray, params))
    opt = _port("galore", params, galore_update_interval=3)
    state, j_params = _jax_steps(tx, state, params, grads[:3])
    _port_steps(opt, grads[:3])
    _assert_params(opt, j_params)
    state, j_params = _jax_steps(tx, state, j_params, grads[3:4])
    _port_steps(opt, grads[3:4])
    load_optax_state(opt, _torch_tree(serialization.to_state_dict(state)))
    with torch.no_grad():
        for name, v in trainable_state_dict(j_params).items():
            opt.params[name].copy_(v)
    state, j_params = _jax_steps(tx, state, j_params, grads[4:6])
    _port_steps(opt, grads[4:6])
    _assert_params(opt, j_params)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_state_layout_is_jax(data, chain):
    """optax_state's keys and shapes are those flax's to_state_dict reads
    off JAX's optax state of the same chain, masked leaves {} included
    (the layout is taken from JAX here, never written out by hand)."""
    params, grads = data
    tx = _jax(chain, params)
    state, _ = _jax_steps(tx, tx.init(jax.tree.map(jnp.asarray, params)),
                          params, grads[:2])
    opt = _port(chain, params)
    _port_steps(opt, grads[:2])
    got = to_state_dict(optax_state(opt))
    want = serialization.to_state_dict(state)
    assert _shapes(got) == _shapes(want)
    if chain == "all":
        core = got["inner_opt_state"]["1"]["0"]["inner_states"]
        proj = core["galore"]["inner_state"]["proj"]["connectors"]
        assert tuple(proj["graph_to_lm"]["w"].shape) == (12, 4)
        assert tuple(proj["lm_to_graph_decoder"]["w"].shape) == (10, 4)
        assert proj["graph_to_lm"]["b"] == {}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_opt_state_interchanges_with_jax(data, chain, tmp_path):
    """A JAX-written opt_state.msgpack read by the port and the port's
    read by JAX's load_state with JAX's target; then one more window on
    each side gives equal parameters."""
    params, grads = data
    k = TRAINING[chain][2]
    tx = _jax(chain, params)
    state, j_params = _jax_steps(
        tx, tx.init(jax.tree.map(jnp.asarray, params)), params,
        grads[:2 * k])
    jax_save_state(state, str(tmp_path / "jax.msgpack"))
    opt = _port(chain, params)
    load_optax_state(opt, load_state(str(tmp_path / "jax.msgpack")))
    with torch.no_grad():
        for name, v in trainable_state_dict(j_params).items():
            opt.params[name].copy_(v)
    assert opt.count == 2 and opt.mini_step == 0

    save_state(optax_state(opt), str(tmp_path / "port.msgpack"))
    back = jax_load_state(state, str(tmp_path / "port.msgpack"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    window = grads[2 * k:3 * k]
    _, want = _jax_steps(tx, back, j_params, window)
    _port_steps(opt, window)
    _assert_params(opt, want)


def test_badam_moves_only_the_active_block(data):
    """With 3 blocks switching every update from block 1, update i moves
    exactly the leaves of block (1 + i) % 3 and every leaf's moments
    update."""
    params, grads = data
    opt = _port("badam", params)
    for i, g in enumerate(grads[:3]):
        before = {n: p.detach().clone() for n, p in opt.params.items()}
        mu = {n: t.clone() for n, t in opt.mu.items()}
        _port_steps(opt, [g])
        moved = {n for n, p in opt.params.items()
                 if not torch.equal(p.detach(), before[n])}
        assert moved == {n for n, b in opt.block.items()
                         if b == (1 + i) % 3}
        assert all(not torch.equal(opt.mu[n], mu[n]) for n in opt.mu)


def test_galore_moments_are_low_rank(data):
    """GaLore's moments of an eligible [in, out] kernel are [r, out] when
    in <= out and [in, r] otherwise, its basis [in, r] / [out, r]."""
    params, _ = data
    opt = _port("galore", params)
    name = "connectors.graph_to_lm.weight"          # JAX [12, 24]
    assert tuple(opt.mu[name].shape) == (4, 24)
    assert tuple(opt.proj[name].shape) == (12, 4)
    name = "connectors.lm_to_graph_decoder.weight"  # JAX [24, 10]
    assert tuple(opt.mu[name].shape) == (24, 4)
    assert tuple(opt.proj[name].shape) == (10, 4)
    full = sum(p.numel() for p in opt.params.values())
    assert sum(t.numel() for t in opt.mu.values()) < full


# the mesh runs: GaLore at rank 2 (LoRA factors too), a refresh at
# updates 1 and 4 of the 4; (ranks, ZeRO-1) of each mesh
MESH_CHAIN = {**CHAINS["all"], "galore_rank": 2, "galore_update_interval": 3}
MESH_RUNS = {"tp:2": (2, False), "dp:2": (2, True), "tp:2,dp:2": (4, True),
             "pp:2": (2, False)}


@pytest.fixture(scope="module")
def mesh_runs(data, tmp_path_factory):
    """Every mesh's ranks side by side on threads, and the mesh-less run
    of the same chain."""
    from concurrent.futures import ThreadPoolExecutor
    params, grads = data
    work = tmp_path_factory.mktemp("opt_mesh")
    torch.save({"params": dict(trainable_state_dict(params)),
                "grads": [dict(trainable_state_dict(g)) for g in grads]},
               work / "data.pt")
    wd, clip, accumulation = TRAINING["all"]
    training = dict(learning_rate=1e-2, lr_scheduler_type="constant",
                    weight_decay=wd, max_grad_norm=clip,
                    gradient_accumulation_steps=accumulation)
    here = os.path.dirname(os.path.abspath(__file__))

    def go(spec):
        ranks, zero1 = MESH_RUNS[spec]
        out = work / spec.replace(":", "").replace(",", "_")
        out.mkdir()
        dryrun.launch("torch_ep_sp_worker:galore_mesh", ranks,
                      {"mesh": spec, "zero1": zero1, "chain": MESH_CHAIN,
                       "training": training, "data": str(work / "data.pt"),
                       "out": str(out)},
                      timeout=120, workdir=str(out / "ranks"), path=[here])
        return [torch.load(out / f"rank{r}.pt") for r in range(ranks)]

    with ThreadPoolExecutor(len(MESH_RUNS)) as pool:
        futures = {spec: pool.submit(go, spec) for spec in MESH_RUNS}
        opt = _port("all", params, galore_rank=2, galore_update_interval=3)
        _port_steps(opt, grads)
        yield futures, opt


MOMENT_RTOL = 1e-4


def _close(got, want, what, rtol=RTOL):
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("spec", list(MESH_RUNS))
def test_custom_chain_on_a_mesh_matches_the_mesh_less_port(mesh_runs, spec):
    """GaLore past a refresh, BAdam and LoRA+ with weight decay, clipping
    and accumulation 2 on the mesh: each rank's parameters, the bases (up
    to a sign per basis vector) and the moments (GaLore's whole from the
    ranks' parts) equal the mesh-less port's; the state dict's layout is
    the mesh-less one's; beside pp every leaf lives on one stage or on
    both, and BAdam dealt the blocks over every stage's names."""
    futures, plain = mesh_runs
    ranks = futures[spec].result()
    assert len(plain.galore_names) > 3      # connectors and LoRA factors
    seen = set()
    for r in ranks:
        for n, p in r["params"].items():
            _close(p, plain.params[n].detach(), f"{spec} {n}")
            seen.add(n)
    assert seen == set(plain.params)
    whole = ranks[0]
    assert set(whole["proj"]) == set(plain.proj)
    for n, want in plain.proj.items():
        got = whole["proj"][n]
        signs = torch.sign((got * want).sum(0))
        np.testing.assert_allclose(got.numpy(), (want * signs).numpy(),
                                   atol=1e-5, err_msg=f"{spec} basis {n}")
        m, k = plain._jax_shape(n, plain.params[n])
        mu = whole["mu"][n]
        mu = mu * (signs[:, None] if m <= k else signs[None, :])
        _close(mu, plain.mu[n], f"{spec} moment {n}", MOMENT_RTOL)
    for n in set(plain.mu) - set(plain.proj):
        _close(whole["mu"][n], plain.mu[n], f"{spec} moment {n}",
               MOMENT_RTOL)
    assert _shapes(whole["chain"]) == _shapes(
        to_state_dict(plain.chain_state()))
