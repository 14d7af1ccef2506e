"""The JAX package's trained-weight directories in llamole_tpu_torch (CPU,
f32), both ways: save_pretrained's adapter / full-LLM / connector files
(logits 1e-5, trees equal), the trainable bundle's tree against JAX's
init_trainable, the Trainer's checkpoint-N (params and the optimizer's
count / mu / nu / acc equal after a resume across packages, one further
update within 1e-5 with loss_weight_design 0 so no random draw enters),
the optax state keys, the generator / rng handling, the orbax refusal,
and merge_adapter's export directory against the JAX one."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from llamole_tpu.config import TrainingArguments as JaxTrainingArguments
from llamole_tpu.models.gllm.convert import export_hf_weights as jax_export
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.train.export import merge_adapter as jax_merge_adapter
from llamole_tpu.train.trainer import Trainer as JaxTrainer
from llamole_tpu.utils.serialization import load_pytree as jax_load
from llamole_tpu_torch.config import TrainingArguments
from llamole_tpu_torch.train.export import merge_adapter
from llamole_tpu_torch.train.trainer import (Trainer, find_last_checkpoint,
                                             load_optax_state, optax_state)
from llamole_tpu_torch.utils import safetensors as st
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import (bundle_tree, trainable_state_dict,
                                       trainable_tree)
from test_torch_train import (_jax_model, _one_torch_thread,  # noqa: F401
                              _torch_model, _train_args, setup)

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees(a, b, atol=0.0):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
            x, np.float32)
        y = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(
            y, np.float32)
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


# -- adapters ------------------------------------------------------------------

@pytest.mark.parametrize("ft", ["lora", "full", "freeze"])
def test_trainable_tree_is_jax_init_trainable(setup, ft):
    """The port's bundle tree equals, key for key and shape for shape,
    the tree JAX's GraphLM.init_trainable builds."""
    tok, _, frozen, trainable, _ = setup
    jm = _jax_model(tok)
    jm.finetuning_type = ft
    j_frozen = jm.init_frozen(jax.random.PRNGKey(0))
    want = jm.init_trainable(jax.random.PRNGKey(1), j_frozen)
    tm = _torch_model(frozen, trainable)
    if ft != "lora":
        tm = _retyped(tm, ft)
    assert _shapes(trainable_tree(tm)) == _shapes(want)


def _retyped(tm, ft):
    """The same port model with another finetuning type."""
    from llamole_tpu_torch.models.composite import GraphLM
    from llamole_tpu_torch.models.gllm import LLM

    llm = LLM(tm.llm.cfg, dtype=torch.float32)
    state = {k: v for k, v in tm.llm.state_dict().items() if "lora_" not in k}
    llm.load_state_dict(state)
    out = GraphLM(llm, tm.graph_decoder, tm.graph_predictor,
                  tm.graph_encoder, tm.tokenizer, tm.token_id_dict,
                  lora_rank=4, finetuning_type=ft)
    out.connectors.load_state_dict(tm.connectors.state_dict())
    return out


def test_jax_adapter_directory_loads_in_the_port(setup, tmp_path):
    """adapter.msgpack + connector/*.msgpack + graphllm_config.json from
    JAX's save_pretrained load into a port model drawn from another seed:
    the bundle equals JAX's, and so do the LLM's logits with the adapter
    (1e-5)."""
    tok, jm, frozen, trainable, _ = setup
    jm.save_pretrained(jax.tree.map(jnp.asarray, trainable),
                       str(tmp_path))
    assert sorted(os.listdir(tmp_path / "connector")) == [
        "graph_to_lm.msgpack", "lm_to_graph_decoder.msgpack",
        "lm_to_graph_predictor.msgpack"]
    tm = _torch_model(frozen, trainable)
    with torch.no_grad():
        for p in tm.trainable_parameters().values():
            p.normal_()
    tm.load_trainable(str(tmp_path))
    want = trainable_state_dict(_np(trainable))
    for name, p in tm.trainable_parameters().items():
        assert torch.equal(p.detach(), want[name]), name
    ids = np.random.default_rng(3).integers(0, 200, (2, 7)).astype(np.int32)
    ref = jax_forward(jax.tree.map(jnp.asarray, frozen["llm"]), jm.llm.cfg,
                      input_ids=jnp.asarray(ids),
                      lora=jax.tree.map(jnp.asarray, trainable["lora"]),
                      lora_scale=jm.lora_scale)[0]
    with torch.no_grad():
        got = tm.llm(torch.as_tensor(ids, dtype=torch.long))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_port_save_pretrained_loads_in_jax(setup, tmp_path):
    """The port's save_pretrained writes the JAX files: JAX's
    load_trainable reads them as the port's bundle tree; with
    save_graph_modules the three graph-module directories load back in
    the port bit-identically."""
    tok, jm, frozen, trainable, _ = setup
    tm = _torch_model(frozen, trainable)
    tm.save_pretrained(str(tmp_path), save_graph_modules=True)
    assert not list(tmp_path.rglob("*.pt"))
    got = jm.load_trainable(str(tmp_path))
    _assert_trees(got, trainable_tree(tm))
    cfg = json.loads((tmp_path / "graphllm_config.json").read_text())
    assert cfg["lora_rank"] == 4 and cfg["token_id_dict"] == tm.token_id_dict
    from llamole_tpu_torch.models.graphdit import GraphDiT
    back = GraphDiT.from_pretrained(str(tmp_path / "graph_decoder"))
    for a, b in zip(back.denoiser.parameters(),
                    tm.graph_decoder.denoiser.parameters()):
        assert torch.equal(a, b)
    for name in ("graph_predictor", "graph_encoder"):
        assert (tmp_path / name / "model.msgpack").exists()


def test_full_llm_bundle_both_ways(setup, tmp_path):
    """Full finetuning: llm.msgpack from JAX loads into the port's LLM
    bit-identically, and the port's llm.msgpack is JAX's tree."""
    tok, jm, frozen, trainable, _ = setup
    jm_full = _jax_model(tok)
    jm_full.finetuning_type = "full"
    bundle = {"connectors": trainable["connectors"],
              "llm": jax.tree.map(lambda a: a + 0.01, frozen["llm"])}
    jm_full.save_pretrained(jax.tree.map(jnp.asarray, bundle),
                            str(tmp_path / "jax"))
    tm = _retyped(_torch_model(frozen, trainable), "full")
    tm.load_trainable(str(tmp_path / "jax"))
    _assert_trees(trainable_tree(tm), _np(bundle))
    tm.save_pretrained(str(tmp_path / "port"))
    _assert_trees(jax_load(str(tmp_path / "port" / "llm.msgpack")),
                  _np(bundle["llm"]))


def test_adapter_refusals(setup, tmp_path):
    """A missing adapter file, a missing leaf or an unknown one raise; a
    DoRA adapter (an "m" leaf) loads with its magnitude; 'freeze' reads
    the connectors alone."""
    tok, jm, frozen, trainable, _ = setup
    tm = _torch_model(frozen, trainable)
    tm.save_pretrained(str(tmp_path / "ok"))
    os.remove(tmp_path / "ok" / "adapter.msgpack")
    with pytest.raises(FileNotFoundError):
        tm.load_trainable(str(tmp_path / "ok"))
    lora = _np(trainable["lora"])
    del lora["layers"][1]["mlp"]["up"]
    jm.save_pretrained({"connectors": trainable["connectors"], "lora": lora},
                       str(tmp_path / "short"))
    with pytest.raises(ValueError, match="missing"):
        tm.load_trainable(str(tmp_path / "short"))
    lora = _np(trainable["lora"])
    q = lora["layers"][0]["attn"]["q"]
    q["m"] = np.ones(q["b"].shape[1], np.float32)
    jm.save_pretrained({"connectors": trainable["connectors"], "lora": lora},
                       str(tmp_path / "dora"))
    tm.load_trainable(str(tmp_path / "dora"))
    q = tm.llm.layers[0].attn["q"]
    assert torch.equal(q.lora_m, torch.ones(q.out_features))
    assert tm.llm.layers[0].attn["k"].lora_m is None
    assert "llm.layers.0.attn.q.lora_m" in tm.trainable_parameters()
    frozen_tm = _retyped(tm, "freeze")
    frozen_tm.load_trainable(str(tmp_path / "dora"))   # connectors only
    for name, p in frozen_tm.connectors.named_parameters():
        assert torch.equal(p, tm.connectors.state_dict()[name])


# -- training checkpoints --------------------------------------------------------

def _args(cls, out, accumulation=2):
    return _train_args(cls, out, lr_scheduler_type="cosine", warmup_steps=1,
                       gradient_accumulation_steps=accumulation)


def _opt_equal(tt, j_opt, atol=0.0):
    """The port optimizer's state equals the JAX opt_state."""
    got = optax_state(tt.optimizer)
    want = serialization.to_state_dict(j_opt)
    from llamole_tpu_torch.utils.serialization import to_state_dict
    _assert_trees(to_state_dict(got), _np(want), atol)


@pytest.mark.parametrize("accumulation", [1, 2])
def test_optax_state_keys_are_jax(setup, tmp_path, accumulation):
    """optax_state has the keys and shapes flax's to_state_dict reads off
    the optax state JAX's create_optimizer builds (MultiSteps at
    accumulation 2, none at 1)."""
    tok, _, frozen, trainable, _ = setup
    jm = _jax_model(tok, loss_weight_design=0.0)
    jt = JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, frozen),
                    _args(JaxTrainingArguments, tmp_path, accumulation), 2)
    j_state = jt.init_state(jax.tree.map(jnp.asarray, trainable), 0)
    tm = _torch_model(frozen, trainable)
    tt = Trainer(lambda b, g: tm.loss(b, g, train=True),
                 tm.trainable_parameters(),
                 _args(TrainingArguments, tmp_path, accumulation), 2)
    from llamole_tpu_torch.utils.serialization import to_state_dict
    assert (_shapes(to_state_dict(optax_state(tt.optimizer)))
            == _shapes(serialization.to_state_dict(j_state.opt_state)))


def _trainers(setup, tmp_path):
    tok, _, frozen, trainable, batches = setup
    jm = _jax_model(tok, loss_weight_design=0.0)
    jt = JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, frozen),
                    _args(JaxTrainingArguments, tmp_path / "jax"), 2)
    tm = _torch_model(frozen, trainable, loss_weight_design=0.0)
    tt = Trainer(lambda b, g: tm.loss(b, g, train=True),
                 tm.trainable_parameters(),
                 _args(TrainingArguments, tmp_path / "torch"), 2)
    stream = [batches[0], batches[1], batches[1], batches[0]]
    return jt, tt, tm, trainable, stream


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    """JAX trains 3 micro steps (one update and one accumulated gradient)
    and writes checkpoint-3; the port resumes it with params, count, mu,
    nu and acc equal, seeds its generator from the rng key, and one more
    micro step (the second update) matches JAX's within 1e-5."""
    jt, tt, tm, trainable, stream = _trainers(setup, tmp_path)
    j_state = jt.init_state(jax.tree.map(jnp.asarray, trainable), 0)
    j_state, _ = jt.train(j_state, iter(stream[:3]), 3)
    ck = str(tmp_path / "jax" / "checkpoint-3")
    jt.save_checkpoint(j_state, ck)
    assert find_last_checkpoint(str(tmp_path / "jax")) == ck

    state = tt.load_checkpoint(tt.init_state(1), ck)
    assert state.step == 3
    _assert_trees(bundle_tree(tt.params), _np(j_state.params))
    _opt_equal(tt, j_state.opt_state)
    assert tt.optimizer.count == 1 and tt.optimizer.mini_step == 1
    assert any(bool(a.abs().sum()) for a in tt.optimizer.acc.values())
    rng = json.loads(open(os.path.join(ck, "trainer_state.json")).read())[
        "rng"]
    seeded = torch.Generator().manual_seed((rng[0] << 32) | rng[1])
    assert torch.equal(state.generator.get_state(), seeded.get_state())

    j_state, _ = jt.train(j_state, iter(stream[3:]), 4)
    state, _ = tt.train(state, iter(stream[3:]), 4)
    _assert_trees(bundle_tree(tt.params), _np(j_state.params), ATOL)
    _opt_equal(tt, j_state.opt_state, ATOL)


def test_port_checkpoint_resumes_in_jax(setup, tmp_path):
    """The reverse: the port's checkpoint-3 restores in JAX's
    load_checkpoint (its rng a valid key) with equal params and optimizer
    state, and one more micro step matches within 1e-5; a port-to-port
    resume restores the generator bit-identically."""
    jt, tt, tm, trainable, stream = _trainers(setup, tmp_path)
    state, _ = tt.train(tt.init_state(0), iter(stream[:3]), 3)
    ck = str(tmp_path / "torch" / "checkpoint-3")
    tt.save_checkpoint(state, ck)
    assert sorted(os.listdir(ck)) == ["opt_state.msgpack",
                                      "trainable.msgpack",
                                      "trainer_state.json"]
    template = jt.init_state(jax.tree.map(jnp.asarray, trainable), 0)
    j_state = jt.load_checkpoint(template, ck)
    assert j_state.step == 3
    _assert_trees(j_state.params, bundle_tree(tt.params))
    _opt_equal(tt, j_state.opt_state)

    again = tt.load_checkpoint(tt.init_state(5), ck)
    assert torch.equal(again.generator.get_state(),
                       state.generator.get_state())

    j_state, _ = jt.train(j_state, iter(stream[3:]), 4)
    state, _ = tt.train(state, iter(stream[3:]), 4)
    _assert_trees(bundle_tree(tt.params), _np(j_state.params), ATOL)


def test_orbax_and_foreign_checkpoints_raise(setup, tmp_path):
    """backend "orbax" raises naming its ROADMAP item (its directory is
    still discovered, as JAX discovers it); an accumulation mismatch
    between the optimizer and opt_state raises."""
    jt, tt, tm, trainable, stream = _trainers(setup, tmp_path)
    ck = tmp_path / "run" / "checkpoint-7"
    (ck / "orbax_state").mkdir(parents=True)
    (ck / "trainer_state.json").write_text(json.dumps(
        {"step": 7, "rng": [0, 1], "backend": "orbax"}))
    assert find_last_checkpoint(str(tmp_path / "run")) == str(ck)
    with pytest.raises(NotImplementedError, match="orbax"):
        tt.load_checkpoint(tt.init_state(0), str(ck))
    state, _ = tt.train(tt.init_state(0), iter(stream[:2]), 2)
    tt.save_checkpoint(state, str(tmp_path / "ck"))
    tm2 = tm
    t1 = Trainer(lambda b, g: tm2.loss(b, g, train=True),
                 tm2.trainable_parameters(),
                 _args(TrainingArguments, tmp_path / "t1", 1), 2)
    with pytest.raises(ValueError, match="MultiSteps"):
        t1.load_checkpoint(t1.init_state(0), str(tmp_path / "ck"))


# -- merge_adapter -----------------------------------------------------------------

def _jax_base_and_adapter(tmp_path):
    """A tiny LLM JAX exported as an HF base (the byte tokenizer grows its
    vocabulary) and a JAX-saved adapter on it: merge_adapter's args, the
    JAX model and the adapter's trainable tree."""
    from llamole_tpu.config import get_infer_args as jax_args
    from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
    from llamole_tpu.models.gllm.model import init_params
    from llamole_tpu.models.loader import build_graph_lm as jax_build

    base = tmp_path / "base"
    cfg = JaxLLMConfig.tiny(200)
    jax_export(init_params(jax.random.PRNGKey(2), cfg, jnp.float32), cfg,
               str(base))
    args = {"model_name_or_path": str(base), "template": "default",
            "finetuning_type": "lora", "lora_rank": 4,
            "compute_dtype": "float32"}
    m_args, d_args, _, f_args, _ = jax_args(dict(args))
    jm, frozen, trainable, _ = jax_build(m_args, d_args, f_args)
    trainable = dict(trainable)
    trainable["lora"] = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                               a.shape), trainable["lora"])
    jm.save_pretrained(trainable, str(tmp_path / "adapter"))
    args["adapter_name_or_path"] = str(tmp_path / "adapter")
    return args, jm, frozen, trainable


def test_merge_adapter_equals_jax(setup, tmp_path):
    """merge_adapter through its normal entry in both packages, on the
    same HF base (a tiny LLM JAX exported, whose vocabulary the byte
    tokenizer grows) and the same JAX-saved adapter: the same files, the
    adapter / connectors / configs equal, the merged weights in
    model.msgpack and the safetensors within 1e-7 (the rank sums may run
    in another order)."""
    args, _, _, _ = _jax_base_and_adapter(tmp_path)
    jax_merge_adapter(dict(args, export_dir=str(tmp_path / "jax")))
    merge_adapter(dict(args, export_dir=str(tmp_path / "port")),
                  device="cpu")
    files = [sorted(str(p.relative_to(tmp_path / s))
                    for p in (tmp_path / s).rglob("*") if p.is_file())
             for s in ("jax", "port")]
    assert files[0] == files[1]
    for rel in files[0]:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        elif rel == "model.msgpack":
            _assert_trees(load_pytree(str(b)), jax_load(str(a)), 1e-7)
        elif rel.endswith(".msgpack"):
            _assert_trees(load_pytree(str(b)), jax_load(str(a)))
        else:
            ours = dict(st.iter_file(str(b)))
            theirs = dict(st.iter_file(str(a)))
            assert set(ours) == set(theirs)
            for k in ours:
                np.testing.assert_allclose(ours[k].numpy(),
                                           theirs[k].numpy(), rtol=0,
                                           atol=1e-7, err_msg=k)


def test_merged_export_under_freeze_differs_as_documented(tmp_path):
    """A merged export carries the merged weights and the unmerged
    adapter.msgpack. Reloaded from that directory under finetuning_type
    'freeze', the port reads only the connectors: its logits are the
    merged model's, i.e. base + adapter once (1e-5). The JAX package
    applies the adapter.msgpack it finds on top of the merged weights, so
    its logits differ (the deliberate difference of ROADMAP.md Queue 3)."""
    from llamole_tpu.config import get_infer_args as jax_args
    from llamole_tpu.models.loader import build_graph_lm as jax_build
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm

    args, jm, frozen, trainable = _jax_base_and_adapter(tmp_path)
    merged = str(tmp_path / "merged")
    merge_adapter(dict(args, export_dir=merged), device="cpu")
    ids = np.random.default_rng(5).integers(0, 200, (2, 7)).astype(np.int32)
    once = np.asarray(jax_forward(frozen["llm"], jm.llm.cfg,
                                  input_ids=jnp.asarray(ids),
                                  lora=trainable["lora"],
                                  lora_scale=jm.lora_scale)[0])

    reload = dict(args, model_name_or_path=merged,
                  adapter_name_or_path=merged, finetuning_type="freeze")
    m_args, d_args, _, f_args, _ = jax_args(dict(reload))
    jm2, j_frozen, j_trainable, _ = jax_build(m_args, d_args, f_args,
                                              load_adapter=True)
    assert "lora" in j_trainable
    llm, lora, scale = jm2._llm_params(j_trainable, j_frozen)
    jax_logits = np.asarray(jax_forward(llm, jm2.llm.cfg,
                                        input_ids=jnp.asarray(ids),
                                        lora=lora, lora_scale=scale)[0])

    m_args, d_args, _, f_args, _ = get_infer_args(dict(reload))
    tm, _ = build_graph_lm(m_args, d_args, f_args, device="cpu",
                           load_adapter=True)
    assert not any("lora_" in k for k in tm.llm.state_dict())
    with torch.no_grad():
        got = tm.llm(torch.as_tensor(ids, dtype=torch.long))[0].numpy()
    np.testing.assert_allclose(got, once, rtol=0, atol=ATOL)
    assert np.abs(jax_logits - once).max() > 100 * ATOL


def test_save_state_is_flax_to_bytes(tmp_path):
    """save_state writes flax's to_bytes of a tree with tuples and
    namedtuples (an empty one included) byte for byte; load_state gives
    back flax's state dict of it (what msgpack_restore reads)."""
    from typing import NamedTuple

    from llamole_tpu_torch.utils.serialization import load_state, save_state

    class Inner(NamedTuple):
        count: np.ndarray
        mu: dict

    class Empty(NamedTuple):
        pass

    rng = np.random.default_rng(4)
    tree = (Empty(), Inner(np.asarray(3, np.int32),
                           {"b": rng.normal(size=(2, 3)).astype(np.float32),
                            "a": [rng.normal(size=4).astype(np.float32)]}))
    path = tmp_path / "state.msgpack"
    save_state(tree, str(path))
    assert path.read_bytes() == serialization.to_bytes(tree)
    want = serialization.msgpack_restore(path.read_bytes())
    _assert_trees(load_state(str(path)), want)
    assert load_state(str(path))["0"] == {}


@pytest.mark.parametrize("accumulation", [1, 2])
def test_load_optax_state_refuses_other_keys(setup, tmp_path, accumulation):
    """load_optax_state refuses a state of the other accumulation, one
    without the chain's keys and one with a leaf the trainable lacks."""
    tok, _, frozen, trainable, _ = setup
    tm = _torch_model(frozen, trainable)
    tt = Trainer(lambda b, g: tm.loss(b, g, train=True),
                 tm.trainable_parameters(),
                 _args(TrainingArguments, tmp_path, accumulation), 2)
    from llamole_tpu_torch.utils.serialization import to_state_dict
    good = to_state_dict(optax_state(tt.optimizer))
    load_optax_state(tt.optimizer, good)
    other = Trainer(lambda b, g: tm.loss(b, g, train=True),
                    tm.trainable_parameters(),
                    _args(TrainingArguments, tmp_path, 3 - accumulation), 2)
    with pytest.raises(ValueError, match="MultiSteps"):
        load_optax_state(other.optimizer, good)
    inner = good["inner_opt_state"] if accumulation > 1 else good
    inner["1"].pop("2")
    with pytest.raises(ValueError, match="chain"):
        load_optax_state(tt.optimizer, good)
    inner["1"]["2"] = {"count": inner["1"]["0"]["count"]}
    inner["1"]["0"]["mu"]["connectors"]["stray"] = torch.zeros(1)
    with pytest.raises(ValueError, match="does not match"):
        load_optax_state(tt.optimizer, good)
