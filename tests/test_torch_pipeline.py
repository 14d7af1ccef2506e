"""The GPipe pipeline of llamole_tpu_torch (parallel/pipeline.py) against
llamole_tpu's parallel/pipeline.py and the mesh-less port.

pipeline_param_pspecs gives, for each list-layout leaf, JAX's spec of the
stacked leaf it belongs to. Gloo ranks on the CPU (parallel/dryrun.py
launch, each a process of tests/torch_mesh_worker.py importing no JAX,
120 s a launch) run the tiny GraphLM (2 layers, f32) bridged from a JAX
draw:

  pipeline_lm_loss on pp:2 (M = 2 and 4) and pp:2,dp:2 (M = 2): the loss
  (the ranks' shares summed) within 1e-5 of JAX's pipeline_lm_loss on
  the same mesh string over stack_layers of the same weights and of the
  mesh-less port's forward, each stage's LoRA gradients within 1e-4 of
  JAX's and the mesh-less port's;
  the Trainer's stage placement on those meshes: a rank holds its
  stage's layers alone, and gather_stages brings the others back;
  run_mmsft on pp:2,dp:2 (M = 2) at zero stages 0 and 1: the losses
  (rtol 1e-5) and the saved bundle (atol 1e-4) equal the mesh-less
  run_mmsft's; the saved bundle loads in JAX; with a held-out split the
  predictions (the dp leg over the stages' gathered adapter) equal the
  mesh-less run's; with LoRA+ and BAdam as well; a run resumed from the
  zero-1 run's msgpack checkpoint-2, and one with GaLore, BAdam and
  LoRA+ resumed from its own DCP checkpoint-2 (each stage writing and
  reading its leaves and their optimizer state), give the uninterrupted
  run's later losses and trained bundle.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from llamole_tpu.models.composite import GraphLM as JaxGraphLM
from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm.stacked import stack_layers
from llamole_tpu.models.graphclip.model import GraphCLIP, GraphCLIPConfig
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.loader import make_fallback_predictor
from llamole_tpu.parallel import mesh_from_string as jax_mesh_from_string
from llamole_tpu.parallel.pipeline import (
    pipeline_lm_loss as jax_pipeline_lm_loss,
    pipeline_param_pspecs as jax_pipeline_pspecs)
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.models.gllm.model import lm_loss
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.parallel.pipeline import pipeline_param_pspecs
from llamole_tpu_torch.utils.constants import IGNORE_INDEX
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import (_llm_path, graph_lm_state_dict,
                                       trainable_state_dict)

import torch_mesh_worker as worker
import torch_parallel_worker as base

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 120       # seconds a launch of ranks may take
REL = 1e-5        # losses
ATOL = 1e-4       # gradients and trained parameters
# the custom chain beside pp: LoRA+ and BAdam (every update switches the
# block) held to the mesh-less run; with GaLore (rank 2, refreshed every
# 3 updates) too, a DCP checkpoint after update 1 and the run resumed
# from it (the rank-2 bases of the tiny leaves turn with the gradients'
# last bits, so that run is held to its own uninterrupted run)
CUSTOM = {"loraplus_lr_ratio": 16.0, "use_badam": True,
          "badam_switch_interval": 1}
ALL = {**CUSTOM, "use_galore": True, "galore_rank": 2,
       "galore_update_interval": 3}
# (mesh, microbatches) of the pipeline_lm_loss launches; JAX runs the
# first and the last (4 microbatches are held to the mesh-less port)
LOSS_MESHES = (("pp:2", 2), ("pp:2", 4), ("pp:2,dp:2", 2))
JAX_MESHES = (("pp:2", 2), ("pp:2,dp:2", 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _open(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX draw (graph modules and adapter opened) bridged into a
    state dict, and a [4, 40] batch drawn with numpy (left padding, a
    masked prompt)."""
    work = tmp_path_factory.mktemp("pipeline")
    tok = JaxByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    jm = JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**base.DIT),
                                  jax_data_info(base.CORPUS, base.MAX_N)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=4,
        finetuning_type="lora")
    frozen = jm.init_frozen(jax.random.PRNGKey(0))
    trainable = jm.init_trainable(jax.random.PRNGKey(1), frozen)
    frozen = {k: (_open(v, 2, 0.2) if k != "llm"
                  else jax.tree.map(np.asarray, v))
              for k, v in frozen.items()}
    trainable = {"connectors": jax.tree.map(np.asarray,
                                            trainable["connectors"]),
                 "lora": _open(trainable["lora"], 3, 0.05)}
    state = graph_lm_state_dict(frozen, trainable)
    torch.save(state, work / "state.pt")
    rng = np.random.default_rng(4)
    b, s = 4, 40
    input_ids = rng.integers(0, 256, size=(b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    for row, pad in enumerate((0, 5, 11, 3)):
        mask[row, :pad] = 0
        input_ids[row, :pad] = tok.pad_token_id
    labels = np.where(mask > 0, input_ids, IGNORE_INDEX)
    labels[:, :12] = IGNORE_INDEX
    batch = {"input_ids": input_ids, "attention_mask": mask,
             "labels": labels}
    return types.SimpleNamespace(work=work, jm=jm, frozen=frozen,
                                 trainable=trainable, state=state,
                                 batch=batch)


@pytest.fixture(scope="module")
def launched(setup):
    """The pipeline_lm_loss launches, the training launch and JAX's
    losses (XLA compiles outside the interpreter lock), side by side on
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    def loss(spec, m):
        return dryrun.launch(
            "torch_mesh_worker:pipeline_loss", 4 if "dp" in spec else 2,
            {"state": str(setup.work / "state.pt"), "mesh": spec,
             "microbatches": m,
             "batch": {k: v.tolist() for k, v in setup.batch.items()}},
            timeout=LIMIT, workdir=str(setup.work / f"loss_{spec}_{m}"
                                       .replace(":", "").replace(",", "_")),
            path=[HERE])

    def train():
        out = setup.work / "train"
        return dryrun.launch(
            "torch_mesh_worker:pipeline_train", 4,
            {"state": str(setup.work / "state.pt"), "mesh": "pp:2,dp:2",
             "microbatches": 2, "out": str(out),
             "runs": [{"name": "zero0", "zero": 0},
                      {"name": "zero1", "zero": 1},
                      # 3 of the 5 examples train, in a batch padded to
                      # 4 rows: the design weight 0 (the pad row changes
                      # the design noise's draws, as in JAX)
                      {"name": "predict", "zero": 1, "val_size": 0.4,
                       "design": 0.0},
                      {"name": "zero1_resume", "zero": 1,
                       "resume": "zero1/checkpoint-2"},
                      {"name": "custom", "zero": 1, "finetuning": CUSTOM},
                      {"name": "dcp", "zero": 0, "dcp": True,
                       "finetuning": ALL},
                      {"name": "dcp_resume", "zero": 0, "dcp": True,
                       "finetuning": ALL, "resume": "dcp/checkpoint-2"}]},
            timeout=LIMIT, workdir=str(out / "ranks"), path=[HERE]), out

    pool = ThreadPoolExecutor(len(LOSS_MESHES) + len(JAX_MESHES) + 1)
    futures = {key: pool.submit(loss, *key) for key in LOSS_MESHES}
    futures["train"] = pool.submit(train)
    for key in JAX_MESHES:
        futures[("jax",) + key] = pool.submit(_jax_loss_and_grads, setup,
                                              *key)
    yield futures
    pool.shutdown(wait=True)


def test_pipeline_param_pspecs_equal_jax(setup):
    """Each list-layout leaf's spec is JAX's spec of its stacked leaf;
    the rest replicate; a tree without layers raises as JAX's does."""
    model = base.tiny_model(setup.state)
    named = {n: p for n, p in model.llm.named_parameters()
             if "lora_" not in n}
    got = pipeline_param_pspecs(named)
    want = jax_pipeline_pspecs(stack_layers(setup.frozen["llm"]))
    for name, spec in got.items():
        keys, _ = _llm_path(name)
        node = want
        if keys[0] == "layers":
            node = node["layers_stacked"]
            keys = keys[2:]
        for k in keys:
            node = node[k]
        assert spec == tuple(node), name
    assert got["layers.1.attn.q.weight"] == ("pp", None, None)
    assert got["embed.weight"] == ()
    with pytest.raises(ValueError):
        jax_pipeline_pspecs({"embed": {"weight": np.zeros((2, 2))}})
    with pytest.raises(ValueError, match="layer stack"):
        pipeline_param_pspecs({"embed.weight": named["embed.weight"]})


def _jax_loss_and_grads(setup, spec, m):
    jm = setup.jm
    params = jax.tree.map(jnp.asarray, stack_layers(setup.frozen["llm"]))
    mesh = jax_mesh_from_string(spec)
    batch = {k: jnp.asarray(v) for k, v in setup.batch.items()}

    def f(lora):
        return jax_pipeline_lm_loss(
            params, jm.llm.cfg, mesh, batch["input_ids"],
            batch["attention_mask"], batch["labels"], num_microbatches=m,
            lora=lora, lora_scale=jm.lora_scale)
    loss, grads = jax.value_and_grad(f)(
        jax.tree.map(jnp.asarray, setup.trainable["lora"]))
    named = trainable_state_dict({"connectors": {}, "lora": jax.tree.map(
        np.asarray, grads)})
    return float(loss), named


def _plain_loss_and_grads(setup):
    model = base.tiny_model(setup.state)
    b = {k: torch.tensor(v) for k, v in setup.batch.items()}
    logits, _, _ = model.llm(input_ids=b["input_ids"],
                             attention_mask=b["attention_mask"])
    loss = lm_loss(logits, b["labels"], IGNORE_INDEX)
    loss.backward()
    return float(loss.detach()), {f"llm.{n}": p.grad.numpy()
                         for n, p in model.llm.named_parameters()
                         if "lora_" in n}


@pytest.mark.parametrize("spec,m", LOSS_MESHES)
def test_pipeline_lm_loss_matches_jax_and_the_mesh_less_port(
        setup, launched, spec, m):
    """The shares summed over pp and dp equal JAX's loss on the same mesh
    (rtol 1e-5) and the mesh-less forward's; each stage's LoRA gradients
    (its layers alone) equal JAX's and the mesh-less backward's."""
    ranks = launched[(spec, m)].result()
    p_loss, p_grads = _plain_loss_and_grads(setup)
    refs = [(p_loss, p_grads)]
    if ("jax", spec, m) in launched:
        refs.append(launched[("jax", spec, m)].result())
        np.testing.assert_allclose(p_loss, refs[1][0], rtol=REL)
    seen = set()
    for r in ranks:
        for want_loss, want_grads in refs:
            np.testing.assert_allclose(r["loss"], want_loss, rtol=REL)
            for name, g in r["grads"].items():
                name = f"llm.{name}"
                np.testing.assert_allclose(np.asarray(g), want_grads[name],
                                           atol=ATOL,
                                           err_msg=f"{spec} {name}")
                seen.add(name)
    # every layer's adapter came from its own stage
    assert seen == set(p_grads) == set(refs[-1][1])
    stages = {r["stage"]: set(r["grads"]) for r in ranks}
    assert not stages[0] & stages[1]


@pytest.mark.parametrize("spec,m", LOSS_MESHES)
def test_place_stages_frees_the_other_stages_layers(setup, launched, spec,
                                                    m):
    """The Trainer's placement over pp: each rank keeps the storage of
    its stage's layers alone (frozen base and adapter) and trains only
    their adapter beside the replicated leaves; gather_stages then brings
    every layer back, equal to the loaded weights."""
    from llamole_tpu_torch.parallel.pipeline import layer_index, stage_of
    layers = setup.jm.llm.cfg.num_layers
    for r in launched[(spec, m)].result():
        held = r["held"]
        for i, nbytes in enumerate(held):
            own = stage_of(i, layers, 2) == r["stage"]
            assert (nbytes > 0) == own, f"{spec} stage {r['stage']} layer {i}"
        staged = {layer_index(n) for n in r["trainable"]} - {None}
        assert staged == {i for i in range(layers)
                          if stage_of(i, layers, 2) == r["stage"]}
        assert any(n.startswith("connectors.") for n in r["trainable"])
        assert r["restored"]


def _losses(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f
                if "loss" in json.loads(line)]


def _bundle(out_dir):
    tree = {"lora": load_pytree(os.path.join(out_dir, "adapter.msgpack")),
            "connectors": {
                name: load_pytree(os.path.join(out_dir, "connector",
                                               f"{name}.msgpack"))
                for name in ("graph_to_lm", "lm_to_graph_decoder",
                             "lm_to_graph_predictor")}}
    return trainable_state_dict(tree)


def _assert_bundle(got, want, what):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   atol=ATOL, err_msg=f"{what}: {n}")


@pytest.mark.parametrize("run", ["zero0", "zero1", "predict"])
def test_pipeline_training_matches_the_mesh_less_port(setup, launched, run,
                                                      tmp_path):
    """run_mmsft on pp:2,dp:2 with 2 microbatches: the losses and the
    bundle save_pretrained gathered from the stages equal the mesh-less
    run's; it loads in JAX (GraphLM.load_trainable) unchanged; with a
    held-out split, generated_predictions.jsonl equals the mesh-less
    run's."""
    names, out = launched["train"].result()
    assert run in names[0]
    val, design = (0.4, 0.0) if run == "predict" else (0.0, 1.0)
    worker.train_mmsft(str(setup.work / "state.pt"), str(tmp_path), "",
                       0, val, 2, design)
    np.testing.assert_allclose(_losses(out / run), _losses(tmp_path),
                               rtol=REL)
    got = _bundle(out / run)
    _assert_bundle(got, _bundle(tmp_path), run)
    _assert_bundle(trainable_state_dict(jax.tree.map(
        np.asarray, setup.jm.load_trainable(str(out / run)))), got,
        "JAX load")
    if run == "predict":
        with open(out / run / "generated_predictions.jsonl") as f:
            got_pred = f.read()
        with open(tmp_path / "generated_predictions.jsonl") as f:
            assert got_pred == f.read()
        assert len(got_pred.splitlines()) == 2


def test_pipeline_custom_chain_matches_the_mesh_less_port(setup, launched,
                                                         tmp_path):
    """LoRA+ and BAdam beside pp:2,dp:2 (each stage's optimizer over its
    leaves, BAdam's blocks dealt over every stage's names): the losses
    and the saved bundle equal the mesh-less run's."""
    _, out = launched["train"].result()
    worker.train_mmsft(str(setup.work / "state.pt"), str(tmp_path), "", 0,
                       0.0, 2, finetuning=CUSTOM)
    np.testing.assert_allclose(_losses(out / "custom"), _losses(tmp_path),
                               rtol=REL)
    _assert_bundle(_bundle(out / "custom"), _bundle(tmp_path), "custom")


@pytest.mark.parametrize("run,backend", [("zero1", "msgpack"),
                                         ("dcp", "dcp")])
def test_pipelined_resume_equals_the_uninterrupted_run(launched, run,
                                                       backend):
    """A pipelined run resumed from checkpoint-2 (msgpack: every stage's
    leaves gathered, each stage keeps its own; DCP: each stage writes
    and reads its own, GaLore's bases and moments among the optimizer
    state) gives the uninterrupted run's steps 3-4 and trained bundle."""
    _, out = launched["train"].result()
    with open(out / run / "checkpoint-2" / "trainer_state.json") as f:
        assert json.load(f)["backend"] == backend
    np.testing.assert_allclose(_losses(out / f"{run}_resume"),
                               _losses(out / run)[2:], rtol=REL)
    _assert_bundle(_bundle(out / f"{run}_resume"), _bundle(out / run),
                   f"{run} resumed")
