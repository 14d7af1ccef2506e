"""mmsft training in llamole_tpu_torch against llamole_tpu (f32, CPU).

One tiny GraphLM is drawn in JAX, its frozen graph modules perturbed so
every AdaLN gate and the LoRA adapter are open, and bridged into the port
(weights.graph_lm_state_dict). Both packages then see the same collated
MolQA batch: the loss with train=False and its gradients (the design
branch fed JAX's own noised graph through the `noisy` seam), the
optimizer and its schedules against optax, four Trainer steps against the
JAX Trainer, and the run_mmsft entry points on the tiny smoke config.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llamole_tpu.config import TrainingArguments as JaxTrainingArguments
from llamole_tpu.data.collator import SeqGraphCollator as JaxCollator
from llamole_tpu.data.loader import get_dataset as jax_get_dataset
from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from llamole_tpu.models.composite import GraphLM as JaxGraphLM
from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.graphclip.model import GraphCLIP, GraphCLIPConfig
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.graphdit.diffusion import apply_noise
from llamole_tpu.models.loader import make_fallback_predictor
from llamole_tpu.train.trainer import Trainer as JaxTrainer
from llamole_tpu.train.trainer import create_optimizer as jax_optimizer
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.config import (FinetuningArguments, TrainingArguments,
                                      get_train_args)
from llamole_tpu_torch.data.collator import SeqGraphCollator
from llamole_tpu_torch.data.loader import get_dataset
from llamole_tpu_torch.data.tokenizer import ByteTokenizer
from llamole_tpu_torch.models.composite import GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphclip import GraphCLIP as TorchCLIP
from llamole_tpu_torch.models.graphclip import (
    GraphCLIPConfig as TorchCLIPConfig)
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (
    make_fallback_predictor as torch_predictor)
from llamole_tpu_torch.train.optimizers import (CustomAdamW, create_optimizer,
                                               make_schedule)
from llamole_tpu_torch.train.trainer import Trainer, token_accuracy
from llamole_tpu_torch.train.workflow import run_mmsft
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import (graph_lm_state_dict,
                                       trainable_state_dict, trainable_values)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
MAX_N = 16
REL = 1e-5        # losses
GRAD_ATOL = 1e-4  # gradients and trained parameters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models here run faster on one thread, and the suite runs
    several test workers side by side on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _open(tree, seed, scale=0.2):
    """Every leaf + noise: the zero-initialised AdaLN gates of the
    denoiser and the predictor and the LoRA B matrices open, so every
    connector and adapter gets a gradient."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


def _jax_model(tok, loss_weight_design=1.0):
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    return JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**DIT),
                                  jax_data_info(CORPUS, MAX_N)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=4,
        finetuning_type="lora", loss_weight_design=loss_weight_design)


def _torch_model(frozen, trainable, loss_weight_design=1.0):
    tok = ByteTokenizer(TORCH_SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in TORCH_SPECIAL_TOKENS}
    tm = GraphLM(LLM(LLMConfig.tiny(), dtype=torch.float32),
                 GraphDiT(GraphDiTConfig(**DIT),
                          build_data_info_from_smiles(CORPUS, MAX_N)),
                 torch_predictor(),
                 TorchCLIP(TorchCLIPConfig(num_layer=2, hidden_size=64)),
                 tok, ids, lora_rank=4, loss_weight_design=loss_weight_design)
    tm.load_state_dict(graph_lm_state_dict(frozen, trainable))
    return tm


@pytest.fixture(scope="module")
def setup():
    tok = JaxByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    jm = _jax_model(tok)
    frozen = jm.init_frozen(jax.random.PRNGKey(0))
    trainable = jm.init_trainable(jax.random.PRNGKey(1), frozen)
    frozen = {k: (_open(v, 2) if k != "llm" else jax.tree.map(np.asarray, v))
              for k, v in frozen.items()}
    trainable = {"connectors": jax.tree.map(np.asarray,
                                            trainable["connectors"]),
                 "lora": _open(trainable["lora"], 3, 0.05)}
    data_args = types.SimpleNamespace(
        dataset="molqa_train_examples", dataset_dir=os.path.join(ROOT, "data"),
        max_samples=None, template="default", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    # the port's data pipeline makes the batches both models consume;
    # they equal the JAX pipeline's
    sides = []
    for load, collate, t in (
            (jax_get_dataset, JaxCollator, tok),
            (get_dataset, SeqGraphCollator,
             ByteTokenizer(TORCH_SPECIAL_TOKENS))):
        bank, inputs = load(None, data_args, None, t)
        collator = collate(tokenizer=t, mol_id_to_graph=bank, max_len=768,
                           max_nodes=MAX_N, max_graphs=16, max_retro=16)
        sides.append([collator(inputs[i:i + 2]) for i in (0, 2)])
    jax_batches, batches = sides
    for a, b in zip(jax_batches, batches):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return tok, jm, frozen, trainable, batches


def _design_draw(jm, batch, key):
    """JAX's noised design graph for loss_fn(rng=key): the splits of
    composite.py loss_fn and GraphDiT.loss."""
    _, k_design = jax.random.split(key)
    k_noise, _ = jax.random.split(k_design)
    d_idx = np.clip(batch["design_graph_index"], 0, None)
    d_valid = (batch["design_start_pos"] >= 0) & (
        batch["design_graph_index"] >= 0)
    mask = jnp.asarray(batch["mol_node_mask"][d_idx] & d_valid[:, None])
    X, E = jm.graph_decoder.codes_to_onehot(
        jnp.asarray(batch["mol_atoms"][d_idx]),
        jnp.asarray(batch["mol_edges"][d_idx]), mask)
    noisy = apply_noise(k_noise, X, E, mask, jm.graph_decoder.schedule,
                        jm.graph_decoder.parts, train=False)
    return {k: torch.from_numpy(np.array(noisy[k])) for k in
            ("t", "X_t", "E_t")}


def test_loss_and_gradients_match_jax(setup):
    """GraphLM.loss(train=False): total and the three terms (1e-5 rel) and
    the gradients of the LoRA adapter and all three connectors (1e-4)."""
    tok, jm, frozen, trainable, batches = setup
    batch = batches[0]
    assert batch["retro_valid"].any() and (batch["design_start_pos"] >= 0
                                           ).any()
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_total, j_aux), j_grads = jax.value_and_grad(
        lambda tr: jm.loss_fn(tr, frozen, key, jb, train=False),
        has_aux=True)(jax.tree.map(jnp.asarray, trainable))

    tm = _torch_model(frozen, trainable)
    total, aux = tm.loss(batch, train=False,
                         noisy=_design_draw(jm, batch, key))
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_total), rtol=REL)
    for k in ("lm_loss", "design_loss", "retro_loss"):
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=REL)
    want = trainable_state_dict(jax.tree.map(np.asarray, j_grads))
    got = tm.trainable_parameters()
    assert set(got) == set(want)
    for name in ("connectors.graph_to_lm.weight",
                 "connectors.lm_to_graph_decoder.weight",
                 "connectors.lm_to_graph_predictor.weight",
                 "llm.layers.0.attn.q.lora_a", "llm.layers.1.mlp.down.lora_b"):
        assert float(got[name].grad.abs().max()) > 0, name
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    # only the trainable bundle keeps gradients
    frozen_grads = [n for n, p in tm.named_parameters()
                    if n not in got and p.grad is not None]
    assert not frozen_grads and not tm.llm.embed.weight.requires_grad


def test_training_loss_draws_noise_and_runs_the_plain_attention(
        setup, monkeypatch):
    """train=True: the design term depends on the generator (noise level,
    condition dropout, property noise), and the denoiser never reaches the
    kernel-A wrapper."""
    tok, jm, frozen, trainable, batches = setup
    tm = _torch_model(frozen, trainable)
    from llamole_tpu_torch.models.graphdit import denoiser

    def refuse(*args, **kwargs):
        raise AssertionError("fused_block_attention reached in training")

    monkeypatch.setattr(denoiser, "fused_block_attention", refuse)
    losses = []
    for seed in (0, 0, 1):
        total, aux = tm.loss(batches[0], torch.Generator().manual_seed(seed))
        total.backward()
        losses.append(aux["design_loss"].item())
    assert losses[0] == losses[1] != losses[2]
    assert all(np.isfinite(losses))


def test_schedules_match_optax():
    for sched_type in ("cosine", "linear", "constant"):
        for steps, ratio in ((2, 0.1), (50, 0.1), (40, 0.0), (7, 0.5)):
            kw = dict(learning_rate=3e-4, warmup_ratio=ratio,
                      lr_scheduler_type=sched_type)
            _, want = jax_optimizer(JaxTrainingArguments(**kw), steps)
            got = make_schedule(TrainingArguments(**kw), steps)
            for count in range(steps + 3):
                # optax evaluates in f32
                np.testing.assert_allclose(got(count), float(want(count)),
                                           rtol=1e-5, atol=1e-10,
                                           err_msg=f"{sched_type} {count}")
    args = TrainingArguments(learning_rate=1e-4, warmup_ratio=0.1)
    assert make_schedule(args, 2)(0) == 0.0   # lr 0 at the first update


def test_accumulated_clipped_update_matches_optax():
    """Two micro steps (accumulation 2) -> one clipped AdamW update with
    weight decay, then a second window, against create_optimizer."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    kw = dict(learning_rate=1e-2, gradient_accumulation_steps=2,
              weight_decay=0.1, max_grad_norm=1.0, lr_scheduler_type="linear",
              warmup_steps=1)
    tx, _ = jax_optimizer(JaxTrainingArguments(**kw), 4)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(j_params)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt, _ = create_optimizer(TrainingArguments(**kw), 4, params)
    applied = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        applied.append(opt.accumulate())
    assert applied == [False, True, False, True]
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(params["a"].detach().numpy(), init["a"])


def test_token_accuracy():
    logits = torch.zeros(1, 4, 5)
    logits[0, 0, 2] = logits[0, 1, 3] = logits[0, 2, 1] = 1.0
    labels = torch.tensor([[-100, 2, 4, -100]])
    assert float(token_accuracy(logits, labels)) == 0.5


def _train_args(cls, out_dir, **kw):
    base = dict(output_dir=str(out_dir), per_device_train_batch_size=2,
                gradient_accumulation_steps=2, learning_rate=1e-3,
                lr_scheduler_type="constant", logging_steps=1, save_steps=100,
                num_train_epochs=2.0, seed=0, max_grad_norm=1.0)
    base.update(kw)
    return cls(**base)


def test_four_trainer_steps_match_jax(setup, tmp_path):
    """loss_weight_design 0, so no random draw reaches the loss: the
    per-step losses (1e-5 rel) and the trained LoRA + connectors (1e-4)
    of four micro steps (two updates) equal the JAX Trainer's."""
    tok, _, frozen, trainable, batches = setup
    jm = _jax_model(tok, loss_weight_design=0.0)
    stream = [batches[0], batches[1], batches[1], batches[0]]

    j_args = _train_args(JaxTrainingArguments, tmp_path / "jax")
    jt = JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, frozen), j_args, 2)
    j_state = jt.init_state(jax.tree.map(jnp.asarray, trainable), 0)
    j_state, _ = jt.train(j_state, iter(stream), 4)

    tm = _torch_model(frozen, trainable, loss_weight_design=0.0)
    t_args = _train_args(TrainingArguments, tmp_path / "torch")
    tt = Trainer(lambda b, g: tm.loss(b, g, train=True),
                 tm.trainable_parameters(), t_args, 2)
    t_state, metrics = tt.train(tt.init_state(0), iter(stream), 4)
    assert t_state.step == 4 and len(metrics["step_times"]) == 4

    def losses(path):
        with open(path / "trainer_log.jsonl") as f:
            return [json.loads(line)["loss"] for line in f]

    np.testing.assert_allclose(losses(tmp_path / "torch"),
                               losses(tmp_path / "jax"), rtol=REL)
    want = trainable_state_dict(jax.tree.map(np.asarray, j_state.params))
    for name, p in tm.trainable_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)


TINY = os.path.join(ROOT, "config", "smoke", "tiny_train.yaml")


def _tiny_args(out_dir, data=None, **kw):
    args = list(get_train_args(TINY))
    args[1] = dataclasses.replace(args[1], **(data or {}))
    args[2] = dataclasses.replace(args[2], output_dir=str(out_dir), **kw)
    return args


def test_run_mmsft_writes_logs_checkpoints_and_resumes(tmp_path,
                                                        monkeypatch):
    """The tiny smoke config on the CPU with a validation split: the
    trainer_log.jsonl records carry the JAX keys, in-train and final
    eval losses and the predictions are written, so are checkpoint-N and
    the trained bundle (which load_trainable reads back); a run stopped
    at step 1 and resumed equals the uninterrupted run; the CPU must be
    asked for."""
    from llamole_tpu_torch.models.loader import build_graph_lm

    val = {"val_size": 0.2}
    full = tmp_path / "full"
    metrics = run_mmsft(*_tiny_args(full, val, save_steps=1,
                                    eval_strategy="steps", eval_steps=2),
                        device="cpu")
    # 4 training records, batch 2, one epoch: 2 micro steps
    assert metrics["train_steps"] == 2 and np.isfinite(metrics["train_loss"])
    assert np.isfinite(metrics["eval_loss"])
    with open(full / "trainer_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    keys = {"current_steps", "total_steps", "loss", "lm_loss", "design_loss",
            "retro_loss", "grad_norm", "learning_rate", "epoch",
            "throughput_tok_s", "elapsed"}
    train_recs = [r for r in recs if "loss" in r]
    assert [r["current_steps"] for r in train_recs] == [1, 2]
    assert all(keys <= set(r) for r in train_recs)
    assert [r["current_steps"] for r in recs if "eval_loss" in r] == [2]
    for d in ("checkpoint-1", "checkpoint-2"):
        assert (full / d / "trainer_state.json").exists()
        assert (full / d / "adapter.msgpack").exists()
        assert (full / d / "trainable.msgpack").exists()
        assert (full / d / "opt_state.msgpack").exists()
    assert (full / "generated_predictions.jsonl").exists()
    assert (full / "graphllm_config.json").exists()

    model_args, data_args, _, ft_args, _ = _tiny_args(tmp_path)
    fresh, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu",
                              seed=1)
    fresh.load_trainable(str(full))
    trained = trainable_values(
        load_pytree(str(full / "checkpoint-2" / "trainable.msgpack")),
        fresh.trainable_parameters())
    for name, p in fresh.trainable_parameters().items():
        torch.testing.assert_close(p.detach(), trained[name], rtol=0, atol=0)

    part = tmp_path / "part"
    run_mmsft(*_tiny_args(part, val, max_steps=1), device="cpu")
    resumed = run_mmsft(*_tiny_args(part, val, overwrite_output_dir=False),
                        device="cpu")
    assert resumed["train_steps"] == 2 and len(resumed["step_times"]) == 1
    for name in ("adapter.msgpack", "connector/lm_to_graph_predictor.msgpack"):
        a = jax.tree_util.tree_leaves(load_pytree(str(full / name)))
        b = jax.tree_util.tree_leaves(load_pytree(str(part / name)))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_mmsft(*_tiny_args(tmp_path / "x"), device="cuda")
    # LLAMOLE_ORBAX=1 writes DCP checkpoints (tests/test_torch_parallel.py
    # resumes from them); a mesh needs as many ranks as it has places
    monkeypatch.setenv("LLAMOLE_ORBAX", "1")
    run_mmsft(*_tiny_args(tmp_path / "y", max_steps=1), device="cpu")
    with open(tmp_path / "y" / "checkpoint-1" / "trainer_state.json") as f:
        assert json.load(f)["backend"] == "dcp"
    assert (tmp_path / "y" / "checkpoint-1" / "dcp_state" / ".metadata"
            ).exists()
    monkeypatch.delenv("LLAMOLE_ORBAX")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        run_mmsft(*_tiny_args(tmp_path / "z", mesh="dp:2"), device="cpu")
    # GaLore, BAdam and LoRA+ build the custom chain (once refused here;
    # tests/test_torch_optimizers.py holds it to JAX's)
    opt, _ = create_optimizer(TrainingArguments(), 4, {},
                              FinetuningArguments(use_galore=True))
    assert isinstance(opt, CustomAdamW) and opt.galore.rank == 16


def test_cli_trains_and_loss_drops(tmp_path):
    """python -m llamole_tpu_torch.train <yaml> --device cpu: 12 micro
    steps at a constant learning rate lower the LM loss (the design term
    draws a new noise level every step, so the total is noisy)."""
    cfg = tmp_path / "cfg.yaml"
    with open(TINY) as f:
        text = f.read()
    text = (text.replace("output_dir: saves/tiny-smoke",
                         f"output_dir: {tmp_path / 'out'}")
            .replace("num_train_epochs: 1.0", "num_train_epochs: 4.0")
            .replace("lr_scheduler_type: cosine",
                     "lr_scheduler_type: constant"))
    cfg.write_text(text)
    proc = subprocess.run([sys.executable, "-m", "llamole_tpu_torch.train",
                           str(cfg), "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "out" / "trainer_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    lm = [r["lm_loss"] for r in recs]
    assert len(lm) == 12 and all(np.isfinite([r["loss"] for r in recs]))
    assert np.mean(lm[-3:]) < np.mean(lm[:3]) - 0.5, lm


def test_chip_smoke_arguments_equal_the_yaml(tmp_path):
    """chip_smoke.py writes llama_lora.yaml's settings out as argument
    objects (the card has no PyYAML): every key the YAML sets is there,
    every value equals get_train_args' apart from the named deviations,
    and they are all run_mmsft needs (a tiny model trains on them)."""
    import yaml

    from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                                 offline_tokenizer)

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    path = os.path.join(ROOT, "config", "train", "llama_lora.yaml")
    ours = chip_smoke.llama_lora_args(str(tmp_path))
    theirs = get_train_args(path)
    with open(path) as f:
        set_keys = set(yaml.safe_load(f))
    held = set()
    for a, b in zip(ours, theirs):
        for key, value in vars(a).items():
            held.add(key)
            if key in chip_smoke.TRAIN_DEVIATIONS:
                continue
            assert value == getattr(b, key), key
    assert set_keys - {"bf16", "pure_bf16", "stage", "do_train",
                       "lora_target", "new_special_tokens"} <= held

    tok = offline_tokenizer()
    model = build_graph_lm_from_configs(
        LLMConfig.tiny(), GraphDiTConfig(**DIT),
        build_data_info_from_smiles(CORPUS, MAX_N), tok, device="cpu",
        llm_dtype=torch.float32, lora_rank=8)
    metrics = run_mmsft(*ours, device="cpu", prebuilt=(model, tok))
    assert metrics["train_steps"] == 4 and np.isfinite(metrics["eval_loss"])
    assert (tmp_path / "checkpoint-4" / "trainer_state.json").exists()
