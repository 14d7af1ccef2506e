"""Mesh training in llamole_tpu_torch (parallel/) against llamole_tpu.

The mesh's axes, shape, errors and DCN order, and the three partition
spec functions, equal the JAX package's. Gloo runs on the CPU (ranks
started by parallel/dryrun.py launch, each a process of
tests/torch_parallel_worker.py importing no JAX, joined through a
FileStore under tmp_path with a time limit) train the tiny GraphLM (2
layers, hidden 64, 4 heads, 2 kv heads, f32), bridged from a JAX draw,
for 4 micro steps (2 updates, accumulation 2) over run_mmsft's batching
on dp:2, dp:2,tp:2 and dcn:2,dp:2 at zero stages 0, 1 and 3: their
losses (rtol 1e-5) and trained adapter + connectors (atol 1e-4) equal
the port's mesh-less Trainer (design branch on: every rank draws the
whole batch's noise) and the JAX Trainer on the same mesh string (design
weight 0: torch and JAX draw different numbers). Kernels B and C run as
their plain versions on the CPU. Then the checkpoints (msgpack across
packages and meshes, DCP's async save and resume), the refusals (the
world size, and the pipeline's equal to JAX's), and dryrun_multichip(4).
The ep and sp axes are held by tests/test_torch_moe_ep.py and
tests/test_torch_ring_attention.py, the quantized, q / k norm and tied
ZeRO-3 placements by tests/test_torch_mesh_placements.py.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.config import TrainingArguments as JaxTrainingArguments
from llamole_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from llamole_tpu.models.composite import GraphLM as JaxGraphLM
from llamole_tpu.models.gllm import LLM as JaxLLM
from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.graphclip.model import GraphCLIP, GraphCLIPConfig
from llamole_tpu.models.graphdit import GraphDiT as JaxGraphDiT
from llamole_tpu.models.graphdit import GraphDiTConfig as JaxDiTConfig
from llamole_tpu.models.graphdit.config import (
    build_data_info_from_smiles as jax_data_info)
from llamole_tpu.models.loader import make_fallback_predictor
from llamole_tpu.parallel import mesh_from_string as jax_mesh_from_string
from llamole_tpu.parallel.mesh import _dcn_grouped as jax_dcn_grouped
from llamole_tpu.parallel.sharding import (
    fsdp_param_pspecs as jax_fsdp_pspecs,
    llm_param_pspecs as jax_llm_pspecs,
    zero1_opt_pspecs as jax_zero1_pspecs)
from llamole_tpu.train.trainer import Trainer as JaxTrainer
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu_torch.config import FinetuningArguments
from llamole_tpu_torch.data.collator import SeqGraphCollator
from llamole_tpu_torch.data.loader import get_dataset
from llamole_tpu_torch.data.tokenizer import ByteTokenizer
from llamole_tpu_torch.models.composite import GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.parallel.mesh import (_dcn_grouped, mesh_from_string,
                                             mesh_layout, parse_mesh)
from llamole_tpu_torch.parallel.sharding import (fsdp_param_pspecs,
                                                 llm_param_pspecs,
                                                 zero1_opt_pspecs)
from llamole_tpu_torch.train.trainer import Trainer, find_last_checkpoint
from llamole_tpu_torch.train.workflow import _epoch_batches, run_mmsft
from llamole_tpu_torch.utils.constants import \
    SPECIAL_TOKENS as TORCH_SPECIAL_TOKENS
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import (_llm_path, graph_lm_state_dict,
                                       llm_tree, trainable_state_dict)

import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
REL = 1e-5        # losses
ATOL = 1e-4       # trained parameters
LIMIT = 120       # seconds a launch of ranks may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["", "dp:2,tp:4", "dcn:2,dp:4", "pp:2,dp:4",
                                  "ep:4,dp:2", "dp:2,sp:2,tp:2"])
def test_mesh_axes_and_shape_equal_jax(spec):
    want = jax_mesh_from_string(spec)
    names, shape = mesh_layout(**{k: v for k, v in parse_mesh(spec).items()})
    assert names == tuple(want.axis_names)
    assert shape == tuple(want.devices.shape)


def test_mesh_errors_equal_jax():
    for bad in ("xx:2", "dp:two"):
        with pytest.raises(ValueError) as jax_err:
            jax_mesh_from_string(bad)
        with pytest.raises(ValueError) as err:
            parse_mesh(bad)
        assert str(err.value) == str(jax_err.value)
    # one process per rank: a world of 1 has no place for dp:2 (JAX
    # would take the first 2 of its 8 devices)
    with pytest.raises(ValueError, match="needs 2 ranks, the process group "
                       "has 1"):
        mesh_from_string("dp:2")
    # every axis trains (the sp and ep axes since item 9c): only the
    # world size stops a mesh here
    for axes in ("pp:2,dp:2", "sp:2,dp:2", "ep:2,dp:2"):
        with pytest.raises(ValueError, match="needs 4 ranks, the process "
                           "group has 1"):
            mesh_from_string(axes)


def test_dcn_order_equals_jax():
    """tests/test_multichip.py's cases: slice-major when every dcn block
    lies on one host, else the contiguous order."""
    class Dev:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s

    cases = [[(i, i // 4) for i in (3, 7, 0, 4, 1, 5, 2, 6)],
             [(i, 0 if i < 3 else 1) for i in range(8)],
             [(i, None) for i in range(8)]]
    for case in cases:
        devs = [Dev(i, s) if s is not None else types.SimpleNamespace(id=i)
                for i, s in case]
        want = [d.id for d in jax_dcn_grouped(devs, dcn=2, per_group=4)]
        hosts = [None if s is None else f"host{s}" for _, s in case]
        got = [case[r][0] for r in _dcn_grouped(hosts, 2, 4)]
        assert got == want


# -- the spec functions -------------------------------------------------------------

def _jax_spec(tree, name):
    node = tree
    for k in _llm_path(name)[0]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    return tuple(node)


@pytest.fixture(scope="module")
def tiny_llm():
    llm = LLM(LLMConfig.tiny(), dtype=torch.float32)
    llm.reset_parameters(torch.Generator().manual_seed(0))
    named = dict(llm.named_parameters())
    return named, jax.tree.map(np.asarray, llm_tree(llm))


def test_llm_and_fsdp_specs_equal_jax(tiny_llm):
    named, tree = tiny_llm
    want = jax_llm_pspecs(tree)
    got = llm_param_pspecs(named)
    assert {n: _jax_spec(want, n) for n in named} == got
    assert got["layers.0.attn.q.weight"] == (None, "tp")
    assert got["layers.0.mlp.down.weight"] == ("tp", None)
    assert got["embed.weight"] == ("tp", None)
    for tp in (None, "tp"):
        want = jax_fsdp_pspecs(tree, dp=4, tp_axis=tp)
        got = fsdp_param_pspecs(named, 4, tp_axis=tp)
        assert {n: _jax_spec(want, n) for n in named} == got
    assert got["layers.0.attn.q.weight"] == ("dp", "tp")


def test_expert_specs_equal_jax():
    """With ep_axis the MoE experts shard their expert dimension, as in
    JAX, and ZeRO-3's spec composes dp with it as JAX's does (shard_llm
    and fsdp_llm apply them: tests/test_torch_moe_ep.py)."""
    llm = LLM(LLMConfig.tiny_moe(), dtype=torch.float32)
    llm.reset_parameters(torch.Generator().manual_seed(0))
    named = dict(llm.named_parameters())
    tree = jax.tree.map(np.asarray, llm_tree(llm))
    want = jax_llm_pspecs(tree, ep_axis="ep")
    got = llm_param_pspecs(named, ep_axis="ep")
    assert {n: _jax_spec(want, n) for n in named} == got
    assert got["layers.0.mlp.experts.gate"] == ("ep", None, None)
    assert got["layers.0.mlp.router.weight"] == ()
    for tp in (None, "tp"):
        want = jax_fsdp_pspecs(tree, dp=2, tp_axis=tp, ep_axis="ep")
        got = fsdp_param_pspecs(named, 2, tp_axis=tp, ep_axis="ep")
        assert {n: _jax_spec(want, n) for n in named} == got
    assert got["layers.0.mlp.experts.gate"][0] == "ep"
    assert "dp" in got["layers.0.mlp.experts.gate"]


def test_zero1_specs_equal_jax(tiny_llm):
    named, tree = tiny_llm
    state = {"mu": tree, "count": np.zeros((), np.int32),
             "b": np.zeros((6,), np.float32)}
    for dp in (2, 4):
        want = jax.tree.map(tuple, jax_zero1_pspecs(state, dp),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
        got = zero1_opt_pspecs(jax.tree.map(torch.from_numpy, state), dp)
        assert got == want


# -- gloo runs against the mesh-less port and JAX ------------------------------------

def _open(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


def _jax_model(tok, loss_weight_design=1.0):
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    return JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny(), dtype=jnp.float32),
        graph_decoder=JaxGraphDiT(JaxDiTConfig(**worker.DIT),
                                  jax_data_info(worker.CORPUS, worker.MAX_N)),
        graph_predictor=make_fallback_predictor(),
        graph_encoder=GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
        tokenizer=tok, token_id_dict=ids, lora_rank=4,
        finetuning_type="lora", loss_weight_design=loss_weight_design)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX draw (graph modules and adapter opened so every gate and
    factor has a gradient) bridged into a state dict, and run_mmsft's
    batch streams over 4 of the examples: "main", one batch of 4 an
    epoch for 4 epochs (every mesh here divides it), and "pairs",
    batches of 2 (4 data ranks replicate them)."""
    work = tmp_path_factory.mktemp("mesh")
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
        max_samples=4, template="default", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    ptok = ByteTokenizer(TORCH_SPECIAL_TOKENS)
    bank, inputs = get_dataset(None, data_args, None, ptok)
    collator = SeqGraphCollator(tokenizer=ptok, mol_id_to_graph=bank,
                                max_len=768, max_nodes=worker.MAX_N,
                                max_graphs=32, max_retro=32)
    streams = {
        "main": list(_epoch_batches(inputs, collator, 4, 4.0, 0, dp=2,
                                    pad_id=ptok.pad_token_id)),
        "pairs": list(_epoch_batches(inputs, collator, 2, 2.0, 0, dp=2,
                                     pad_id=ptok.pad_token_id))}
    assert [len(b["input_ids"]) for b in streams["main"]] == [4] * 4
    assert [len(b["input_ids"]) for b in streams["pairs"]] == [2] * 4
    state = graph_lm_state_dict(frozen, trainable)
    torch.save(state, work / "state.pt")
    for name, stream in streams.items():
        with open(work / f"{name}.pkl", "wb") as f:
            pickle.dump(stream, f)
    return types.SimpleNamespace(work=work, tok=tok, frozen=frozen,
                                 trainable=trainable, streams=streams,
                                 stream=streams["main"], state=state)


def _losses(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def _mesh_less(setup, weight, out_dir, stream="main", adapter="lora",
               finetuning=None):
    model = worker.tiny_model(setup.state, weight, adapter)
    t = Trainer(lambda b, g: model.loss(b, g, train=True),
                model.trainable_parameters(),
                worker.train_args(str(out_dir)), 2,
                finetuning_args=FinetuningArguments(**(finetuning or {})))
    t.train(t.init_state(0), iter(setup.streams[stream]), 4)
    return _losses(out_dir), {n: p.detach() for n, p in t.params.items()}


def _jax_run(setup, spec, zero, out_dir):
    jm = _jax_model(setup.tok, loss_weight_design=0.0)
    args = worker.train_args(str(out_dir), zero_stage=zero, mesh=spec)
    j_args = JaxTrainingArguments(**{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(JaxTrainingArguments)
        if hasattr(args, f.name)})
    jt = JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, setup.frozen),
                    j_args, 2, mesh=jax_mesh_from_string(spec))
    st = jt.init_state(jax.tree.map(jnp.asarray, setup.trainable), 0)
    st, _ = jt.train(st, iter(setup.stream), 4)
    return _losses(out_dir), trainable_state_dict(
        jax.tree.map(np.asarray, st.params))


def _assert_bundle(got, want, what):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   atol=ATOL, err_msg=f"{what}: {n}")


# GaLore on every 2-D leaf (rank 2 < the adapter's 4), its bases refreshed
# at updates 1, 4, ...: checkpoint-2 (update 1) lies between two refreshes
GALORE = {"use_galore": True, "galore_rank": 2, "galore_update_interval": 3}

# spec: (ranks, the zero stage of the JAX comparison, the mesh's other runs)
MESHES = {
    "dp:2": (2, 1, [{"name": "ckpt", "zero": 1, "weight": 0.0},
                    {"name": "ckpt_resume", "zero": 1, "weight": 0.0,
                     "resume": "ckpt/checkpoint-2"},
                    {"name": "galore", "zero": 0, "weight": 1.0,
                     "dcp": True, "finetuning": GALORE},
                    {"name": "galore_resume", "zero": 0, "weight": 1.0,
                     "dcp": True, "finetuning": GALORE,
                     "resume": "galore/checkpoint-2"},
                    {"name": "custom", "zero": 1, "weight": 1.0,
                     "finetuning": {"loraplus_lr_ratio": 16.0,
                                    "use_badam": True,
                                    "badam_switch_interval": 1}}]),
    "dp:2,tp:2": (4, 3, [{"name": "dcp", "zero": 3, "weight": 1.0,
                          "dcp": True},
                         {"name": "dcp_resume", "zero": 3, "weight": 1.0,
                          "dcp": True, "resume": "dcp/checkpoint-2"},
                         {"name": "dora", "zero": 1, "weight": 1.0,
                          "adapter": "dora"},
                         {"name": "full", "zero": 1, "weight": 1.0,
                          "adapter": "full"}]),
    "dcn:2,dp:2": (4, 0, [{"name": "pairs", "zero": 1, "weight": 1.0,
                           "stream": "pairs"}]),
}


@pytest.fixture(scope="module")
def launched(setup):
    """Every mesh's ranks, started side by side on threads (the JAX runs
    go on meanwhile): zero stages 0, 1, 3 with the design branch on, the
    JAX comparison's stage with it off, and the mesh's other runs."""
    from concurrent.futures import ThreadPoolExecutor

    def go(spec):
        ranks, jax_zero, extra = MESHES[spec]
        runs = [{"name": f"zero{z}", "zero": z, "weight": 1.0}
                for z in (0, 1, 3)]
        runs.append({"name": "jax", "zero": jax_zero, "weight": 0.0})
        runs += [dict(r) for r in extra]
        for r in runs:
            r["mesh"] = spec
        out = setup.work / spec.replace(":", "").replace(",", "_")
        done = dryrun.launch("torch_parallel_worker:train", ranks, {
            "state": str(setup.work / "state.pt"),
            "streams": {k: str(setup.work / f"{k}.pkl")
                        for k in setup.streams},
            "out": str(out), "runs": runs, "placements": spec},
            timeout=LIMIT, workdir=str(out / "ranks"), path=[HERE])
        with open(out / "placements.json", "w") as f:
            json.dump(done[0][0], f)
        return out

    def torchrun():
        """The CLI on dp:2 under torchrun, 2 gloo ranks."""
        out = setup.work / "torchrun"
        out.mkdir()
        with open(os.path.join(ROOT, "config", "smoke",
                               "tiny_train.yaml")) as f:
            text = f.read().replace("output_dir: saves/tiny-smoke",
                                    f"output_dir: {out / 'run'}")
        (out / "train.yaml").write_text(
            text + "mesh: dp:2\nzero_stage: 1\nmax_steps: 2\n")
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-port", str(_free_port()),
             "-m", "llamole_tpu_torch", "train", str(out / "train.yaml"),
             "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
            timeout=LIMIT, env={**os.environ, "OMP_NUM_THREADS": "1"}), out

    def dryrun_cli():
        """python -m llamole_tpu_torch.parallel.dryrun 4: dryrun_multichip(4)."""
        return subprocess.run(
            [sys.executable, "-m", "llamole_tpu_torch.parallel.dryrun", "4"],
            cwd=ROOT, capture_output=True, text=True, timeout=LIMIT + 30,
            env={**os.environ, "OMP_NUM_THREADS": "1",
                 "TMPDIR": str(setup.work)})

    pool = ThreadPoolExecutor(len(MESHES) + 2)
    futures = {spec: pool.submit(go, spec) for spec in MESHES}
    futures["torchrun"] = pool.submit(torchrun)
    futures["dryrun"] = pool.submit(dryrun_cli)
    yield futures
    pool.shutdown(wait=True)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_runs(launched, jax_runs):
    """{spec: the runs' output directory}: a launch that failed or passed
    LIMIT raises here."""
    return {spec: launched[spec].result() for spec in MESHES}


def test_torchrun_trains_the_cli_on_a_mesh(launched):
    """torchrun --nproc-per-node 2 -m llamole_tpu_torch train <yaml with
    mesh dp:2> --device cpu: two gloo ranks from torchrun's environment;
    rank 0 alone writes the log, the adapter and the checkpoint."""
    proc, out = launched["torchrun"].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = out / "run"
    assert len(_losses(run)) == 2
    for name in ("adapter.msgpack", "checkpoint-2/trainable.msgpack",
                 "checkpoint-2/opt_state.msgpack", "train_results.json"):
        assert (run / name).exists(), name


@pytest.fixture(scope="module")
def jax_runs(setup, launched, tmp_path_factory):
    """The JAX Trainer on each mesh string (design weight 0), one thread
    each (XLA compiles outside the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    work = tmp_path_factory.mktemp("jax")
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {spec: pool.submit(
            _jax_run, setup, spec, MESHES[spec][1],
            work / spec.replace(":", "").replace(",", "_"))
            for spec in MESHES}
        return {spec: fut.result() for spec, fut in futures.items()}


@pytest.mark.parametrize("spec", list(MESHES))
def test_mesh_training_matches_the_mesh_less_port(setup, mesh_runs, spec,
                                                  tmp_path):
    """zero stages 0, 1 and 3 on the mesh, the design branch on: the
    losses and the trained bundle equal the mesh-less Trainer's; on
    dcn:2,dp:2 the 2-row batches replicate over the 4 data ranks; on
    dp:2 LoRA+ and BAdam (the custom chain) at ZeRO-1; on dp:2,tp:2 DoRA
    and full finetuning too."""
    out = mesh_runs[spec]
    want_loss, want = _mesh_less(setup, 1.0, tmp_path / "plain")
    for z in (0, 1, 3):
        what = f"{spec} zero {z}"
        np.testing.assert_allclose(_losses(out / f"zero{z}"), want_loss,
                                   rtol=REL, err_msg=what)
        _assert_bundle(torch.load(out / f"zero{z}.pt"), want, what)
    if spec == "dcn:2,dp:2":
        want_loss, want = _mesh_less(setup, 1.0, tmp_path / "pairs", "pairs")
        np.testing.assert_allclose(_losses(out / "pairs"), want_loss,
                                   rtol=REL, err_msg="replicated rows")
        _assert_bundle(torch.load(out / "pairs.pt"), want, "replicated rows")
    if spec == "dp:2":
        # the custom chain's LoRA+ and BAdam on ZeRO-1's chunks
        custom = MESHES[spec][2][-1]["finetuning"]
        want_loss, want = _mesh_less(setup, 1.0, tmp_path / "custom",
                                     finetuning=custom)
        np.testing.assert_allclose(_losses(out / "custom"), want_loss,
                                   rtol=REL, err_msg="LoRA+ and BAdam")
        _assert_bundle(torch.load(out / "custom.pt"), want, "LoRA+, BAdam")
    if spec == "dp:2,tp:2":
        # DoRA's row norm all-reduced under row-parallel o / down; the
        # full-finetune LLM trained tensor-parallel
        for adapter in ("dora", "full"):
            want_loss, want = _mesh_less(setup, 1.0, tmp_path / adapter,
                                         adapter=adapter)
            np.testing.assert_allclose(_losses(out / adapter), want_loss,
                                       rtol=REL, err_msg=adapter)
            _assert_bundle(torch.load(out / f"{adapter}.pt"), want, adapter)


@pytest.mark.parametrize("spec", list(MESHES))
def test_shard_params_and_replicate_place_by_the_specs(mesh_runs, spec):
    """shard_params splits the q weight's output rows over tp (the JAX
    spec (None, tp) of its [in, out] leaf); replicate keeps a norm whole."""
    with open(mesh_runs[spec] / "placements.json") as f:
        got = json.load(f)
    tp = parse_mesh(spec)["tp"]
    assert got["q"] == [[64, 64], [64 // tp, 64]]
    assert got["norm"] == [[64], [64]]


@pytest.mark.parametrize("spec", list(MESHES))
def test_mesh_training_matches_jax_on_the_same_mesh(jax_runs, mesh_runs,
                                                    spec):
    out = mesh_runs[spec]
    j_loss, j_params = jax_runs[spec]
    what = f"{spec} zero {MESHES[spec][1]} against JAX"
    np.testing.assert_allclose(_losses(out / "jax"), j_loss, rtol=REL,
                               err_msg=what)
    _assert_bundle(torch.load(out / "jax.pt"), j_params, what)


def test_zero1_msgpack_checkpoint_loads_in_jax_and_the_mesh_less_port(
        setup, mesh_runs, tmp_path):
    """dp:2 at ZeRO-1 writes whole tensors (msgpack): a dp:2 run, the
    mesh-less port Trainer and the JAX Trainer resume from checkpoint-2
    and give the uninterrupted run's later losses."""
    out = mesh_runs["dp:2"]
    ckpt = out / "ckpt" / "checkpoint-2"
    with open(ckpt / "trainer_state.json") as f:
        assert json.load(f)["backend"] == "msgpack"
    later = _losses(out / "ckpt")[2:]
    np.testing.assert_allclose(_losses(out / "ckpt_resume"), later, rtol=REL)
    _assert_bundle(torch.load(out / "ckpt_resume.pt"),
                   torch.load(out / "ckpt.pt"), "dp:2 resumed")
    model = worker.tiny_model(setup.state, 0.0)
    t = Trainer(lambda b, g: model.loss(b, g, train=True),
                model.trainable_parameters(),
                worker.train_args(str(tmp_path / "port")), 2)
    st = t.load_checkpoint(t.init_state(0), str(ckpt))
    t.train(st, iter(setup.stream[2:]), 4)
    np.testing.assert_allclose(_losses(tmp_path / "port"), later, rtol=REL)
    jm = _jax_model(setup.tok, loss_weight_design=0.0)
    j_args = JaxTrainingArguments(
        output_dir=str(tmp_path / "jax"), gradient_accumulation_steps=2,
        learning_rate=1e-3, lr_scheduler_type="constant", logging_steps=1,
        save_steps=100, seed=0, max_grad_norm=1.0)
    jt = JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, setup.frozen),
                    j_args, 2)
    st = jt.init_state(jax.tree.map(jnp.asarray, setup.trainable), 0)
    st = jt.load_checkpoint(st, str(ckpt))
    assert st.step == 2
    _assert_bundle(trainable_state_dict(jax.tree.map(np.asarray, st.params)),
                   trainable_state_dict(load_pytree(
                       str(ckpt / "trainable.msgpack"))), "JAX load")
    jt.train(st, iter(setup.stream[2:]), 4)
    np.testing.assert_allclose(_losses(tmp_path / "jax"), later, rtol=REL)


def test_dcp_async_save_and_resume_equal_the_uninterrupted_run(mesh_runs):
    """dp:2,tp:2 at ZeRO-3 under LLAMOLE_ORBAX=1: checkpoint-2 is DCP's
    sharded async save, and the run resumed from it gives the
    uninterrupted run's later losses and trained bundle."""
    out = mesh_runs["dp:2,tp:2"]
    ckpt = out / "dcp" / "checkpoint-2"
    with open(ckpt / "trainer_state.json") as f:
        assert json.load(f)["backend"] == "dcp"
    assert (ckpt / "dcp_state" / ".metadata").exists()
    assert find_last_checkpoint(str(out / "dcp")).endswith("checkpoint-4")
    np.testing.assert_allclose(_losses(out / "dcp_resume"),
                               _losses(out / "dcp")[2:], rtol=REL)
    _assert_bundle(torch.load(out / "dcp_resume.pt"),
                   torch.load(out / "dcp.pt"), "DCP resumed")


def test_dcp_resume_keeps_the_galore_bases(mesh_runs):
    """GaLore on dp:2 at stage 0 under LLAMOLE_ORBAX=1, saved after update
    1 of a refresh interval of 3: the DCP checkpoint holds the bases and
    the low-rank moments at their own shapes, so the resumed run's update
    2 projects through the saved bases (zero ones would leave every GaLore
    leaf where it was) and its losses and bundle equal the uninterrupted
    run's. (Not held to the mesh-less run: the rank-2 bases of the tiny
    leaves turn with the gradients' last bits, which the sum over the
    ranks rounds differently.)"""
    out = mesh_runs["dp:2"]
    np.testing.assert_allclose(_losses(out / "galore_resume"),
                               _losses(out / "galore")[2:], rtol=REL)
    _assert_bundle(torch.load(out / "galore_resume.pt"),
                   torch.load(out / "galore.pt"), "GaLore resumed")


def test_jax_orbax_checkpoint_raises(setup, tmp_path):
    """A deliberate difference: the JAX package's orbax format needs orbax
    / tensorstore; the port's sharded checkpoints are DCP."""
    ck = tmp_path / "run" / "checkpoint-3"
    (ck / "orbax_state").mkdir(parents=True)
    (ck / "trainer_state.json").write_text(json.dumps(
        {"step": 3, "rng": [0, 1], "backend": "orbax"}))
    assert find_last_checkpoint(str(tmp_path / "run")) == str(ck)
    model = worker.tiny_model(setup.state)
    t = Trainer(lambda b, g: model.loss(b, g, train=True),
                model.trainable_parameters(), worker.train_args(None), 2)
    with pytest.raises(NotImplementedError, match="orbax / tensorstore"):
        t.load_checkpoint(t.init_state(0), str(ck))


def test_galore_on_a_sharded_mesh_raises():
    """It raised naming item 9c; since item 9c GaLore runs on a leaf's
    parts (tp > 1, ZeRO-1 over dp > 1) and beside pp, so the custom chain
    is built there (its runs against the mesh-less port:
    tests/test_torch_optimizers.py, tests/test_torch_pipeline.py)."""
    from llamole_tpu_torch.train.optimizers import CustomAdamW, create_optimizer
    ft = FinetuningArguments(use_galore=True, use_badam=True,
                             loraplus_lr_ratio=16.0)
    for groups, zero1 in ((types.SimpleNamespace(tp=2, dp=1, pp=1), False),
                          (types.SimpleNamespace(tp=1, dp=2, pp=1), True)):
        opt, _ = create_optimizer(worker.train_args(None), 2, {}, ft,
                                  groups=groups, zero1=zero1)
        assert isinstance(opt, CustomAdamW) and opt.galore is not None


def test_refusals_name_item_9b(tmp_path):
    """Item 9b is done: the pp axis trains and the inference legs take a
    mesh, where both raised naming it. What stops them now is JAX's: a
    mesh needs as many ranks as it has places."""
    from llamole_tpu_torch.config import get_train_args
    from llamole_tpu_torch.eval.workflow import run_molqa
    args = list(get_train_args(os.path.join(ROOT, "config", "smoke",
                                            "tiny_train.yaml")))
    for spec in ("pp:2,dp:2", "dp:4"):
        args[2] = dataclasses.replace(args[2], mesh=spec, zero_stage=0,
                                      output_dir=str(tmp_path))
        with pytest.raises(ValueError, match="world size must equal the "
                           "mesh"):
            run_mmsft(*args, device="cpu")
    with pytest.raises(ValueError, match="world size must equal the mesh"):
        run_molqa(None, None, types.SimpleNamespace(mesh="dp:2"), None,
                  None)


def test_refusals_name_item_9c(setup, tmp_path):
    """Item 9c is done: sp and ep meshes train, where they raised naming
    it; what stops them here is JAX's, a mesh needs as many ranks as it
    has places. The pipeline refuses what JAX's refuses, with JAX's
    messages: ZeRO-3 beside pp (dp > 1), MoE training, a sliding window,
    microbatches that do not divide the batch, stages that do not divide
    the depth, and enable_pipeline after the first loss."""
    from llamole_tpu.parallel.pipeline import (
        pipeline_decoder_forward as jax_pipeline_forward)
    from llamole_tpu_torch.config import get_train_args
    from llamole_tpu_torch.parallel.pipeline import (check_pipeline,
                                                     check_pipeline_zero)
    args = list(get_train_args(os.path.join(ROOT, "config", "smoke",
                                            "tiny_train.yaml")))
    for spec, zero in (("sp:2,dp:2", 1), ("ep:2,dp:2", 0)):
        args[2] = dataclasses.replace(args[2], mesh=spec, zero_stage=zero,
                                      output_dir=str(tmp_path))
        with pytest.raises(ValueError, match="world size must equal the "
                           "mesh"):
            run_mmsft(*args, device="cpu")
    # ZeRO-3 with pp: the JAX Trainer's ValueError, before any placement
    jm = _jax_model(setup.tok)
    j_args = JaxTrainingArguments(output_dir=None, zero_stage=3)
    with pytest.raises(ValueError) as jax_err:
        JaxTrainer(jm.loss_fn, jax.tree.map(jnp.asarray, setup.frozen),
                   j_args, 2, mesh=jax_mesh_from_string("pp:2,dp:2"))
    with pytest.raises(ValueError) as err:
        check_pipeline_zero(parse_mesh("pp:2,dp:2"), 3)
    assert str(err.value) == str(jax_err.value)
    args[2] = dataclasses.replace(args[2], mesh="pp:2,dp:2", zero_stage=3)
    with pytest.raises(ValueError, match="zero_stage=3 with pipeline"):
        run_mmsft(*args, device="cpu")
    check_pipeline_zero(parse_mesh("pp:2"), 3)     # dp 1: JAX's is inert
    # the schedule's refusals, in JAX's order and words
    mesh = jax_mesh_from_string("pp:2,dp:4")
    x = jnp.zeros((4, 8, 64), jnp.float32)
    mask = jnp.ones((4, 8), jnp.int32)
    jt, pt = JaxLLMConfig.tiny(), LLMConfig.tiny()
    cases = [  # (JAX config, the port's, depth, train, microbatches)
        (JaxLLMConfig.tiny_moe(), LLMConfig.tiny_moe(), 2, True, 2),
        (dataclasses.replace(jt, sliding_window=4),
         dataclasses.replace(pt, sliding_window=4), 2, False, 2),
        (jt, dataclasses.replace(pt, num_layers=3), 3, True, 2),
        (jt, pt, 2, True, 3)]
    for jcfg, pcfg, depth, train, m in cases:
        with pytest.raises(ValueError) as jax_err:
            jax_pipeline_forward(
                {"layers_stacked": {"w": jnp.zeros((depth, 1))}}, x, mask,
                mask, jcfg, mesh, num_microbatches=m, train=train)
        with pytest.raises(ValueError) as err:
            check_pipeline(pcfg, 2, 4, m, train)
        assert str(err.value) == str(jax_err.value)
    # enable_pipeline: MoE raises as JAX's does, and so does a call after
    # the first loss
    model = worker.tiny_model(setup.state)
    moe = GraphLM(LLM(LLMConfig.tiny_moe(), dtype=torch.float32),
                  model.graph_decoder, model.graph_predictor,
                  model.graph_encoder, model.tokenizer,
                  model.token_id_dict, lora_rank=4)
    j_moe = JaxGraphLM(
        llm=JaxLLM(JaxLLMConfig.tiny_moe(), dtype=jnp.float32),
        graph_decoder=jm.graph_decoder, graph_predictor=jm.graph_predictor,
        graph_encoder=jm.graph_encoder, tokenizer=setup.tok,
        token_id_dict=jm.token_id_dict, lora_rank=4)
    with pytest.raises(ValueError) as jax_err:
        j_moe.enable_pipeline(mesh, 2)
    with pytest.raises(ValueError) as err:
        moe.enable_pipeline(None, 2)
    assert str(err.value) == str(jax_err.value)
    model.loss(setup.stream[0], torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="after the first loss"):
        model.enable_pipeline(None, 2)


def test_dryrun_multichip_prints_ok(launched):
    """The dp x tp, ZeRO-1, ZeRO-3, dcn x dp, pipeline, sp x dp, S²-attn
    under tp and moe-ep legs, the ring-sp leg, the quantized (int8 QLoRA
    on dp x tp at ZeRO-3, then an int8-KV decode), q / k norm (tp) and
    tied ZeRO-3 legs, and the dp inference, tp design, MoE design and dp
    retro legs on 4 gloo ranks, each equal to the mesh-less run."""
    proc = launched["dryrun"].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "dryrun_multichip OK" in out
    for leg in ("dp=2 tp=2", "zero1 dp=4", "zero3 dp=4", "dcn=2 dp=2",
                "pipeline", "sp=2 dp=2", "s2-tp", "moe-ep", "ring-sp",
                "quant dp=2 tp=2", "qk-norm tp=2", "zero3 tied dp=2 tp=2",
                "dp-inference", "tp-design", "moe-design", "dp-retro"):
        assert f"dryrun {leg} OK" in out
    assert "dryrun dp-inference OK: mesh dp=4, batch 5 (padded to 8)" in out
    assert "dryrun pipeline OK: mesh pp=2 dp=2" in out
    assert "dryrun moe-ep OK: mesh ep=2 dp=2" in out
    assert "dryrun ring-sp OK: mesh sp=2 dp=2" in out
