"""The MoE LLM of llamole_tpu_torch on a mesh (models/gllm/model.py
moe_mlp with its MoEMesh, parallel/sharding.py shard_llm / fsdp_llm)
against llamole_tpu's unsharded forward (f32, CPU).

JAX's _moe_mlp routes over the global batch: the capacity C comes from
every row's units and one stable sort over the concatenated batch gives
each unit its place in its expert. The port's ranks each hold a block of
the rows; they exchange per-expert counts so that the same units are
kept. Gloo ranks (parallel/dryrun.py launch, each a process of
tests/torch_ep_sp_worker.py importing no JAX, 120 s a launch) run the
tiny MoE LLM (2 layers, hidden 64, 4 experts, top-2) bridged from a JAX
draw at capacity factor 0.5, where units drop, over 4 left-padded rows
(padding in every data block), on dp:2,ep:2, tp:2,ep:2, dp:2 and ZeRO-3
ep:2,dp:2 (FSDP2 over dp of the frozen base, the attention adapter
trainable): the loss and the aux loss (the ranks' shares summed) within
1e-5 of JAX's forward(return_moe_aux=True) and of the mesh-less port,
the units dropped equal to the mesh-less port's, and every gradient
(router, experts, attention; the adapter's under ZeRO-3) within 1e-4
of jax.grad's and the mesh-less port's. Then run_mmsft of the tiny
config with 4 experts on ep:2,dp:2 at zero stages 0 and 3 (capacity
factor 0.75, units dropping): E/ep experts a rank, and its losses (rtol
1e-5) and saved bundle (atol 1e-4) equal the mesh-less run_mmsft's.
And the CLI under torchrun (gloo ranks) trains on ep:2,dp:2 with 4
experts, on dp:2,sp:2 and on tp:2 with shift_attn, rank 0 writing the
log, the adapter and the checkpoint.
"""

import json
import os
import socket
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.models.gllm import LLMConfig as JaxLLMConfig
from llamole_tpu.models.gllm.model import forward as jax_forward
from llamole_tpu.models.gllm.model import init_params
from llamole_tpu.models.gllm.model import lm_loss as jax_lm_loss
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.parallel import dryrun
from llamole_tpu_torch.utils.serialization import load_pytree
from llamole_tpu_torch.weights import llm_state_dict, trainable_state_dict

import torch_ep_sp_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 120
REL = 1e-5        # losses
ATOL = 1e-4       # gradients and trained parameters
FACTOR = 0.5      # units drop
# spec: (ranks, ZeRO-3)
MESHES = {"dp:2,ep:2": (4, False), "tp:2,ep:2": (4, False),
          "dp:2": (2, False), "ep:2,dp:2": (4, True)}
TRAIN = {"zero0": ("ep:2,dp:2", 0), "zero3": ("ep:2,dp:2", 3),
         "plain": ("", 0)}
ROOT = os.path.dirname(HERE)
# torchrun ... train: (mesh, ranks, the YAML's other lines)
CLI = {"ep": ("ep:2,dp:2", 4, "num_experts: 4\nnum_experts_per_tok: 2\n"),
       "sp": ("dp:2,sp:2", 4, ""), "s2": ("tp:2", 2, "shift_attn: true\n")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b=4, s=11, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :4] = 0       # left padding in both dp blocks
    mask[3, :7] = 0
    keep = mask.astype(bool) & (rng.random(ids.shape) < 0.7)
    return ids, mask, np.where(keep, ids, -100).astype(np.int32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX draw bridged into a state dict, the adapter the ZeRO-3
    case trains (A drawn, B = 0), the batch, and JAX's loss, aux and
    gradients."""
    work = tmp_path_factory.mktemp("moe_ep")
    jcfg = replace(JaxLLMConfig.tiny_moe(), moe_capacity_factor=FACTOR)
    cfg = replace(LLMConfig.tiny_moe(), moe_capacity_factor=FACTOR)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    state = llm_state_dict(params)
    ids, mask, labels = _batch()
    adapted = LLM(cfg, dtype=torch.float32)
    adapted.add_lora(4, 2.0)
    adapted.reset_lora(torch.Generator().manual_seed(1))
    lora = {n: p.detach().clone() for n, p in adapted.named_parameters()
            if "lora_" in n}
    data = {"cfg": cfg, "state": state, "lora": lora,
            "ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(labels)}
    torch.save(data, work / "data.pt")

    def j_loss(p):
        logits, _, _, aux = jax_forward(p, jcfg, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask),
                                        train=True, return_moe_aux=True)
        return (jax_lm_loss(logits, jnp.asarray(labels))
                + jcfg.moe_aux_loss_coef * aux), aux

    (loss, aux), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return dict(work=work, data=data, cfg=cfg, loss=float(loss),
                aux=float(aux),
                grads=llm_state_dict(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def launched(setup):
    """Every mesh's ranks and the run_mmsft runs, side by side on
    threads."""
    from concurrent.futures import ThreadPoolExecutor
    work = setup["work"]

    def go(target, ranks, name, payload):
        out = work / name
        out.mkdir()
        dryrun.launch(f"torch_ep_sp_worker:{target}", ranks,
                      {**payload, "out": str(out)}, timeout=LIMIT,
                      workdir=str(out / "ranks"), path=[HERE])
        return [torch.load(out / f"rank{r}.pt") for r in range(ranks)], out

    def torchrun(name):
        mesh, ranks, extra = CLI[name]
        out = work / f"cli_{name}"
        out.mkdir()
        with open(os.path.join(ROOT, "config", "smoke",
                               "tiny_train.yaml")) as f:
            text = f.read().replace("output_dir: saves/tiny-smoke",
                                    f"output_dir: {out / 'run'}")
        (out / "train.yaml").write_text(
            text + f"mesh: {mesh}\nzero_stage: 1\nmax_steps: 2\n" + extra)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(ranks), "--master-port", str(port),
             "-m", "llamole_tpu_torch", "train", str(out / "train.yaml"),
             "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
            timeout=LIMIT, env={**os.environ, "OMP_NUM_THREADS": "1"}), out

    pool = ThreadPoolExecutor(len(MESHES) + len(TRAIN) + len(CLI))
    futures = {("cli", name): pool.submit(torchrun, name) for name in CLI}
    for spec, (ranks, zero3) in MESHES.items():
        name = f"{spec}{'_zero3' if zero3 else ''}".replace(":", "") \
            .replace(",", "_")
        futures[(spec, zero3)] = pool.submit(
            go, "moe", ranks, name, {"mesh": spec, "zero3": zero3,
                                     "data": str(work / "data.pt")})
    for name, (spec, zero) in TRAIN.items():
        futures[name] = pool.submit(
            go, "moe_train", 4 if spec else 1, f"train_{name}",
            {"mesh": spec, "zero": zero, "name": name,
             "factor": dryrun.MOE_CAPACITY})
    yield futures
    pool.shutdown(wait=True)


def _mesh_less(setup, zero3):
    """The mesh-less port's loss, aux, units dropped and gradients."""
    llm = worker._moe_llm(setup["data"], zero3)
    d = setup["data"]
    loss, aux = worker.moe_loss(llm, d["ids"].long(), d["mask"],
                                d["labels"])
    loss.backward()
    dropped = int(sum(layer.mlp.drop_count for layer in llm.layers))
    grads = {n: p.grad for n, p in llm.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), float(aux.detach()), dropped, grads


@pytest.mark.parametrize("spec,zero3", [(s, z) for s, (_, z) in
                                        MESHES.items()])
def test_moe_on_a_mesh_matches_jax_and_the_mesh_less_port(setup, launched,
                                                          spec, zero3):
    """Loss, aux, units dropped and gradients on the mesh against JAX's
    unsharded forward and the mesh-less port, at a capacity factor where
    units drop."""
    ranks, _ = launched[(spec, zero3)].result()
    loss, aux, dropped, grads = _mesh_less(setup, zero3)
    assert dropped > 0
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=REL, err_msg=spec)
        np.testing.assert_allclose(r["loss"], setup["loss"], rtol=REL)
        np.testing.assert_allclose(r["aux"], aux, rtol=REL, err_msg=spec)
        np.testing.assert_allclose(r["aux"], setup["aux"], rtol=REL)
        assert r["dropped"] == dropped, spec
    got = ranks[0]["grads"]
    assert set(got) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), atol=ATOL,
                                   err_msg=f"{spec}: {n}")
        if not zero3:
            np.testing.assert_allclose(got[n].numpy(),
                                       setup["grads"][n].numpy(), atol=ATOL,
                                       err_msg=f"{spec} vs JAX: {n}")
    experts = setup["cfg"].num_experts
    ep = 2 if "ep" in spec else 1
    assert ranks[0]["expert_shape"][0] == experts // ep
    if zero3:     # the experts' storage: 1/ep of them, and of that 1/dp
        shape = ranks[0]["expert_shape"]
        assert shape[0] * shape[1] * shape[2] * 4 == experts * 64 * 128


def _losses(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def _bundle(out_dir):
    tree = {"lora": load_pytree(os.path.join(out_dir, "adapter.msgpack")),
            "connectors": {
                name: load_pytree(os.path.join(out_dir, "connector",
                                               f"{name}.msgpack"))
                for name in ("graph_to_lm", "lm_to_graph_decoder",
                             "lm_to_graph_predictor")}}
    return trainable_state_dict(tree)


@pytest.mark.parametrize("run", ["zero0", "zero3"])
def test_moe_run_mmsft_on_ep_matches_the_mesh_less_run(launched, run):
    """run_mmsft with 4 experts on ep:2,dp:2: each rank's Trainer trains
    the adapter and the connectors over an LLM holding E/ep experts a
    rank, units drop, and the losses and the saved bundle equal the
    mesh-less run_mmsft's."""
    ranks, out = launched[run].result()
    plain, plain_out = launched["plain"].result()
    assert plain[0]["dropped"] > 0
    assert {r["dropped"] for r in ranks} == {plain[0]["dropped"]}
    for r in ranks:
        assert r["expert_shape"][0] == dryrun.MOE["num_experts"] // 2
        assert r["trainable"] == plain[0]["trainable"]
        assert not any(".experts." in n for n in r["trainable"])
    got = _losses(out / run)
    assert len(got) == 4
    np.testing.assert_allclose(got, _losses(plain_out / "plain"), rtol=REL)
    want = _bundle(plain_out / "plain")
    got = _bundle(out / run)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=ATOL, err_msg=f"{run}: {n}")


@pytest.mark.parametrize("name", list(CLI))
def test_torchrun_trains_the_cli_on_ep_and_sp_meshes(launched, name):
    """torchrun --nproc-per-node N -m llamole_tpu_torch train <yaml>
    --device cpu with mesh ep:2,dp:2 (4 experts), dp:2,sp:2 or tp:2 with
    shift_attn: rank 0 alone writes the log (two finite losses), the
    adapter and the checkpoint."""
    proc, out = launched[("cli", name)].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = out / "run"
    losses = _losses(run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    for f in ("adapter.msgpack", "checkpoint-2/trainable.msgpack",
              "checkpoint-2/opt_state.msgpack", "train_results.json"):
        assert (run / f).exists(), f
