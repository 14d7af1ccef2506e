"""The ranks' side of tests/test_torch_parallel.py: gloo processes
started by llamole_tpu_torch.parallel.dryrun.launch, which import the
port and never JAX (a rank that imports it fails)."""

import os
import pickle

import torch

from llamole_tpu_torch.config import FinetuningArguments, TrainingArguments
from llamole_tpu_torch.data.tokenizer import ByteTokenizer
from llamole_tpu_torch.models.composite import GraphLM
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphclip import GraphCLIP, GraphCLIPConfig
from llamole_tpu_torch.models.graphdit import (GraphDiT, GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import make_fallback_predictor
from llamole_tpu_torch.parallel import mesh_from_string
from llamole_tpu_torch.parallel.mesh import MeshGroups
from llamole_tpu_torch.parallel.sharding import full, shard_graph_lm
from llamole_tpu_torch.train.trainer import Trainer
from llamole_tpu_torch.utils.constants import SPECIAL_TOKENS

CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
MAX_N = 16


def tiny_model(state, loss_weight_design=1.0, adapter="lora") -> GraphLM:
    """The tiny GraphLM of the tests (2 layers, hidden 64, 4 heads, 2 kv
    heads, f32) with the given state dict. adapter: "lora", "dora" (the
    LoRA adapter with DoRA's magnitudes from the loaded weights) or
    "full" (the whole LLM trainable, the adapter's leaves dropped)."""
    tok = ByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    ids = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    full = adapter == "full"
    model = GraphLM(LLM(LLMConfig.tiny(), dtype=torch.float32),
                    GraphDiT(GraphDiTConfig(**DIT),
                             build_data_info_from_smiles(CORPUS, MAX_N)),
                    make_fallback_predictor(),
                    GraphCLIP(GraphCLIPConfig(num_layer=2, hidden_size=64)),
                    tok, ids, lora_rank=4,
                    finetuning_type="full" if full else "lora",
                    loss_weight_design=loss_weight_design,
                    use_dora=adapter == "dora")
    model.load_state_dict({k: v for k, v in state.items()
                           if not (full and "lora_" in k)})
    if adapter == "dora":
        model.init_pissa_dora()
    return model


def train_args(out_dir, **kw) -> TrainingArguments:
    base = dict(output_dir=out_dir, per_device_train_batch_size=4,
                gradient_accumulation_steps=2, learning_rate=1e-3,
                lr_scheduler_type="constant", logging_steps=1, save_steps=2,
                num_train_epochs=2.0, seed=0, max_grad_norm=1.0)
    base.update(kw)
    return TrainingArguments(**base)


def train(rank, world, payload):
    """Each run of payload["runs"] ({"name", "mesh", "zero", "weight",
    "dcp", "resume", "stream", "adapter", "finetuning": FinetuningArguments
    fields}): 4 micro steps (2 updates) of the Trainer
    on the mesh over a pickled batch stream (payload["streams"]; "main"
    by default), from the pickled state, saving
    checkpoint-2 and -4 under out/<name>; rank 0 writes the trained
    bundle (whole tensors) to out/<name>.pt."""
    streams = {}
    for name, path in payload["streams"].items():
        with open(path, "rb") as f:
            streams[name] = pickle.load(f)
    state_dict = torch.load(payload["state"])
    done = []
    if payload.get("placements"):
        done.append(placements(payload["placements"]))
    for run in payload["runs"]:
        out = os.path.join(payload["out"], run["name"])
        if run.get("dcp"):
            os.environ["LLAMOLE_ORBAX"] = "1"
        else:
            os.environ.pop("LLAMOLE_ORBAX", None)
        model = tiny_model(state_dict, run["weight"],
                           run.get("adapter", "lora"))
        groups = MeshGroups(mesh_from_string(run["mesh"], "cpu"))
        shard_graph_lm(model, groups, zero3=run["zero"] >= 3)
        trainer = Trainer(lambda b, g: model.loss(b, g, train=True),
                          model.trainable_parameters(),
                          train_args(out, zero_stage=run["zero"],
                                     mesh=run["mesh"]), 2,
                          finetuning_args=FinetuningArguments(
                              **run.get("finetuning", {})),
                          mesh=groups)
        state = trainer.init_state(0)
        if run.get("resume"):
            state = trainer.load_checkpoint(state, os.path.join(
                payload["out"], run["resume"]))
        stream = streams[run.get("stream", "main")]
        trainer.train(state, iter(stream[state.step:]), 4,
                      save_fn=trainer.save_checkpoint)
        bundle = {n: full(p).detach().clone()
                  for n, p in trainer.params.items()}
        opt = trainer.optimizer
        with opt.whole_state():
            moments = {n: t.clone() for n, t in opt.mu.items()}
        if rank == 0:
            torch.save(bundle, out + ".pt")
            # GaLore's bases (every rank holds them whole) and the first
            # moments joined from the ranks' parts
            torch.save({"proj": dict(getattr(opt, "proj", {})),
                        "mu": moments}, out + ".opt.pt")
        done.append(run["name"])
    os.environ.pop("LLAMOLE_ORBAX", None)
    return done


def placements(spec):
    """shard_params and replicate on the mesh: each rank's local shapes of
    the tiny LLM's q weight (JAX spec (None, tp): its output rows over
    tp) and of a replicated norm."""
    from llamole_tpu_torch.parallel import replicate, shard_params
    mesh = mesh_from_string(spec, "cpu")
    named = dict(LLM(LLMConfig.tiny(), dtype=torch.float32,
                     device="cpu").named_parameters())
    q = "layers.0.attn.q.weight"
    sharded = shard_params({q: named[q]}, mesh, {q: (None, "tp")})[q]
    norm = replicate({"n": named["final_norm.weight"]}, mesh)["n"]
    return {"q": [list(sharded.shape), list(sharded.to_local().shape)],
            "norm": [list(norm.shape), list(norm.to_local().shape)]}
