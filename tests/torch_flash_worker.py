"""The ranks' side of tests/test_torch_flash_attention.py's mesh case:
gloo processes started by llamole_tpu_torch.parallel.dryrun.launch, which
import the port and never JAX. Each runs the flash-route LLM of that test
(the gate forced as on a CUDA device, so the route's plain version runs)
through pipeline_lm_loss on its mesh: tp places this rank's heads, pp
this rank's stage."""

import torch

import llamole_tpu_torch.models.gllm.model as port_model
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.parallel import mesh_from_string
from llamole_tpu_torch.parallel.comm import all_reduce_
from llamole_tpu_torch.parallel.mesh import MeshGroups
from llamole_tpu_torch.parallel.pipeline import (layer_index,
                                                 pipeline_lm_loss, stage_of)
from llamole_tpu_torch.parallel.sharding import full, shard_llm


def forced_flash(calls):
    """Open the route's gate off the card and count the route's calls
    (and the heads each saw) in calls."""
    gate, flash = port_model.flash_ok, port_model.flash_attention

    def counted(q, k, v, mask):
        calls.append([q.shape[2], k.shape[2]])
        return flash(q, k, v, mask)
    port_model.flash_ok = lambda cfg, s, device: gate(cfg, s, "cuda")
    port_model.flash_attention = counted


def flash_llm(payload) -> LLM:
    llm = LLM(LLMConfig(**payload["config"]), dtype=torch.float32)
    llm.add_lora(4, 2.0)
    llm.load_state_dict(torch.load(payload["state"]))
    return llm


def flash_loss(rank, world, payload):
    """payload: {"config", "state", "mesh", "microbatches", "batch"}: the
    causal-LM loss of the batch on the mesh (the ranks' shares summed
    over the data and pp axes), this rank's stage's LoRA gradients
    (summed over the data axes, whole over tp) and the route's calls."""
    calls = []
    forced_flash(calls)
    llm = flash_llm(payload)
    for n, p in llm.named_parameters():
        p.requires_grad_("lora_" in n)
    groups = MeshGroups(mesh_from_string(payload["mesh"], "cpu"))
    if groups.tp > 1:
        shard_llm(llm, groups)
    batch = {k: torch.tensor(v) for k, v in payload["batch"].items()}
    share = pipeline_lm_loss(llm, groups, batch["input_ids"],
                             batch["attention_mask"], batch["labels"],
                             num_microbatches=payload["microbatches"])
    share.backward()
    loss = share.detach().clone()
    all_reduce_(loss, groups.data_group)
    if groups.pp > 1:
        all_reduce_(loss, groups.pp_group)
    grads = {}
    for n, p in llm.named_parameters():
        layer = layer_index(n)
        if "lora_" not in n or (layer is not None and stage_of(
                layer, llm.cfg.num_layers, groups.pp) != groups.pp_rank):
            continue
        g = full(p.grad)
        all_reduce_(g, groups.data_group)
        grads[n] = g.tolist()
    return {"loss": float(loss), "grads": grads, "calls": calls}
