"""The ranks' side of tests/test_torch_mesh_placements.py: gloo processes
started by llamole_tpu_torch.parallel.dryrun.launch, which import the
port and never JAX (a rank that imports it fails).

Each case of payload["cases"] (a torch.save'd {name: case}) builds the
tiny LLM from the case's state dict, places it on the launch's mesh
(shard_llm, then fsdp_llm under ZeRO-3) and runs it: "loss" one forward
and backward of the LM loss, each dp rank on its block of the rows (the
loss divided by dp and summed over dp, the gradients summed over dp,
as the Trainer reduces them); "decode" a greedy generate of the whole
batch on every rank; "w8a8_row" one row-parallel W8A8 projection whose
input's largest entry lies on the last tp rank. Rank 0 writes the
results (whole tensors) to payload["out"]."""

import dataclasses

import torch
import torch.distributed as dist

from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.gllm.lora import LoRALinear, quantized_product
from llamole_tpu_torch.models.gllm.model import lm_loss
from llamole_tpu_torch.models.gllm.quantize import quantized_bytes
from llamole_tpu_torch.parallel import mesh_from_string
from llamole_tpu_torch.parallel.comm import all_gather_dim, all_reduce_
from llamole_tpu_torch.parallel.mesh import MeshGroups
from llamole_tpu_torch.parallel.sharding import (TP, fsdp_llm, full, local,
                                                 shard_llm)


def build(case) -> LLM:
    """The case's LLM (f32, quantized as its state says, with a rank-r
    adapter when it has one) and only the case's leaves trainable."""
    cfg = dataclasses.replace(LLMConfig.tiny(), **case.get("cfg", {}))
    llm = LLM(cfg, dtype=torch.float32, quant=case.get("quant"))
    if case.get("lora_rank"):
        llm.add_lora(case["lora_rank"], case["lora_scale"])
    llm.load_state_dict(case["state"])
    train = case.get("train", "lora")
    for n, p in llm.named_parameters():
        p.requires_grad_(train == "full" or (train == "lora" and "lora_" in n)
                         or (train == "qk_norm" and ("q_norm" in n
                                                     or "k_norm" in n)))
    return llm


def place(llm, groups, zero3: bool):
    """Place the LLM; returns its local bytes before, after tp and after
    ZeRO-3."""
    before = quantized_bytes(llm)
    shard_llm(llm, groups)
    placed = quantized_bytes(llm)
    if zero3:
        fsdp_llm(llm, groups)
    return [before, placed, quantized_bytes(llm)]


def lm_case(case, groups):
    """The LM loss of the case's ids on the placed LLM: logits (all the
    rows), the loss and the trainable leaves' whole gradients."""
    llm = build(case)
    nbytes = place(llm, groups, case.get("zero3", False))
    ids = torch.as_tensor(case["ids"]).long()
    rows = ids.shape[0] // groups.dp
    mine = ids[groups.dp_rank * rows:(groups.dp_rank + 1) * rows]
    logits = llm(input_ids=mine)[0]
    loss = lm_loss(logits, mine) / groups.dp
    loss.backward()
    grads = {}
    for n, p in llm.named_parameters():
        if p.requires_grad:
            all_reduce_(local(p.grad), groups.dp_group)
            grads[n] = full(p.grad).detach().clone()
    return {"loss": float(all_reduce_(loss.detach().clone(),
                                      groups.dp_group)),
            "logits": all_gather_dim(logits.detach(), 0, groups.dp,
                                     groups.dp_group),
            "grads": grads, "bytes": nbytes,
            "zero": sorted(n for n, m in llm.named_modules()
                           if getattr(m, "zero", None) is not None),
            "tied_zero": llm.tied_zero is not None}


def decode_case(case, groups):
    """Greedy tokens of the placed LLM (every rank the whole batch)."""
    llm = build(case)
    place(llm, groups, False)
    ids = torch.as_tensor(case["ids"]).long()
    out, done = llm.generate(ids, torch.ones_like(ids),
                             max_new_tokens=case["new"], do_sample=False,
                             spec_tokens=0)
    return {"tokens": out, "done": done}


def w8a8_row_case(case, groups):
    """A row-parallel W8A8 projection on tp: its output and the input's
    gradient with the amax taken over tp, and the output each rank's own
    amax would give (the sums of the ranks' products)."""
    tp = groups.tp
    proj = LoRALinear(case["in"], case["out"], False)
    proj.set_quantized_("w8a8", case["w_q"], case["scale"])
    proj.tp = TP("row", groups.tp_group, tp, groups.tp_rank)
    cols = case["in"] // tp
    part = slice(groups.tp_rank * cols, (groups.tp_rank + 1) * cols)
    proj.w_q = case["w_q"][:, part].contiguous()
    x = case["x"][..., part].clone().requires_grad_(True)
    y = proj(x)
    (y * case["probe"]).sum().backward()
    with torch.no_grad():
        own = quantized_product(x, proj.w_q, proj.scale, "w8a8")
        all_reduce_(own, groups.tp_group)
    return {"y": y.detach(), "own_amax": own,
            "x_grad": all_gather_dim(x.grad, x.dim() - 1, tp,
                                     groups.tp_group)}


KINDS = {"loss": lm_case, "decode": decode_case, "w8a8_row": w8a8_row_case}


def run(rank, world, payload):
    """Every case of the payload on the mesh payload["mesh"]."""
    cases = torch.load(payload["cases"], weights_only=False)
    groups = MeshGroups(mesh_from_string(payload["mesh"], "cpu"))
    out = {}
    for name, case in cases.items():
        out[name] = KINDS[case["kind"]](case, groups)
        dist.barrier()
    if rank == 0:
        torch.save(out, payload["out"])
    return sorted(out)
