"""The ranks' side of tests/test_torch_ring_attention.py,
tests/test_torch_moe_ep.py, tests/test_torch_s2_attention.py and the
mesh cases of tests/test_torch_optimizers.py: gloo processes started by
llamole_tpu_torch.parallel.dryrun.launch, which import the port and never
JAX. Inputs come in torch files the tests write; each rank writes what
the test reads to out/rank<r>.pt."""

import os

import torch

from llamole_tpu_torch.parallel import mesh_from_string
from llamole_tpu_torch.parallel.comm import all_gather_dim, all_reduce_
from llamole_tpu_torch.parallel.mesh import MeshGroups
from llamole_tpu_torch.parallel.sharding import full


def _groups(spec):
    return MeshGroups(mesh_from_string(spec, "cpu"))


def _load(path):
    """A data file of the tests (it holds an LLMConfig besides tensors)."""
    return torch.load(path, weights_only=False)


def _save(payload, rank, value):
    torch.save(value, os.path.join(payload["out"], f"rank{rank}.pt"))
    return rank


def ring(rank, world, payload):
    """ring_attention on the mesh over the whole q / k / v / mask and the
    output's cotangent of payload["data"]: this rank's rows (over dp) and
    sequence shard (over sp); writes its output block and its q / k / v
    gradients with its (dp, sp) coordinate."""
    from llamole_tpu_torch.ops.ring_attention import ring_attention
    gr = _groups(payload["mesh"])
    data = _load(payload["data"])
    b, s = data["mask"].shape
    rows = slice(gr.dp_rank * b // gr.dp, (gr.dp_rank + 1) * b // gr.dp)
    cols = slice(gr.sp_rank * s // gr.sp, (gr.sp_rank + 1) * s // gr.sp)
    q, k, v = (data[n][rows, cols].clone().requires_grad_(True)
               for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, data["mask"][rows, cols], gr.sp_group)
    out.backward(data["cot"][rows, cols])
    return _save(payload, rank, {"rows": (rows.start, rows.stop),
                                 "cols": (cols.start, cols.stop),
                                 "out": out.detach(),
                                 "grads": [t.grad for t in (q, k, v)]})


def _moe_llm(data, zero3: bool):
    """The tiny MoE LLM of payload["data"] (its config and state dict);
    under ZeRO-3 with the attention adapter (B = 0, so the forward is
    the base's) as the only trainable leaves."""
    from llamole_tpu_torch.models.gllm import LLM
    llm = LLM(data["cfg"], dtype=torch.float32)
    if zero3:
        llm.add_lora(4, 2.0)
        llm.load_state_dict({**data["state"], **data["lora"]})
        for n, p in llm.named_parameters():
            p.requires_grad_("lora_" in n)
    else:
        llm.load_state_dict(data["state"])
    return llm


def moe_loss(llm, ids, mask, labels, count=None):
    """lm_loss + coef x aux and the aux term (the LLM's, a share on a
    mesh), with every MoE layer's drop counter on."""
    from llamole_tpu_torch.models.gllm.model import lm_loss
    for layer in llm.layers:
        layer.mlp.drop_count = torch.zeros((), dtype=torch.long)
    logits, _, _, aux = llm(input_ids=ids, attention_mask=mask,
                            return_moe_aux=True, train=True)
    loss = lm_loss(logits, labels, -100, count) \
        + llm.cfg.moe_aux_loss_coef * aux
    return loss, aux


def moe(rank, world, payload):
    """The MoE LLM's loss and gradients on the mesh (zero3: ZeRO-3's
    FSDP2 over dp as well), this rank's block of the batch's rows over
    (dcn, dp): writes the loss and aux summed over the data ranks, the
    units dropped, every leaf's gradient whole (summed over the data
    ranks, the expert shards joined over ep) and this rank's expert
    storage."""
    from llamole_tpu_torch.parallel.sharding import fsdp_llm, local, shard_llm
    gr = _groups(payload["mesh"])
    data = _load(payload["data"])
    llm = _moe_llm(data, payload["zero3"])
    shard_llm(llm, gr)
    if payload["zero3"]:
        fsdp_llm(llm, gr)
    ids, mask, labels = (data[n] for n in ("ids", "mask", "labels"))
    per = ids.shape[0] // gr.data
    rows = slice(gr.data_rank * per, (gr.data_rank + 1) * per)

    def count(n):
        return all_reduce_(n.detach().clone(), gr.data_group)
    loss, aux = moe_loss(llm, ids[rows].long(), mask[rows], labels[rows],
                         count)
    loss.backward()
    dropped = int(sum(layer.mlp.drop_count for layer in llm.layers))
    loss, aux = (all_reduce_(t.detach().clone(), gr.data_group)
                 for t in (loss, aux))
    grads = {}
    for n, p in llm.named_parameters():
        if p.grad is None:
            continue
        g = local(p.grad).clone()
        all_reduce_(g, gr.data_group)
        if ".experts." in n and gr.ep > 1:
            g = all_gather_dim(g, 0, gr.ep, gr.ep_group)
        elif hasattr(p.grad, "placements"):
            from torch.distributed.tensor import DTensor
            g = full(DTensor.from_local(g, p.grad.device_mesh,
                                        p.grad.placements, run_check=False,
                                        shape=p.shape, stride=p.stride()))
        grads[n] = g
    gate = llm.layers[0].mlp.experts.gate
    return _save(payload, rank, {
        "loss": float(loss), "aux": float(aux), "dropped": dropped,
        "grads": grads, "expert_shape": tuple(local(gate).shape),
        "placed": type(gate).__name__})


def moe_train(rank, world, payload):
    """run_mmsft on the tiny config with 4 experts (top-2) at the
    payload's capacity factor, on payload["mesh"] ("": none) at
    payload["zero"], into out/<name>: writes the units the MoE layers
    dropped over the run, the experts this rank holds and the Trainer's
    trainable names."""
    from dataclasses import replace

    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.parallel import dryrun
    from llamole_tpu_torch.parallel.sharding import local
    from llamole_tpu_torch.train import trainer as trainer_mod
    from llamole_tpu_torch.train.workflow import run_mmsft
    args = dryrun._tiny_args(payload["mesh"], payload["zero"], dryrun.MOE)
    args[2] = replace(args[2], output_dir=os.path.join(payload["out"],
                                                       payload["name"]))
    model, tok = build_graph_lm(args[0], args[1], args[3], device="cpu",
                                seed=args[2].seed)
    model.llm.cfg.moe_capacity_factor = payload["factor"]
    for layer in model.llm.layers:
        layer.mlp.drop_count = torch.zeros((), dtype=torch.long)
    seen = []
    step = trainer_mod.Trainer._micro_step

    def record(self, state, batch):
        seen.append(self)
        return step(self, state, batch)
    trainer_mod.Trainer._micro_step = record
    try:
        run_mmsft(*args, device="cpu", prebuilt=(model, tok))
    finally:
        trainer_mod.Trainer._micro_step = step
    gate = model.llm.layers[0].mlp.experts.gate
    return _save(payload, rank, {
        "dropped": int(sum(layer.mlp.drop_count
                           for layer in model.llm.layers)),
        "expert_shape": tuple(local(gate).shape),
        "trainable": sorted(seen[0].params)})


def s2(rank, world, payload):
    """The tiny GQA LLM with shift_attn and its adapter (payload["data"]:
    config, state dict, batch), placed on payload["mesh"]: the training
    forward's LM loss and the adapter's gradients, whole."""
    from llamole_tpu_torch.models.gllm import LLM
    from llamole_tpu_torch.models.gllm.model import lm_loss, s2_attention
    from llamole_tpu_torch.parallel.sharding import shard_llm
    gr = _groups(payload["mesh"])
    data = _load(payload["data"])
    llm = LLM(data["cfg"], dtype=torch.float32)
    llm.add_lora(4, 2.0)
    llm.load_state_dict(data["state"])
    for n, p in llm.named_parameters():
        p.requires_grad_("lora_" in n)
    shard_llm(llm, gr)
    calls = s2_attention.calls
    logits, _, _ = llm(input_ids=data["ids"].long(),
                       attention_mask=data["mask"], train=True)
    loss = lm_loss(logits, data["labels"])
    loss.backward()
    grads = {n: full(p.grad) for n, p in llm.named_parameters()
             if p.grad is not None}
    return _save(payload, rank, {"loss": float(loss), "grads": grads,
                                 "s2_calls": s2_attention.calls - calls})


def galore_mesh(rank, world, payload):
    """The custom chain over payload["data"]'s parameters and gradient
    bundles on the mesh: with tp each 2-D leaf a DTensor sharded over tp
    on its dimension (i % 2) (i its place in the bundle), under ZeRO-1
    the moments chunked over dp, with pp each layer's leaves on its
    stage alone. A data rank's gradient is the bundle's / data and a pp
    rank's of a leaf outside the layers / pp, so the sums are the
    bundle's. Writes this rank's parameters (whole), and from rank 0
    the bases and the first moments joined whole (whole_state) and the
    state dict of the optimizer's chain."""
    from torch.distributed.tensor import DTensor, Shard

    from llamole_tpu_torch.config import FinetuningArguments
    from llamole_tpu_torch.config import TrainingArguments
    from llamole_tpu_torch.parallel.pipeline import layer_index
    from llamole_tpu_torch.train.optimizers import create_optimizer
    gr = _groups(payload["mesh"])
    data = _load(payload["data"])
    tp_mesh = gr.mesh["tp"]
    params, placement = {}, {}
    for i, (n, t) in enumerate(data["params"].items()):
        layer = layer_index(n)
        if gr.pp > 1 and layer is not None and layer % gr.pp != gr.pp_rank:
            continue
        if gr.tp > 1 and t.dim() == 2:
            d = i % 2
            placement[n] = d
            local = t.chunk(gr.tp, dim=d)[gr.tp_rank].clone()
            t = DTensor.from_local(local, tp_mesh, [Shard(d)],
                                   run_check=False, shape=t.shape,
                                   stride=t.stride())
        else:
            t = t.clone()
        params[n] = torch.nn.Parameter(t)
    opt, _ = create_optimizer(TrainingArguments(**payload["training"]), 10,
                              params,
                              FinetuningArguments(**payload["chain"]),
                              groups=gr, zero1=payload["zero1"])
    for bundle in data["grads"]:
        for n, p in params.items():
            g = bundle[n] / gr.data
            if gr.pp > 1 and layer_index(n) is None:
                g = g / gr.pp
            if n in placement:
                d = placement[n]
                g = DTensor.from_local(g.chunk(gr.tp, dim=d)[gr.tp_rank],
                                       tp_mesh, [Shard(d)], run_check=False,
                                       shape=p.shape, stride=p.stride())
            p.grad = g
        opt.accumulate()
    from llamole_tpu_torch.utils.serialization import to_state_dict
    with opt.whole_state():
        state = {"proj": {n: t.clone() for n, t in opt.proj.items()},
                 "mu": {n: t.clone() for n, t in opt.mu.items()},
                 "chain": to_state_dict(opt.chain_state())}
    return _save(payload, rank, {
        "params": {n: full(p).detach().clone() for n, p in params.items()},
        **(state if rank == 0 else {})})
