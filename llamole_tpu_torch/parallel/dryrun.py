"""The multi-process CPU rehearsal of mesh training and inference
(counterpart of __graft_entry__.py's legs, beside it):
`dryrun_multichip(n)` starts n gloo ranks on the CPU and runs, through
run_mmsft on the tiny smoke config (config/smoke/tiny_train.yaml), the
dp x tp step, ZeRO-1, ZeRO-3, the dcn x dp step, the pipeline (pp:2
over the rest as dp, 2 microbatches), the sp x dp step (the ranks along
sp repeat it), the dp x tp step with shift_attn (S²-attn, its heads
split over tp; held to the same run without a mesh) and the MoE step
on ep:2 over the rest as dp (the tiny config with 4 experts, top-2, at
a capacity factor that drops units; held to the same MoE run without a
mesh), the quantized step (int8 QLoRA on dp x tp at ZeRO-3, each rank
keeping its dp chunks of the int8 base; then the int8 base with the int8
KV cache placed on tp decoding a design greedily), the q / k norm step
(a qwen3-shaped tiny LLM, freeze-tuned with its per-head q / k norms
trainable, on dp x tp) and the tied ZeRO-3 step (a gemma-shaped tiny LLM
with tied embeddings on dp x tp at ZeRO-3), each held to its run without
a mesh; the ring-sp leg (a training
step of ring attention on sp:2 over the rest as dp, its loss and
gradients held to the whole sequence's on one rank); then on the tiny
config's GraphLM the dp inference leg (design_molecule on dp:n, a batch
of n + 1 rows), the tp design leg (dp:2 x tp:n/2, 3 rows), the MoE
design leg (the MoE GraphLM on dp:2 x ep:n/2, 4 rows) and the dp retro
leg (batched_one_step_reaction on dp:n, 5 products); each held to the
same run without a mesh (every rank builds the same model from the seed),
each printing its "dryrun ... OK" line, then "dryrun_multichip OK".

`launch(target, n, ...)` is the harness: n processes of
`python -m llamole_tpu_torch.parallel.dryrun --worker module:function`,
joined through a FileStore, each calling function(rank, world, payload)
and writing its JSON result; it waits at most `timeout` seconds, then
kills every rank and raises, so a hang fails instead of stalling. A rank
that imported JAX fails (the port imports none of it).

    python -m llamole_tpu_torch.parallel.dryrun [N]      (N = 4)
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = os.path.join(ROOT, "config", "smoke", "tiny_train.yaml")


def launch(target: str, n: int, payload: Any = None, timeout: float = 120.0,
           workdir: Optional[str] = None, path: Sequence[str] = (),
           rank_env: Optional[Dict[int, Dict[str, str]]] = None
           ) -> List[Any]:
    """Run target ("module:function") in n gloo CPU ranks; returns each
    rank's result. path: directories the ranks import from besides the
    checkout; rank_env: environment variables of single ranks (say, a
    PYTHONHASHSEED of their own). Raises on a rank's failure (with its
    stderr) or past timeout seconds (every rank killed)."""
    work = workdir or tempfile.mkdtemp(prefix="llamole-dryrun-")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "payload.json"), "w") as f:
        json.dump(payload, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, *path, *filter(None, [env.get("PYTHONPATH")])])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs, logs = [], []
    for rank in range(n):
        log = open(os.path.join(work, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "llamole_tpu_torch.parallel.dryrun",
             "--worker", target, str(rank), str(n), work],
            stdout=log, stderr=subprocess.STDOUT,
            env={**env, **(rank_env or {}).get(rank, {})}, cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {n} ranks passed {timeout} "
                                   f"s:\n{_tails(logs)}")
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(1.0)       # let the others print their errors
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() != 0]
        if bad:
            raise RuntimeError(f"{target}: ranks {bad} failed:\n"
                               f"{_tails(logs)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    out = []
    for rank in range(n):
        with open(os.path.join(work, f"result{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _tails(logs, lines: int = 30) -> str:
    out = []
    for rank, log in enumerate(logs):
        log.flush()
        log.seek(0)
        text = log.read().splitlines()[-lines:]
        out.append(f"--- rank {rank} ---\n" + "\n".join(text))
    return "\n".join(out)


def _worker(target: str, rank: int, world: int, work: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    module, _, fn = target.partition(":")
    with open(os.path.join(work, "payload.json")) as f:
        payload = json.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    try:
        result = getattr(importlib.import_module(module), fn)(
            rank, world, payload)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} imported jax")
    with open(os.path.join(work, f"result{rank}.json"), "w") as f:
        json.dump(result, f)


# -- the legs ------------------------------------------------------------------

# the MoE legs' model: the tiny LLM with 4 experts, top-2 (JAX's moe-ep
# leg's), at a capacity factor under 1 so that units drop
MOE = {"num_experts": 4, "num_experts_per_tok": 2}
MOE_CAPACITY = 0.75
# the item-9d legs: the int8 base with the int8 KV cache (QLoRA), and the
# tiny LLM's config reshaped as qwen3's (per-head q / k norms) and as
# gemma-2's (tied embeddings, unit-offset and sandwich norms, GeGLU,
# scaled embeddings, soft caps)
QUANT = {"quantization_bit": 8, "kv_cache_dtype": "int8"}
QWEN3 = {"qk_norm": True}
GEMMA = {"tie_word_embeddings": True, "rms_norm_unit_offset": True,
         "sandwich_norms": True, "hidden_act": "gelu_tanh",
         "scale_embeddings": True, "attn_logit_softcap": 50.0,
         "final_logit_softcap": 30.0}


def _tiny_args(mesh: str, zero: int, model=None, **training):
    from dataclasses import replace

    from ..config import get_train_args
    args = list(get_train_args(TINY))
    # 4 examples in one batch an epoch: every mesh of 2 or 4 data ranks
    # divides it, so no padding row changes the design branch's draws
    # f32, so a mesh's other summation order stays within 1e-5; a
    # constant learning rate, so the first update moves the adapter
    args[0] = replace(args[0], compute_dtype="float32", **(model or {}))
    args[1] = replace(args[1], max_samples=4)
    args[2] = replace(args[2], output_dir=None, mesh=mesh, zero_stage=zero,
                      per_device_train_batch_size=4,
                      gradient_accumulation_steps=2, max_steps=4,
                      num_train_epochs=4.0, logging_steps=1,
                      lr_scheduler_type="constant", pipeline_microbatches=2,
                      **training)
    return args


def _qk_norms(name: str) -> bool:
    return ".q_norm." in name or ".k_norm." in name


def _losses(mesh: str, zero: int, model=None, llm=None, freeze=False):
    """(each micro step's loss, the Trainer, the GraphLM placed on the
    mesh or None) of run_mmsft on the tiny config with the model
    arguments `model` (MOE's experts run at MOE_CAPACITY), its LLM config
    changed by `llm` (QWEN3, GEMMA), and with freeze: freeze-tuned with
    the q / k norms trainable beside the connectors."""
    from ..train import trainer as trainer_mod
    from ..train.workflow import run_mmsft
    from . import sharding
    seen: List[float] = []
    trainers, models = [], [None]
    step, place = trainer_mod.Trainer._micro_step, sharding.shard_graph_lm

    def record(self, state, batch):
        out = step(self, state, batch)
        seen.append(out["loss"])
        trainers[:] = [self]
        return out

    def placed(model, groups, zero3):
        models[:] = [model]
        return place(model, groups, zero3)
    trainer_mod.Trainer._micro_step = record
    sharding.shard_graph_lm = placed
    args = _tiny_args(mesh, zero, model)
    build = None
    if freeze:
        from dataclasses import replace
        args[3] = replace(args[3], finetuning_type="freeze")
    if (model and model.get("num_experts")) or llm or freeze:
        model, tok = _build(args, llm=llm)
        if model.llm.cfg.num_experts:
            model.llm.cfg.moe_capacity_factor = MOE_CAPACITY
        if freeze:
            for n, p in model.llm.named_parameters():
                p.requires_grad_(_qk_norms(n))
        models[:] = [model]
        build = (model, tok)
    try:
        run_mmsft(*args, device="cpu", prebuilt=build)
    finally:
        trainer_mod.Trainer._micro_step = step
        sharding.shard_graph_lm = place
    return seen, trainers[0], models[0]


def _build(args, llm=None, **kw):
    """build_graph_lm on the CPU from the tiny arguments, the LLM config
    it resolves changed by `llm`."""
    import dataclasses

    from ..models import loader
    resolve = loader.resolve_llm_config
    if llm:
        loader.resolve_llm_config = lambda a: dataclasses.replace(
            resolve(a), **llm)
    try:
        return loader.build_graph_lm(args[0], args[1], args[3], device="cpu",
                                     seed=args[2].seed, **kw)
    finally:
        loader.resolve_llm_config = resolve


def _check(name: str, got: List[float], want: List[float]) -> None:
    import numpy as np
    if not (len(got) == len(want) == 4 and np.all(np.isfinite(got))):
        raise RuntimeError(f"{name}: losses {got}, mesh-less {want}")
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               err_msg=f"{name}: {got} vs mesh-less {want}")


def _check_placement(name: str, trainer, model, zero: int) -> None:
    """ZeRO-1: the largest parameter's moments are a 1/dp chunk; ZeRO-3:
    the LLM's largest frozen leaf is stored in 1/(dp tp) per rank."""
    from .sharding import local
    gr = trainer.groups
    if zero >= 1:
        opt = trainer.optimizer
        n = max(opt.params, key=lambda k: opt.params[k].numel())
        if opt.mu[n].numel() * gr.dp != local(opt.params[n]).numel():
            raise RuntimeError(f"{name}: moments of {n} not dp-sharded")
    if zero >= 3:
        big = max((p for p in model.llm.parameters()
                   if not p.requires_grad), key=lambda p: p.numel())
        if local(big).numel() * gr.dp * gr.tp != big.numel():
            raise RuntimeError(f"{name}: frozen LLM not dp-sharded")


def _legs(rank: int, world: int, payload) -> Dict[str, Any]:
    """Every leg on this rank: {leg: its losses}, and under "inference"
    the inference legs' OK lines."""
    dp, tp = (world // 2, 2) if world % 2 == 0 and world > 2 else (world, 1)
    plain = _losses("", 0)[0]
    legs = {f"dp={dp} tp={tp}": (f"dp:{dp},tp:{tp}", 0),
            f"zero1 dp={world}": (f"dp:{world}", 1),
            f"zero3 dp={world}": (f"dp:{world}", 3)}
    if world % 2 == 0:
        legs[f"dcn=2 dp={world // 2}"] = (f"dcn:2,dp:{world // 2}", 0)
        legs["pipeline"] = (f"pp:2,dp:{world // 2}", 0)
        legs[f"sp=2 dp={world // 2}"] = (f"dp:{world // 2},sp:2", 0)
    out = {"plain": plain}
    for name, (mesh, zero) in legs.items():
        got, trainer, model = _losses(mesh, zero)
        _check(name, got, plain)
        _check_placement(name, trainer, model, zero)
        out[name] = got
    if world % 2 == 0:     # S²-attn with its heads split over tp
        from ..models.gllm.model import s2_attention
        s2 = {"shift_attn": True}
        out["plain s2"] = _losses("", 0, s2)[0]
        calls = s2_attention.calls
        out["s2 tp"] = _losses(f"dp:{world // 2},tp:2", 0, s2)[0]
        _check("s2 tp", out["s2 tp"], out["plain s2"])
        if s2_attention.calls == calls:
            raise RuntimeError("s2 tp: S²-attn did not run")
        out["plain moe"], _, model = _losses("", 0, MOE)
        got, _, model = _losses(f"ep:2,dp:{world // 2}", 0, MOE)
        _check("moe-ep", got, out["plain moe"])
        experts = model.llm.layers[0].mlp.experts.gate
        if experts.to_local().shape[0] * 2 != experts.shape[0]:
            raise RuntimeError("moe-ep: the experts are not split over ep")
        out["moe-ep"] = got
        out.update(_placement_legs(world))
        out["ring-sp"] = _ring_leg(world)
    out["inference"] = _inference_legs(world)
    return out


def _placement_legs(world: int) -> Dict[str, Any]:
    """The quantized, q / k norm and tied ZeRO-3 steps on dp x tp (tp 2),
    each against its own run without a mesh; the quantized leg's decode
    (a greedy design on the int8 base with the int8 KV cache, the LLM on
    tp) against the mesh-less one's."""
    from .sharding import local
    dp = world // 2
    mesh = f"dp:{dp},tp:2"
    out = {}
    out["plain quant"] = _losses("", 0, QUANT)[0]
    got, trainer, model = _losses(mesh, 3, QUANT)
    _check("quant", got, out["plain quant"])
    q = model.llm.layers[0].attn["q"]
    if q.quant != "int8" or q.zero is None or \
            local(q.w_q).numel() * 2 * dp != q.w_q.numel():
        raise RuntimeError("quant: the int8 base is not split over dp x tp")
    out["quant"] = got
    want = _design(_tiny_model(model=QUANT)[0], dp + 1)
    placed, groups = _tiny_model(mesh, model=QUANT)
    got = _design(placed, dp + 1, groups)
    _same("quant decode", got, want)
    out["quant decode"] = f"{_assembled(got)}/{dp + 1}"
    out["plain qk"] = _losses("", 0, llm=QWEN3, freeze=True)[0]
    got, trainer, model = _losses(mesh, 0, llm=QWEN3, freeze=True)
    _check("qk-norm", got, out["plain qk"])
    if sum(_qk_norms(n) for n in trainer.params) != 4:
        raise RuntimeError(f"qk-norm: trains {sorted(trainer.params)}")
    out["qk-norm"] = got
    out["plain tied"] = _losses("", 0, llm=GEMMA)[0]
    got, trainer, model = _losses(mesh, 3, llm=GEMMA)
    _check("zero3 tied", got, out["plain tied"])
    _check_placement("zero3 tied", trainer, model, 3)
    if model.llm.tied_zero is None:
        raise RuntimeError("zero3 tied: the head does not gather the "
                           "embedding's dp chunks")
    out["zero3 tied"] = got
    return out


def _ring_qkv(b: int, s: int):
    """The ring-sp leg's q, k, v, target (JAX's leg's shapes, from seed
    0) and key mask (the last 4 keys of row 0 padded)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    arrs = [torch.tensor(rng.normal(size=(b, s, 2, 8)), dtype=torch.float32)
            for _ in range(4)]
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[0, -4:] = 0
    return arrs, mask


def _ring_step(q, k, v, target, mask, count, group=None):
    """The leg's loss (its squared error over `count` elements of the
    whole batch) and the gradients of q, k and v."""
    import torch

    from ..ops.ring_attention import ring_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*leaves, mask, group)
    loss = ((out - target) ** 2).sum() / count
    loss.backward()
    return loss.detach(), [t.grad for t in leaves]


def _ring_leg(world: int) -> Dict[str, Any]:
    """JAX's ring-sp leg: a training step of ring attention on dp x sp
    (sp = 2; rows over dp, the sequence over sp) against the whole batch
    on one rank. Returns the loss, the mesh-less loss and the largest
    gradient gap."""
    import torch

    from .comm import all_gather_dim, all_reduce_
    from .mesh import MeshGroups, mesh_from_string
    sp, dp = 2, world // 2
    groups = MeshGroups(mesh_from_string(f"dp:{dp},sp:{sp}", "cpu"))
    b, s = 2 * dp, 32
    (q, k, v, target), mask = _ring_qkv(b, s)
    count = target.numel()
    want, want_grads = _ring_step(q, k, v, target, mask, count)
    rows = slice(groups.dp_rank * 2, groups.dp_rank * 2 + 2)
    cols = slice(groups.sp_rank * (s // sp), (groups.sp_rank + 1) * (s // sp))
    loss, grads = _ring_step(*(t[rows, cols] for t in (q, k, v, target)),
                             mask[rows, cols], count, groups.sp_group)
    loss = all_reduce_(all_reduce_(loss.clone(), groups.sp_group),
                       groups.dp_group)
    gap = 0.0
    for g, w in zip(grads, want_grads):
        whole = all_gather_dim(all_gather_dim(g, 1, sp, groups.sp_group), 0,
                               dp, groups.dp_group)
        gap = max(gap, float((whole - w).abs().max()))
    if not torch.isfinite(loss) or abs(float(loss) - float(want)) > 1e-5 \
            or gap > 1e-5:
        raise RuntimeError(f"ring-sp: loss {float(loss)} (mesh-less "
                           f"{float(want)}), gradient gap {gap}")
    return {"sp": sp, "dp": dp, "loss": float(loss),
            "plain": float(want), "grad_gap": gap}


def _tiny_model(mesh: str = "", moe: bool = False, model=None):
    """The tiny config's GraphLM (f32, from its seed; moe: with MOE's
    experts at MOE_CAPACITY; model: model arguments, QUANT) and, with
    mesh, its MeshGroups with the LLM placed on the tp axis (and the
    experts on ep)."""
    from .mesh import MeshGroups, mesh_from_string
    from .sharding import shard_llm
    args = _tiny_args("", 0, MOE if moe else model)
    model, _ = _build(args, generate_mode=True)
    if moe:
        model.llm.cfg.moe_capacity_factor = MOE_CAPACITY
    if not mesh:
        return model, None
    groups = MeshGroups(mesh_from_string(mesh, "cpu"))
    shard_llm(model.llm, groups)
    return model, groups


def _design(model, rows: int, groups=None):
    """design_molecule of `rows` copies of one prompt (greedy, drafts off
    so the query extension runs on the decode cache)."""
    import numpy as np
    import torch

    from ..models.composite import GenerationSettings
    enc = model.tokenizer.encode("Design a soluble aromatic molecule.")
    ids = np.tile(np.asarray(enc, np.int64)[None, :], (rows, 1))
    props = np.full((rows, 10), np.nan, np.float32)
    props[:, 1] = 1.0
    gen = GenerationSettings(max_new_tokens=8, do_sample=False,
                             speculative_tokens=0)
    analysis, smiles = model.design_molecule(
        ids, np.ones_like(ids), props, gen=gen,
        generator=torch.Generator().manual_seed(3), mesh=groups)
    return analysis.tolist(), smiles


PRODUCTS = ["CC(=O)Oc1ccccc1C(=O)O", "CCOC(=O)c1ccccc1", "CC(N)C(=O)OCC",
            "c1ccc(COC(C)=O)cc1", "CCO"]


def _retro(model, groups=None):
    import torch

    from ..models.composite import GenerationSettings
    gen = GenerationSettings(max_new_tokens=8, do_sample=False,
                             speculative_tokens=0)
    out = model.batched_one_step_reaction(
        PRODUCTS, topk=10, gen=gen, analysis_tokens=16,
        generator=torch.Generator().manual_seed(6), mesh=groups)
    return [(r["reactants"], [round(float(x), 6) for x in r["scores"]],
             r["templates"]) for r in out]


def _inference_legs(world: int) -> List[str]:
    """The dp inference, tp design and dp retro legs of __graft_entry__.py
    (:546, :587, :636), each equal to the mesh-less run: JAX's OK lines."""
    lines = []
    b = world + 1       # not a dp multiple: the rows pad
    padded = -(-b // world) * world
    want = _design(_tiny_model()[0], b)
    model, groups = _tiny_model(f"dp:{world}")
    got = _design(model, b, groups)
    _same("dp inference", got, want)
    lines.append(f"dryrun dp-inference OK: mesh dp={world}, batch {b} "
                 f"(padded to {padded}), {_assembled(got)}/{b} assembled "
                 "== mesh-less")
    if world >= 4 and world % 2 == 0:
        dp, tp = 2, world // 2
        want = _design(_tiny_model()[0], dp + 1)
        model, groups = _tiny_model(f"dp:{dp},tp:{tp}")
        got = _design(model, dp + 1, groups)
        _same("tp design", got, want)
        lines.append(f"dryrun tp-design OK: mesh dp={dp} tp={tp}, batch "
                     f"{dp + 1}, {_assembled(got)}/{dp + 1} assembled == "
                     "mesh-less")
        # an MoE GraphLM: every forward routes over both dp blocks
        ep = world // 2
        want = _design(_tiny_model(moe=True)[0], 2 * dp)
        model, groups = _tiny_model(f"dp:{dp},ep:{ep}", moe=True)
        got = _design(model, 2 * dp, groups)
        _same("moe design", got, want)
        lines.append(f"dryrun moe-design OK: mesh dp={dp} ep={ep}, batch "
                     f"{2 * dp}, {_assembled(got)}/{2 * dp} assembled == "
                     "mesh-less")
    want = _retro(_tiny_model()[0])
    model, groups = _tiny_model(f"dp:{world}")
    got = _retro(model, groups)
    _same("dp retro", got, want)
    lines.append(f"dryrun dp-retro OK: mesh dp={world}, frontier "
                 f"{len(PRODUCTS)} (padded to {-(-len(PRODUCTS) // world) * world}), "
                 f"{sum(len(r[0]) for r in got)} proposals == mesh-less")
    return lines


def _assembled(design) -> int:
    return sum(s is not None for s in design[1])


def _same(name: str, got, want) -> None:
    if got != want:
        raise RuntimeError(f"{name}: the mesh's {got} differs from the "
                           f"mesh-less run's {want}")


def dryrun_multichip(n: int = 4, timeout: float = 120.0,
                     workdir: Optional[str] = None) -> Dict[str, Any]:
    """The legs on n gloo CPU ranks (their store and logs in workdir, a
    temporary directory by default); prints each and "dryrun_multichip
    OK"; raises if a leg fails or the ranks pass the timeout."""
    with tempfile.TemporaryDirectory(prefix="llamole-dryrun-") as tmp:
        results = launch("llamole_tpu_torch.parallel.dryrun:_legs", n,
                         timeout=timeout, workdir=workdir or tmp)
    legs = results[0]
    for name, losses in legs.items():
        if name == "pipeline":     # JAX's line
            print(f"dryrun pipeline OK: mesh pp=2 dp={n // 2}, "
                  f"loss={losses[-1]:.4f} == mesh-less "
                  f"{legs['plain'][-1]:.4f} ({len(losses)} micro steps, 2 "
                  "microbatches)")
        elif name == "moe-ep":     # JAX's line
            print(f"dryrun moe-ep OK: mesh ep=2 dp={n // 2}, "
                  f"loss={losses[-1]:.4f} == mesh-less "
                  f"{legs['plain moe'][-1]:.4f} ({len(losses)} micro steps, "
                  f"capacity factor {MOE_CAPACITY})")
        elif name == "s2 tp":
            print(f"dryrun s2-tp OK: mesh dp={n // 2} tp=2, shift_attn, "
                  f"{len(losses)} micro steps, loss {losses[-1]:.4f} == "
                  f"mesh-less {legs['plain s2'][-1]:.4f}")
        elif name == "ring-sp":    # JAX's line
            print(f"dryrun ring-sp OK: mesh sp={losses['sp']} "
                  f"dp={losses['dp']}, loss={losses['loss']:.4f} == "
                  f"mesh-less {losses['plain']:.4f} (gradients within "
                  f"{losses['grad_gap']:.1e})")
        elif name == "quant":
            print(f"dryrun quant dp={n // 2} tp=2 OK: int8 QLoRA at zero "
                  f"stage 3, {len(losses)} micro steps, loss "
                  f"{losses[-1]:.4f} == mesh-less "
                  f"{legs['plain quant'][-1]:.4f}; int8-KV greedy design "
                  f"{legs['quant decode']} assembled == mesh-less")
        elif name == "qk-norm":
            print(f"dryrun qk-norm tp=2 OK: mesh dp={n // 2} tp=2, "
                  f"qwen3-shaped, freeze-tuned with the q / k norms, "
                  f"{len(losses)} micro steps, loss {losses[-1]:.4f} == "
                  f"mesh-less {legs['plain qk'][-1]:.4f}")
        elif name == "zero3 tied":
            print(f"dryrun zero3 tied dp={n // 2} tp=2 OK: gemma-shaped, "
                  f"tied embeddings, {len(losses)} micro steps, loss "
                  f"{losses[-1]:.4f} == mesh-less "
                  f"{legs['plain tied'][-1]:.4f}")
        elif name not in ("plain", "plain moe", "plain s2", "inference",
                          "plain quant", "quant decode", "plain qk",
                          "plain tied"):
            print(f"dryrun {name} OK: {len(losses)} micro steps, loss "
                  f"{losses[-1]:.4f} == mesh-less {legs['plain'][-1]:.4f}")
    for line in legs["inference"]:
        print(line)
    print(f"dryrun_multichip OK: {n} gloo ranks")
    return legs


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
