#!/usr/bin/env python3
"""Smoke run of llamole_tpu_torch (the PyTorch + CUDA port) on one card.

    python3 chip_smoke.py

1. Needs CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from llamole_tpu_torch/csrc (one nvcc per
   source, in parallel; build seconds and the ptxas report).
3. Kernel A check: the fused graph attention against its plain PyTorch
   version at the main-path shape (16, 50, 1024, 16) and at (5, 17, 128,
   4) and (8, 64, 256, 8), in f32 (tolerance 1e-4, the JAX kernel's
   contract) and bf16 (2e-2 absolute: the output is a convex combination
   of O(1) v rows and bf16 rounds at ~4e-3), on rows whose node is kept.
   Median CUDA-event times of kernel and plain version at the main path.
4. Kernel B check: the GIN aggregation against its plain version at the
   path shapes (8, 56, 300) and (1, 24, 300) in f32 and at (3, 11, 40)
   and (2, 17, 64) in f32 and bf16, on random graphs, plus an empty
   graph; f32 within 1e-4 (abs and rel, the JAX contract), bf16 within
   1e-2 x max|ref| (the output rounds once to bf16). Median CUDA-event
   times at (8, 56, 300) f32 on molecular graphs.
5. Design + retrosynthesis at full width through the serving entry
   point: Llama-3.1-8B shape (random bf16 weights drawn on the card from
   a seed, LoRA rank 8) + GraphDiT 1024 wide, 28 deep, 16 heads, 50
   nodes, 100 diffusion steps, CFG 2.0 + GraphCLIP 5 x 300 + the GIN
   template predictor 5 x 300 (text 768, 16 labels, the built-in
   templates and inventory), f32, behind DesignServer(batch_size=8) with
   the serving retro defaults (top-k 50, 100 iterations, 30 s wall,
   width 8); 11 requests with the llama_drug.yaml generation settings,
   those with i % 3 == 0 asking for a route. Every answer must carry no
   "error", every retro request whose molecule was designed a "retro"
   block; kernel A must have launched >= 28 x steps x design batches and
   kernel B >= 5 x (expansion rounds + products scored).
6. run_molqa (the eval entry point) on the same model: 2 records of
   data/molqa_drug_examples.json, frontier width 8, one shared 30 s
   planning wall, scores on (FGD through GraphCLIP, kernel B).
7. Reference checks: f32 copies of the full-width denoiser and of
   GraphCLIP on the card (kernel paths) against the same weights on the
   CPU (plain paths), max relative error < 1e-3.

Prints, before the last line, one {"kernels": [...]} JSON line; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero.
"""

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

MAIN_SHAPE = (16, 50, 1024, 16)          # (2 x batch 8 for CFG, N, H, heads)
CHECK_SHAPES = (MAIN_SHAPE, (5, 17, 128, 4), (8, 64, 256, 8))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
          "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "c1cc[nH]c1"]
REQUESTS = 11
PROPERTIES = [{"HIV": 1.0}, {"BBBP": 1.0}, {"SA": 2.5}, None]
GIN_MAIN = (8, 56, 300)      # GraphCLIP splice of a width-8 frontier
GIN_CHECKS = ((GIN_MAIN, (torch.float32,)), ((1, 24, 300), (torch.float32,)),
              ((3, 11, 40), (torch.float32, torch.bfloat16)),
              ((2, 17, 64), (torch.float32, torch.bfloat16)))
GIN_LAYERS = 5               # GraphCLIP and predictor depth (5 x 300)
MOLECULES = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
             "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Nc1ccc(O)cc1",
             "COc1ccc2[nH]cc(CCN(C)C)c2c1", "O=C(O)c1ccccc1O",
             "CCN(CC)CCNC(=O)c1ccc(N)cc1", "CC12CCC3c4ccc(O)cc4CCC3C1CCC2O"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, launches: int = 50, repeats: int = 21) -> float:
    """Median per-call time of `fn` over repeats of `launches` calls."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def device_ms(fn, kernel: str, launches: int = 20):
    """Mean device time per launch (ms) of the CUDA kernel whose name
    holds `kernel`, read from a torch.profiler trace of `launches` calls;
    None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "device_time_total", None) or getattr(
                evt, "cuda_time_total", 0.0)
            count += evt.count
    return total_us / count / 1e3 if count and total_us else None


def check_kernel(fused, reference, tag):
    """Phase 3 (kernel A). Returns (max bf16 error at the main shape, ms, plain ms)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for (b, n, h, heads) in CHECK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            dh = h // heads
            qkv = torch.randn(b, n, 3 * h, device="cuda", generator=gen).to(dt)
            mask = torch.rand(b, n, device="cuda", generator=gen) > 0.3
            mask[:, 0] = True        # every graph keeps >= 1 node
            norms = [torch.randn(dh, device="cuda", generator=gen).to(dt)
                     for _ in range(4)]
            out = fused(qkv, mask, *norms, heads)
            torch.cuda.synchronize()
            ref = reference(qkv, mask, *norms, heads)
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f"kernel output {tuple(out.shape)} not finite/shaped")
            err = ((out.float() - ref.float()) * mask[..., None]).abs().max()
            err = float(err)
            print(f"kernel check B,N,H,heads={b},{n},{h},{heads} {dt}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dt]:g})", flush=True)
            if not err < TOL[dt]:
                fail(f"fused attention disagrees: {err} >= {TOL[dt]}")
            if (b, n, h, heads) == MAIN_SHAPE and dt == torch.bfloat16:
                main_err = err
                args = (qkv, mask, *norms, heads)
    ms = cuda_ms(lambda: fused(*args))
    plain_ms = cuda_ms(lambda: reference(*args))
    dev = device_ms(lambda: fused(*args), "fused_attention_kernel")
    print(f"fused attention at {MAIN_SHAPE} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per call (CUDA events); kernel device "
          f"time {dev} ms (torch.profiler) [{tag}]", flush=True)
    return main_err, ms, plain_ms


def molecular_graphs(n_pad: int):
    """MOLECULES as a dense padded batch (atoms, int32 edges, mask) on the
    card."""
    from llamole_tpu.chem.featurize import pad_graph_batch, smiles_to_graph
    bank = pad_graph_batch([smiles_to_graph(s) for s in MOLECULES], n_pad)
    return (torch.as_tensor(bank["atom_types"], device="cuda"),
            torch.as_tensor(bank["edge_classes"], device="cuda"),
            torch.as_tensor(bank["node_mask"], device="cuda"))


def check_gin(gin, reference, tag):
    """Phase 4. Returns (max f32 error at GIN_MAIN, ms, plain ms)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_err = None
    for (b, n, h), dtypes in GIN_CHECKS:
        for dt in dtypes:
            x = torch.randn(b, n, h, device="cuda", generator=gen).to(dt)
            edge = torch.randint(0, 5, (b, n, n), device="cuda",
                                 generator=gen).triu(1)
            edge = (edge + edge.transpose(1, 2)).to(torch.int32)
            valid = torch.arange(n, device="cuda")[None] < torch.randint(
                1, n + 1, (b, 1), device="cuda", generator=gen)
            adj = ((edge > 0) & valid[:, :, None] & valid[:, None, :]).to(dt)
            table = torch.randn(5, h, device="cuda", generator=gen).to(dt)
            with torch.no_grad():
                out = gin(x, edge, adj, table)
            torch.cuda.synchronize()
            ref = reference(x, edge, adj, table)
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f"gin kernel output {tuple(out.shape)} not finite/shaped")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            scale = float(ref.float().abs().max())
            if dt == torch.float32:
                ok = bool((diff <= 1e-4 + 1e-4 * ref.float().abs()).all())
                tol = "atol = rtol = 1e-4"
            else:
                ok = err <= 1e-2 * scale
                tol = f"1e-2 x max|ref| = {1e-2 * scale:.3e}"
            print(f"gin check B,N,H={b},{n},{h} {dt}: max_abs_err={err:.3e} "
                  f"({tol})", flush=True)
            if not ok:
                fail(f"gin_aggregate disagrees at {(b, n, h)} {dt}: {err}")
            if (b, n, h) == GIN_MAIN:
                main_err = err
    empty = gin(torch.zeros(1, 4, 8, device="cuda"),
                torch.zeros(1, 4, 4, dtype=torch.int32, device="cuda"),
                torch.zeros(1, 4, 4, device="cuda"),
                torch.ones(5, 8, device="cuda"))
    torch.cuda.synchronize()
    if not bool((empty == 0).all()):
        fail("gin_aggregate of an empty graph is not 0")
    print("gin check empty graph: 0", flush=True)
    # time on molecular graphs (~2-3 bonds per atom), as the path sees them
    b, n, h = GIN_MAIN
    _, edge, mask = molecular_graphs(n)
    adj = ((edge > 0) & mask[:, :, None] & mask[:, None, :]).float()
    x = torch.randn(b, n, h, device="cuda", generator=gen)
    table = torch.randn(5, h, device="cuda", generator=gen)
    args = (x, edge.to(torch.int32).contiguous(), adj, table)
    with torch.no_grad():
        ms = cuda_ms(lambda: gin(*args))
        plain_ms = cuda_ms(lambda: reference(*args))
        dev = device_ms(lambda: gin(*args), "gin_aggregate_kernel")
    print(f"gin_aggregate at {GIN_MAIN} f32, molecular graphs: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms per call (CUDA events); "
          f"kernel device time {dev} ms (torch.profiler) [{tag}]",
          flush=True)
    return main_err, ms, plain_ms


def build_slice():
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.graphclip import GraphCLIPConfig
    from llamole_tpu_torch.models.graphdit import (
        GraphDiTConfig, build_data_info_from_smiles)
    from llamole_tpu_torch.models.retro import GraphPredictorConfig
    from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                                 offline_tokenizer)
    from llamole_tpu_torch.ops.nn import xavier_uniform_

    tok = offline_tokenizer()
    info = build_data_info_from_smiles(CORPUS, max_n_nodes=50)
    dit = GraphDiTConfig(hidden_size=1024, depth=28, num_heads=16,
                         diffusion_steps=100, text_dim=768, guide_scale=2.0)
    model = build_graph_lm_from_configs(
        LLMConfig.llama3_8b(), dit, info, tok, device="cuda",
        llm_dtype=torch.bfloat16, graph_dtype=torch.bfloat16, seed=0,
        finetuning_type="lora", lora_rank=8,
        clip_cfg=GraphCLIPConfig(num_layer=GIN_LAYERS, hidden_size=300),
        predictor_cfg=GraphPredictorConfig(num_layer=GIN_LAYERS,
                                           hidden_size=300, out_dim=16,
                                           text_input_size=768))
    # the JAX init zero-gates every AdaLN block of the denoiser and of
    # the predictor (training starts from identity blocks); random
    # serving weights redraw those layers so each block's attention and
    # each GIN layer reach the outputs
    gen = torch.Generator(device="cuda").manual_seed(1)
    den = model.graph_decoder.denoiser
    for lin in [blk.ada_fc1 for blk in den.blocks] + [
            den.output_layer.ada_fc2] + list(model.graph_predictor.adapters):
        xavier_uniform_(lin.weight, gen)
    return model, tok


def timed(obj, name, log):
    """Wrap obj.name so every call is timed between synchronizations;
    log gets (seconds, result) per call."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, wrapper)


class PathTimers:
    """Timed wrappers around the stages of design and retrosynthesis."""

    def __init__(self, model):
        self.log = {k: [] for k in (
            "design", "decode", "sampler", "rounds", "splice", "retro_query",
            "predictor", "value", "retro")}
        timed(model, "design_molecule", self.log["design"])
        timed(model.llm, "generate", self.log["decode"])
        timed(model.graph_decoder, "generate", self.log["sampler"])
        timed(model, "batched_one_step_reaction", self.log["rounds"])
        timed(model, "_splice_molecule_embeds", self.log["splice"])
        timed(model, "_body_hidden", self.log["retro_query"])
        timed(model.graph_predictor, "sample_templates",
              self.log["predictor"])
        timed(model, "batched_estimate_complexity", self.log["value"])
        timed(model, "retrosynthesize_batch", self.log["retro"])

    def clear(self):
        for calls in self.log.values():
            calls.clear()

    def seconds(self, key):
        return sum(t for t, _ in self.log[key])

    def count(self, key):
        return len(self.log[key])

    def gin_floor(self):
        """Kernel B launches the retro path must have made: one GraphCLIP
        call per expansion round and one predictor call per product
        scored, GIN_LAYERS launches each."""
        return GIN_LAYERS * (self.count("splice") + self.count("predictor"))

    def report_phase2(self, tag):
        rounds = self.seconds("rounds")
        splice = self.seconds("splice")
        query = self.seconds("retro_query")
        pred = self.seconds("predictor")
        decode = rounds - splice - query - pred
        value = self.seconds("value")
        plans = [p for _, out in self.log["retro"] for p in out.values()]
        found = sum(bool(p.get("success")) for p in plans)
        exp = [p.get("expansions", 0) for p in plans]
        print(f"phase 2: {self.count('retro')} searches over {len(plans)} "
              f"molecules, {self.count('rounds')} expansion rounds "
              f"(walls {[round(t, 3) for t, _ in self.log['rounds']]} s), "
              f"expansions per molecule {exp}, routes found {found} "
              f"[{tag}]")
        print(f"phase 2 split: expansion decode {decode:.3f} s, splice "
              f"(GraphCLIP) {splice:.3f} s over {self.count('splice')} calls,"
              f" retro query re-forward {query:.3f} s, predictor + template "
              f"application {pred:.3f} s over {self.count('predictor')} "
              f"products, value scoring {value:.3f} s over "
              f"{self.count('value')} calls; searches "
              f"{self.seconds('retro'):.3f} s [{tag}]", flush=True)


def check_launches(name, launches, need, how):
    print(f"{name} launches {launches} (need >= {need} = {how})", flush=True)
    if launches < need:
        fail(f"{name}: the path launched the kernel {launches} < {need} "
             "times")


def diffusion_steps(model) -> int:
    from llamole_tpu_torch.models.graphdit.api import time_grid
    cfg = model.graph_decoder.cfg
    return len(time_grid(cfg.diffusion_steps, cfg.sampling_steps)) - 1


def run_serving(model, tok, timers, fused, gin, tag):
    """Phase 5. Returns (kernel A launches, kernel B launches) of the
    main-path run."""
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import DesignServer

    gen = GenerationSettings(max_new_tokens=128, temperature=0.6, top_p=0.9,
                             do_sample=True)
    server = DesignServer(model, tok, batch_size=8, max_wait_s=0.5, gen=gen,
                          rollback=True, seed=0)
    wants_retro = [i % 3 == 0 for i in range(REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    timers.clear()
    fused.launches = gin.launches = 0
    server.start()
    try:
        handles = [server.submit(f"Design a drug-like molecule, request {i}.",
                                 PROPERTIES[i % len(PROPERTIES)],
                                 retro=wants_retro[i])
                   for i in range(REQUESTS)]
        results = [h.result(timeout=900) for h in handles]
    finally:
        server.stop()
    launches = fused.launches, gin.launches
    peak = torch.cuda.max_memory_allocated()

    errors = [r["error"] for r in results if "error" in r]
    if len(results) != REQUESTS or errors:
        fail(f"{len(results)} answers, errors: {errors[:3]}")
    for r, retro in zip(results, wants_retro):
        if not isinstance(r["text"], str) or not (
                r["smiles"] is None or isinstance(r["smiles"], str)):
            fail(f"malformed result {r}")
        if retro and r["smiles"] is not None and not isinstance(
                r.get("retro"), dict):
            fail(f"retro request without a retro block: {r}")
    design_batches = timers.count("design")
    print(f"serving: {len(results)} answered ({sum(wants_retro)} asked for "
          f"a route), {server.batches_run} batches", flush=True)
    check_launches("fused_block_attention", launches[0],
                   model.graph_decoder.cfg.depth * diffusion_steps(model)
                   * design_batches,
                   f"{model.graph_decoder.cfg.depth} x "
                   f"{diffusion_steps(model)} x {design_batches}")
    check_launches("gin_aggregate", launches[1], timers.gin_floor(),
                   f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                   f"{timers.count('predictor')} products)")

    pad = tok.pad_token_id
    decodes = timers.log["decode"]
    dec_tokens = sum(int((out[0] != pad).sum()) for _, out in decodes)
    dec_s = timers.seconds("decode")
    valid = sum(model.graph_decoder.check_valid(r["smiles"])
                for r in results)
    for i, (t, _) in enumerate(timers.log["design"]):
        print(f"design batch {i}: wall {t:.3f} s [{tag}]")
    print(f"decode: {dec_tokens} tokens in {dec_s:.3f} s over {len(decodes)} "
          f"generate calls = {dec_tokens / dec_s:.1f} tok/s [{tag}]")
    print(f"sampler: {timers.count('sampler')} calls, "
          f"{timers.seconds('sampler'):.3f} s total, per call "
          f"{[round(t, 3) for t, _ in timers.log['sampler']]} [{tag}]")
    timers.report_phase2(tag)
    retro_lat = [r["latency_s"] for r, w in zip(results, wants_retro) if w]
    design_lat = [r["latency_s"] for r, w in zip(results, wants_retro)
                  if not w]
    print(f"latency: retro requests {retro_lat} s, design-only requests "
          f"{design_lat} s; routes in answers "
          f"{sum(bool(r.get('retro', {}).get('success')) for r in results)}"
          f" [{tag}]")
    print(f"valid SMILES: {valid} of {len(results)}; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) [{tag}]",
          flush=True)
    return launches


def run_eval(model, tok, timers, fused, gin, tag):
    """Phase 6: run_molqa over 2 records with the prebuilt model."""
    from llamole_tpu_torch.eval.workflow import run_molqa

    data_dir = Path(__file__).resolve().parent / "data"
    with tempfile.TemporaryDirectory() as out_dir:
        args = dict(
            model_args=SimpleNamespace(adapter_name_or_path=None,
                                       property_oracle_path=None),
            data_args=SimpleNamespace(dataset="molqa_drug_examples",
                                      dataset_dir=str(data_dir),
                                      template="llama3", cutoff_len=128),
            training_args=SimpleNamespace(per_device_eval_batch_size=2,
                                          output_dir=out_dir, seed=0,
                                          mesh=""),
            finetuning_args=SimpleNamespace(),
            generating_args=SimpleNamespace(
                max_new_tokens=128, temperature=0.6, top_p=0.9,
                do_sample=True, repetition_penalty=1.0,
                speculative_tokens=None, speculative_ngram=2,
                frontier_width=8))
        timers.clear()
        fused.launches = gin.launches = 0
        t0 = time.perf_counter()
        results = run_molqa(**args, max_records=2, prebuilt=(model, tok),
                            share_planning_wall=True, score=True)
        wall = time.perf_counter() - t0
        with open(Path(out_dir) / "molqa_results.json") as f:
            summary = json.load(f)["summary"]
    launches = fused.launches, gin.launches
    if len(results) != 2 or summary["num_records"] != 2:
        fail(f"run_molqa answered {len(results)} records")
    for r in results:
        if "llm_reactions" not in r or not isinstance(r["llm_response"], str):
            fail(f"malformed run_molqa result {r}")
    if summary["fgd"] is not None and not np.isfinite(summary["fgd"]):
        fail(f"FGD not finite: {summary['fgd']}")
    print(f"run_molqa: {wall:.3f} s, summary {json.dumps(summary)} [{tag}]")
    timers.report_phase2(tag)
    check_launches("fused_block_attention (run_molqa)", launches[0],
                   model.graph_decoder.cfg.depth * diffusion_steps(model),
                   f"{model.graph_decoder.cfg.depth} x "
                   f"{diffusion_steps(model)} x 1 design batch")
    check_launches("gin_aggregate (run_molqa)", launches[1],
                   timers.gin_floor() + GIN_LAYERS,
                   f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                   f"{timers.count('predictor')} products + 1 FGD chunk)")


def check_denoiser(model, tag):
    """Phase 5: full-width denoiser, f32 on the card vs the CPU."""
    den = model.graph_decoder.denoiser
    cfg = model.graph_decoder.cfg
    gpu32 = copy.deepcopy(den).float()
    cpu32 = copy.deepcopy(den).float().cpu()
    rng = np.random.default_rng(0)
    b, n = 2, cfg.max_n_nodes
    X = np.eye(cfg.Xdim, dtype=np.float32)[rng.integers(0, cfg.Xdim, (b, n))]
    E = np.eye(cfg.Edim, dtype=np.float32)[rng.integers(0, cfg.Edim,
                                                        (b, n, n))]
    mask = np.arange(n)[None, :] < np.array([[9], [23]])
    y = rng.normal(size=(b, cfg.ydim)).astype(np.float32)
    y[:, ::2] = np.nan
    txt = rng.normal(size=(b, cfg.text_dim)).astype(np.float32)
    t = np.array([0.5, 0.9], np.float32)
    inputs = [torch.from_numpy(a) for a in (X, E, mask, y, txt, t)]
    with torch.no_grad():
        lx_g, le_g = gpu32(*[a.cuda() for a in inputs])
        lx_c, le_c = cpu32(*inputs)
    for g, c in ((lx_g, lx_c), (le_g, le_c)):
        if g.shape != c.shape or not torch.isfinite(g).all():
            fail("denoiser logits not finite / wrong shape")
        rel = float((g.cpu() - c).abs().max() / c.abs().max())
        print(f"denoiser f32 card vs CPU {tuple(g.shape)}: max rel err "
              f"{rel:.3e} (tol 1e-3) [{tag}]", flush=True)
        if not rel < 1e-3:
            fail(f"full-width denoiser disagrees with the CPU: {rel}")


def check_graphclip(model, tag):
    """Phase 7b: full-width GraphCLIP, f32 on the card vs the CPU."""
    enc = model.graph_encoder
    cpu = copy.deepcopy(enc).cpu()
    atoms, edges, mask = molecular_graphs(56)
    with torch.no_grad():
        g = enc(atoms, edges, mask)
        c = cpu(atoms.cpu(), edges.cpu(), mask.cpu())
    if g.shape != c.shape or not torch.isfinite(g).all():
        fail("GraphCLIP embeddings not finite / wrong shape")
    rel = float((g.cpu() - c).abs().max() / c.abs().max())
    print(f"GraphCLIP {enc.cfg.num_layer} x {enc.hidden_size} f32 card vs "
          f"CPU {tuple(g.shape)}: max rel err {rel:.3e} (tol 1e-3) [{tag}]",
          flush=True)
    if not rel < 1e-3:
        fail(f"full-width GraphCLIP disagrees with the CPU: {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    print(tag, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from llamole_tpu_torch.ops import cuda_lib
    from llamole_tpu_torch.ops.fused_attention import (
        fused_attention_reference, fused_block_attention)
    from llamole_tpu_torch.ops.gin_aggregate import (gin_aggregate,
                                                     gin_aggregate_reference)

    lib = cuda_lib.library()
    print(f"kernels built in {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    err, ms, plain_ms = check_kernel(fused_block_attention,
                                     fused_attention_reference, tag)
    gin_err, gin_ms, gin_plain_ms = check_gin(gin_aggregate,
                                              gin_aggregate_reference, tag)
    t0 = time.perf_counter()
    model, tok = build_slice()
    torch.cuda.synchronize()
    print(f"slice built (random weights on the card) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    timers = PathTimers(model)
    launches, gin_launches = run_serving(model, tok, timers,
                                         fused_block_attention,
                                         gin_aggregate, tag)
    run_eval(model, tok, timers, fused_block_attention, gin_aggregate, tag)
    check_denoiser(model, tag)
    check_graphclip(model, tag)

    print(json.dumps({"kernels": [{
        "name": "fused_block_attention", "route": "cuda",
        "source": "llamole_tpu_torch/csrc/fused_attention.cu",
        "replaces": "llamole_tpu/ops/pallas/fused_attention.py:34",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}, {
        "name": "gin_aggregate", "route": "cuda",
        "source": "llamole_tpu_torch/csrc/gin_aggregate.cu",
        "replaces": "llamole_tpu/ops/pallas/gin_aggregate.py:40",
        "launches": gin_launches, "max_abs_err": gin_err, "ms": gin_ms,
        "plain_ms": gin_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
