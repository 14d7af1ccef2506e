#!/usr/bin/env python3
"""Smoke run of llamole_tpu_torch (the PyTorch + CUDA port) on one card.

    python3 chip_smoke.py

1. Needs CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from llamole_tpu_torch/csrc (build seconds and
   the ptxas register / shared-memory report).
3. Kernel check: the fused graph attention against its plain PyTorch
   version at the main-path shape (16, 50, 1024, 16) and at (5, 17, 128,
   4) and (8, 64, 256, 8), in f32 (tolerance 1e-4, the JAX kernel's
   contract) and bf16 (2e-2 absolute: the output is a convex combination
   of O(1) v rows and bf16 rounds at ~4e-3), on rows whose node is kept.
   Median CUDA-event times of kernel and plain version at the main path.
4. The Phase-1 slice at full width through the serving entry point:
   Llama-3.1-8B shape (random bf16 weights drawn on the card from a seed,
   LoRA rank 8) + GraphDiT 1024 wide, 28 deep, 16 heads, 50 nodes, 100
   diffusion steps, CFG 2.0, behind DesignServer(batch_size=8); 11
   requests (one full batch, one padded) with the llama_drug.yaml
   generation settings. Every answer must carry no "error", and the
   fused-attention kernel must have launched >= 28 x steps x batches.
5. Reference check: an f32 copy of the full-width denoiser on the card
   (kernel path) against the same weights on the CPU (plain path).

Prints, before the last line, one {"kernels": [...]} JSON line; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_SHAPE = (16, 50, 1024, 16)          # (2 x batch 8 for CFG, N, H, heads)
CHECK_SHAPES = (MAIN_SHAPE, (5, 17, 128, 4), (8, 64, 256, 8))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
          "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "c1cc[nH]c1"]
REQUESTS = 11
PROPERTIES = [{"HIV": 1.0}, {"BBBP": 1.0}, {"SA": 2.5}, None]


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


def check_kernel(fused, reference, tag):
    """Phase 3. Returns (max bf16 error at the main shape, ms, plain ms)."""
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
    print(f"fused attention at {MAIN_SHAPE} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms [{tag}]", flush=True)
    return main_err, ms, plain_ms


def build_slice():
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.graphdit import (
        GraphDiTConfig, build_data_info_from_smiles)
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
        finetuning_type="lora", lora_rank=8)
    # the JAX init zero-gates every AdaLN block (training starts from
    # identity blocks); random serving weights redraw those layers so
    # each block's attention output reaches the logits
    gen = torch.Generator(device="cuda").manual_seed(1)
    den = model.graph_decoder.denoiser
    for lin in [blk.ada_fc1 for blk in den.blocks] + [
            den.output_layer.ada_fc2]:
        xavier_uniform_(lin.weight, gen)
    return model, tok


def timed(obj, name, log):
    """Wrap obj.name so every call is timed between synchronizations."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, wrapper)


def run_slice(model, tok, fused, tag):
    """Phase 4. Returns the kernel's launch count in the main-path run."""
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.models.graphdit.api import time_grid
    from llamole_tpu_torch.serve import DesignServer

    gen = GenerationSettings(max_new_tokens=128, temperature=0.6, top_p=0.9,
                             do_sample=True)
    batches, decodes, samplers = [], [], []
    timed(model, "design_molecule", batches)
    timed(model.llm, "generate", decodes)
    timed(model.graph_decoder, "generate", samplers)
    server = DesignServer(model, tok, batch_size=8, max_wait_s=0.5, gen=gen,
                          rollback=True, seed=0)
    torch.cuda.reset_peak_memory_stats()
    fused.launches = 0
    server.start()
    try:
        handles = [server.submit(f"Design a drug-like molecule, request {i}.",
                                 PROPERTIES[i % len(PROPERTIES)])
                   for i in range(REQUESTS)]
        results = [h.result(timeout=900) for h in handles]
    finally:
        server.stop()
    launches = fused.launches
    peak = torch.cuda.max_memory_allocated()

    errors = [r["error"] for r in results if "error" in r]
    if len(results) != REQUESTS or errors:
        fail(f"{len(results)} answers, errors: {errors[:3]}")
    for r in results:
        if not isinstance(r["text"], str) or not (
                r["smiles"] is None or isinstance(r["smiles"], str)):
            fail(f"malformed result {r}")
    steps = len(time_grid(model.graph_decoder.cfg.diffusion_steps,
                          model.graph_decoder.cfg.sampling_steps)) - 1
    depth = model.graph_decoder.cfg.depth
    need = depth * steps * server.batches_run
    print(f"slice: {len(results)} answered, {server.batches_run} batches, "
          f"fused-attention launches {launches} (need >= {need} = {depth} x "
          f"{steps} x {server.batches_run})", flush=True)
    if launches < need:
        fail(f"the main path launched the kernel {launches} < {need} times")

    pad = tok.pad_token_id
    dec_tokens = sum(int((out[0] != pad).sum()) for _, out in decodes)
    dec_s = sum(t for t, _ in decodes)
    valid = sum(model.graph_decoder.check_valid(r["smiles"])
                for r in results)
    for i, (t, _) in enumerate(batches):
        print(f"batch {i}: wall {t:.3f} s [{tag}]")
    print(f"decode: {dec_tokens} tokens in {dec_s:.3f} s over {len(decodes)} "
          f"generate calls = {dec_tokens / dec_s:.1f} tok/s [{tag}]")
    print(f"sampler: {len(samplers)} calls, {sum(t for t, _ in samplers):.3f}"
          f" s total, per call {[round(t, 3) for t, _ in samplers]} [{tag}]")
    print(f"valid SMILES: {valid} of {len(results)}; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) [{tag}]",
          flush=True)
    return launches


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

    lib = cuda_lib.library()
    print(f"kernels built in {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    err, ms, plain_ms = check_kernel(fused_block_attention,
                                     fused_attention_reference, tag)
    t0 = time.perf_counter()
    model, tok = build_slice()
    torch.cuda.synchronize()
    print(f"slice built (random weights on the card) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = run_slice(model, tok, fused_block_attention, tag)
    check_denoiser(model, tag)

    print(json.dumps({"kernels": [{
        "name": "fused_block_attention", "route": "cuda",
        "source": "llamole_tpu_torch/csrc/fused_attention.cu",
        "replaces": "llamole_tpu/ops/pallas/fused_attention.py:34",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
