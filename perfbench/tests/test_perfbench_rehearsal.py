"""CPU rehearsals of both drivers at a tiny configuration
(perfbench/tests/tiny/; not cells): the window's control flow, the result
line's shape, the comparison with the reference; the faults the check
must catch, planted in the timed path (a token altered where it is
produced; an optimizer step that leaves the state unchanged; half of
every batch left out, the mean taken over the rest); the control (the
reference in the precision below the configuration's) failing the limits
the program passes. On the card, the control at each cell's own size."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from perfbench import core
from perfbench.drivers import design, sft

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
CELLS = {"design": ("qwen2-7b.design-c32", "qwen2-7b", design),
         "sft": ("mistral-7b.sft-tiny", "mistral-7b", sft)}
SEED = 2 ** 31 + 11
# the metrics of a training cell (BENCHMARK.json has none yet): what the
# training driver and its readers give
SFT_METRICS = {
    "end_to_end": [{"name": "train_tokens_per_s", "unit": "tokens/s"},
                   {"name": "train_peak_gib", "unit": "GiB"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": n, "unit": u} for n, u in (
        ("collate_ms.sft", "ms"), ("roofline.E", "%"), ("mfu.sft", "%"),
        ("device_idle_pct.sft", "%"))]}


def _json(name):
    with open(os.path.join(TINY, name)) as f:
        return json.load(f)


def tiny_cell(kind):
    name, config, _ = CELLS[kind]
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if kind == "sft":
        bench = SFT_METRICS
    return types.SimpleNamespace(
        name=name, config=_json(f"{config}.json"), traffic=_json(
            f"{kind}.json"), limits=_json(f"{kind}-limits.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def rehearse(kind, trace=False, seconds=3.0, control=False):
    cell = tiny_cell(kind)
    run = CELLS[kind][2].run(cell, SEED, seconds, trace, time.monotonic(),
                             device=torch.device("cpu"), control=control)
    return run, core.result_line(run, cell, trace)


@pytest.mark.parametrize("kind", ["design", "sft"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(kind, trace):
    run, line = rehearse(kind, trace)
    print(json.dumps(line)[:2000])
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in (tiny_cell(kind).per_layer if trace
                                else tiny_cell(kind).end_to_end)}
    if trace:      # no device on the CPU: the trace's readers read nothing
        want -= {"roofline.A", "roofline.E", "device_idle_pct.design",
                 "device_idle_pct.sft"}
    assert want <= set(line["metrics"])
    assert list(line)[-1] == "checks"


def test_token_altered_fails(monkeypatch):
    from llamole_tpu_torch.models.gllm import model as llm_module
    orig = llm_module.sample_token

    def altered(generator, logits, *a, **k):
        return (orig(generator, logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(llm_module, "sample_token", altered)
    run, line = rehearse("design")
    assert not line["correct"]
    assert line["checks"]["sampled_outside"]["value"] > 0


def test_state_unchanged_fails(monkeypatch):
    from llamole_tpu_torch.train.optimizers import AccumulatingAdamW
    monkeypatch.setattr(AccumulatingAdamW, "_update", lambda self: None)
    run, line = rehearse("sft")
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails(monkeypatch):
    from llamole_tpu_torch.models.composite import GraphLM
    orig = GraphLM.loss
    rows = ("input_ids", "attention_mask", "labels", "molecule_properties",
            "design_graph_index", "design_start_pos")

    def half(self, batch, *a, **k):
        keep = batch["input_ids"].shape[0] // 2
        batch = {n: (v[:keep] if n in rows else v) for n, v in batch.items()}
        noisy = k.get("noisy")
        if noisy is not None:
            k["noisy"] = {n: v[:keep] for n, v in noisy.items()}
        return orig(self, batch, *a, **k)

    monkeypatch.setattr(GraphLM, "loss", half)
    run, line = rehearse("sft")
    assert not line["correct"]


@pytest.mark.parametrize("kind", ["design", "sft"])
def test_control_fails_what_the_program_passes(kind):
    run, line = rehearse(kind, control=True)
    assert line["correct"], line["checks"]
    lim = tiny_cell(kind).limits
    ctrl = run.notes["control"]
    sides = [ctrl] if kind == "design" else list(ctrl.values())
    for side in sides:
        assert any(side[n] > lim[n] for n in lim if n in side), side


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen2-7b.design-c32"])
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    out = subprocess.run(
        [sys.executable, os.path.join(core.PB, "control.py"), "--workload",
         cell, "--seeds", "101,102,103"], capture_output=True, text=True,
        timeout=3000, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.splitlines()
             if s.startswith("{")]
    assert len(lines) == 3
    for rec in lines:
        ctrl = rec["control"]
        sides = [ctrl] if "int8" not in ctrl else list(ctrl.values())
        for side in sides:
            assert any(side[n] > rec["limits"][n] for n in rec["limits"]
                       if n in side), rec
