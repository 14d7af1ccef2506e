"""The port's tracing (llamole_tpu_torch/utils/profiling.py) on the tiny
stack on the CPU: spans record only under a torch profiler and nest as
the design path's layers do, on the profiler's clock; the always-on
counters count requests, rows, decode steps and assembly outcomes; the
snapshot carries the kernels' launch counters; DesignServer.stats()
returns the counters; the benchmark's readers of them (perfbench/metrics/)
read None on an empty snapshot and the right value on a made-up one."""

import os
import statistics
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llamole_tpu_torch.chem.assemble import graph_to_smiles
from llamole_tpu_torch.models.composite import GenerationSettings
from llamole_tpu_torch.models.gllm import LLMConfig
from llamole_tpu_torch.models.gllm.model import LLM
from llamole_tpu_torch.models.graphdit import (GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                             offline_tokenizer)
from llamole_tpu_torch.ops import flash_attention, fused_attention
from llamole_tpu_torch.serve import DesignServer
from llamole_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
GEN = GenerationSettings(max_new_tokens=6, do_sample=True, design_resamples=1)
TIMEOUT = 120
# each span's parent, as the design path nests them
PARENTS = {
    "serve.batch": {None},
    "serve.respond": {"serve.batch"},
    "design.analysis": {"serve.batch"},
    "design.extend": {"serve.batch"},
    "design.connector": {"serve.batch"},
    "design.diffuse": {"serve.batch"},
    "design.rollback": {"serve.batch"},
    "llm.prefill": {"design.analysis", "design.rollback"},
    "llm.first_step": {"design.analysis", "design.rollback"},
    "llm.step": {"design.analysis", "design.rollback"},
    "llm.forward": {"llm.first_step", "llm.step"},
    "llm.pick": {"llm.first_step", "llm.step"},
    "llm.stop_wait": {"llm.prefill", "llm.first_step", "llm.step"},
    "graphdit.step": {"design.diffuse"},
    "graphdit.fetch": {"design.diffuse"},
    "graphdit.assemble": {"design.diffuse"},
}


@pytest.fixture(scope="module")
def stack():
    tok = offline_tokenizer()
    model = build_graph_lm_from_configs(
        LLMConfig.tiny(), GraphDiTConfig(**DIT),
        build_data_info_from_smiles(CORPUS, 10), tok, device="cpu",
        llm_dtype=torch.float32, finetuning_type="lora", lora_rank=4)
    return model, tok


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def _no_device_calls(monkeypatch):
    """Fail any CUDA event or synchronisation the tracing would make."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA call while no profiler is active")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _serve(stack, n_requests, batch_size=4, all_fail=False):
    """One DesignServer batch of n_requests; with all_fail, every sample
    fails to assemble, so every row goes to the rollback decode. Returns
    the rows design_rollback was handed to decode."""
    model, tok = stack
    rollback_rows = []
    orig_rollback = model.design_rollback
    orig_generate = model.graph_decoder.generate

    def rollback(generator, seqs, smiles, gen):
        rollback_rows.append(sum(s is None for s in smiles))
        return orig_rollback(generator, seqs, smiles, gen)

    model.design_rollback = rollback
    if all_fail:
        model.graph_decoder.generate = \
            lambda *a, **k: [None] * len(orig_generate(*a, **k))
    server = DesignServer(model, tok, gen=GEN, batch_size=batch_size,
                          max_wait_s=0.5, seed=3).start()
    try:
        handles = [server.submit(f"Design molecule {i}.", {"SA": 2.0})
                   for i in range(n_requests)]
        results = [h.result(timeout=TIMEOUT) for h in handles]
    finally:
        server.stop()
        del model.design_rollback
        if all_fail:
            del model.graph_decoder.generate
    assert all("error" not in r for r in results), results
    assert server.batches_run == 1
    return rollback_rows


def _generate(model, steps=5):
    ids = torch.randint(5, 200, (2, 9), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    return model.llm.generate(ids, mask, generator=torch.Generator()
                              .manual_seed(1), max_new_tokens=steps,
                              spec_tokens=0, return_spec_iters=True)


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    _no_device_calls(monkeypatch)
    assert not profiling.recording()
    a = profiling.span("llm.forward", torch.device("cuda"))
    assert a is profiling.span("x") and a is profiling.span("y", None)
    with a:
        pass
    assert profiling.snapshot()["spans"] == []


def test_generate_counts_without_a_profiler(stack, monkeypatch):
    _no_device_calls(monkeypatch)
    out, done, iters = _generate(stack[0])
    snap = profiling.snapshot()
    assert snap["spans"] == []
    c = snap["counters"]
    assert iters >= 1 and c["llm.decode_steps"] == iters
    assert c["llm.generate_calls"] == 1
    # the prefill's read, then one after every step but the budget's last
    assert c["llm.stop_reads"] == 1 + min(iters, 4)
    assert "llm.graph_captures" not in c          # eager on the CPU


def test_server_counts_without_a_profiler(stack, monkeypatch):
    _no_device_calls(monkeypatch)
    rollback_rows = _serve(stack, 3, all_fail=True)
    snap = profiling.snapshot()
    assert snap["spans"] == []
    c = snap["counters"]
    assert c["serve.requests"] == 3 and c["serve.rows_real"] == 3
    assert c["serve.rows_run"] == 4               # the last request repeated
    assert c["serve.queue_wait_s"] > 0
    assert rollback_rows == [4]
    assert c["design.rollback_rows"] == 4 and c["design.rows"] == 4
    assert c["design.redraws"] == GEN.design_resamples
    assert c["llm.generate_calls"] == 2           # analysis, rollback
    assert c["graphdit.reverse_steps"] == DIT["diffusion_steps"] * (
        1 + GEN.design_resamples)


def test_spans_nest_under_the_profiler(stack):
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(stack, 2, all_fail=True)
    snap = profiling.snapshot()
    spans = snap["spans"]
    names = {s["id"]: s["name"] for s in spans}
    assert set(names.values()) == set(PARENTS)
    for s in spans:
        assert names.get(s["parent"]) in PARENTS[s["name"]], s
        assert s["batch"] == 0
        assert s["start_ns"] <= s["end_ns"]
        device = s["name"] in ("llm.prefill", "llm.forward", "llm.pick",
                               "graphdit.step")
        assert (s["device_ms"] == s["wall_ms"]) if device else (
            s["device_ms"] is None)
    by = {n: [s for s in spans if s["name"] == n] for n in PARENTS}
    c = snap["counters"]
    assert len(by["llm.first_step"]) == c["llm.generate_calls"] == 2
    assert len(by["llm.step"]) == c["llm.decode_steps"] - 2
    assert len(by["llm.forward"]) == c["llm.decode_steps"]
    assert len(by["graphdit.step"]) == c["graphdit.reverse_steps"]
    assert len(by["design.diffuse"]) == 1 + c["design.redraws"]
    # a child lies inside its parent
    spans_by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            p = spans_by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]


def test_spans_carry_the_batch_when_the_profiler_starts_inside(stack):
    """The benchmark's window opens at design_molecule, inside the
    server's batch: the batch's spans carry its number, and serve.batch,
    opened before the profiler, is not recorded."""
    model, _ = stack
    orig = model.design_molecule
    prof = profile(activities=[ProfilerActivity.CPU])

    def traced(*a, **k):
        prof.__enter__()
        try:
            return orig(*a, **k)
        finally:
            prof.__exit__(None, None, None)

    model.design_molecule = traced
    try:
        _serve(stack, 2)
    finally:
        del model.design_molecule
    spans = profiling.snapshot()["spans"]
    names = {s["name"] for s in spans}
    assert names >= {"design.analysis", "design.diffuse", "llm.step"}
    assert not names & {"serve.batch", "serve.respond"}
    assert all(s["batch"] == 0 for s in spans)


def test_trace_writes_the_spans_and_drops_their_records(stack, tmp_path):
    with profiling.trace(str(tmp_path)):
        _generate(stack[0], steps=3)
    assert profiling.snapshot()["spans"] == []
    assert profiling.counters()["llm.generate_calls"] == 1
    written, = os.listdir(tmp_path)
    with open(tmp_path / written) as f:
        text = f.read()
    for name in ("llm.prefill", "llm.first_step", "llm.step", "llm.forward"):
        assert f'"name": "{name}"' in text, name


def test_spans_lie_on_the_profilers_clock(stack):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _generate(stack[0], steps=8)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    gaps = []
    spans = profiling.snapshot()["spans"]
    for name in {s["name"] for s in spans}:
        mine = sorted((s for s in spans if s["name"] == name),
                      key=lambda s: s["start_ns"])
        theirs = sorted(events.get(name, []),
                        key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            gaps.append(abs((s["start_ns"] - t0) / 1e3 - e.time_range.start))
            gaps.append(abs((s["end_ns"] - t0) / 1e3 - e.time_range.end))
    assert len(gaps) >= 2 * 3 * 8 * 3
    assert statistics.median(gaps) < 50.0, statistics.median(gaps)


def test_snapshot_carries_the_launch_counters(monkeypatch):
    monkeypatch.setattr(LLM, "graph_replays", 17)
    monkeypatch.setattr(fused_attention.fused_block_attention,
                        "launches_mma", 5)
    monkeypatch.setattr(flash_attention.flash_attention, "launches_fwd", 3)
    got = profiling.snapshot()["launches"]
    assert got["LLM.graph_replays"] == 17
    assert got["fused_block_attention.launches_mma"] == 5
    assert got["flash_attention.launches_fwd"] == 3
    for key in ("fused_block_attention.launches", "graph_attention.launches",
                "flash_attention.launches_dq", "gin_aggregate.launches",
                "gin_aggregate_backward.launches_smem",
                "int8_matmul.launches"):
        assert key in got


def test_stats_returns_the_counters(stack):
    model, tok = stack
    profiling.count("serve.requests", 2)
    profiling.add("serve.queue_wait_s", 0.25)
    stats = DesignServer(model, tok).stats()
    assert stats["counters"] == {"serve.requests": 2,
                                 "serve.queue_wait_s": 0.25}
    assert stats["requests_served"] == 0


def test_counters_hold_under_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                profiling.count("n")
                profiling.add("s", 0.5)

        threads = [threading.Thread(target=bump)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    c = profiling.counters()
    assert c["n"] == 2000 * len(threads) and c["s"] == 1000.0 * len(threads)


def test_spans_of_threads_do_not_nest_into_each_other():
    seen = {}
    ready = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"outer.{tag}"):
            ready.wait()
            with profiling.span(f"inner.{tag}"):
                ready.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    spans = profiling.snapshot()["spans"]
    for s in spans:
        seen[s["name"]] = s
    for tag in "ab":
        assert seen[f"inner.{tag}"]["parent"] == seen[f"outer.{tag}"]["id"]
        assert seen[f"outer.{tag}"]["parent"] is None


def _graph(atoms, bonds):
    e = np.zeros((len(atoms), len(atoms)), np.int64)
    for i, j, t in bonds:
        e[i, j] = e[j, i] = t
    return np.array(atoms, np.int64), e


def test_assembly_outcomes_are_counted():
    """The port's assemble.<outcome> counters equal the reference's
    collect_assembly_stats on the same graphs, and both assemble the same
    ones."""
    from llamole_tpu.chem.assemble import collect_assembly_stats
    from llamole_tpu.chem.assemble import graph_to_smiles as ref_to_smiles
    decoder = ["C", "N", "O", "F", "*", "S", "Cl", "B"]
    graphs = [
        (_graph([0, 0, 2], [(0, 1, 1), (1, 2, 1)]), ["ok"]),      # CCO
        (_graph([0], []), ["ok"]),                                 # C
        (_graph([0, 9], [(0, 1, 1)]), ["exception"]),  # no atom 9
        (_graph([], []), ["write_failed"]),
        (_graph([4, 0], [(0, 1, 2)]), ["polymer_reject"]),         # *=C
        (_graph([3, 3, 3, 3], [(0, 1, 3), (1, 2, 3), (2, 3, 3),
                               (0, 3, 3)]),
         ["correction_failed", "reparse_failed"]),
        (_graph([7, 2, 6], [(0, 1, 2), (0, 2, 4)]),
         ["correction_failed", "ok"]),                            # B(=O)Cl
        (_graph([3, 3, 7, 6], [(1, 2, 4), (1, 3, 3)]),
         ["correction_failed", "reparse_failed"]),
        (_graph([4, 5, 6], [(0, 1, 1), (0, 2, 3)]), ["polymer_reject"]),
    ]
    out = graph_to_smiles([g for g, _ in graphs], decoder)
    with collect_assembly_stats() as ref:
        ref_out = ref_to_smiles([g for g, _ in graphs], decoder)
    assert profiling.counters() == {f"assemble.{k}": v
                                    for k, v in ref.items()}
    assert [s is not None for s in out] == [s is not None for s in ref_out]
    assert [s is not None for s in out] == [True, True, False, False,
                                            False, False, True, False,
                                            False]
    want = {}
    for _, outcomes in graphs:
        for o in outcomes:
            want[f"assemble.{o}"] = want.get(f"assemble.{o}", 0) + 1
    assert profiling.counters() == want


READERS = {
    # metric: (made-up snapshot, its value)
    "queue_wait_ms": ({"counters": {"serve.queue_wait_s": 0.5,
                                    "serve.requests": 4}}, 125.0),
    "batch_fill_pct": ({"counters": {"serve.rows_real": 24,
                                     "serve.rows_run": 32}}, 75.0),
    "rollback_row_pct": ({"counters": {"design.rows": 64,
                                       "design.rollback_rows": 16}}, 25.0),
    "decode_first_step_ms": ({"spans": [
        {"id": 1, "name": "llm.first_step", "parent": None,
         "wall_ms": 90.0, "device_ms": None},
        {"id": 2, "name": "llm.first_step", "parent": None,
         "wall_ms": 110.0, "device_ms": None}]}, 100.0),
    "decode_forward_ms": (None, 21.0),
    "decode_pick_ms": (None, 3.0),
    "decode_stop_wait_ms": (None, 7.0),
    "assemble_ms": ({"spans": [
        {"id": 1, "name": "graphdit.assemble", "parent": None,
         "wall_ms": 4.0, "device_ms": None}]}, 4.0),
}


def _steps_snapshot():
    """Two decode steps after a first: llm.forward 20 / 22 ms on the
    device, llm.pick 2 / 4, llm.stop_wait 6 / 8 walls; the first step's
    children are not a step's."""
    spans = [{"id": 0, "name": "llm.first_step", "parent": None,
              "wall_ms": 500.0, "device_ms": None}]
    for i, (f, p, w) in enumerate(((20.0, 2.0, 6.0), (22.0, 4.0, 8.0))):
        step = 10 * (i + 1)
        spans.append({"id": step, "name": "llm.step", "parent": None,
                      "wall_ms": f + p + w, "device_ms": None})
        for k, (name, v) in enumerate((("llm.forward", f), ("llm.pick", p),
                                       ("llm.stop_wait", w))):
            spans.append({"id": step + k + 1, "name": name, "parent": step,
                          "wall_ms": v if name == "llm.stop_wait" else 0.5,
                          "device_ms": None if name == "llm.stop_wait"
                          else v})
    for k, name in enumerate(("llm.forward", "llm.pick", "llm.stop_wait")):
        spans.append({"id": 100 + k, "name": name, "parent": 0,
                      "wall_ms": 300.0, "device_ms": 300.0})
    return {"spans": spans}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_the_program_counters(metric, monkeypatch):
    if ROOT not in sys.path:
        monkeypatch.syspath_prepend(ROOT)
    from perfbench import core
    read = core.load_reader(metric)
    made, want = READERS[metric]
    made = made or _steps_snapshot()
    full = {"spans": [], "counters": {}, "launches": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(full))
    assert read(None) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {**full, **made})
    assert read(None) == pytest.approx(want)
    monkeypatch.delattr(profiling, "snapshot")      # a program without it
    assert read(None) is None
