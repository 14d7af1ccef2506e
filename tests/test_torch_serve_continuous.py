"""llamole_tpu_torch's continuous serving (ContinuousDesignServer: the slot
pool, the design and retro workers, the TCP transport and the CLI switch)
on the tiny stack on the CPU, mirroring tests/test_serve_continuous.py;
and the adapter switch of value scoring, which must hold for the calling
thread alone now that three threads share the LLM."""

import io
import json
import socket
import threading

import numpy as np
import pytest
import torch

from llamole_tpu_torch import serve
from llamole_tpu_torch.models.composite import GenerationSettings
from llamole_tpu_torch.models.gllm import LLM, LLMConfig
from llamole_tpu_torch.models.graphdit import (GraphDiTConfig,
                                               build_data_info_from_smiles)
from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                             offline_tokenizer)
from llamole_tpu_torch.serve import (ContinuousDesignServer, DesignServer,
                                     make_tcp_server, serve_stream)

CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1"]
DIT = dict(hidden_size=32, depth=2, num_heads=4, diffusion_steps=6,
           text_dim=16)
GEN = GenerationSettings(max_new_tokens=8, do_sample=True)
POOL = dict(slots=2, chunk_steps=4, cache_len=256, prompt_buckets=(64,),
            gen=GEN)
TIMEOUT = 300


@pytest.fixture(scope="module")
def stack():
    tok = offline_tokenizer()
    model = build_graph_lm_from_configs(
        LLMConfig.tiny(), GraphDiTConfig(**DIT),
        build_data_info_from_smiles(CORPUS, 10), tok, device="cpu",
        llm_dtype=torch.float32, finetuning_type="lora", lora_rank=4)
    return model, tok


def _continuous(stack, **kw):
    model, tok = stack
    return ContinuousDesignServer(model, tok, **{**POOL, "design_batch": 2,
                                                 "max_wait_s": 0.05, **kw})


def test_continuous_server_routes_results(stack):
    server = _continuous(stack, design_batch=3, max_wait_s=0.2).start()
    try:
        handles = [server.submit(f"Design molecule number {i} please.",
                                 {"SA": float(i)}) for i in range(5)]
        results = [h.result(timeout=TIMEOUT) for h in handles]
    finally:
        server.stop()
    for r in results:
        assert "error" not in r, r
        assert isinstance(r["text"], str)
        assert r["smiles"] is None or isinstance(r["smiles"], str)
    assert server.requests_served == 5
    # 5 requests through a 2-slot pool in design groups of <= 3
    assert server.batches_run >= 2
    assert server.decoder.chunks_run >= 2
    assert server.decoder.idle and sorted(server.decoder._free) == [0, 1]
    assert server.stats()["decode_chunks_run"] == server.decoder.chunks_run


def test_latency_stats_on_both_servers(stack):
    model, tok = stack
    for server in (DesignServer(model, tok, gen=GEN, batch_size=2,
                                max_wait_s=0.1),
                   _continuous(stack, max_wait_s=0.1)):
        server.start()
        try:
            handles = [server.submit(f"request {i}") for i in range(3)]
            results = [h.result(timeout=TIMEOUT) for h in handles]
        finally:
            server.stop()
        assert all(r["latency_s"] > 0 for r in results)
        stats = server.stats()
        assert stats["requests_served"] == 3
        assert stats["latency_p50_s"] > 0
        assert stats["latency_max_s"] >= stats["latency_p50_s"]


def _always_designs(monkeypatch, model):
    """Run the real design stage, then answer every real row with a
    molecule, so that retro rows always reach the retro worker (random
    tiny weights often design none)."""
    inner = model.design_from_analysis

    def design(*args, true_b=None, **kwargs):
        inner(*args, true_b=true_b, **kwargs)
        return ["CCO"] * true_b

    monkeypatch.setattr(model, "design_from_analysis", design)


def test_continuous_server_retro_request(stack, monkeypatch):
    model, _ = stack
    _always_designs(monkeypatch, model)
    server = _continuous(stack, retro_iterations=1, retro_max_time=5.0,
                         retro_width=2).start()
    try:
        r = server.submit("Design and synthesize something small.",
                          {"SA": 2.0}, retro=True).result(timeout=TIMEOUT)
    finally:
        server.stop()
    assert "error" not in r, r
    assert set(r["retro"]) == {"success", "reactions", "templates", "cost"}
    assert len(r["retro"]["reactions"]) == len(r["retro"]["cost"])


def test_stop_resolves_outstanding_requests(stack):
    """stop() leaves no waiter hanging: queued requests of a server that
    never started answer "server stopped", on both servers."""
    model, tok = stack
    for server in (DesignServer(model, tok, gen=GEN, batch_size=4,
                                max_wait_s=5.0),
                   _continuous(stack, design_batch=4, max_wait_s=5.0)):
        handles = [server.submit(f"request {i}") for i in range(3)]
        server.stop()
        for h in handles:
            assert h.result(timeout=10)["error"] == "server stopped"
        late = server.submit("after stop").result(timeout=10)
        assert late["error"] == "server stopped"


def test_tcp_round_trip(stack):
    """Two concurrent clients on 127.0.0.1 share one continuous server:
    each gets its own JSONL answers by id, a malformed line answers with
    an error without dropping the connection, and {"stats": true}
    reports the decode chunks."""
    server = _continuous(stack, max_wait_s=0.2).start()
    tcp = make_tcp_server(server, "127.0.0.1", 0)   # a free port
    t = threading.Thread(target=tcp.serve_forever, daemon=True)
    t.start()
    host, port = tcp.server_address
    results = {}

    def client(name, lines):
        with socket.create_connection((host, port), timeout=TIMEOUT) as s:
            f = s.makefile("rw", encoding="utf-8")
            for line in lines:
                f.write(line + "\n")
            f.flush()
            results[name] = [json.loads(f.readline()) for _ in lines]
            f.write("\n")   # end of this connection's stream
            f.flush()

    clients = [
        threading.Thread(target=client, args=("a", [
            json.dumps({"prompt": "Design something small."}),
            "this is not json"])),
        threading.Thread(target=client, args=("b", [
            json.dumps({"prompt": "Another molecule please.",
                        "property": {"SA": 2.0}})]))]
    try:
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=TIMEOUT)
        client("stats", ['{"stats": true}'])
    finally:
        tcp.shutdown()
        tcp.server_close()
        server.stop()
    a = {r["id"]: r for r in results["a"]}
    assert "smiles" in a[0] and "latency_s" in a[0] and "error" not in a[0]
    assert "bad request" in a[1]["error"]
    assert "smiles" in results["b"][0] and "error" not in results["b"][0]
    (stats,) = results["stats"]
    assert stats["requests_served"] == 2
    assert stats["decode_chunks_run"] >= 1


def test_retro_search_does_not_block_decode(stack, monkeypatch):
    """A design-only request submitted after a retro request is answered
    while that request's search is still running (the search runs on the
    retro worker)."""
    model, _ = stack
    _always_designs(monkeypatch, model)
    release, searching = threading.Event(), threading.Event()

    def parked_search(smiles, **kwargs):
        searching.set()
        release.wait(timeout=TIMEOUT)
        return {}

    monkeypatch.setattr(model, "retrosynthesize_batch", parked_search)
    server = _continuous(stack, design_batch=1).start()
    try:
        h_retro = server.submit("Design and synthesize.", retro=True)
        assert searching.wait(timeout=TIMEOUT)
        plain = server.submit("Just design, no synthesis.").result(
            timeout=TIMEOUT)
        assert "error" not in plain and "smiles" in plain
        assert not h_retro._p.event.is_set()   # its search still runs
        release.set()
        r_retro = h_retro.result(timeout=TIMEOUT)
    finally:
        release.set()
        server.stop()
    assert r_retro["retro"]["success"] is False and "error" not in r_retro


def test_continuous_server_survives_a_bad_design_stage(stack, monkeypatch):
    model, _ = stack
    inner = model.design_from_analysis
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return inner(*args, **kwargs)

    monkeypatch.setattr(model, "design_from_analysis", flaky)
    server = _continuous(stack, design_batch=1).start()
    try:
        r1 = server.submit("first request").result(timeout=TIMEOUT)
        r2 = server.submit("second request").result(timeout=TIMEOUT)
    finally:
        server.stop()
    assert r1["error"] == "boom"
    assert "error" not in r2 and "smiles" in r2


def test_a_failed_retro_search_answers_with_an_error(stack, monkeypatch):
    """A search that raises answers its rows with the design, an empty
    route and an "error", as DesignServer does; the retro worker goes on
    to the next group."""
    model, _ = stack
    _always_designs(monkeypatch, model)
    calls = []

    def flaky_search(smiles, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("search broke")
        return {}

    monkeypatch.setattr(model, "retrosynthesize_batch", flaky_search)
    server = _continuous(stack, design_batch=1).start()
    try:
        r1 = server.submit("first retro request", retro=True).result(
            timeout=TIMEOUT)
        r2 = server.submit("second retro request", retro=True).result(
            timeout=TIMEOUT)
    finally:
        server.stop()
    assert r1["error"] == "search broke"
    assert r1["smiles"] == "CCO" and r1["retro"]["success"] is False
    assert "error" not in r2 and r2["retro"]["success"] is False
    assert len(calls) == 2


def test_build_server_continuous_from_config_on_the_cpu():
    cfg = {"model_name_or_path": "", "max_new_tokens": 4,
           "learned_query_size": 8, "finetuning_type": "lora",
           "lora_rank": 4, "serve_batch_size": 2, "serve_chunk_steps": 3,
           "serve_cache_len": 128, "continuous_batching": True,
           "shared_prefix_text": "Design"}
    server = serve._build_server(cfg, device="cpu")
    try:
        assert isinstance(server, ContinuousDesignServer)
        dec = server.decoder
        assert (dec.slots, server.design_batch, dec.chunk_steps,
                dec.cache_len) == (2, 2, 3, 128)
        # buckets the cache cannot hold with the prefix are dropped
        assert dec.buckets == (64,)
        out = io.StringIO()
        serve_stream(server, io.StringIO(
            '{"prompt": "Design a ring.", "property": {"BBBP": 1.0}}\n'),
            out)
    finally:
        server.stop()
    (result,) = map(json.loads, out.getvalue().splitlines())
    assert result["id"] == 0 and "error" not in result
    assert dec.prefix_admissions == 1


def test_tcp_flag_parsing(monkeypatch):
    parse = serve._parser().parse_args
    assert parse(["c.yaml"]).tcp is None
    args = parse(["c.yaml", "--tcp"])
    assert (args.tcp, args.host, args.device) == (7733, "127.0.0.1", "cuda")
    args = parse(["c.yaml", "--tcp", "9001", "--host", "0.0.0.0",
                  "--device", "cpu"])
    assert (args.tcp, args.host, args.device) == (9001, "0.0.0.0", "cpu")
    seen = {}
    monkeypatch.setattr(serve, "serve_tcp",
                        lambda config, **kw: seen.update(kw, config=config))
    serve.main(["c.yaml", "--tcp", "9002", "--device", "cpu"])
    assert seen == {"config": "c.yaml", "host": "127.0.0.1", "port": 9002,
                    "device": "cpu"}


def test_repetition_penalty_is_refused(stack):
    with pytest.raises(ValueError, match="repetition_penalty"):
        _continuous(stack, gen=GenerationSettings(repetition_penalty=1.2))


def test_adapter_switch_holds_for_the_calling_thread_only():
    """Value scoring turns the adapter off inside adapter_disabled(); a
    forward on another thread meanwhile (the continuous server's decode)
    keeps the adapter: its logits within 1e-6 of a plain adapter-on
    forward (the same math on the same inputs)."""
    torch.manual_seed(0)
    llm = LLM(LLMConfig.tiny(), dtype=torch.float32)
    llm.reset_parameters(torch.Generator().manual_seed(0))
    llm.add_lora(4, 2.0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in llm.named_parameters():
            if "lora_" in name:   # B too, so the adapter changes logits
                p.normal_(0.0, 0.05, generator=gen)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, LLMConfig.tiny().vocab_size, size=(2, 9)))

    def logits():
        with torch.no_grad():
            return llm(input_ids=ids)[0]

    adapter_on = logits()
    inside, release = threading.Event(), threading.Event()
    base = {}

    def scorer():
        with llm.adapter_disabled():
            base["logits"] = logits()
            inside.set()
            release.wait(timeout=60)

    th = threading.Thread(target=scorer)
    th.start()
    try:
        assert inside.wait(timeout=60)
        other_thread = logits()
    finally:
        release.set()
        th.join(timeout=60)
    torch.testing.assert_close(other_thread, adapter_on, atol=1e-6, rtol=0)
    assert not torch.allclose(base["logits"], adapter_on, atol=1e-3)
    torch.testing.assert_close(logits(), adapter_on, atol=1e-6, rtol=0)


def test_a_request_is_answered_once_under_racing_resolvers(stack):
    """A worker and stop() may race to answer one request: the first
    answer wins and its latency is recorded once. Many threads, a short
    switch interval."""
    import sys

    from llamole_tpu_torch.serve import _Pending

    server = _continuous(stack)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            p = _Pending(prompt_ids=[1], properties=np.zeros(10, np.float32))
            go = threading.Event()

            def answer(k):
                go.wait(timeout=10)
                server._resolve_error(p, f"answer {k}")

            threads = [threading.Thread(target=answer, args=(k,))
                       for k in range(16)]
            for th in threads:
                th.start()
            go.set()
            for th in threads:
                th.join(timeout=10)
            assert not any(th.is_alive() for th in threads)
            assert p.event.is_set() and p.result["error"].startswith("answer")
    finally:
        sys.setswitchinterval(interval)
        server.stop()
    assert len(server._lat._lat) == 20
