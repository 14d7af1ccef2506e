"""chip_smoke.py's byte count for kernels B and C (gin_bytes / gin_bound),
on a hand-built bank on the CPU: it counts the x rows of adj's used
columns, the g rows of its used rows, the classes of adj's non-zero
entries, and every other input and output once in full. And the training shape chip_smoke.py times kernel B at is
the bank run_mmsft builds under its llama_lora settings. And phase 11
(the learned-weights stack) runs end to end on the CPU at small sizes."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

import chip_smoke

N, H = 4, 8
F32 = 4


def bank(empty: int):
    """Two graphs plus `empty` graphs without a bond. Graph 0 is the chain
    0-1-2, both ways: columns and rows {0, 1, 2}. Graph 1 has the directed
    bonds 0->2 and 0->3: columns {2, 3}, row {0}."""
    b = 2 + empty
    adj = torch.zeros(b, N, N)
    for i, j in ((0, 1), (1, 0), (1, 2), (2, 1)):
        adj[0, i, j] = 1.0
    adj[1, 0, 2] = adj[1, 0, 3] = 1.0
    edge = (adj * 2).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, N, H, generator=gen)
    table = torch.randn(5, H, generator=gen)
    g = torch.randn(b, N, H, generator=gen)
    return x, edge, adj, table, g


def hand_count(empty: int, backward: bool) -> int:
    b = 2 + empty
    x_rows = (3 + 2) * H * F32
    edge = (4 + 2) * F32                   # the classes of the 6 bonds
    adj = b * N * N * F32
    table = 5 * H * F32
    out = b * N * H * F32                  # out (B) or dx (C)
    total = x_rows + edge + adj + table + out
    if backward:
        total += (3 + 1) * H * F32         # g rows
        total += 5 * H * F32               # dtable
    return total


@pytest.mark.parametrize("backward", [False, True], ids=["B", "C"])
def test_gin_bytes_equal_a_hand_count(backward):
    args = bank(3)
    assert chip_smoke.gin_bytes(args, backward) == hand_count(3, backward)
    bound_ms, bound_by = chip_smoke.gin_bound(args, backward)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(hand_count(3, backward)
                                     / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("backward", [False, True], ids=["B", "C"])
def test_empty_graphs_add_only_adj_edge_and_output(backward):
    added = 5
    more = chip_smoke.gin_bytes(bank(3 + added), backward)
    fewer = chip_smoke.gin_bytes(bank(3), backward)
    # adj and out; edge adds nothing where adj has no non-zero
    per_graph = N * N * F32 + N * H * F32
    assert more - fewer == added * per_graph


def test_b_and_c_differ_by_g_rows_dx_and_dtable():
    args = bank(3)
    b, c = (chip_smoke.gin_bytes(args, bwd) for bwd in (False, True))
    out = dx = 5 * N * H * F32
    g_rows = (3 + 1) * H * F32
    dtable = 5 * H * F32
    assert c - b == g_rows + dx + dtable - out


def test_training_shape_is_the_bank_run_mmsft_builds(tmp_path, monkeypatch):
    """GIN_TRAIN is the molecule and retro bank that run_mmsft's collator
    gets under llama_lora_args (max(8, 8 x batch) graphs of the graph
    decoder's max_n_nodes) at the GIN width of the slice chip_smoke.py
    builds."""
    from llamole_tpu_torch.models.graphdit import build_data_info_from_smiles
    from llamole_tpu_torch.models.loader import offline_tokenizer
    from llamole_tpu_torch.train import workflow

    class Built(Exception):
        pass

    seen = {}

    def collator(**kwargs):
        seen.update(kwargs)
        raise Built

    monkeypatch.setattr(workflow, "SeqGraphCollator", collator)
    info = build_data_info_from_smiles(chip_smoke.CORPUS,
                                       max_n_nodes=chip_smoke.MAX_NODES)
    model = SimpleNamespace(graph_decoder=SimpleNamespace(
        cfg=SimpleNamespace(max_n_nodes=info.max_n_nodes)))
    with pytest.raises(Built):
        workflow.run_mmsft(*chip_smoke.llama_lora_args(str(tmp_path)),
                           prebuilt=(model, offline_tokenizer()))
    rows, n, h = chip_smoke.GIN_TRAIN
    assert (seen["max_graphs"], seen["max_nodes"]) == (rows, n)
    assert (seen["max_retro"], seen["max_nodes"]) == (rows, n)
    assert (rows, n, h) == (80, 50, chip_smoke.GIN_HIDDEN)


def test_bound_at_the_training_bank_counts_the_output_once():
    """gin_bound of kernel B at GIN_TRAIN on the training bank: the 4.8 MB
    output once, adj once, the table, and only the molecules' bonds'
    classes and the x rows of their bonded columns."""
    rows, n, h = chip_smoke.GIN_TRAIN
    _, edge, mask, adj = chip_smoke.path_graphs(rows, n, device="cpu")
    x = torch.zeros(rows, n, h)
    table = torch.zeros(5, h)
    args = (x, edge, adj, table)
    out = rows * n * h * F32
    assert out == 4_800_000
    bonded_columns = int((adj != 0).any(dim=1).sum())
    assert 0 < bonded_columns < len(chip_smoke.MOLECULES) * n
    bonds = int((adj != 0).sum())
    assert bonded_columns < bonds < len(chip_smoke.MOLECULES) * n * n
    want = (bonded_columns * h * F32 + bonds * F32 + rows * n * n * F32
            + 5 * h * F32 + out)
    assert chip_smoke.gin_bytes(args, backward=False) == want
    bound_ms, bound_by = chip_smoke.gin_bound(args, backward=False)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e3)


# phase 11 at small sizes: the same stages, checks and reloads as on the
# card (the GIN wrappers run their plain versions on the CPU, and no
# launch is counted there)
_STACK_CPU = {
    "train_records": 24, "eval_records": 2,
    "graphdit": dict(hidden_size=32, depth=2, num_heads=4,
                     diffusion_steps=12, steps=4, batch_size=8),
    "predictor": dict(hidden_size=32, num_layer=2, steps=10, batch_size=8),
    "cost_mlp": dict(steps=10, batch_size=16),
    "graphclip": dict(hidden_size=32, num_layer=2, steps=4, batch_size=8),
    "oracle": dict(hidden_size=32, num_layer=2, steps=10, batch_size=8),
    "mmsft_steps": 2,
    "eval": dict(per_device_eval_batch_size=2, max_new_tokens=16,
                 expansion_topk=10, iterations=2, max_planning_time=2.0),
}


def test_stack_phase_runs_on_the_cpu():
    assert set(_STACK_CPU) == set(chip_smoke.STACK_SIZES)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        launches, bank_records = chip_smoke.run_stack(
            (), "CPU", device="cpu", sizes=_STACK_CPU)
    finally:
        torch.set_num_threads(threads)
    assert launches == {"B": 0, "C": 0} and bank_records == {}


def test_stack_phase_sizes_are_the_reference_widths():
    sizes = chip_smoke.STACK_SIZES
    assert sizes["graphdit"] | {"steps": 0} == dict(
        hidden_size=1024, depth=28, num_heads=16, diffusion_steps=100,
        steps=0, batch_size=64)
    for name in ("predictor", "graphclip"):
        assert (sizes[name]["hidden_size"], sizes[name]["num_layer"]) == (
            300, 5)
    # the oracle at the JAX package's defaults (3 x 128)
    assert "hidden_size" not in sizes["oracle"]
    assert all(sizes[k]["batch_size"] == 64 for k in
               ("graphdit", "predictor", "cost_mlp", "graphclip", "oracle"))


# phase 12 (weight interchange) at a small width on the CPU: a tiny shard
# budget so the export writes several shards and an index
_INTERCHANGE_CPU = {"shard_gb": 2e-4, "requests": 3, "max_new_tokens": 8,
                    "retro_iterations": 1, "retro_max_time": 5.0}


def _tiny_slice(llm=None):
    """build_slice's composition at small widths on the CPU: the LLM in
    bf16 with a rank-8 adapter (`llm` when given), GraphDiT in bf16, f32
    GIN modules."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.graphclip import GraphCLIPConfig
    from llamole_tpu_torch.models.graphdit import (
        GraphDiTConfig, build_data_info_from_smiles)
    from llamole_tpu_torch.models.loader import (
        build_graph_lm_from_configs, offline_tokenizer)
    from llamole_tpu_torch.models.retro import GraphPredictorConfig

    tok = offline_tokenizer()
    info = build_data_info_from_smiles(chip_smoke.CORPUS,
                                       max_n_nodes=chip_smoke.MAX_NODES)
    dit = GraphDiTConfig(hidden_size=32, depth=2, num_heads=4,
                         diffusion_steps=4, text_dim=768, guide_scale=2.0)
    model = build_graph_lm_from_configs(
        LLMConfig.tiny(), dit, info, tok, device="cpu", llm=llm,
        llm_dtype=torch.bfloat16, graph_dtype=torch.bfloat16, seed=0,
        finetuning_type="lora", lora_rank=8,
        clip_cfg=GraphCLIPConfig(num_layer=2, hidden_size=32),
        predictor_cfg=GraphPredictorConfig(num_layer=2, hidden_size=32,
                                           out_dim=16, text_input_size=768))
    return model, tok


def test_interchange_phase_runs_on_the_cpu(tmp_path, capsys):
    """Phase 12 end to end at a small width: run_mmsft's output (adapter
    and checkpoint-4) reloads bit-identically, the base exports in
    several shards, merge_adapter merges it, the merged export reloads
    with every tensor equal to base + adapter and last-token logits
    within a third of MERGE_LOGIT_TOL of the unmerged model, the
    model.msgpack merge_adapter streamed has the size and sha256 of the
    reloaded LLM's msgpack, and three requests (one with a route) are
    answered; base/ and merged/ are gone afterwards."""
    from llamole_tpu_torch.train.workflow import run_mmsft

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, tok = _tiny_slice()
        train_dir = str(tmp_path / "mmsft")
        with chip_smoke.capture_checkpoints() as saved:
            run_mmsft(*chip_smoke.llama_lora_args(train_dir),
                      prebuilt=(model, tok))
        assert "checkpoint-4" in saved
        exported = chip_smoke.interchange_export(
            model, str(tmp_path), train_dir, saved, "CPU",
            sizes=_INTERCHANGE_CPU)
        assert exported["shards"] > 1
        assert (tmp_path / "base" / "model.safetensors.index.json").exists()
        for name in ("graph_decoder", "graph_encoder", "graph_predictor"):
            assert (tmp_path / "modules" / name / "model.msgpack").exists()
        del model
        launches, rel = chip_smoke.run_interchange(
            (), str(tmp_path), train_dir, "CPU", device="cpu",
            sizes=_INTERCHANGE_CPU)
    finally:
        torch.set_num_threads(threads)
    assert "equals the msgpack of the reloaded merged LLM: True" in \
        capsys.readouterr().out
    print(f"merged vs unmerged logits (bf16, CPU): {rel:.3e}")
    assert launches == {"A": 0, "B": 0}
    assert rel <= chip_smoke.MERGE_LOGIT_TOL / 3
    assert not (tmp_path / "base").exists()
    assert not (tmp_path / "merged").exists()


# phase 17 (the entry points) at a small width on the CPU
_ENTRY_CPU = {"oracle_steps": 2, "eval_records": 2, "eval_batch": 2,
              "max_new_tokens": 8, "cutoff_len": 96, "parity_records": 1,
              "parity_wall": 2.0}


def test_entry_points_phase_runs_on_the_cpu(tmp_path, capsys):
    """Phase 17 end to end at a small width over phase 12's files (the
    base exported as HF safetensors, run_mmsft's adapter, the saved graph
    modules): env in a subprocess, validate_data and `pretrain oracle`
    under trace(), eval on a written YAML, parity with nothing to convert
    and the web UI's page, design and malformed requests."""
    from llamole_tpu_torch.train.workflow import run_mmsft

    assert set(_ENTRY_CPU) == set(chip_smoke.ENTRY)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, tok = _tiny_slice()
        train_dir = str(tmp_path / "mmsft")
        with chip_smoke.capture_checkpoints() as saved:
            run_mmsft(*chip_smoke.llama_lora_args(train_dir),
                      prebuilt=(model, tok))
        chip_smoke.interchange_export(model, str(tmp_path), train_dir, saved,
                                      "CPU", sizes=_INTERCHANGE_CPU)
        del model
        launches = chip_smoke.run_entry_points(
            (), str(tmp_path), train_dir, "CPU", device="cpu",
            sizes=_ENTRY_CPU)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"A": 0, "A_mma": 0, "A_tf32x3": 0, "A_fma": 0,
                        "B": 0, "C": 0}
    for line in ("phase 17 (a) python -m llamole_tpu_torch env: exit 0",
                 "phase 17 (b) validate_data: ok True, 5 records",
                 "phase 17 (b) pretrain oracle (2 steps) under trace()",
                 "plain GIN calls", "phase 17 (c) eval", "1 design batch(es)",
                 "phase 17 (d) parity", "phase 17 (e) web UI: built in",
                 "malformed request 500", "phase 17 (entry points)"):
        assert line in out, line
    table = json.loads((tmp_path / "entry" / "parity" /
                        "parity_table.json").read_text())
    assert tuple(table) == chip_smoke.PARITY_KEYS
    assert len(os.listdir(tmp_path / "entry" / "trace")) == 1


def test_entry_points_phase_sizes():
    """Phase 17 on the card: 20 oracle steps, eval over 2 records at an
    eval batch of 2 with 64 new tokens and the llama3 template, parity on
    1 record with a 10 s wall, the UI's design with HIV and SA."""
    sizes = chip_smoke.ENTRY
    assert (sizes["oracle_steps"], sizes["eval_records"],
            sizes["eval_batch"], sizes["max_new_tokens"]) == (20, 2, 2, 64)
    assert (sizes["parity_records"], sizes["parity_wall"]) == (1, 10.0)
    assert chip_smoke.UI_PROPERTIES == {"HIV": 1.0, "SA": 2.5}
    config = chip_smoke._entry_config("w", "w/mmsft", sizes)
    assert config["template"] == "llama3"
    assert config["model_name_or_path"] == os.path.join("w", "base")


def test_interchange_phase_sizes_are_the_8b_shape(monkeypatch):
    """Phase 12 runs on the slice's Llama-3.1-8B shape (vocab 128256,
    bf16, LoRA rank 8) and exports it in 5 GiB shards (the JAX rule:
    shard_gb x 1024^3 bytes): 3 shards and an index for the 16.06 GB of
    base weights, planned on a meta-device LLM (nothing allocated)."""
    from llamole_tpu_torch.models import loader
    from llamole_tpu_torch.models.gllm import LLM, LLMConfig
    from llamole_tpu_torch.models.gllm.convert import (hf_state_dict,
                                                       shard_plan)

    built = {}

    def capture(llm_cfg, *args, **kwargs):
        built.update(kwargs, llm_cfg=llm_cfg)
        raise StopIteration

    monkeypatch.setattr(loader, "build_graph_lm_from_configs", capture)
    with pytest.raises(StopIteration):
        chip_smoke.build_slice()
    assert built["llm_cfg"] == LLMConfig.llama3_8b()
    assert (built["llm_dtype"], built["lora_rank"]) == (torch.bfloat16, 8)
    sizes = chip_smoke.INTERCHANGE
    assert (sizes["shard_gb"], sizes["requests"],
            sizes["max_new_tokens"]) == (5.0, 3, 64)
    args = chip_smoke._interchange_args("w")
    assert (args["compute_dtype"], args["lora_rank"]) == ("bfloat16", 8)
    cfg = LLMConfig.llama3_8b()
    assert cfg.vocab_size == 128256
    llm = LLM(cfg, dtype=torch.bfloat16, device="meta")
    shards, nbytes = shard_plan(hf_state_dict(llm), sizes["shard_gb"])
    assert len(shards) == 3 and sum(nbytes) == 16060522496
    assert max(nbytes) <= 5 * 2 ** 30


def test_large_n_bank_is_what_bucket_gives(tmp_path):
    """The bank chip_smoke.py times kernel C's second body at is the
    pretraining batch of 64 with LARGE_MOLECULE in it, as wide as
    pretrain._bucket makes the bank of a corpus holding that molecule:
    162 atoms rounded up to 168, past the staged body's 161."""
    import json

    from llamole_tpu_torch.data.synthetic import write_corpus
    from llamole_tpu_torch.ops.gin_aggregate import gin_backward_body
    from llamole_tpu_torch.train import pretrain

    path = tmp_path / "corpus.json"
    write_corpus(str(path), 24, seed=0)
    records = json.loads(path.read_text())
    atoms, edges, mask = chip_smoke._stack_batch(records, device="cpu",
                                                 large=True)
    clip_rows = pretrain._clip_rows(chip_smoke.large_n_records(records))
    assert pretrain._bucket(clip_rows) == atoms.shape[1] == 168
    assert atoms.shape == (64, 168) and int(mask[-1].sum()) == 162
    assert int(mask[:-1].sum(dim=1).max()) <= 24   # corpus-sized molecules
    assert gin_backward_body(168) == "global"
    assert chip_smoke._stack_batch(records, device="cpu")[0].shape == (64,
                                                                       24)


# phase 13 (continuous serving over TCP) at small sizes on the CPU
_CONTINUOUS_CPU = {"slots": 2, "design_batch": 2, "chunk_steps": 4,
                   "cache_len": 256, "max_new_tokens": 8,
                   "retro_iterations": 1, "retro_max_time": 5.0}


def test_continuous_phase_runs_on_the_cpu(capsys):
    """Phase 13 end to end at a small width: 11 requests over two TCP
    connections to a ContinuousDesignServer, answered without an error,
    every admission on the shared prefix, the decoder idle afterwards,
    and the stats line counting 11 requests."""
    assert set(_CONTINUOUS_CPU) == set(chip_smoke.CONTINUOUS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, tok = _tiny_slice()
        launches = chip_smoke.run_continuous(
            model, tok, chip_smoke.PathTimers(model), (), "CPU",
            sizes=_CONTINUOUS_CPU,
            phase7={"retro": [1.0, 2.0], "design": [0.5]})
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"A": 0, "B": 0}
    assert f"{chip_smoke.REQUESTS} of {chip_smoke.REQUESTS} admissions on " \
        "the shared prefix" in out
    assert '"requests_served": 11' in out
    assert "phase 7 (DesignServer) p50 0.5 s" in out


def test_continuous_phase_sizes_are_phase_7s():
    """Phase 13 serves at phase 7's batch (8 slots, design groups of 8),
    128 new tokens and the retro defaults, in a 1024-slot cache."""
    assert chip_smoke.CONTINUOUS == {
        "slots": 8, "design_batch": 8, "chunk_steps": 8, "cache_len": 1024,
        "max_new_tokens": 128, "retro_iterations": 100,
        "retro_max_time": 30.0}


# phase 14 (quantized serving) at small sizes on the CPU: a small LLM
# whose projections outweigh its embedding as at 8B (4 layers, hidden 256,
# so the byte bounds apply), the tiny slice's graph modules, the loader's
# tiny LLM for QLoRA ("" names no family)
_QUANTIZED_CPU = {"requests": 4, "max_new_tokens": 8, "retro_iterations": 1,
                  "retro_max_time": 5.0, "prefill_batch": 8,
                  "decode_tokens": 4, "train_steps": 2, "design_batch": 2,
                  "scheme_layers": 4, "serving_layers": 4,
                  "model_name_or_path": ""}


# phase 21 at small sizes on the CPU: 8 new tokens in its run_molqa
_PHASE21_CPU = {**chip_smoke.PHASE21, "max_new_tokens": 8}


def test_quantized_phase_runs_on_the_cpu(capsys):
    """Phase 14 end to end at a small width: 4 requests answered from the
    int8 slice (int8 KV cache), the int8 denoiser within its bound and
    its design batch, the three schemes' projections within their bounds
    with every W8A8 projection through torch._int_mm, the KV check, and
    QLoRA through run_mmsft changing the LoRA and the connectors, not the
    int8 base. With it phase 21 (a) on one-rank gloo groups: run_molqa
    on the int8 slice equal with and without the mesh, the int4 and W8A8
    LLMs placed within the logit gate, QLoRA at ZeRO-3 within the loss
    gate of (d)'s; the group is gone after."""
    import torch.distributed as dist

    from llamole_tpu_torch.models.gllm import LLMConfig

    assert set(_QUANTIZED_CPU) - {"model_name_or_path"} == set(
        chip_smoke.QUANTIZED)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    phase21 = {"sizes": _PHASE21_CPU}
    try:
        launches, schemes = chip_smoke.run_quantized(
            (), "CPU", device="cpu", sizes=_QUANTIZED_CPU,
            build=_tiny_slice,
            llm_cfg=LLMConfig(vocab_size=512, hidden_size=256,
                              intermediate_size=512, num_layers=4,
                              num_heads=4, num_kv_heads=2,
                              rope_theta=10000.0),
            phase7={"decode_tok_s": 1.0}, phase21=phase21)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"A": 0, "A_mma": 0, "A_fma": 0, "B": 0, "C": 0}
    assert "phase 21 (a) int8 run_molqa on the mesh dp:1,tp:1: the int8 " \
        "base placed (w_q a DTensor)" in out
    assert "equal: {'analysis tokens': True, 'SMILES': True, " \
        "'responses': True}" in out
    for scheme in ("int4", "w8a8"):
        assert f"phase 21 (a) {scheme} placed on the mesh dp:1,tp:1" in out
        assert phase21["a"][scheme]["gap"] <= \
            chip_smoke.PHASE21["logit_tol"]
    assert "phase 21 (a) QLoRA at ZeRO-3 on the mesh dp:1,tp:1" in out
    assert max(phase21["a"]["qlora"]["loss_gaps"]) <= \
        chip_smoke.PHASE21["loss_gap"]
    assert not dist.is_initialized()
    assert "quantized serving (int8 weights, int8 KV cache): 4 answered" \
        in out
    assert "int8 base's checksum" in out and "unchanged" in out
    for scheme, bound in chip_smoke.QUANT_BOUNDS.items():
        assert schemes[scheme]["proj"] < bound
        assert schemes[scheme]["bytes"] < (
            chip_smoke.BYTES_BOUNDS[scheme] * schemes["int8"]["bytes"] / 0.5)
    assert schemes["kv"]["layer0"] < chip_smoke.KV_BOUND


def test_quantized_phase_gates_and_sizes():
    """Phase 14's gates are the CPU tests' bounds (int8 0.05, W8A8 0.10,
    int4 0.15: tests/test_quantize.py; the int8 KV cache 0.02:
    tests/test_llm.py; the int8 denoiser 0.05: tests/test_graphdit.py),
    its requests phase 7's first 4 at phase 7's settings. At the 8B shape,
    counted on the meta device (nothing allocated): the bf16 LLM is phase
    12's 16060522496 bytes, int8 and W8A8 below 0.55x of it and packed
    int4 below 0.35x, and so at the 24 of 32 layers (b) runs; (a) serves
    at all 32."""
    from dataclasses import replace

    from llamole_tpu_torch.models.gllm import LLM, LLMConfig
    from llamole_tpu_torch.models.gllm.quantize import quantized_bytes

    sizes = chip_smoke.QUANTIZED
    assert chip_smoke.QUANT_BOUNDS == {"int8": 0.05, "w8a8": 0.10,
                                       "int4": 0.15}
    assert (chip_smoke.KV_BOUND, chip_smoke.DENOISER_BOUND) == (0.02, 0.05)
    assert chip_smoke.BYTES_BOUNDS == {"int8": 0.55, "w8a8": 0.55,
                                       "int4": 0.35}
    assert sizes == {
        "requests": 4, "max_new_tokens": 128, "retro_iterations": 100,
        "retro_max_time": 30.0, "prefill_batch": 8, "decode_tokens": 32,
        "train_steps": 2, "design_batch": 8, "scheme_layers": 24,
        "serving_layers": 32}
    cfg = LLMConfig.llama3_8b()
    assert quantized_bytes(LLM(cfg, torch.bfloat16, "meta")) == 16060522496
    for layers in (32, sizes["scheme_layers"], sizes["serving_layers"]):
        cut = replace(cfg, num_layers=layers)
        dense = quantized_bytes(LLM(cut, torch.bfloat16, "meta"))
        for scheme, group in (("int8", 0), ("w8a8", 0), ("int4", 128)):
            got = quantized_bytes(LLM(cut, torch.bfloat16, "meta",
                                      quant=(scheme, group)))
            assert got < chip_smoke.BYTES_BOUNDS[scheme] * dense, scheme
    args = chip_smoke.qlora_args("out", chip_smoke.QUANTIZED)
    assert (args["quantization_bit"], args["max_steps"],
            args["gradient_accumulation_steps"]) == (8, 2, 1)
    assert set(chip_smoke.QLORA_DEVIATIONS) == {
        "quantization_bit", "max_steps", "gradient_accumulation_steps"}



# phase 15 (the other LLM families) at small sizes on the CPU: each
# family's knobs at the tiny width (gemma-2 / 3 with a 16-token window, so
# the 40-token prompt and the serving prompts cross it), the tiny slice's
# graph modules
_FAMILIES_CPU = {"prompts": 8, "greedy_tokens": 8, "spec_tokens": 2,
                 "requests": 4, "max_new_tokens": 8, "retro_iterations": 1,
                 "retro_max_time": 5.0, "long_prompt": 40,
                 "long_prefill": 16, "long_steps": 4, "moe_layers": 2,
                 "moe_tokens": 8, "train_batch": 2, "qwen3_layers": 2,
                 "gemma3_layers": 3, "gemma2_layers": 2}


def _family_cfgs():
    from dataclasses import replace

    from llamole_tpu_torch.models.gllm import LLMConfig

    gemma = dict(hidden_act="gelu_tanh", rms_norm_unit_offset=True,
                 scale_embeddings=True, tie_word_embeddings=True,
                 sandwich_norms=True, query_scale=16.0, sliding_window=16)
    tiny = LLMConfig.tiny()
    return {"qwen3": replace(tiny, qk_norm=True, head_dim=16),
            "gemma2": replace(tiny, attn_logit_softcap=50.0,
                              final_logit_softcap=30.0, **gemma),
            "gemma3": replace(tiny, qk_norm=True, num_layers=3,
                              sliding_window_pattern=3,
                              rope_local_base_freq=1e4,
                              rope_scaling="linear", **gemma),
            "mixtral": LLMConfig.tiny_moe()}


def test_families_phase_runs_on_the_cpu(capsys):
    """Phase 15 end to end at a small width in bf16: qwen3's cache and
    drafts checks on both KV caches, gemma-2 answering 4 requests through
    DesignServer, gemma-3's cache across its window and drafts off under
    it, Mixtral's drops, checks and one loss + backward with the router
    term, and on its model phase 20 (b) on a one-rank gloo group: the
    loss and gradients with the LLM placed equal the mesh-less ones."""
    import torch.distributed as dist

    assert set(_FAMILIES_CPU) == set(chip_smoke.FAMILIES)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    phase20, phase21 = {}, {"sizes": _PHASE21_CPU}
    try:
        launches = chip_smoke.run_families(
            (), "CPU", device="cpu", sizes=_FAMILIES_CPU, build=_tiny_slice,
            cfgs=_family_cfgs(), phase20=phase20, phase21=phase21)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"A": 0, "A_mma": 0, "A_fma": 0, "B": 0, "C": 0}
    assert "phase 20 (b) Mixtral on the mesh dp:1,tp:1" in out
    assert phase20["b"]["loss_gap"] <= 1e-6
    assert phase20["b"]["grad_rel"] <= 1e-5
    # phase 21 (b) on qwen3's LLM and (c) on gemma-2's model
    assert "phase 21 (b) qwen3 freeze-tuned (the 4 q / k norms " \
        "trainable) on the tp mesh dp:1,tp:1" in out
    assert "phase 21 (c) gemma-2 LoRA step at ZeRO-3 on the mesh " \
        "dp:1,tp:1 (tied embedding under FSDP2, the head gathering it: " \
        "True)" in out
    for part in "bc":
        assert phase21[part]["loss_gap"] <= 1e-6, part
        assert phase21[part]["grad_rel"] <= 1e-5, part
    assert not dist.is_initialized()
    for line in ("qwen3 (compute KV cache): greedy decode",
                 "qwen3 (int8 KV cache): greedy decode",
                 "gemma-2 serving (bf16, compute-dtype KV cache): 4 answered",
                 "gemma-3: 4 greedy steps on the 40-token prompt",
                 "drafts off", "units dropped for capacity at prefill",
                 "Mixtral loss + backward at batch 2"):
        assert line in out, line


def test_families_phase_sizes_are_the_presets():
    """Phase 15 runs the presets at full width (counted on the meta device:
    qwen3_8b 8.19B parameters, gemma2_9b 9.24B, gemma3_12b 11.77B; Mixtral
    at 8 of 32 layers 11.87B, 23.7 GB in bf16 where all 32 take 93.4 GB),
    qwen3 and gemma-3 cut in depth since phase 16 joined: qwen3 to 4 of
    36 layers, gemma-3 to 6 of 48 (5 of them windowed, one global);
    gemma-2 at all 42 (21 local, 21 global); a 1280-token prompt past
    gemma-3's 1024-token window, and phase 7's serving settings."""
    from dataclasses import replace

    from llamole_tpu_torch.models.gllm import LLM, LLMConfig

    sizes = chip_smoke.FAMILIES
    assert sizes == {"prompts": 8, "greedy_tokens": 128, "spec_tokens": 2,
                     "requests": 4, "max_new_tokens": 128,
                     "retro_iterations": 100, "retro_max_time": 30.0,
                     "long_prompt": 1280, "long_prefill": 1024,
                     "long_steps": 32, "moe_layers": 8, "moe_tokens": 64,
                     "train_batch": 2, "qwen3_layers": 4,
                     "gemma3_layers": 6, "gemma2_layers": 42}
    assert chip_smoke.CACHE_LOGIT_TOL == chip_smoke.MERGE_LOGIT_TOL

    def count(cfg):
        return sum(p.numel() for p in
                   LLM(cfg, torch.bfloat16, "meta").parameters())

    assert count(LLMConfig.qwen3_8b()) == 8190735360
    g2 = LLMConfig.gemma2_9b()
    assert count(g2) == 9241705984
    assert sum(not g2.is_global_layer(i) for i in range(42)) == 21
    assert sum(not g2.is_global_layer(i)
               for i in range(sizes["gemma2_layers"])) == 21
    g3 = LLMConfig.gemma3_12b()
    assert count(g3) == 11766034176
    assert sizes["long_prompt"] > g3.sliding_window == sizes["long_prefill"]
    assert sum(not g3.is_global_layer(i) for i in range(48)) == 40
    assert sum(not g3.is_global_layer(i)
               for i in range(sizes["gemma3_layers"])) == 5
    mix = LLMConfig.mixtral_8x7b()
    assert count(replace(mix, num_layers=8)) * 2 == 23744618496
    assert count(mix) * 2 == 93405585408


# phase 16 (the rest of training) at small sizes on the CPU: the tiny
# LLM config at 2 layers in every part, the tiny slice's graph modules in
# all four runs ((a) saves them, (b) and (c) load them)
_FINETUNE_CPU = {"dora_layers": 2, "pissa_layers": 2, "galore_layers": 2,
                 "badam_layers": 2, "loraplus_lr_ratio": 16.0,
                 "galore_rank": 16, "galore_update_interval": 200,
                 "galore_scale": 0.25, "badam_n_blocks": 4,
                 "badam_switch_interval": 1}


def test_finetune_phase_runs_on_the_cpu(capsys):
    """Phase 16 end to end at a small width in bf16: DoRA + LoRA+ +
    S²-attn through run_mmsft (S² in every layer of every training
    forward, none in generation), PiSSA + DoRA's untrained logits and
    its rank-16 export reloaded onto the original base, GaLore's
    checkpoint reloaded bit-identically, BAdam moving one block an
    update."""
    from llamole_tpu_torch.models.gllm import LLMConfig

    assert set(_FINETUNE_CPU) == set(chip_smoke.FINETUNE)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    phase20 = {}
    try:
        launches = chip_smoke.run_finetune(
            (), "CPU", device="cpu",
            sizes={**_FINETUNE_CPU, "cfg": LLMConfig.tiny()},
            build=_tiny_slice, phase20=phase20)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"B": 0, "C": 0}
    # phase 20 (c) on (a)'s model: its LongLoRA step on the tp mesh
    assert "phase 20 (c) LongLoRA micro step on the tp mesh dp:1,tp:1" in out
    assert phase20["c"]["s2_calls"] == 2
    assert phase20["c"]["loss_gap"] <= 1e-6
    for line in ("in the training forwards 8 (need 8 = 2 layers x 4 micro "
                 "steps), in generation 0",
                 "phase 16 (a) DoRA + LoRA+ (16.0) + shift_attn at 2 layers",
                 "phase 7's graph modules saved for (b) and (c)",
                 "adapter.msgpack rank 16 with m",
                 "with both LLMs widened to f32",
                 "reloaded bit-identically into a new Trainer",
                 "phase 16 (c) BAdam (4 blocks, switch every 1)",
                 "plain GIN calls"):
        assert line in out, line


def test_finetune_phase_sizes():
    """Phase 16 runs (a) at all 32 layers and cuts (b) and (c) only in
    depth; its optimizer settings are the finetuning arguments' defaults
    but LoRA+'s ratio and BAdam's switch interval."""
    from llamole_tpu_torch.config import FinetuningArguments

    sizes = chip_smoke.FINETUNE
    assert sizes["dora_layers"] == 32
    assert all(1 <= sizes[k] <= 32 for k in ("pissa_layers",
                                             "galore_layers",
                                             "badam_layers"))
    ft = FinetuningArguments()
    assert (sizes["galore_rank"], sizes["galore_update_interval"],
            sizes["galore_scale"], sizes["badam_n_blocks"]) == (
        ft.galore_rank, ft.galore_update_interval, ft.galore_scale,
        ft.badam_n_blocks)
    assert (sizes["loraplus_lr_ratio"], sizes["badam_switch_interval"]) == (
        16.0, 1)
    assert chip_smoke.PISSA_EXPORT_RANK == 2 * 8


def test_mesh_phase_runs_on_the_cpu(tmp_path, capsys):
    """Phase 18 end to end at a small width on a one-rank gloo group:
    phase 9's run_mmsft, then (a) ZeRO-1, (b) ZeRO-3 with DCP saves and
    (c) (b) resumed from its checkpoint-2, each loss and the bundles of
    (a) and (b) held to phase 9's, the resumed losses and bundle equal to
    (b)'s; the group is gone after."""
    import torch.distributed as dist

    from llamole_tpu_torch.ops import gin_aggregate as G
    from llamole_tpu_torch.train.workflow import run_mmsft

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, tok = _tiny_slice()
        start = {n: p.detach().clone()
                 for n, p in model.trainable_parameters().items()}
        p9 = tmp_path / "p9"
        run_mmsft(*chip_smoke.llama_lora_args(str(p9)), prebuilt=(model, tok))
        with open(p9 / "trainer_log.jsonl") as f:
            losses = [json.loads(line)["loss"] for line in f]
        final = {n: p.detach().clone()
                 for n, p in model.trainable_parameters().items()}
        launches = chip_smoke.run_mesh_training(
            model, tok, (None, G.gin_aggregate, G.gin_aggregate_backward),
            "CPU", str(tmp_path), {"losses": losses, "start": start,
                                   "final": final, "peak": "0.00 GiB"})
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert launches == {"B": 0, "C": 0}
    assert "mesh dp:1,tp:1 over gloo" in out
    assert "FSDP2 units" in out and "DCP async save checkpoint-2" in out
    assert "differs from (b)'s by 0.000e+00" in out
    for k in "ab":
        assert f"mesh ({k}): trained bundle after update 2 differs from " \
            "phase 9's by" in out
    assert not dist.is_initialized()


def test_phase20_sizes():
    """Phase 20 on the card: a world-size-1 mesh dp:1,tp:1, the ring at
    the 8B attention width (32 heads of 128) over 4096 tokens with 512
    padded, (b) and (c) gated as phase 19 gates its pipeline."""
    sizes = chip_smoke.PHASE20
    assert sizes["mesh"] == "dp:1,tp:1"
    assert (sizes["heads"], sizes["head_dim"], sizes["batch"], sizes["seq"],
            sizes["padded"]) == (32, 128, 1, 4096, 512)
    for k in ("loss_gap", "grad_rel", "leaf_rel"):
        assert sizes[k] == chip_smoke.MESH_INFER[k]


def test_phase21_sizes():
    """Phase 21 on the card: world-size-1 meshes dp:1,tp:1; run_molqa on
    phase 8's 2 records at 64 new tokens (phase 8's 128 halved: the
    placed int8 LLM decodes eagerly, and the phase's time budget is about
    90 s of the script's); the schemes' placed logits within the script's
    5e-2 of the largest logit (MERGE_LOGIT_TOL), the QLoRA losses within
    1e-3, (b) and (c) gated as phase 20 (b) and (c)."""
    sizes = chip_smoke.PHASE21
    assert sizes["mesh"] == "dp:1,tp:1"
    assert (sizes["records"], sizes["max_new_tokens"]) == (
        chip_smoke.MESH_INFER["records"], 64)
    assert sizes["logit_tol"] == chip_smoke.MERGE_LOGIT_TOL == 5e-2
    for k in ("loss_gap", "grad_rel", "leaf_rel"):
        assert sizes[k] == chip_smoke.PHASE20[k]


def test_ring_phase_runs_on_the_cpu(capsys):
    """Phase 20 (a) at a small size on a one-rank gloo group: the ring's
    output and gradients against the plain causal attention in bf16,
    within the phase's bounds; the group is gone after."""
    import torch.distributed as dist

    got = chip_smoke.run_ring("CPU", "cpu", {
        **chip_smoke.PHASE20, "heads": 2, "head_dim": 16, "seq": 64,
        "padded": 8})
    out = capsys.readouterr().out
    assert "phase 20 (a) ring_attention on the world-size-1 sp group at " \
        "[1, 64, 2, 16] bf16, the last 8 keys padded" in out
    assert got["out_gap"] <= chip_smoke.PHASE20["ring_out"]
    assert max(got["grad_gaps"]) <= chip_smoke.PHASE20["ring_grad"]
    assert not dist.is_initialized()


def test_mesh_inference_phase_sizes():
    """Phase 19 on the card: a world-size-1 mesh dp:1,tp:1 (one card),
    phase 8's 2 records, the pipeline at 2 microbatches held to the plain
    forward within 1e-3 (loss), 1e-2 (relative L2 of the LoRA gradients
    as one vector) and 5e-2 (of the largest leaf), a 64-token expansion
    and an 8 x 32 greedy decode."""
    sizes = chip_smoke.MESH_INFER
    assert sizes["mesh"] == "dp:1,tp:1"
    assert (sizes["records"], sizes["microbatches"]) == (2, 2)
    assert (sizes["loss_gap"], sizes["grad_rel"],
            sizes["leaf_rel"]) == (1e-3, 1e-2, 5e-2)
    assert (sizes["analysis_tokens"], sizes["decode_rows"],
            sizes["decode_steps"]) == (64, 8, 32)


def test_mesh_inference_phase_runs_on_the_cpu(tmp_path, capsys):
    """Phase 19 end to end at a small width on a one-rank gloo group,
    after phase 9's run_mmsft: the LLM copied back into plain tensors,
    run_molqa's design, an expansion and a greedy decode equal with and
    without the mesh (the LLM's leaves DTensors on it), and the pipelined
    loss and LoRA gradients on phase 9's last batch held to the plain
    forward's; the group is gone after."""
    import torch.distributed as dist

    from llamole_tpu_torch.ops import fused_attention as A
    from llamole_tpu_torch.ops import gin_aggregate as G
    from llamole_tpu_torch.train.workflow import run_mmsft

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, tok = _tiny_slice()
        batches, loss = [], model.loss

        def watched(batch, generator=None, train=True, noisy=None):
            if train:
                batches[:] = [batch]
            return loss(batch, generator, train, noisy)

        model.loss = watched
        run_mmsft(*chip_smoke.llama_lora_args(str(tmp_path / "p9")),
                  prebuilt=(model, tok))
        del model.loss
        got = chip_smoke.run_mesh_inference(
            model, tok, (A.fused_block_attention, G.gin_aggregate), "CPU",
            {"batch": batches[0]},
            sizes={**chip_smoke.MESH_INFER, "max_new_tokens": 8,
                   "analysis_tokens": 8, "decode_steps": 4})
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert {k: got[k] for k in ("A", "A_mma", "A_fma", "B")} == {
        "A": 0, "A_mma": 0, "A_fma": 0, "B": 0}
    assert "phase 19 (a) mesh dp:1,tp:1 over gloo" in out
    assert ("equal: {'analysis tokens': True, 'SMILES': True, 'responses': "
            "True, 'expansion': True, 'decode': True}") in out
    assert "phase 19 (b) pipeline_lm_loss on (4, " in out
    assert got["pipeline"]["loss_gap"] <= 1e-3
    assert got["pipeline"]["grad_rel"] <= 1e-2
    assert got["pipeline"]["leaf_max"] <= 5e-2
    assert "llm" not in dict(model.named_children())   # phase 18's copy freed
    assert not dist.is_initialized()


def test_flash_phase_sizes():
    """Phase 22 on the card: kernel E at the 8B's attention (32 query
    heads, 8 KV heads of 128) at the training step's 2048 tokens and at
    batch 2 x 1024, at head_dim 256 and in f32, padded on both sides;
    f32 within 1e-4 (the script's TOL), bf16 rows within 2 x the plain
    version's gap to the exact result plus a bf16 step; the steps at
    [1, 2048] and [1, 4096]."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    sizes = chip_smoke.PHASE22
    cfg = LLMConfig.llama3_8b()
    main = (1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    assert sizes["main"] == main and main + ("bf16",) in sizes["checks"]
    assert (2, 1024, 32, 8, 128, "bf16") in sizes["checks"]
    assert {c[4] for c in sizes["checks"]} == {128, 256}
    assert {c[5] for c in sizes["checks"]} == {"bf16", "f32"}
    assert sizes["f32_atol"] == 1e-4 and sizes["bf16_gap"] == 2.0
    assert (sizes["train_seq"], sizes["long_seq"]) == (2048, 4096)
    assert sizes["left_pad"] > 0 and sizes["right_pad"] > 0


def test_flash_bound_counts_the_causal_half_and_gqa_reads():
    """flash_bound at (1, 2048, 32, 8, 128) bf16 with no padding: the
    forward's two products over the causal half (~34.4 GFLOP) bind it at
    ~35 us, and the backward's five are 2.5 times that; k and v are read
    at their 8 KV heads."""
    s = 2048
    pairs = s * (s + 1) // 2
    seg = torch.ones((1, s), dtype=torch.int32)
    assert int(chip_smoke.flash_allowed(seg).sum()) == pairs
    fwd = chip_smoke.flash_bound((1, s, 32, 8, 128), torch.bfloat16, pairs,
                                 backward=False)
    bwd = chip_smoke.flash_bound((1, s, 32, 8, 128), torch.bfloat16, pairs,
                                 backward=True)
    flops = 4 * 32 * 128 * pairs
    assert abs(flops - 34.4e9) < 0.1e9
    assert fwd[1] == bwd[1] == "operations"
    assert fwd[0] == pytest.approx(flops / 989e12 * 1e3
                                   + 6 * 32 * pairs / 67e12 * 1e3)
    assert bwd[0] == pytest.approx(2.5 * flops / 989e12 * 1e3
                                   + 6 * 32 * pairs / 67e12 * 1e3)
    padded = seg.clone()
    padded[0, -300:] = 0
    assert int(chip_smoke.flash_allowed(padded).sum()) == (
        pairs - 300 * (s - 300))


def test_flash_bound_takes_f32_products_at_the_split_tf32_rate():
    """f32_tensor, the rate of f32 products on the tensor cores, is the
    dense TF32 rate over three passes (494.7 / 3 TFLOP/s, above the FMA
    units' 67): E's f32 check shape (1, 1024, 32, 8, 128), padded as
    phase 22 pads it (292,932 pairs a head), is bound by its operations
    at ~30 us forward and ~74 us backward (12.0 GFLOP of products), and
    kernel A's f32 main shape stays bound by its bytes."""
    assert chip_smoke.PEAK_OPS_PER_S["f32_tensor"] == pytest.approx(
        494.7e12 / 3)
    shape = (1, 1024, 32, 8, 128)
    seg = chip_smoke.flash_inputs(shape, torch.float32, chip_smoke.PHASE22,
                                  "cpu")[4]
    pairs = int(chip_smoke.flash_allowed(seg).sum())
    assert pairs == 292932
    fwd = chip_smoke.flash_bound(shape, torch.float32, pairs, backward=False)
    bwd = chip_smoke.flash_bound(shape, torch.float32, pairs, backward=True)
    products = 5 * 2 * 32 * 128 * pairs
    assert abs(products - 12.0e9) < 0.05e9
    assert fwd[1] == bwd[1] == "operations"
    assert bwd[0] == pytest.approx(products / (494.7e12 / 3) * 1e3
                                   + 6 * 32 * pairs / 67e12 * 1e3)
    assert 0.029 < fwd[0] < 0.031 and 0.073 < bwd[0] < 0.075
    b, n, h, heads = chip_smoke.MAIN_SHAPE
    assert chip_smoke.attention_bound(b, n, heads, h // heads,
                                      torch.float32, True)[1] == "bytes"


def test_bf16_step_is_one_unit_in_the_last_place():
    """bf16_step: 2^-7 at 1, 2^-5 (3.125e-2) in [4, 8), 2^-12 at 0.05:
    adding it to a bf16 value gives the next bf16 value."""
    x = torch.tensor([1.0, -1.5, 4.0, 7.9, 0.05, 3e-3])
    step = chip_smoke.bf16_step(x)
    assert step[:4].tolist() == [2 ** -7, 2 ** -7, 2 ** -5, 2 ** -5]
    assert step[4] == 2 ** -12
    b = x.abs().to(torch.bfloat16)
    up = (b.float() + step).to(torch.bfloat16).float()
    assert torch.equal(up - b.float(), step)


def test_flash_gate_passes_the_plain_version_and_fails_a_late_fault():
    """The bf16 check of phase 22 (a) (flash_gate, tile by tile) on the
    CPU at the main shape's length, two query heads on one KV head,
    padded: the plain version in bf16 held as the kernel passes it; the
    same with dv zeroed on a late tile of 64 keys or with out off by 5%
    on a late tile of 64 rows fails it, where the former limit, 2e-2 x
    max(1, max |plain|), passes both. (The faults sit on real rows before
    the right-padded tail, whose pad keys the pad queries attend with
    large weights.)"""
    from llamole_tpu_torch.ops.flash_attention import (
        flash_attention_reference as ref)
    sizes = chip_smoke.PHASE22
    shape = (1, 2048, 2, 1, 128)
    q, k, v, dout, seg = chip_smoke.flash_inputs(
        shape, torch.bfloat16, {"left_pad": 9, "right_pad": 40}, "cpu")
    out, grads = chip_smoke._flash_grads(ref, q, k, v, dout, seg)
    plain = (out, *grads)
    exact = chip_smoke._flash_grads(ref, *(t.float() for t in (q, k, v,
                                                                dout)), seg)
    exact = (exact[0], *exact[1])
    gap = sizes["bf16_gap"]
    for got, want, x in zip(plain, plain, exact):
        assert chip_smoke.flash_gate(got, want, x, 128, gap) <= 0.5
    tile = slice(shape[1] - 128, shape[1] - 64)
    dv = plain[3].clone()
    dv[:, tile] = 0
    late = plain[0].clone()
    late[:, tile] = (late[:, tile].float() * 1.05).to(torch.bfloat16)
    for got, want, x in ((dv, plain[3], exact[3]),
                         (late, plain[0], exact[0])):
        assert chip_smoke.flash_gate(got, want, x, 128, gap) > 1.0
        old = float((got.float() - want.float()).abs().max()) / max(
            1.0, float(want.float().abs().max()))
        assert old < 2e-2


def test_flash_phase_runs_on_the_cpu(capsys, monkeypatch):
    """Phase 22 (b) and (c) at a small width on the CPU, the route forced
    on (the gate reads a CUDA device; here the plain version runs): the
    causal-LM and GraphLM.loss flash steps' losses and LoRA gradients
    held to the plain steps', no plain attention call in the flash
    steps, the LLM's use_flash off again after."""
    import llamole_tpu_torch.models.gllm.model as gllm
    from llamole_tpu_torch.models.gllm import LLM, LLMConfig

    gate = gllm.flash_ok
    monkeypatch.setattr(gllm, "flash_ok",
                        lambda cfg, s, device: gate(cfg, s, "cuda"))
    cfg = LLMConfig(vocab_size=512, hidden_size=256, intermediate_size=256, num_layers=2,
                    num_heads=2, num_kv_heads=1, head_dim=128,
                    rope_theta=10000.0, rope_scaling=None,
                    max_position_embeddings=4096, flash_min_seq=128)
    llm = LLM(cfg, dtype=torch.bfloat16)
    llm.reset_parameters(torch.Generator().manual_seed(0))
    model, tok = _tiny_slice(llm)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = chip_smoke.run_flash(model, tok, "CPU", "cpu", {
            **chip_smoke.PHASE22, "train_seq": 512, "long_seq": 1024})
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert ("phase 22 (b) causal-LM loss + backward at [1, 512] (512 "
            "real tokens)") in out
    assert "phase 22 (b) GraphLM.loss + backward, a right-padded tail," in out
    assert ("phase 22 (c) causal-LM loss + backward at [1, 1024] (1024 "
            "real tokens)") in out
    for pair in (got["train"], got["padded"]):
        assert pair["plain"]["plain"] == cfg.num_layers
        assert pair["flash"]["plain"] == 0
        assert pair["grad_rel"] < chip_smoke.PHASE22["grad_rel"]
    assert got["long"]["plain"] == 0
    assert not model.llm.cfg.use_flash


def test_flash_gemma_config_is_gemma_7b():
    """Phase 22 (d)'s model: PHASE22["gemma7b"] is google/gemma-7b's
    published config.json, and from_hf_config reads it as gemma-1 at full
    width (3072 wide, 24576 MLP, 16 heads of 256 with one KV head each,
    256000 tokens, tied embeddings) with no softcap, window or query
    scale, so the flash route takes it at head_dim 256 on the card; (d)
    runs it at all 28 layers, and phase 22 (a) checks the kernels at its
    step's shape."""
    import llamole_tpu_torch.models.gllm.model as gllm
    from llamole_tpu_torch.models.gllm import LLMConfig
    sizes = chip_smoke.PHASE22
    cfg = LLMConfig.from_hf_config(sizes["gemma7b"])
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.vocab_size) == (3072, 24576, 28, 16, 16, 256, 256000)
    assert cfg.tie_word_embeddings and cfg.hidden_act == "gelu_tanh"
    assert cfg.rms_norm_unit_offset and cfg.scale_embeddings
    assert (cfg.attn_logit_softcap, cfg.query_scale,
            cfg.sliding_window) == (None, None, None)
    assert sizes["gemma_layers"] == cfg.num_layers
    cfg.use_flash = True
    assert gllm.flash_ok(cfg, sizes["train_seq"], "cuda")
    assert not gllm.flash_ok(cfg, sizes["train_seq"], "cpu")
    wide = [c for c in sizes["checks"] if c[4] == 256]
    assert (1, 1024, cfg.num_heads, cfg.num_kv_heads, 256, "bf16") == wide[0]
    assert {c[2] // c[3] for c in wide} == {1, 2}
    # the kernels are held to the plain version at the shape (d) sends them
    assert (1, sizes["train_seq"], cfg.num_heads, cfg.num_kv_heads, 256,
            "bf16") in wide


def test_flash_gemma_phase_runs_on_the_cpu(capsys, monkeypatch):
    """Phase 22 (d) at a small width on the CPU: gemma-7b's config dict
    with 2 layers of 2 heads of 256 (the route's head dim), 256 wide,
    through from_hf_config, the route forced on (here the plain version
    runs): the flash step's loss and LoRA gradients held to the plain
    step's, every layer on the route and none on the plain attention,
    the slice freed after."""
    import llamole_tpu_torch.models.gllm.model as gllm

    gate = gllm.flash_ok
    monkeypatch.setattr(gllm, "flash_ok",
                        lambda cfg, s, device: gate(cfg, s, "cuda"))
    sizes = {**chip_smoke.PHASE22, "gemma_layers": 2, "train_seq": 1024,
             "gemma7b": {**chip_smoke.PHASE22["gemma7b"], "vocab_size": 512,
                         "hidden_size": 256, "intermediate_size": 256,
                         "num_attention_heads": 2,
                         "num_key_value_heads": 2}}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = chip_smoke.run_flash_gemma("CPU", "cpu", sizes, _tiny_slice)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert ("phase 22 (d) gemma-7b (256 wide, 2 x 256 heads, 2 layers) "
            "causal-LM loss + backward at [1, 1024] (1024 real tokens)") in out
    assert got["plain"]["plain"] == 2 and got["flash"]["plain"] == 0
    assert got["loss_gap"] <= sizes["loss_gap"] * abs(got["plain"]["loss"])
    assert got["grad_rel"] < sizes["grad_rel"]
    assert got["kernels"] == {} and got["timed"] == {} and got["wall"] > 0


def test_flash_f32_phase_sizes():
    """Phase 22 (e) and its checks: the 8B (4096 wide, 14336 MLP, 32 heads
    of 128 on 8 KV heads, 128256 tokens, all 32 layers) in f32 at [1,
    1024], the route's shortest sequence, every layer one launch of each
    of E's kernels (no remat); the loss within 1e-4 of the loss and the
    LoRA gradients within 1e-3 (relative L2), far tighter than bf16's 5e-2;
    phase 22 (a) checks the f32 kernels at the 8B's heads and at 16 heads
    of 256 on 8 KV heads, and the f32 route routes there."""
    import llamole_tpu_torch.models.gllm.model as gllm
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.ops import flash_attention as E
    sizes = chip_smoke.PHASE22
    cfg = LLMConfig.llama3_8b()
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim_, cfg.vocab_size,
            cfg.num_layers) == (4096, 14336, 32, 8, 128, 128256, 32)
    assert not cfg.remat
    assert sizes["f32_seq"] == cfg.flash_min_seq == 1024
    assert (sizes["f32_loss_gap"], sizes["f32_grad_rel"]) == (1e-4, 1e-3)
    f32 = [tuple(c[:5]) for c in sizes["checks"] if c[5] == "f32"]
    assert f32 == [(1, 1024, 32, 8, 128), (1, 1024, 16, 8, 256)]
    assert {E.backward_body(torch.float32, c[4]) for c in f32} == {"tf32x3"}
    cfg.use_flash = True
    assert gllm.flash_ok(cfg, sizes["f32_seq"], "cuda")
    assert not gllm.flash_ok(cfg, sizes["f32_seq"] - 128, "cuda")


def test_flash_f32_phase_runs_on_the_cpu(capsys, monkeypatch):
    """Phase 22 (e) at a small width on the CPU: a 2-layer LLM of two
    query heads of 128 on one KV head in f32 (LLM.dtype), the route forced
    on (here the plain version runs): the flash step's loss within 1e-4 x
    loss and its LoRA gradients within 1e-3 of the plain f32 step's, every
    layer on the route and none on the plain attention, no card times."""
    import llamole_tpu_torch.models.gllm.model as gllm
    from llamole_tpu_torch.models.gllm import LLMConfig

    gate = gllm.flash_ok
    monkeypatch.setattr(gllm, "flash_ok",
                        lambda cfg, s, device: gate(cfg, s, "cuda"))
    cfg = LLMConfig(vocab_size=512, hidden_size=256, intermediate_size=256,
                    num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                    rope_theta=10000.0, rope_scaling=None,
                    max_position_embeddings=4096, flash_min_seq=128)
    sizes = {**chip_smoke.PHASE22, "f32_seq": 256}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = chip_smoke.run_flash_f32("CPU", "cpu", sizes, _tiny_slice, cfg)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert ("phase 22 (e) Llama-3.1-8B in f32 (256 wide, 2 x 128 heads, 1 "
            "KV heads, 2 layers) causal-LM loss + backward at [1, 256] (256 "
            "real tokens)") in out
    assert got["plain"]["plain"] == 2 and got["flash"]["plain"] == 0
    assert got["loss_gap"] <= 1e-4 * abs(got["plain"]["loss"])
    assert got["grad_rel"] < 1e-3
    assert got["kernels"] == {} and got["timed"] == {} and got["wall"] > 0


def test_flash_f32_gemma_phase_runs_on_the_cpu(capsys, monkeypatch):
    """Phase 22 (f) at a small width on the CPU: gemma-7b's config dict
    with 2 layers of 2 heads of 256 (the route's head dim), 256 wide,
    through from_hf_config, in f32 (LLM.dtype), the route forced on (here
    the plain version runs): the flash step's loss within 1e-4 x loss and
    its LoRA gradients within 1e-3 of the plain f32 step's, every layer on
    the route and none on the plain attention, no card times."""
    import llamole_tpu_torch.models.gllm.model as gllm

    gate = gllm.flash_ok
    monkeypatch.setattr(gllm, "flash_ok",
                        lambda cfg, s, device: gate(cfg, s, "cuda"))
    sizes = {**chip_smoke.PHASE22, "gemma_layers": 2, "f32_seq": 1024,
             "gemma7b": {**chip_smoke.PHASE22["gemma7b"], "vocab_size": 512,
                         "hidden_size": 256, "intermediate_size": 256,
                         "num_attention_heads": 2,
                         "num_key_value_heads": 2}}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = chip_smoke.run_flash_f32_gemma("CPU", "cpu", sizes,
                                             _tiny_slice)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert ("phase 22 (f) gemma-7b in f32 (256 wide, 2 x 256 heads, 2 "
            "layers) causal-LM loss + backward at [1, 1024] (1024 real "
            "tokens)") in out
    assert got["plain"]["plain"] == 2 and got["flash"]["plain"] == 0
    assert got["loss_gap"] <= 1e-4 * abs(got["plain"]["loss"])
    assert got["grad_rel"] < 1e-3
    assert got["kernels"] == {} and got["timed"] == {} and got["wall"] > 0
