"""The port's one-command parity eval (llamole_tpu_torch/eval/parity.py)
against the JAX package's (llamole_tpu/eval/parity.py), on the CPU:
discover_checkpoints on tiny reference-layout directories (and its
ambiguity errors), _flatten_table on the same summaries, _convert_all's
trees byte for byte (and its skip of kinds already converted), and
run_parity end to end through `python -m llamole_tpu_torch parity
--device cpu` over a tiny composite's saved graph modules, writing
parity_table.json with JAX's keys and a non-null validity."""

import json
import math
import os
import shutil

import pytest
import torch

from llamole_tpu.eval import parity as jparity
from llamole_tpu_torch import cli
from llamole_tpu_torch.eval import parity
from test_torch_convert import _reference_state_dicts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_checkpoints(root):
    """The reference's HF checkout layout under root: GraphDiT, the
    GraphCLIP encoder, the GNN predictor, the connectors and a base LLM
    directory (config.json + safetensors), from a numpy seed."""
    dit, encoder, proj, predictor, connectors = _reference_state_dicts()
    dirs = {"graphdit": {"model.pt": dit},
            "encoder": {"model.pt": encoder, "model_proj.pt": proj},
            "predictor": {"model.pt": predictor},
            "adapter": connectors}
    for name, files in dirs.items():
        os.makedirs(os.path.join(root, f"Llamole-{name}"))
        for fname, sd in files.items():
            torch.save(sd, os.path.join(root, f"Llamole-{name}", fname))
    with open(os.path.join(root, "Llamole-graphdit", "config.yaml"), "w") as f:
        f.write("hidden_size: 32\n")
    with open(os.path.join(root, "Llamole-encoder", "model_config.json"),
              "w") as f:
        f.write("{}")
    with open(os.path.join(root, "Llamole-predictor",
                           "label_to_template.csv.gz"), "wb") as f:
        f.write(b"x")
    _base_llm(os.path.join(root, "Llama-3.1-8B"))


def _base_llm(path):
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write("{}")
    open(os.path.join(path, "model.safetensors"), "wb").close()


def _discover(module, path):
    try:
        return module.discover_checkpoints(path)
    except ValueError as e:
        return f"ValueError: {e}"


def test_discover_checkpoints_equals_jax(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _reference_checkpoints(ckpt)
    found = parity.discover_checkpoints(ckpt)
    assert found == jparity.discover_checkpoints(ckpt)
    assert {k: os.path.basename(v) for k, v in found.items()} == {
        "graphdit": "Llamole-graphdit", "encoder": "Llamole-encoder",
        "predictor": "Llamole-predictor", "adapter": "Llamole-adapter",
        "base_llm": "Llama-3.1-8B"}
    # the checkout itself as one module's directory
    one = str(tmp_path / "ckpt" / "Llamole-predictor")
    assert _discover(parity, one) == _discover(jparity, one) == {
        "predictor": one}
    # a model.pt directory with every marker is the predictor, only
    mixed = tmp_path / "mixed"
    shutil.copytree(one, mixed / "p")
    for name in ("model_proj.pt", "config.yaml"):
        (mixed / "p" / name).write_text("")
    assert _discover(parity, str(mixed)) == _discover(jparity, str(mixed)) \
        == {"predictor": str(mixed / "p")}


@pytest.mark.parametrize("copy", ["Llamole-graphdit", "Llamole-encoder",
                                  "Llamole-adapter", "Llama-3.1-8B"])
def test_discover_checkpoints_ambiguity_equals_jax(tmp_path, copy):
    ckpt = tmp_path / "ckpt"
    _reference_checkpoints(str(ckpt))
    shutil.copytree(ckpt / copy, ckpt / f"{copy}-again")
    ours, theirs = _discover(parity, str(ckpt)), _discover(jparity, str(ckpt))
    assert ours == theirs and ours.startswith("ValueError: ambiguous")


_SUMMARIES = [
    {},
    {"validity": 0.5, "retro_success": 0.25, "num_records": 4,
     "molecules_per_min": 1.5, "uniqueness": 1.0, "novelty": 0.75,
     "fgd": 3.25, "text_metrics": {"bleu-4": 0.1, "rouge-1": 0.2,
                                   "rouge-2": 0.3, "rouge-l": 0.4},
     "property_accuracy": {"BBBP": 1.0, "HIV": 0.0, "BACE": 0.5},
     "property_mae": {"CO2": 1.0, "N2": 2.0, "O2": 3.0, "FFV": 0.1,
                      "TC": 0.2, "SC": 0.3, "SA": 0.4}},
    {"validity": 1.0, "retro_success": None, "num_records": 1,
     "property_accuracy": {"HIV": 1.0}, "property_mae": {"SA": 0.5}},
]


@pytest.mark.parametrize("summary", _SUMMARIES, ids=["empty", "full",
                                                     "partial"])
def test_flatten_table_equals_jax(summary):
    ours = parity._flatten_table(summary)
    theirs = jparity._flatten_table(summary)
    assert list(ours.items()) == list(theirs.items())
    assert len(ours) == 21


def test_convert_all_writes_the_jax_trees_and_skips_done_kinds(
        tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    _reference_checkpoints(ckpt)
    sources = {k: v for k, v in parity.discover_checkpoints(ckpt).items()
               if k != "base_llm"}
    ours = parity._convert_all(sources, str(tmp_path / "port"))
    theirs = jparity._convert_all(sources, str(tmp_path / "jax"))
    assert {k: os.path.relpath(v, tmp_path / "port")
            for k, v in ours.items()} == {
        k: os.path.relpath(v, tmp_path / "jax") for k, v in theirs.items()}
    files = []
    for base, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(base, n), tmp_path / "jax")
                  for n in names]
    assert len(files) == 9
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as a, \
                open(tmp_path / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    # a second run converts nothing
    from llamole_tpu_torch.models import refconvert

    def refuse(src, dst):
        raise AssertionError(f"converted {src} again")

    for kind in ("graphdit", "encoder", "predictor", "connectors"):
        monkeypatch.setattr(refconvert, f"convert_{kind}", refuse)
    assert parity._convert_all(sources, str(tmp_path / "port")) == ours


def test_run_parity_end_to_end_on_the_cpu(tmp_path, capsys):
    """`parity --device cpu` over a tiny composite's graph modules (placed
    where the conversion would put them, so it is skipped) and an oracle
    trained by the port: the table has JAX's keys, validity and the
    oracle's property metrics are not null, and it is the file written."""
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.train.pretrain import pretrain_property_oracle

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model_args, data_args, _, ft_args, _ = get_infer_args(
            os.path.join(ROOT, "config/smoke/tiny_eval.yaml"))
        model, _ = build_graph_lm(model_args, data_args, ft_args,
                                  device="cpu", generate_mode=True)
        modules = tmp_path / "modules"
        model.save_pretrained(str(modules), save_graph_modules=True)
        del model
        out = tmp_path / "parity"
        for kind, name in (("graphdit", "graph_decoder"),
                           ("encoder", "graph_encoder"),
                           ("predictor", "graph_predictor")):
            os.makedirs(out / "converted", exist_ok=True)
            os.symlink(modules / name, out / "converted" / kind)
        pretrain_property_oracle(
            os.path.join(ROOT, "data/molqa_train_examples.json"),
            str(tmp_path / "oracle"), steps=4, hidden_size=16, num_layer=2,
            device="cpu")
        capsys.readouterr()
        cli.main(["parity", "--graphdit", str(modules / "graph_decoder"),
                  "--encoder", str(modules / "graph_encoder"),
                  "--predictor", str(modules / "graph_predictor"),
                  "--oracle", str(tmp_path / "oracle"),
                  "--dataset-dir", os.path.join(ROOT, "data"),
                  "--records", "2", "--batch", "2", "--iterations", "1",
                  "--topk", "2", "--max-planning-time", "2",
                  "--out", str(out), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    with open(out / "parity_table.json") as f:
        table = json.load(f)
    assert list(table) == list(jparity._flatten_table({}))
    assert table["num_records"] == 2
    assert table["validity"] is not None and 0.0 <= table["validity"] <= 1.0
    assert "parity table (vs arXiv 2410.04223 paper metrics):" in printed
    with open(out / "molqa_results.json") as f:
        summary = json.load(f)["summary"]
    assert summary["planning_wall"] == "per_molecule"
    assert summary["design_resamples"] == 0
    assert "property_accuracy" in summary and "property_mae" in summary
    assert not any(isinstance(v, float) and math.isnan(v)
                   for v in (table["validity"], table["fgd"]))


def test_the_smoke_script_checks_the_jax_keys():
    """chip_smoke.py (which imports no JAX) holds the card's
    parity_table.json to its PARITY_KEYS: the JAX package's keys."""
    import chip_smoke

    assert chip_smoke.PARITY_KEYS == tuple(jparity._flatten_table({}))
