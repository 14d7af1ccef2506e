"""`python -m llamole_tpu_torch <command>` (llamole_tpu_torch/cli.py)
against the JAX package's dispatcher (llamole_tpu/cli.py, `python
main.py`), on the CPU: pretrain's kwarg typing and its bad usage (the same
kwargs reach both packages' functions), validate_data's JSON and exit
code on every data/*.json, serve's --tcp parsing, the unknown-command and
download_data exits, env, and train -> export -> eval run end to end on
tiny configs with --device cpu (the default device is the card)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import llamole_tpu.cli as jcli
import llamole_tpu.train.pretrain as jpt
import llamole_tpu_torch.train.pretrain as tpt
from llamole_tpu.utils import cache as jcache
from llamole_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
KINDS = {"graphdit": "pretrain_graphdit", "predictor": "pretrain_predictor",
         "cost_mlp": "pretrain_cost_mlp", "graphclip": "pretrain_graphclip",
         "oracle": "pretrain_property_oracle"}


def _jax_main(monkeypatch, *args):
    """llamole_tpu.cli.main as `python main.py <args>` runs it (without
    its XLA compile cache, which would move the tests' cache)."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["main.py", *args])
    jcli.main()


def _recorders(monkeypatch, module):
    calls = {}
    for kind, name in KINDS.items():
        def fake(corpus, outdir, _kind=kind, **kw):
            calls.update(kind=_kind, corpus=corpus, outdir=outdir, **kw)
            return {"final_loss": 0.0}
        monkeypatch.setattr(module, name, fake)
    return calls


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pretrain_dispatch_and_kwarg_typing(monkeypatch, capsys, kind):
    argv = [kind, "corpus.json", "out/", "steps=40", "learning_rate=2e-3",
            "hidden_size=32", "name=abc"]
    theirs = _recorders(monkeypatch, jpt)
    jcli.run_pretrain(argv)
    ours = _recorders(monkeypatch, tpt)
    cli.main(["pretrain", *argv])
    assert ours.pop("device") == "cuda"     # the default device
    assert ours == theirs
    assert theirs["kind"] == kind and theirs["steps"] == 40
    assert isinstance(theirs["steps"], int)
    assert theirs["learning_rate"] == pytest.approx(2e-3)
    assert theirs["name"] == "abc"
    cli.main(["pretrain", "--device", "cpu", *argv])
    assert ours["device"] == "cpu"
    out = capsys.readouterr().out
    assert out.count("{'final_loss': 0.0}") == 3


@pytest.mark.parametrize("argv,match", [
    (["nope", "c.json", "out/"], "usage"),
    (["oracle"], "usage"),
    (["oracle", "c.json", "out/", "steps40"], "key=value"),
])
def test_pretrain_dispatch_rejects_bad_usage(argv, match):
    with pytest.raises(SystemExit, match=match) as theirs:
        jcli.run_pretrain(argv)
    with pytest.raises(SystemExit, match=match) as ours:
        cli.run_pretrain(argv)
    assert str(ours.value).replace("python -m llamole_tpu_torch",
                                   "python main.py") == str(theirs.value)


@pytest.mark.parametrize("path", sorted((ROOT / "data").glob("*.json")),
                         ids=lambda p: p.name)
def test_validate_data_equals_jax(monkeypatch, capsys, path):
    """The same printed report and exit code (2 when not ok), or the same
    error for a file that is not a list of records."""
    def run(fn):
        try:
            fn()
            code = 0
        except SystemExit as e:
            code = e.code
        except ValueError as e:
            code = f"ValueError: {e}"
        return code, capsys.readouterr().out

    theirs = run(lambda: _jax_main(monkeypatch, "validate_data", str(path)))
    ours = run(lambda: cli.main(["validate_data", str(path)]))
    assert ours == theirs
    if path.name.startswith("molqa_"):
        assert json.loads(ours[1])["ok"] and ours[0] == 0


def test_validate_data_fails_with_code_2(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"instruction": "x", "output": "no mol"}]))
    with pytest.raises(SystemExit) as e:
        cli.main(["validate_data", str(bad)])
    assert e.value.code == 2
    assert json.loads(capsys.readouterr().out)["ok"] is False


@pytest.mark.parametrize("args,want", [
    (["cfg.yaml"], ("jsonl", "cfg.yaml", None)),
    (["cfg.yaml", "--tcp"], ("tcp", "cfg.yaml", 7733)),
    (["cfg.yaml", "--tcp", "8123"], ("tcp", "cfg.yaml", 8123)),
    (["--tcp", "8123", "cfg.yaml"], ("tcp", "cfg.yaml", 8123)),
    (["--tcp", "cfg.yaml"], ("tcp", "cfg.yaml", 7733)),
    ([], ("jsonl", None, None)),
])
def test_serve_tcp_parsing_equals_jax(monkeypatch, args, want):
    import llamole_tpu.serve as jserve
    import llamole_tpu_torch.serve as tserve

    got = {}
    for module, key in ((jserve, "jax"), (tserve, "port")):
        monkeypatch.setattr(module, "serve_tcp", lambda c, port, _k=key,
                            **kw: got.update({_k: ("tcp", c, port, kw)}))
        monkeypatch.setattr(module, "serve_jsonl", lambda c, _k=key, **kw:
                            got.update({_k: ("jsonl", c, None, kw)}))
    _jax_main(monkeypatch, "serve", *args)
    cli.main(["serve", *args])
    assert got["jax"][:3] == got["port"][:3] == want
    assert got["jax"][3] == {} and got["port"][3] == {"device": "cuda"}
    cli.main(["serve", "--device=cpu", *args])
    assert got["port"][3] == {"device": "cpu"}


def test_unknown_command_and_bare_call_exit(monkeypatch):
    with pytest.raises(SystemExit, match="unknown command 'frobnicate'"):
        cli.main(["frobnicate"])
    with pytest.raises(SystemExit, match="unknown command"):
        _jax_main(monkeypatch, "frobnicate")
    with pytest.raises(SystemExit, match="usage: python -m llamole_tpu_torch"):
        cli.main([])
    with pytest.raises(SystemExit, match="--device needs a value"):
        cli.main(["env", "--device"])


def test_download_data_refuses_and_fetches_nothing(monkeypatch, tmp_path):
    """It names the network and the offline example files, and touches
    neither the network nor the disk."""
    import socket

    def no_network(*args, **kwargs):
        raise AssertionError("download_data opened a socket")

    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["download_data"])
    message = str(e.value)
    assert "needs the network" in message
    for name in ("molqa_train_examples", "molqa_drug_examples",
                 "molqa_material_examples"):
        assert name in message
    assert os.listdir(tmp_path) == []


def test_env_prints_the_device(capsys):
    cli.main(["env", "--device", "cpu"])
    lines = dict(line.split(": ", 1)
                 for line in capsys.readouterr().out.splitlines())
    assert lines["default_device"] == "cpu"
    assert lines["torch"] == torch.__version__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["env"])


def test_python_dash_m_runs_the_dispatcher():
    proc = subprocess.run(
        [sys.executable, "-m", "llamole_tpu_torch", "env", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "default_device: cpu" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "llamole_tpu_torch", "frobnicate"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "unknown command" in proc.stderr


def test_train_export_eval_run_on_tiny_configs(tmp_path, monkeypatch):
    """train, export and eval through cli.main with --device cpu on the
    smoke configs: the adapter, the merged export and the eval results
    are written, and LLAMOLE_TRACE_DIR traces a command."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.chdir(ROOT)
    try:
        train = tmp_path / "train.yaml"
        train.write_text((ROOT / "config/smoke/tiny_train.yaml").read_text()
                         .replace("saves/tiny-smoke", str(tmp_path / "t")))
        cli.main(["train", str(train), "--device", "cpu"])
        assert (tmp_path / "t" / "adapter.msgpack").exists()
        export = tmp_path / "export.yaml"
        export.write_text(
            'model_name_or_path: ""\n'
            f"adapter_name_or_path: {tmp_path / 't'}\n"
            "template: default\nfinetuning_type: lora\nlora_rank: 4\n"
            f"export_dir: {tmp_path / 'merged'}\n")
        cli.main(["export", "--device", "cpu", str(export)])
        assert (tmp_path / "merged" / "model.safetensors").exists()
        evaluate = tmp_path / "eval.yaml"
        evaluate.write_text(
            (ROOT / "config/smoke/tiny_eval.yaml").read_text()
            .replace("saves/tiny-eval", str(tmp_path / "e")))
        monkeypatch.setenv("LLAMOLE_TRACE_DIR", str(tmp_path / "trace"))
        cli.main(["eval", str(evaluate), "--device=cpu"])
    finally:
        torch.set_num_threads(threads)
    with open(tmp_path / "e" / "molqa_results.json") as f:
        summary = json.load(f)["summary"]
    assert summary["num_records"] == 4 and summary["validity"] is not None
    assert len(os.listdir(tmp_path / "trace")) == 1
