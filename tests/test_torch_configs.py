"""llamole_tpu_torch's re-declared configs stay equal to the JAX ones, its
first-party YAML reads every config file as PyYAML does, and the port
never imports JAX, flax, msgpack, safetensors, PyYAML nor anything of the
JAX package."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from llamole_tpu.models.gllm.config import LLMConfig as JaxLLMConfig
from llamole_tpu.models.graphdit.config import GraphDiTConfig as JaxDiTConfig
from llamole_tpu_torch.models.gllm.config import LLMConfig
from llamole_tpu_torch.models.graphdit.config import GraphDiTConfig


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("ours,theirs", [(LLMConfig, JaxLLMConfig),
                                         (GraphDiTConfig, JaxDiTConfig)])
def test_config_fields_equal_jax(ours, theirs):
    assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("preset", ["llama3_8b", "qwen2_7b", "mistral_7b",
                                    "tiny"])
def test_llm_presets_equal_jax(preset):
    assert (dataclasses.asdict(getattr(LLMConfig, preset)())
            == dataclasses.asdict(getattr(JaxLLMConfig, preset)()))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import llamole_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'llamole_tpu_torch.') if m.ispkg or m.module_finder.find_spec("
        "m.name).origin.endswith('.py')]   # not the built chemkit.so\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 15, names\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'yaml') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


ROOT = pathlib.Path(__file__).resolve().parents[1]

# what the port must never import: the JAX package, JAX, the msgpack stack
# flax checkpoints are otherwise read with, the safetensors package and
# PyYAML (the port reads and writes both formats itself)
REFUSED = ("llamole_tpu", "jax", "flax", "msgpack", "safetensors", "yaml")

# Installed first in the subprocess below: any import of a REFUSED package
# (at module top or deferred inside a function) raises.
_REFUSE_JAX_PACKAGE = """
import importlib.abc, sys
REFUSED = %r
class _RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"the port imported {name}")
        return None
sys.meta_path.insert(0, _RefuseJaxPackage())
""" % (REFUSED,)

_DRIVE_THE_PORT = r"""
import dataclasses, importlib, io, json, pkgutil, tempfile
import torch
import llamole_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "llamole_tpu_torch."):
    if m.ispkg or m.module_finder.find_spec(m.name).origin.endswith(".py"):
        importlib.import_module(m.name)   # not the built chemkit.so

from llamole_tpu_torch.config import get_infer_args, get_train_args
from llamole_tpu_torch.models.composite import GenerationSettings
from llamole_tpu_torch.models.loader import build_graph_lm
from llamole_tpu_torch.serve import DesignServer, serve_stream
from llamole_tpu_torch.train.workflow import run_mmsft

torch.set_num_threads(1)
model_args, data_args, _, ft_args, _ = get_infer_args(
    "config/smoke/tiny_eval.yaml")
model, tok = build_graph_lm(model_args, data_args, ft_args, device="cpu",
                            generate_mode=True)
gen = GenerationSettings(max_new_tokens=4)
server = DesignServer(model, tok, batch_size=2, max_wait_s=0.1, gen=gen,
                      retro_iterations=1, retro_max_time=60.0).start()
out = io.StringIO()
try:
    serve_stream(server, io.StringIO(
        json.dumps({"prompt": "Design.", "property": {"SA": 2.0}}) + "\n"
        + json.dumps({"prompt": "Plan it.", "retro": True}) + "\n"), out,
        join_timeout=300)
finally:
    server.stop()
answers = [json.loads(line) for line in out.getvalue().splitlines()]
assert len(answers) == 2 and not any("error" in a for a in answers), answers
# a route search on an ester the built-in templates split: the planner,
# the template predictor, template application and the fingerprints
plans = model.retrosynthesize_batch(
    ["CC(=O)OCC"], generator=torch.Generator().manual_seed(0),
    iterations=1, gen=GenerationSettings(max_new_tokens=4, do_sample=False))
assert plans["CC(=O)OCC"]["expansions"] >= 1, plans

args = list(get_train_args("config/smoke/tiny_train.yaml"))
with tempfile.TemporaryDirectory() as out_dir:
    args[2] = dataclasses.replace(args[2], output_dir=out_dir, max_steps=1)
    metrics = run_mmsft(*args, device="cpu")
assert metrics["train_steps"] == 1, metrics

# a stack directory written by the port's own pretraining loads back
from llamole_tpu_torch.eval.scoring import oracle_property_metrics
from llamole_tpu_torch.train import stack
with tempfile.TemporaryDirectory() as d:
    stack.main(["--tiny", "--device", "cpu", "--stack-dir", d, "--stages",
                "corpus,graphdit,predictor,cost_mlp,graphclip,oracle,"
                "llm_config"])
    paths = stack.stack_paths(d)
    m_args, d_args, _, f_args, _ = get_infer_args(stack.eval_args(
        paths, stack.sizes(True)["eval"], 0))
    model, _ = build_graph_lm(m_args, d_args, f_args, device="cpu")
    assert model.cost_mlp is not None and model.llm.cfg.hidden_size == 64
    scores = oracle_property_metrics(paths["oracle"], [
        {"llm_smiles": "CCO", "property": {"SA": 2.0, "HIV": 1.0}}])
    assert scores["property_scored_counts"] == {"HIV": 1, "SA": 1}, scores

# weight interchange: an HF export of the LLM, merge_adapter over it with
# a save_pretrained adapter, and the merged export loaded back
from llamole_tpu_torch.models.gllm.convert import export_hf_weights
from llamole_tpu_torch.train.export import merge_adapter
with tempfile.TemporaryDirectory() as d:
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    export_hf_weights(model.llm, d + "/base", shard_gb=1e-4)
    model.save_pretrained(d + "/adapter")
    args = {"model_name_or_path": d + "/base", "template": "default",
            "finetuning_type": "lora", "lora_rank": ft_args.lora_rank,
            "compute_dtype": model_args.compute_dtype,
            "adapter_name_or_path": d + "/adapter"}
    merge_adapter(dict(args, export_dir=d + "/merged"), device="cpu")
    m_args, d_args, _, f_args, _ = get_infer_args(dict(
        args, model_name_or_path=d + "/merged", finetuning_type="freeze",
        adapter_name_or_path=d + "/merged"))
    merged, _ = build_graph_lm(m_args, d_args, f_args, device="cpu",
                               load_adapter=True)
    assert not any("lora_" in n for n, _ in merged.llm.named_parameters())
bad = [m for m in sys.modules if m.split(".")[0] in
       ("llamole_tpu", "jax", "flax", "msgpack", "optax", "safetensors",
        "yaml")]
assert not bad, bad
print("ok")
"""


def test_port_runs_with_the_jax_package_refused():
    """Every module of the port imports, a design + retro request through
    DesignServer and one training step on the smoke configs run, the
    graph modules of a tiny stack pretrain, save and load back, and an HF
    export, merge_adapter and the merged export's reload run, with any
    import of llamole_tpu, jax, flax, msgpack, safetensors or PyYAML
    refused: deferred imports included."""
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE_JAX_PACKAGE + _DRIVE_THE_PORT],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


def _imports_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] in REFUSED]
    return found


@pytest.mark.parametrize("path", sorted(
    [p for p in (ROOT / "llamole_tpu_torch").rglob("*.py")]
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_worker.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_of_the_port_imports_the_jax_package(path):
    assert _imports_of_the_jax_package(path) == []


# the LLM family resolved by name: the port agrees with the JAX loader
# on every family it names
@pytest.mark.parametrize("name", ["meta-llama/Meta-Llama-3.1-8B-Instruct",
                                  "Qwen/Qwen2-7B-Instruct",
                                  "mistralai/Mistral-7B-Instruct-v0.3", "",
                                  "Qwen/Qwen3-8B", "google/gemma-2-9b",
                                  "google/gemma-3-12b"])
def test_resolve_llm_config_equals_jax(name):
    from types import SimpleNamespace

    from llamole_tpu.models.loader import resolve_llm_config as jax_resolve
    from llamole_tpu_torch.models.loader import resolve_llm_config
    args = SimpleNamespace(model_name_or_path=name)
    assert (dataclasses.asdict(resolve_llm_config(args))
            == dataclasses.asdict(jax_resolve(args)))


_TINY_EVAL = {"model_name_or_path": "", "dataset": "molqa_drug_examples",
              "dataset_dir": "data", "template": "default", "cutoff_len": 96,
              "learned_query_size": 8, "output_dir": "unused",
              "finetuning_type": "lora", "lora_rank": 4}


def test_shift_attn_is_refused():
    """(Named when it raised.) shift_attn now reaches the LLM's config:
    training forwards take S²-attn (tests/test_torch_s2_attention.py)."""
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm
    model_args, data_args, _, ft_args, _ = get_infer_args(
        {**_TINY_EVAL, "shift_attn": True})
    assert model_args.shift_attn
    model, _ = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    assert model.llm.cfg.shift_attn and model.llm.cfg.group_size_ratio == 0.25


def test_token_id_dict_follows_new_special_tokens():
    """A config whose new_special_tokens differ from SPECIAL_TOKENS: the
    model's token_id_dict has the keys of the JAX loader's
    `model_args.special_token_list() or SPECIAL_TOKENS`."""
    from llamole_tpu.config import ModelArguments as JaxModelArguments
    from llamole_tpu.utils.constants import SPECIAL_TOKENS as JAX_SPECIALS
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.utils.constants import SPECIAL_TOKENS
    listed = ",".join([*SPECIAL_TOKENS, "<scaffold_start>", "<scaffold_end>"])
    model_args, data_args, _, ft_args, _ = get_infer_args(
        {**_TINY_EVAL, "new_special_tokens": listed})
    model, tok = build_graph_lm(model_args, data_args, ft_args, device="cpu")
    jax_args = JaxModelArguments(model_name_or_path="",
                                 new_special_tokens=listed)
    want = jax_args.special_token_list() or JAX_SPECIALS
    assert list(model.token_id_dict) == want != list(SPECIAL_TOKENS)
    assert model.token_id_dict["<scaffold_end>"] == tok.token_to_id(
        "<scaffold_end>")


@pytest.mark.parametrize("path", sorted((ROOT / "config").rglob("*.yaml")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_flat_yaml_reads_the_configs_as_pyyaml(path):
    """The port's argument files are read without PyYAML: every config
    file gives what yaml.safe_load gives."""
    import yaml

    from llamole_tpu_torch.utils.flat_yaml import load_flat_yaml

    text = path.read_text()
    assert load_flat_yaml(text) == yaml.safe_load(text)
