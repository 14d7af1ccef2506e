"""llamole_tpu_torch's re-declared configs stay equal to the JAX ones, and
the port never imports JAX."""

import dataclasses
import os
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
        "'llamole_tpu_torch.')]\n"
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
