"""The port's utils/misc.py and utils/profiling.py against the JAX
package's (CPU): parameter counts, the environment dump's keys, the
encoded-record dump's text, and trace(): a no-op without a
directory, a Chrome trace of the block's ops with one, and an error when
the trace cannot be written."""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamole_tpu.data import loader as jloader
from llamole_tpu.data import tokenizer as jtokenizer
from llamole_tpu.utils import constants as jconst
from llamole_tpu.utils import misc as jmisc
from llamole_tpu_torch.data import loader as tloader
from llamole_tpu_torch.data import tokenizer as ttokenizer
from llamole_tpu_torch.utils import constants as tconst
from llamole_tpu_torch.utils import misc, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Leaf(tuple):
    """A leaf's shape in the trees below."""


def _s(*shape):
    return _Leaf(shape)


_SHAPES = [
    {"w": _s(3, 4), "b": _s(4)},
    {"layers": [{"q": _s(8, 8), "k": _s(8, 2)},
                {"q": _s(8, 8), "k": _s(8, 2)}],
     "scale": _s(), "table": _s(5, 300)},
    [_s(2, 3, 4), None, (_s(7), _s(1, 1))],
]


def _tree(shapes, make):
    if isinstance(shapes, _Leaf):
        return make(tuple(shapes))
    if isinstance(shapes, dict):
        return {k: _tree(v, make) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return type(shapes)(_tree(v, make) for v in shapes)
    return shapes


@pytest.mark.parametrize("shapes", _SHAPES, ids=["flat", "nested", "list"])
def test_count_parameters_equals_jax(shapes):
    rng = np.random.default_rng(0)
    ours = misc.count_parameters(_tree(
        shapes, lambda s: torch.from_numpy(rng.normal(size=s))))
    theirs = jmisc.count_parameters(_tree(
        shapes, lambda s: jnp.asarray(rng.normal(size=s))))
    assert ours == theirs and ours[0] == ours[1] > 0
    # numpy leaves count the same
    assert misc.count_parameters(_tree(shapes, np.zeros)) == theirs


def test_count_parameters_of_a_module_equals_its_jax_tree():
    module = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.LayerNorm(7))
    tree = {k: jnp.asarray(v.detach().numpy())
            for k, v in module.state_dict().items()}
    assert misc.count_parameters(module) == jmisc.count_parameters(tree) \
        == (5 * 7 + 7 + 7 + 7,) * 2


def test_env_info_keys_and_values():
    ours = misc.env_info("cpu")
    theirs = jmisc.env_info()
    assert set(ours) == {"llamole_tpu_torch", "python", "platform", "torch",
                         "cuda", "devices", "default_device",
                         "chemkit_native"}
    for key in ("python", "platform", "chemkit_native"):
        assert ours[key] == theirs[key], key
    assert ours["torch"] == torch.__version__
    assert ours["default_device"] == "cpu"
    if torch.cuda.is_available():
        assert misc.get_current_device().startswith("cuda:0 (")
    else:
        assert ours["devices"] == "cpu" == misc.get_current_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            misc.env_info()


def test_print_supervised_dataset_example_equals_jax(capsys):
    """The dump of every encoded training record is JAX's text."""
    data_args = types.SimpleNamespace(
        dataset="molqa_train_examples", dataset_dir=os.path.join(ROOT, "data"),
        max_samples=None, template="llama3", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    out = []
    for loader, tok_mod, const, dump in (
            (tloader, ttokenizer, tconst, misc),
            (jloader, jtokenizer, jconst, jmisc)):
        tok = tok_mod.ByteTokenizer(const.SPECIAL_TOKENS)
        _, inputs = loader.get_dataset(None, data_args, None, tok)
        for example in inputs:
            dump.print_supervised_dataset_example(example, tok)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert out[0].count("input_ids:\n") == 5 and "<retro_start>" in out[0]


def test_trace_is_a_noop_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("LLAMOLE_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(3) @ torch.ones(3)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("via_env", [False, True], ids=["argument", "env"])
def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch,
                                                via_env):
    out = tmp_path / "traces"
    if via_env:
        monkeypatch.setenv("LLAMOLE_TRACE_DIR", str(out))
    with profiling.trace(None if via_env else str(out)):
        assert torch.autograd.profiler._is_profiler_enabled
        torch.ones(4, 4) @ torch.ones(4, 4)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_trace_that_cannot_be_written_raises(tmp_path):
    """A directory that cannot be made stops the block before it runs."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    ran = []
    with pytest.raises(FileExistsError):
        with profiling.trace(str(blocker)):
            ran.append(1)
    assert ran == []
