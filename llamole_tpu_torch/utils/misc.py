"""Misc utilities (counterpart of llamole_tpu/utils/misc.py): parameter
counts, the device description, the environment dump of
`python -m llamole_tpu_torch env` and the encoded-record dump."""

import platform
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def count_parameters(params: Any) -> Tuple[int, int]:
    """(trainable?, all) over a bundle: a module, or nested dicts, lists
    and tuples of tensors or arrays. As in the JAX package every leaf of
    the bundle counts as trainable; callers pass the bundles separately."""
    total = sum(int(np.prod(x.shape)) for x in _leaves(params)
                if hasattr(x, "shape"))
    return total, total


def _describe(device: torch.device) -> str:
    if device.type == "cuda":
        index = device.index if device.index is not None else 0
        return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
    return str(device)


def get_current_device() -> str:
    """The primary device: e.g. 'cuda:0 (NVIDIA H100 80GB HBM3)', or
    'cpu' without a card."""
    if torch.cuda.is_available():
        return _describe(torch.device("cuda", torch.cuda.current_device()))
    return "cpu"


def env_info(device="cuda") -> Dict[str, str]:
    """Environment dump for bug reports. default_device is `device` as the
    entry points resolve it: "cuda" without a card raises."""
    import llamole_tpu_torch
    from ..serve import resolve_device

    default = resolve_device(device)
    cards = [_describe(torch.device("cuda", i))
             for i in range(torch.cuda.device_count())]
    info = {
        "llamole_tpu_torch": llamole_tpu_torch.__version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "devices": ", ".join(cards) or "cpu",
        "default_device": _describe(default),
    }
    try:
        from ..chem import _native
        info["chemkit_native"] = str(_native.available())
    except Exception:
        info["chemkit_native"] = "False"
    return info


def print_supervised_dataset_example(example: Dict, tokenizer) -> None:
    """Debug dump of one encoded record (the JAX package's text)."""
    from .constants import IGNORE_INDEX
    valid_labels = [t for t in example["labels"] if t != IGNORE_INDEX]
    print("input_ids:\n{}".format(example["input_ids"]))
    print("inputs:\n{}".format(
        tokenizer.decode(example["input_ids"], skip_special_tokens=False)))
    print("label_ids:\n{}".format(example["labels"]))
    print("labels:\n{}".format(
        tokenizer.decode(valid_labels, skip_special_tokens=False)))
    print("molecule_ids:\n{}".format(example.get("molecule_ids")))
    print("molecule_properties:\n{}".format(example.get("molecule_properties")))
    print("retro_labels:\n{}".format(example.get("retro_labels")))
    print("retro_product_ids:\n{}".format(example.get("retro_product_ids")))
