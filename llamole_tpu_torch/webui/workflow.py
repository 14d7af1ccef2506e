"""Single-example interactive pipeline backing the web UI (counterpart of
llamole_tpu/webui/workflow.py): a one-off model load on a device,
process_input and generate.

generate draws from a torch.Generator seeded with `seed` where the JAX
package splits jax.random.PRNGKey(seed): the same seed gives other
random draws in the two packages (ROADMAP Queue 3)."""

from typing import Any, Dict

import numpy as np
import torch

from ..config import get_infer_args
from ..data.template import get_template
from ..eval.dataset import MolQADataset
from ..models.composite import GenerationSettings
from ..utils.logging import get_logger

logger = get_logger(__name__)


def load_model_and_tokenizer(args: Any = None, device="cuda"):
    """Config (YAML path / dict) -> the UI's state, the model built on
    `device` (default the card; without one it raises unless "cpu")."""
    from ..models.loader import build_graph_lm
    from ..serve import resolve_device

    model_args, data_args, training_args, finetuning_args, generating_args = (
        get_infer_args(args))
    model, tokenizer = build_graph_lm(
        model_args, data_args, finetuning_args,
        device=resolve_device(device), generate_mode=True,
        load_adapter=bool(model_args.adapter_name_or_path))
    template = get_template(data_args.template, tokenizer)
    return {
        "model": model, "tokenizer": tokenizer, "template": template,
        "data_args": data_args, "generating_args": generating_args,
    }


def process_input(state: Dict, instruction: str,
                  property_dict: Dict[str, float]) -> Dict[str, np.ndarray]:
    """One record -> padded prompt batch of size 1."""
    record = {"instruction": instruction, "input": "",
              "property": property_dict}
    ds = MolQADataset([record], state["tokenizer"], state["template"],
                      state["data_args"].cutoff_len)
    item = ds[0]
    return {k: v[None, ...] for k, v in item.items()}


def generate(state: Dict, batch: Dict[str, np.ndarray], seed: int = 0,
             do_retrosynthesis: bool = True) -> Dict[str, Any]:
    """Design + retrosynthesis for one example."""
    g = state["generating_args"]
    gen = GenerationSettings(
        max_new_tokens=g.max_new_tokens, temperature=g.temperature,
        top_p=g.top_p, do_sample=g.do_sample,
        speculative_tokens=g.speculative_tokens,
        speculative_ngram=g.speculative_ngram)
    model = state["model"]
    return model.generate(
        batch["input_ids"], batch["attention_mask"],
        molecule_properties=batch["property"],
        generator=torch.Generator(device=model.device).manual_seed(seed),
        do_molecular_design=True, do_retrosynthesis=do_retrosynthesis,
        rollback=True, gen=gen)
