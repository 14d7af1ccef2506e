"""MolQA evaluation dataset: raw records -> left-padded prompts + property
vectors (counterpart of llamole_tpu/eval/dataset.py)."""

from typing import Any, Dict, Sequence

import numpy as np

from ..data.template import Template
from ..utils.constants import MOL_PROPERTIES


class MolQADataset:
    def __init__(self, data: Sequence[Dict[str, Any]], tokenizer,
                 template: Template, max_len: int):
        self.data = list(data)
        self.tokenizer = tokenizer
        self.template = template
        self.max_len = max_len

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.data[idx]
        combined = f"{item['instruction']}\n{item.get('input', '')}"
        props = [item.get("property", {}).get(p, float("nan"))
                 for p in MOL_PROPERTIES]
        chat = self.template.render_prompt(
            [{"role": "user", "content": combined}])
        ids = self.tokenizer.encode(chat)[-self.max_len:]
        input_ids = np.full(self.max_len, self.tokenizer.pad_token_id,
                            np.int32)
        mask = np.zeros(self.max_len, np.int32)
        input_ids[-len(ids):] = ids
        mask[-len(ids):] = 1
        return {"input_ids": input_ids, "attention_mask": mask,
                "property": np.asarray(props, np.float32)}

    def batches(self, batch_size: int):
        """(stacked batch, start index) over the records in order."""
        for start in range(0, len(self.data), batch_size):
            items = [self[i] for i in range(
                start, min(start + batch_size, len(self.data)))]
            yield {k: np.stack([it[k] for it in items])
                   for k in items[0]}, start
