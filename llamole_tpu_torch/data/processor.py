"""Supervised multimodal tokenization: chat encoding, label masking,
retro-tag-balanced truncation.

Behavioral parity with src/data/processors/mmsupervised.py:
  infer_seqlen            (:43-53)  proportional source/target budget
  encode_supervised_example (:137-255) incl. keeping <retro_start>/
      <design_start> as label targets while masking other specials
  preprocess_mmsupervised_dataset (:257-313)
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.constants import IGNORE_INDEX, NO_LABEL_INDEX
from .template import Template

_MASKED_SPECIALS = [
    "<design_start>", "<design_end>", "<design_body>", "<molecule>",
    "<retro_start>", "<retro_end>", "<retro_body>",
]


def infer_seqlen(source_len: int, target_len: int, cutoff_len: int) -> Tuple[int, int]:
    if target_len * 2 < cutoff_len:
        max_target_len = cutoff_len
    elif source_len * 2 < cutoff_len:
        max_target_len = cutoff_len - source_len
    else:
        max_target_len = int(cutoff_len * (target_len / (source_len + target_len)))
    new_target_len = min(max_target_len, target_len)
    new_source_len = max(cutoff_len - new_target_len, 0)
    return new_source_len, new_target_len


def _balanced_retro_truncation(target_ids: List[int], target_len: int,
                               retro_start_id: int, retro_end_id: int) -> int:
    """Never cut a <retro_start>…<retro_end> pair in half
    (mmsupervised.py:179-209)."""
    starts = [i for i, t in enumerate(target_ids) if t == retro_start_id]
    ends = [i for i, t in enumerate(target_ids) if t == retro_end_id]
    if not starts or not ends:
        return target_len
    last_pair = -1
    for s, e in zip(starts, ends):
        if e < target_len:
            last_pair = e
        else:
            break
    if last_pair >= 0:
        return last_pair + 1
    return min(target_len, starts[0])


def encode_supervised_example(
    prompt: Sequence[Dict[str, str]],
    response: Sequence[Dict[str, str]],
    system: Optional[str],
    molecule_ids: List[int],
    retro_product_ids: List[int],
    retro_labels: List[int],
    template: Template,
    tokenizer,
    cutoff_len: int,
    train_on_prompt: bool = False,
) -> Tuple[List[int], List[int], List[int], List[int], List[int]]:
    messages = list(prompt) + list(response)
    input_ids: List[int] = []
    labels: List[int] = []
    final_mols: List[int] = []
    final_products: List[int] = []
    final_retro: List[int] = []

    special_ids = {t: tokenizer.token_to_id(t) for t in _MASKED_SPECIALS}
    keep_as_labels = {special_ids["<retro_start>"], special_ids["<design_start>"]}
    masked = set(special_ids.values())

    pairs = template.encode_multiturn(tokenizer, messages, system)
    total_length = 1 if template.efficient_eos else 0
    for turn_idx, (source_ids, target_ids) in enumerate(pairs):
        if total_length >= cutoff_len:
            break
        source_len, target_len = infer_seqlen(
            len(source_ids), len(target_ids), cutoff_len - total_length)
        source_ids = source_ids[:source_len]
        target_len = _balanced_retro_truncation(
            target_ids, target_len,
            special_ids["<retro_start>"], special_ids["<retro_end>"])
        target_ids = target_ids[:target_len]

        mols_in_turn = sum(1 for t in target_ids if t == special_ids["<molecule>"])
        retro_in_turn = sum(1 for t in target_ids if t == special_ids["<retro_end>"])
        assert (sum(1 for t in target_ids if t == special_ids["<retro_start>"])
                == retro_in_turn), "unbalanced retro tags after truncation"

        final_mols.extend(molecule_ids[:mols_in_turn])
        final_products.extend(retro_product_ids[:retro_in_turn])
        final_retro.extend(retro_labels[:retro_in_turn])
        total_length += source_len + target_len

        if train_on_prompt:
            source_mask = list(source_ids)
        elif turn_idx != 0 and template.efficient_eos:
            source_mask = [tokenizer.eos_token_id] + [IGNORE_INDEX] * (len(source_ids) - 1)
        else:
            source_mask = [IGNORE_INDEX] * len(source_ids)
        source_mask = [IGNORE_INDEX if t in masked else t for t in source_mask]
        target_mask = [
            t if t in keep_as_labels else (IGNORE_INDEX if t in masked else t)
            for t in target_ids
        ]
        input_ids += list(source_ids) + list(target_ids)
        labels += source_mask + target_mask

    if template.efficient_eos:
        input_ids.append(tokenizer.eos_token_id)
        labels.append(tokenizer.eos_token_id)

    return input_ids, labels, final_mols, final_products, final_retro


def preprocess_examples(
    examples: Sequence[Dict[str, Any]],
    template: Template,
    tokenizer,
    cutoff_len: int,
    train_on_prompt: bool = False,
) -> List[Dict[str, Any]]:
    """Aligned examples -> model inputs (mmsupervised.py:257-313)."""
    out = []
    for ex in examples:
        if len(ex["prompt"]) % 2 != 1 or len(ex["response"]) != 1:
            continue
        retro_labels = [NO_LABEL_INDEX if l is None else l
                        for l in ex["retro_labels"]]
        props = [NO_LABEL_INDEX if p is None else p for p in ex["property"]]
        input_ids, labels, mols, products, retro = encode_supervised_example(
            ex["prompt"], ex["response"], ex["system"],
            ex["molecules"], ex["retro_products"], retro_labels,
            template, tokenizer, cutoff_len, train_on_prompt)
        out.append({
            "input_ids": input_ids,
            "attention_mask": [1] * len(input_ids),
            "labels": labels,
            "molecule_ids": mols,
            "molecule_properties": props,
            "retro_labels": retro,
            "retro_product_ids": products,
        })
    return out
