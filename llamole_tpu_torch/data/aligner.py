"""MolQA record alignment: raw instruction/input/output records ->
chat-form examples with molecule ids, properties and retro labels.

Behavioral parity with src/data/aligner.py:
  extract_all_smiles       (aligner.py:35)   <mol_start>…<mol_end> capture
  replace_smiles_with_callback (aligner.py:43) design molecule ->
      <molecule><rollback_start>SMILES<rollback_end>; others -> <molecule>
  insert_bodies            (aligner.py:62)   learned-query body tokens
  extract_retro_products   (aligner.py:92)   product = <retro_end>…>>
  align_dataset            (aligner.py:148)  global SMILES<->int-id map
"""

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.constants import MOL_PROPERTIES

_MOL_RE = re.compile(r"<mol_start>(.*?)<mol_end>")
_DESIGN_MOL_RE = re.compile(r"(<design_start><design_end>)<mol_start>(.*?)<mol_end>")
_DESIGN_RE = re.compile(r"<design_start>(.*?)<design_end>")
_RETRO_STEP_RE = re.compile(
    r"(This is step \d+ in the retrosynthesis process\..*?<retro_start>.*?<retro_end>)"
    r"(.*?)(?=This is step \d+|$)", re.S)
_RETRO_TAG_RE = re.compile(r"<retro_start>.*?<retro_end>", re.S)
_RETRO_PRODUCT_RE = re.compile(r"<retro_end>(.*?)>>")


def extract_all_smiles(text: str) -> List[str]:
    return _MOL_RE.findall(text)


def replace_smiles_with_rollback(text: str) -> str:
    """Design molecule keeps a rollback transcript; the rest collapse to
    <molecule> (aligner.py:43-57)."""
    def repl(m):
        return f"{m.group(1)}<molecule><rollback_start>{m.group(2)}<rollback_end>"

    text = _DESIGN_MOL_RE.sub(repl, text)
    return _MOL_RE.sub("<molecule>", text)


def insert_bodies(text: str, num_insertions: int,
                  retro_labels: Sequence[Optional[int]]) -> str:
    """Replace design/retro tag interiors with learned query tokens
    (aligner.py:62-90). Retro steps with a None label keep their text."""
    design_body = "<design_start>" + "<design_body>" * num_insertions + "<design_end>"
    text = _DESIGN_RE.sub(design_body, text)

    retro_body = "<retro_start>" + "<retro_body>" * num_insertions + "<retro_end>"
    out, last, i = [], 0, 0
    for m in _RETRO_STEP_RE.finditer(text):
        label = retro_labels[i] if i < len(retro_labels) else None
        step, remaining = m.group(1), m.group(2)
        out.append(text[last:m.start()])
        if _RETRO_TAG_RE.search(step) and label is not None:
            out.append(_RETRO_TAG_RE.sub(retro_body, step))
        else:
            out.append(step + remaining)
        last = m.end()
        i += 1
    out.append(text[last:])
    return "".join(out)


def extract_retro_products(text: str) -> List[str]:
    return [m.strip() for m in _RETRO_PRODUCT_RE.findall(text)]


def property_vector(prop: Dict[str, Any]) -> List[Optional[float]]:
    return [prop.get(name, None) for name in MOL_PROPERTIES]


def convert_molqa_record(record: Dict[str, Any],
                         learned_query_size: int) -> Dict[str, Any]:
    """One raw MolQA record -> aligned example (aligner.py:97-145)."""
    content = []
    if record.get("instruction"):
        content.append(record["instruction"])
    if record.get("input"):
        content.append(record["input"])
    prompt = [{"role": "user", "content": "\n".join(content)}]

    output = record.get("output", "")
    smiles_list = extract_all_smiles(output)
    modified = replace_smiles_with_rollback(output)
    retro_labels = list(record.get("retro", []) or [])
    retro_products = extract_retro_products(output)
    modified = insert_bodies(modified, learned_query_size, retro_labels)

    return {
        "prompt": prompt,
        "response": [{"role": "assistant", "content": modified}],
        "system": record.get("system", ""),
        "molecules": smiles_list,
        "property": property_vector(record.get("property", {}) or {}),
        "retro_labels": retro_labels,
        "retro_products": retro_products,
    }


def align_dataset(
    records: Sequence[Dict[str, Any]], learned_query_size: int
) -> Tuple[List[Dict[str, Any]], Dict[int, str]]:
    """Convert all records and map unique SMILES -> int ids
    (aligner.py:148-231). Returns (examples, id_to_smiles)."""
    examples = [convert_molqa_record(r, learned_query_size) for r in records]
    # canonicalization boundary: MolQA records are external assets (the
    # reference's are RDKit-canonical) — key the molecule bank by OUR
    # canonical spelling so equivalent spellings across records share one
    # id/graph; record text keeps the original spelling
    from ..chem import recanonicalize
    raw_to_canon: Dict[str, str] = {}
    all_smiles = set()
    for ex in examples:
        for s in list(ex["molecules"]) + list(ex["retro_products"]):
            if s not in raw_to_canon:
                raw_to_canon[s] = recanonicalize(s)
            all_smiles.add(raw_to_canon[s])
    smiles_to_id = {s: i for i, s in enumerate(sorted(all_smiles))}
    for ex in examples:
        ex["molecules"] = [smiles_to_id[raw_to_canon[s]]
                           for s in ex["molecules"]]
        ex["retro_products"] = [smiles_to_id[raw_to_canon[s]]
                                for s in ex["retro_products"]]
    return examples, {i: s for s, i in smiles_to_id.items()}
