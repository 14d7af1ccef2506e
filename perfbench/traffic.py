"""The benchmark's one generator of traffic: design requests and MolQA
training records, made from the seed and the parameters of a traffic
file (perfbench/workloads/<traffic>.json) over the repository's MolQA
example records copied into perfbench/data/molqa.json.

Lengths are the records' own: nothing is padded or lengthened. Every
seed gets the same multiset of sizes; the seed decides the order, and in
a training record which molecules of the same SMILES length stand in the
record's place and which template labels its retro steps carry, so that
seeds change what is said and not how much work it is.
"""

import itertools
import json
import os
import random
import re
from typing import Dict, List

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "molqa.json")

# characters a SMILES string is made of: a molecule is exchanged only
# where it stands whole, not inside a longer one
_SMILES_CHARS = r"A-Za-z0-9@+\-\[\]\(\)=#\\/%*"


def load_data() -> dict:
    with open(DATA) as f:
        return json.load(f)


def _query(rec: dict) -> str:
    """A record's user turn: its instruction, then its input (as the
    aligner joins them)."""
    return "\n".join(s for s in (rec["instruction"], rec["input"]) if s)


def design_requests(seed: int, traffic: dict, data: dict = None) -> list:
    """[(prompt text, property dict)] of traffic["pool"] requests: each
    record of data[traffic["records"]] as often as the others (the
    pool's remainder to the first in the seed's order), in the seed's
    order, its user turn put into traffic["prompt_format"] with
    traffic["system"]."""
    data = data or load_data()
    recs = data[traffic["records"]]
    rng = random.Random(f"design/{seed}")
    order = list(range(len(recs)))
    rng.shuffle(order)
    picks = [order[i % len(recs)] for i in range(traffic["pool"])]
    rng.shuffle(picks)
    return [(traffic["prompt_format"].format(system=traffic["system"],
                                             query=_query(recs[k])),
             dict(recs[k]["property"])) for k in picks]


def record_molecules(rec: dict) -> List[str]:
    """The molecules a record names, in order of first mention: each
    between <mol_start> and <mol_end>, and each side of every reaction
    (product>>reactant.reactant)."""
    out = []
    text = rec["output"]
    found = re.findall(r"<mol_start>(.*?)<mol_end>", text)
    for prod, reac in re.findall(r"<retro_end>([^>]*)>>([^,\s]*)", text):
        found += [prod] + reac.split(".")
    for m in found:
        if m and m not in out:
            out.append(m)
    return out


def _exchange(text: str, mapping: Dict[str, str]) -> str:
    """text with each molecule of mapping, where it stands whole,
    replaced at once (no replacement is replaced again)."""
    if not mapping:
        return text
    alt = "|".join(re.escape(m) for m in sorted(mapping, key=len,
                                                 reverse=True))
    pat = re.compile(f"(?<![{_SMILES_CHARS}])(?:{alt})(?![{_SMILES_CHARS}])")
    return pat.sub(lambda mo: mapping[mo.group(0)], text)


def variants(rec: dict, corpus: List[str]) -> List[Dict[str, str]]:
    """Every way to exchange the record's molecules of three characters
    or more for corpus molecules of the same length (or keep them):
    [{molecule: stand-in}], keeping all first."""
    mols = [m for m in record_molecules(rec) if len(m) >= 3]
    choices = [[m] + [c for c in corpus if len(c) == len(m) and c != m
                      and c not in mols] for m in mols]
    out = []
    for combo in itertools.product(*choices):
        if len(set(combo)) == len(combo):      # two never become one
            out.append({m: c for m, c in zip(mols, combo) if m != c})
    return out


def training_records(seed: int, traffic: dict, data: dict = None
                     ) -> List[dict]:
    """traffic["pool"] MolQA records in rounds: each round holds every
    record of data[traffic["records"]] once, in the seed's order, so any
    traffic["rows"] consecutive records of a round boundary hold each
    record as often. Copy j of a record takes the seed's j-th way of
    exchanging its molecules for ones of the same length (consecutive
    copies differ wherever the corpus allows) and retro template labels
    drawn from range(traffic["template_labels"])."""
    data = data or load_data()
    recs = data[traffic["records"]]
    corpus = data["molecules"]
    rng = random.Random(f"records/{seed}")
    order = list(range(len(recs)))
    rng.shuffle(order)
    ways = []
    for rec in recs:
        v = variants(rec, corpus)
        start = rng.randrange(len(v))
        ways.append(v[start:] + v[:start])
    out = []
    for i in range(traffic["pool"]):
        k = order[i % len(recs)]
        copy = i // len(recs)
        rec = recs[k]
        mapping = ways[k][copy % len(ways[k])]
        out.append({
            "instruction": rec["instruction"], "input": rec["input"],
            "output": _exchange(rec["output"], mapping),
            "property": dict(rec["property"]),
            "retro": [rng.randrange(traffic["template_labels"])
                      for _ in rec["retro"]]})
    return out
