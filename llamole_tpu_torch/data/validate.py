"""MolQA corpus preflight: parse/featurize every record and report
what training/eval would actually see.

A copy of llamole_tpu/data/validate.py (host code with no JAX), on this
package's own chem/ and data/aligner; tests/test_torch_pretrain.py holds
its report equal to the JAX package's.

The runbook's first real-data step (scripts/REAL_WEIGHTS_RUNBOOK.md):
when the full MolQA JSON lands, run `python main.py validate_data
data/molqa_train.json` BEFORE training — it surfaces unparseable
SMILES (designed molecules AND retro products — both featurize at
ingest), records with no extractable molecule, retro-label mismatches,
property-channel coverage, and token-length pressure against
cutoff_len, none of which should be discovered mid-run. (The reference
has no equivalent; bad records surface as mid-epoch exceptions.)
"""

import json
from collections import Counter
from typing import Any, Dict, List, Optional

from ..chem.featurize import smiles_to_graph
from ..chem.smiles import canonical_smiles
from ..utils.constants import MOL_PROPERTIES
from ..utils.logging import get_logger
from .aligner import extract_all_smiles, extract_retro_products

logger = get_logger(__name__)


def validate_molqa(path: str, *, cutoff_len: int = 1024,
                   tokenizer=None, learned_query_size: int = 8,
                   max_report: int = 10) -> Dict[str, Any]:
    """Returns the report dict (also logged). Never raises on bad
    records — counting them is the point (malformed entries, null
    fields, and non-dict rows count as issues, they don't abort)."""
    with open(path) as f:
        records = json.load(f)
    if not isinstance(records, list):
        raise ValueError(f"{path}: expected a JSON list of records")

    n = len(records)
    issues: List[str] = []
    malformed = no_molecule = bad_smiles = bad_graph = retro_mismatch = 0
    molecules = set()
    graph_cache: Dict[str, Optional[Any]] = {}   # canonical -> graph|None
    atom_counts: List[int] = []
    prop_cover = Counter()
    token_over = 0

    def note(msg: str) -> None:
        if len(issues) < max_report:
            issues.append(msg)

    def check_smiles(i: int, s: str) -> None:
        nonlocal bad_smiles, bad_graph
        can = canonical_smiles(s)
        if can is None:
            bad_smiles += 1
            note(f"record {i}: unparseable SMILES {s!r}")
            return
        molecules.add(can)
        if can not in graph_cache:   # corpora repeat molecules heavily
            g = smiles_to_graph(can)
            graph_cache[can] = g
            if g is not None:
                atom_counts.append(g.n_nodes)
        if graph_cache[can] is None:
            bad_graph += 1
            note(f"record {i}: unfeaturizable {s!r}")

    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            malformed += 1
            note(f"record {i}: not a JSON object ({type(rec).__name__})")
            continue
        out = rec.get("output") or ""
        if not isinstance(out, str):
            malformed += 1
            note(f"record {i}: 'output' is {type(out).__name__}, "
                 "not a string")
            continue
        smis = extract_all_smiles(out)
        if not smis:
            no_molecule += 1
            note(f"record {i}: no <mol_start> molecule")
        for s in smis:
            check_smiles(i, s)
        # retro products featurize at ingest too (loader build_graph_bank)
        products = extract_retro_products(out)
        for s in products:
            check_smiles(i, s)
        labels = rec.get("retro") or []
        if len(products) != len(labels):
            retro_mismatch += 1
            note(f"record {i}: {len(products)} retro products vs "
                 f"{len(labels)} labels")
        prop = rec.get("property") or {}
        for name in (prop if isinstance(prop, dict) else ()):
            if name in MOL_PROPERTIES:
                prop_cover[name] += 1
            else:
                note(f"record {i}: unknown property {name!r}")
        if tokenizer is not None:
            text = " ".join(filter(None, [
                str(rec.get("instruction") or ""),
                str(rec.get("input") or ""), out]))
            # APPROXIMATE training length: the processor also inserts
            # learned_query_size body tokens per design/retro tag and
            # template role markers (data/processor.py); pad the raw
            # count accordingly rather than undercounting
            extra = learned_query_size * (
                out.count("<design_start>") + out.count("<retro_start>"))
            if len(tokenizer.encode(text)) + extra + 32 > cutoff_len:
                token_over += 1

    report: Dict[str, Any] = {
        "path": path,
        "records": n,
        "malformed_records": malformed,
        "distinct_molecules": len(molecules),
        "max_atoms": max(atom_counts) if atom_counts else 0,
        "mean_atoms": (round(sum(atom_counts) / len(atom_counts), 1)
                       if atom_counts else 0),
        "records_without_molecule": no_molecule,
        "unparseable_smiles": bad_smiles,
        "unfeaturizable_molecules": bad_graph,
        "retro_label_mismatches": retro_mismatch,
        "property_coverage": {p: prop_cover.get(p, 0)
                              for p in MOL_PROPERTIES},
        "issues_sample": issues,
    }
    if tokenizer is not None:
        report["records_over_cutoff_len_approx"] = token_over
    report["ok"] = (malformed == 0 and no_molecule == 0 and bad_smiles == 0
                    and bad_graph == 0 and retro_mismatch == 0)
    logger.info("validate %s: %s", path,
                {k: v for k, v in report.items() if k != "issues_sample"})
    return report
