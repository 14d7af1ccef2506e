"""Dataset loading: registry json -> aligned + tokenized examples +
molecule graph bank (parity: src/data/loader.py:50-149 get_dataset and
src/data/parser.py dataset registry)."""

import json
import os
from typing import Any, Dict, List, Tuple

from ..chem.featurize import GraphSample, smiles_to_graph
from ..utils.constants import DATA_CONFIG
from ..utils.logging import get_logger
from .aligner import align_dataset
from .processor import preprocess_examples
from .template import get_template

logger = get_logger(__name__)


def resolve_dataset_path(dataset: str, dataset_dir: str) -> str:
    registry = os.path.join(dataset_dir, DATA_CONFIG)
    if os.path.exists(registry):
        with open(registry) as f:
            info = json.load(f)
        if dataset in info:
            return os.path.join(dataset_dir, info[dataset]["file_name"])
    candidate = os.path.join(dataset_dir, f"{dataset}.json")
    if os.path.exists(candidate):
        return candidate
    raise ValueError(f"Dataset {dataset!r} not found under {dataset_dir}")


def build_graph_bank(id_to_smiles: Dict[int, str]) -> Dict[int, GraphSample]:
    """SMILES -> dense graphs for every unique molecule
    (parity: mmsupervised.py:55-135 encode_graph_pyg, minus the pickle
    cache — featurization here is fast enough to redo)."""
    bank: Dict[int, GraphSample] = {}
    for mol_id, smiles in id_to_smiles.items():
        g = smiles_to_graph(smiles)
        if g is None:
            raise ValueError(f"Invalid SMILES for molecule {mol_id}: {smiles}")
        bank[mol_id] = g
    return bank


def get_dataset(
    model_args, data_args, training_args, tokenizer,
) -> Tuple[Dict[int, GraphSample], List[Dict[str, Any]]]:
    """Returns (mol_id->GraphSample bank, tokenized examples)."""
    path = resolve_dataset_path(data_args.dataset, data_args.dataset_dir)
    with open(path) as f:
        records = json.load(f)
    if data_args.max_samples:
        records = records[: data_args.max_samples]
    template = get_template(data_args.template, tokenizer)
    examples, id_to_smiles = align_dataset(records, data_args.learned_query_size)
    bank = build_graph_bank(id_to_smiles)
    inputs = preprocess_examples(
        examples, template, tokenizer, data_args.cutoff_len,
        train_on_prompt=data_args.train_on_prompt)
    logger.info("Loaded %d examples (%d unique molecules) from %s",
                len(inputs), len(bank), path)
    return bank, inputs
