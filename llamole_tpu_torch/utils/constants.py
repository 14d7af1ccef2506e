"""Framework-wide constants.

Parity notes (reference: src/extras/constants.py):
  - IGNORE_INDEX = -100  (constants.py:51) — label positions excluded from LM loss.
  - NO_LABEL_INDEX = -200 (constants.py:25) — "absent" marker for retro labels
    and property channels (mapped to NaN inside the graph decoder).
  - BOND_INDEX (constants.py:24) maps bond kinds to edge classes
    {SINGLE:1, DOUBLE:2, TRIPLE:3, AROMATIC:4}; class 0 means "no edge".
  - The 9 special tokens come from config/train/llama_lora.yaml:3.
"""

IGNORE_INDEX = -100
NO_LABEL_INDEX = -200

# Edge classes used everywhere a bond order is featurized. 0 = no edge.
BOND_INDEX = {
    "SINGLE": 1,
    "DOUBLE": 2,
    "TRIPLE": 3,
    "AROMATIC": 4,
}
NUM_EDGE_CLASSES = 5  # none + 4 bond kinds

# Atom-type featurization: heavy atoms encoded as atomic_num - 2;
# the wildcard '*' (polymer attachment point) maps to 119 - 2 = 117.
# (reference: src/data/processors/mmsupervised.py:98-103)
ATOM_TYPE_OFFSET = 2
WILDCARD_ATOM_TYPE = 119 - 2
NUM_ATOM_TYPES = 118

# The 10 conditioning property channels, in wire order.
# (reference: src/eval/dataset.py:36-47)
MOL_PROPERTIES = ["BBBP", "HIV", "BACE", "CO2", "N2", "O2", "FFV", "TC", "SC", "SA"]

# Multimodal control tokens added to the tokenizer.
# (reference: config/train/llama_lora.yaml:3)
SPECIAL_TOKENS = [
    "<design_start>",
    "<design_end>",
    "<design_body>",
    "<molecule>",
    "<retro_start>",
    "<retro_end>",
    "<retro_body>",
    "<rollback_start>",
    "<rollback_end>",
]

# Markers used by the raw MolQA text format (never tokenized; the aligner
# strips them).  (reference: src/data/aligner.py:35-41)
MOL_START = "<mol_start>"
MOL_END = "<mol_end>"

DATA_CONFIG = "dataset_info.json"

DEFAULT_LEARNED_QUERY_SIZE = 8
