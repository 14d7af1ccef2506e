"""Host-side chemistry runtime.

The reference delegates all chemistry to RDKit/rdchiral C++ (see
SURVEY.md §2 L0). This environment ships neither, so the package
carries a first-party chemistry stack:

  periodic.py     element data + valence model
  mol.py          molecular graph containers
  smiles.py       SMILES reader/writer + kekulize/aromatize + canonical ranks
  assemble.py     dense-graph -> molecule assembly, valence correction,
                  fragment connection (molecule_utils.py parity)
  fingerprint.py  Morgan/ECFP bit fingerprints (CostMLP features)
  featurize.py    SMILES -> dense padded tensors for the graph models
  smarts.py       SMARTS pattern engine (subgraph matching)
  reaction.py     retro reaction-template application (rdchiral-lite)
  depict.py       2D layout + SVG depiction of molecules and reactions

Everything here is pure Python/numpy and runs on the host; device code
never parses strings.
"""

from .mol import Atom, Bond, Mol
from .smiles import (parse_smiles, mol_to_smiles, canonical_smiles,
                     recanonicalize, SmilesError)
from .assemble import graph_to_smiles, check_valid
from .fingerprint import morgan_fingerprint
from .featurize import smiles_to_graph, GraphSample
