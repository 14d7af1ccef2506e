"""Synthetic MolQA corpus generation (beyond-reference surface).

A copy of llamole_tpu/data/synthetic.py (host code with no JAX), on this
package's own chem/; tests/test_torch_pretrain.py holds its corpus
byte-identical to the JAX package's for the same seed and size.

The reference trains on an external MolQA corpus and auto-downloads its
pretrained graph modules (src/model/loader.py:226-331); this environment
has neither network nor the corpus. This module synthesizes a chemically
consistent MolQA-format corpus from first principles using the
framework's own chemistry stack:

  * a building-block inventory (the purchasable leaves)
  * a reaction library where the FORWARD construction and the matching
    RETRO template both run through the same engine
    (chem/reaction.rdchiral_run_text) — every emitted record is VERIFIED:
    applying the retro template to the product must regenerate exactly
    the recorded reactant set, so planner success on corpus molecules is
    achievable by construction
  * deterministic property labels computed from first-party structural
    descriptors, so the property oracle has a learnable (and
    discrimination-testable) ground truth

Purpose: the first learned-weights operating point (VERDICT r4 next #1).
Pretraining GraphDiT / GNNPredictor / oracle / GraphCLIP / CostMLP plus
the mmsft LoRA run on this corpus gives the full two-phase eval
(validity, retro success, BLEU/ROUGE, FGD, property fidelity)
non-degenerate numbers without any external download.

Record format matches data/molqa_train_examples.json and the reference's
MolQA schema (instruction / input / output / property / retro), and every
record round-trips through data/aligner.py extractors.
"""

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..chem import canonical_smiles
from ..chem.reaction import rdchiral_run_text
from ..chem.smiles import parse_smiles
from ..utils.logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Reaction library: forward construction + retro template pairs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Reaction:
    label: int          # stable retro-template label (the `retro` ints)
    name: str
    fwd: str            # reactants>>product template (same engine)
    retro: str          # product>>reactants template (ships to planner)
    slots: Tuple[str, ...]   # building-block class per reactant slot
    procedure: str      # free-text synthesis sentence fragment


REACTIONS: List[Reaction] = [
    Reaction(101, "esterification",
             "[C:1](=[O:2])[OH:3].[OH:5][CX4:4]>>[C:1](=[O:2])[O:5][C:4]",
             "[C;!R:1](=[O:2])[O;!R:3][CX4:4]>>[C:1](=[O:2])[OH].[OH:3][C:4]",
             ("acid", "alcohol"),
             "the acid couples with the alcohol under Fischer "
             "esterification conditions"),
    Reaction(102, "amidation",
             "[C:1](=[O:2])[OH:3].[NX3;H2:5][C:4]>>[C:1](=[O:2])[N:5][C:4]",
             "[C;!R:1](=[O:2])[NX3;H1;!R:3][C:4]>>"
             "[C:1](=[O:2])[OH].[NH2:3][C:4]",
             ("acid", "amine"),
             "amide coupling of the acid with the amine"),
    Reaction(103, "williamson_ether",
             "[c:1][OH:2].[CX4:3][Br:4]>>[c:1][O:2][C:3]",
             "[c:1][O;!R:2][CX4;!R:3]>>[c:1][OH:2].[Br][C:3]",
             ("phenol", "alkyl_bromide"),
             "Williamson etherification of the phenol with the alkyl "
             "bromide"),
    Reaction(104, "n_alkylation",
             "[NX3;H2:1][C:2].[CX4:3][Br:4]>>[N:1]([C:2])[C:3]",
             "[NX3;H1;!R:1]([CX4:2])[CX4;!R:3]>>[NH2:1][C:2].[Br][C:3]",
             ("amine", "alkyl_bromide"),
             "N-alkylation of the primary amine with the alkyl bromide"),
    Reaction(105, "nitro_reduction",
             "[c:1][N+:2](=[O:3])[O-:4]>>[c:1][NH2:2]",
             "[c:1][NH2:2]>>[c:1][N+:2](=[O])[O-]",
             ("nitroarene",),
             "reduction of the nitro group"),
    Reaction(106, "nitrile_hydrolysis",
             "[C:1]#[N:2]>>[C:1](=[O])[OH]",
             "[CX3;!R:1](=[O:2])[OH:3]>>[C:1]#[N]",
             ("nitrile",),
             "hydrolysis of the nitrile to the carboxylic acid"),
    Reaction(107, "ketone_reduction",
             "[C:1][C:2](=[O:3])[C:4]>>[C:1][CH:2]([OH:3])[C:4]",
             "[CX4:1][CH1;!R:2]([OH:3])[CX4:4]>>[C:1][C:2](=[O:3])[C:4]",
             ("ketone",),
             "carbonyl reduction to the secondary alcohol"),
    Reaction(108, "reductive_amination",
             "[NX3;H2:1][C:5].[CH:2](=[O:3])[C:4]>>"
             "[N:1]([C:5])[CH2:2][C:4]",
             "[NX3;H1;!R:1]([C:5])[CH2;!R:2][C:4]>>"
             "[NH2:1][C:5].[CH:2](=[O])[C:4]",
             ("amine", "aldehyde"),
             "reductive amination of the aldehyde with the amine"),
    Reaction(109, "buchwald_amination",
             "[c:1][Br:2].[NX3;H2:3][C:4]>>[c:1][N:3][C:4]",
             "[c:1][NX3;H1:3][CX4:4]>>[c:1][Br].[NH2:3][C:4]",
             ("aryl_bromide", "amine"),
             "palladium-catalyzed C-N coupling of the aryl bromide with "
             "the amine"),
    Reaction(110, "sulfonamidation",
             "[S:1](=[O:2])(=[O:3])[Cl:4].[NX3;H2:5][C:6]>>"
             "[S:1](=[O:2])(=[O:3])[N:5][C:6]",
             "[S:1](=[O:2])(=[O:3])[NX3;H1:5][C:6]>>"
             "[S:1](=[O:2])(=[O:3])[Cl].[NH2:5][C:6]",
             ("sulfonyl_chloride", "amine"),
             "sulfonamide formation from the sulfonyl chloride and the "
             "amine"),
]

LABEL_TO_TEMPLATE: Dict[int, str] = {r.label: r.retro for r in REACTIONS}


# ---------------------------------------------------------------------------
# Building blocks (the purchasable inventory)
# ---------------------------------------------------------------------------

BUILDING_BLOCKS: Dict[str, List[str]] = {
    "acid": [
        "CC(=O)O", "CCC(=O)O", "CC(C)C(=O)O", "CCCC(=O)O",
        "O=C(O)C1CC1", "O=C(O)c1ccccc1", "Cc1ccc(C(=O)O)cc1",
        "O=C(O)c1ccc(F)cc1", "O=C(O)c1ccc(Cl)cc1", "O=C(O)c1ccncc1",
        "COc1ccc(C(=O)O)cc1", "O=C(O)Cc1ccccc1",
        # bifunctional: leave a handle for the next step
        "O=C(O)c1ccc(Br)cc1", "O=C(O)c1ccc([N+](=O)[O-])cc1",
        "O=C(O)c1ccc(O)cc1", "NCC(=O)O",
    ],
    "alcohol": [
        "CO", "CCO", "CCCO", "CC(C)O", "CCCCO", "CC(C)CO",
        "OCC1CC1", "OCc1ccccc1", "OCCc1ccccc1", "OC1CCCC1",
    ],
    "phenol": [
        "Oc1ccccc1", "Cc1ccc(O)cc1", "Oc1ccc(F)cc1", "Oc1ccc(Cl)cc1",
        "COc1ccc(O)cc1", "Cc1cccc(O)c1", "Oc1ccccc1C",
        # bifunctional handles
        "Nc1ccc(O)cc1", "O=Cc1ccc(O)cc1", "N#Cc1ccc(O)cc1",
        "O=[N+]([O-])c1ccc(O)cc1", "Oc1ccc(Br)cc1",
    ],
    "amine": [
        "CN", "CCN", "CCCN", "CC(C)N", "NC1CC1", "NCc1ccccc1",
        "Nc1ccccc1", "Cc1ccc(N)cc1", "NCCc1ccccc1", "Nc1ccc(F)cc1",
        # bifunctional handles
        "NCCO", "Nc1ccc(O)cc1", "NCc1ccc(Br)cc1",
    ],
    "alkyl_bromide": [
        "CBr", "CCBr", "CCCBr", "CC(C)Br", "BrCc1ccccc1", "BrCC1CC1",
    ],
    "aryl_bromide": [
        "Brc1ccccc1", "Cc1ccc(Br)cc1", "Fc1ccc(Br)cc1", "Brc1ccncc1",
        "COc1ccc(Br)cc1",
    ],
    "nitroarene": [
        "O=[N+]([O-])c1ccccc1", "Cc1ccc([N+](=O)[O-])cc1",
        "O=[N+]([O-])c1ccc(O)cc1", "O=[N+]([O-])c1ccc(F)cc1",
        "COc1ccc([N+](=O)[O-])cc1",
    ],
    "nitrile": [
        "CC#N", "CCC#N", "N#Cc1ccccc1", "N#CCc1ccccc1",
        "Cc1ccc(C#N)cc1", "N#Cc1ccc(Br)cc1",
    ],
    "ketone": [
        "CC(C)=O", "CCC(C)=O", "CC(=O)c1ccccc1", "O=C1CCCCC1",
        "CC(=O)CC(C)C",
    ],
    "aldehyde": [
        "CC=O", "CCC=O", "O=Cc1ccccc1", "Cc1ccc(C=O)cc1",
        "O=Cc1ccc(F)cc1",
    ],
    "sulfonyl_chloride": [
        "CS(=O)(=O)Cl", "O=S(=O)(Cl)c1ccccc1", "Cc1ccc(S(=O)(=O)Cl)cc1",
    ],
}

# small ubiquitous leaves the reference's inventory also carries
EXTRA_AVAILABLE = ["O", "CO", "CCO", "N", "CC(=O)O"]


def inventory() -> List[str]:
    """Every purchasable building block, canonical, deduped."""
    out: List[str] = []
    seen = set()
    for blocks in BUILDING_BLOCKS.values():
        for s in blocks:
            c = canonical_smiles(s)
            if c and c not in seen:
                seen.add(c)
                out.append(c)
    for s in EXTRA_AVAILABLE:
        c = canonical_smiles(s)
        if c and c not in seen:
            seen.add(c)
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# Deterministic structural properties
# ---------------------------------------------------------------------------

def _descriptors(smiles: str) -> Optional[Dict[str, float]]:
    mol = None
    try:
        mol = parse_smiles(smiles)
    except Exception:
        return None
    if mol is None:
        return None
    n = mol.n_atoms()
    if n == 0:
        return None
    rings = mol.smallest_rings()
    arom = sum(1 for a in mol.atoms if a.aromatic)
    polar = sum(1 for a in mol.atoms if a.z in (7, 8, 16))
    halo = sum(1 for a in mol.atoms if a.z in (9, 17, 35, 53))
    donors = sum(1 for i, a in enumerate(mol.atoms)
                 if a.z in (7, 8) and mol.total_hs(i) > 0)
    branches = sum(1 for i in range(n) if mol.degree(i) >= 3)
    return {
        "heavy": float(n),
        "rings": float(len(rings)),
        "aromatic_frac": arom / n,
        "polar_frac": polar / n,
        "polar": float(polar),
        "halo": float(halo),
        "donors": float(donors),
        "branches": float(branches),
    }


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


def structural_properties(smiles: str,
                          route_len: int = 0) -> Optional[Dict[str, float]]:
    """Deterministic pseudo-labels for all 10 channels from first-party
    descriptors. Not physical measurements — a LEARNABLE synthetic ground
    truth (every channel is a smooth function of graph structure, so a
    GIN oracle can regress it and discrimination tests have a target).
    Ranges mirror data/property_ranges.json."""
    d = _descriptors(smiles)
    if d is None:
        return None
    sa = 1.0 + 0.28 * d["rings"] + 0.055 * d["heavy"] + 0.35 * d["branches"] \
        + 0.6 * d["polar_frac"]
    sc = 1.0 + 0.55 * route_len + 0.04 * d["heavy"] + 0.2 * d["rings"] \
        + 0.3 * d["polar_frac"]
    return {
        # binary drug channels: structural thresholds
        "BBBP": 1.0 if (d["polar"] <= 3 and d["heavy"] <= 22
                        and d["donors"] <= 2) else 0.0,
        "HIV": 1.0 if (d["rings"] >= 2 and d["polar"] >= 2) else 0.0,
        "BACE": 1.0 if (d["aromatic_frac"] >= 0.4 and d["heavy"] >= 12)
                else 0.0,
        # continuous material channels: smooth structural functions
        "CO2": round(_clamp(0.5 + 3.0 * d["polar_frac"]
                            + 0.2 * d["halo"], 0.1, 6.0), 2),
        "N2": round(_clamp(0.3 + 1.5 * d["aromatic_frac"]
                           + 0.05 * d["heavy"], 0.1, 4.0), 2),
        "O2": round(_clamp(0.4 + 2.0 * d["polar_frac"]
                           + 0.6 * d["rings"] * 0.3, 0.1, 5.0), 2),
        "FFV": round(_clamp(0.25 + 0.01 * d["branches"]
                            + 0.004 * d["heavy"]
                            - 0.05 * d["polar_frac"], 0.1, 0.6), 3),
        "TC": round(_clamp(0.15 + 0.02 * d["rings"]
                           + 0.003 * d["heavy"], 0.05, 0.5), 3),
        "SC": round(_clamp(sc, 1.0, 5.0), 2),
        "SA": round(_clamp(sa, 1.0, 5.0), 2),
    }


# ---------------------------------------------------------------------------
# Route construction (forward) + retro verification
# ---------------------------------------------------------------------------

@dataclass
class RouteStep:
    product: str                 # canonical
    reactants: List[str]         # canonical
    reaction: Reaction


def _forward(rxn: Reaction, reactants: Sequence[str]) -> Optional[str]:
    """Apply the forward template; single-fragment, parseable outcomes
    only. Deterministic: first outcome in the engine's canonical-sorted
    order."""
    try:
        outcomes = rdchiral_run_text(rxn.fwd, ".".join(reactants))
    except Exception:
        return None
    for out in sorted(outcomes):
        if "." in out:
            continue
        c = canonical_smiles(out)
        if c is not None:
            return c
    return None


def _retro_verifies(rxn: Reaction, product: str,
                    reactants: Sequence[str]) -> bool:
    """The planner-visible check: running the RETRO template on the
    product must regenerate exactly the recorded reactant set (the same
    sorted-reactant-key merge sample_templates uses)."""
    want = ".".join(sorted(canonical_smiles(r) or r for r in reactants))
    try:
        outcomes = rdchiral_run_text(rxn.retro, product)
    except Exception:
        return False
    for out in outcomes:
        parts = sorted(canonical_smiles(p) or p for p in out.split("."))
        if ".".join(parts) == want:
            return True
    return False


def _build_route(rng: random.Random, n_steps: int,
                 max_heavy: int = 26) -> Optional[List[RouteStep]]:
    """Forward-construct an n_steps route; every step retro-verified.
    Returns steps in SYNTHESIS order (last step's product = the target)."""
    inv = set(inventory())
    steps: List[RouteStep] = []
    intermediate: Optional[str] = None

    def try_step(rxn: Reaction,
                 cand: List[str]) -> Optional[str]:
        cand[:] = [canonical_smiles(r) or r for r in cand]
        prod = _forward(rxn, cand)
        if prod is None or prod in inv:
            return None
        d = _descriptors(prod)
        if d is None or d["heavy"] > max_heavy:
            return None
        if not _retro_verifies(rxn, prod, cand):
            return None
        return prod

    # bifunctional blocks carry the handle the NEXT step consumes —
    # bias step 1 toward them when a multi-step route is requested
    def pick_block(cls: str) -> str:
        pool = BUILDING_BLOCKS[cls]
        if n_steps > 1 and not steps and rng.random() < 0.7:
            multi = [s for s in pool
                     if sum(s.count(h) for h in
                            ("N", "O", "Br", "#N")) >= 3]
            if multi:
                return rng.choice(multi)
        return rng.choice(pool)

    for _ in range(n_steps):
        placed = False
        if intermediate is None:
            for _attempt in range(12):
                rxn = rng.choice(REACTIONS)
                cand = [pick_block(s) for s in rxn.slots]
                prod = try_step(rxn, cand)
                if prod is not None:
                    steps.append(RouteStep(prod, cand, rxn))
                    intermediate = prod
                    placed = True
                    break
        else:
            # extension: sweep every reaction (shuffled), intermediate in
            # each slot, a few random fills for the remaining slots
            order = list(REACTIONS)
            rng.shuffle(order)
            for rxn in order:
                for si in range(len(rxn.slots)):
                    for _fill in range(3):
                        cand = [intermediate if sj == si
                                else rng.choice(BUILDING_BLOCKS[rxn.slots[sj]])
                                for sj in range(len(rxn.slots))]
                        prod = try_step(rxn, cand)
                        if prod is not None and intermediate in cand:
                            steps.append(RouteStep(prod, cand, rxn))
                            intermediate = prod
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
        if not placed:
            return steps or None
    return steps


# ---------------------------------------------------------------------------
# Record rendering (MolQA schema; aligner-compatible)
# ---------------------------------------------------------------------------

_INSTRUCTIONS = [
    "Can you design a molecule with the requested property profile and "
    "describe its synthesis?",
    "Design a molecule that satisfies the given property constraints and "
    "outline a synthetic route.",
    "Propose a molecule meeting the property requirements and explain "
    "how to make it.",
    "What molecule fits this property profile, and how would you "
    "synthesize it?",
]

_DRUG_CHANNELS = ["BBBP", "HIV", "BACE"]
_MATERIAL_CHANNELS = ["CO2", "N2", "O2", "FFV", "TC"]


def _analysis_sentence(smiles: str, props: Dict[str, float]) -> str:
    d = _descriptors(smiles) or {}
    bits = []
    rings = int(d.get("rings", 0))
    bits.append(f"{int(d.get('heavy', 0))} heavy atoms")
    bits.append(f"{rings} ring{'s' if rings != 1 else ''}")
    if d.get("aromatic_frac", 0) > 0.3:
        bits.append("an aromatic core")
    if d.get("donors", 0) >= 2:
        bits.append("multiple hydrogen-bond donors")
    elif d.get("polar", 0) >= 2:
        bits.append("polar functionality")
    sa = props.get("SA")
    if sa is not None:
        level = ("low" if sa < 2.2 else "moderate" if sa < 3.2 else "high")
        bits.append(f"{level} synthetic accessibility")
    return ("the designed molecule features " + ", ".join(bits[:-1])
            + " and " + bits[-1])


def _render_output(steps: List[RouteStep], props: Dict[str, float],
                   inv: set) -> Tuple[str, List[int]]:
    """MolQA output text + retro label list, retro order (step 1 =
    disconnect the final target, like the shipped examples)."""
    target = steps[-1].product
    retro_steps = list(reversed(steps))
    parts = [
        "To satisfy the requirements: "
        f"{_analysis_sentence(target, props)}. Therefore, the designed "
        f"molecule is: <design_start><design_end><mol_start>{target}"
        "<mol_end>."
    ]
    labels: List[int] = []
    for k, st in enumerate(retro_steps, start=1):
        rxn_text = f"{st.product}>>{'.'.join(st.reactants)}"
        reactant_bits = []
        for r in st.reactants:
            mark = " (available)" if r in inv else ""
            reactant_bits.append(f"{r}{mark}")
        parts.append(
            f" This is step {k} in the retrosynthesis process. To "
            f"synthesize <mol_start>{st.product}<mol_end>, follow these "
            f"procedures: {st.reaction.procedure}. The applied reaction "
            f"is: <retro_start><retro_end>{rxn_text}, which requires the "
            f"reactants: {', '.join(reactant_bits)}.")
        labels.append(st.reaction.label)
    return "".join(parts), labels


def generate_record(rng: random.Random,
                    kind: str = "drug") -> Optional[Dict[str, Any]]:
    n_steps = rng.choices([1, 2, 3], weights=[0.55, 0.33, 0.12])[0]
    steps = _build_route(rng, n_steps)
    if not steps:
        return None
    target = steps[-1].product
    props_all = structural_properties(target, route_len=len(steps))
    if props_all is None:
        return None
    if kind == "material":
        channels = rng.sample(_MATERIAL_CHANNELS,
                              k=rng.randint(2, len(_MATERIAL_CHANNELS)))
    else:
        channels = rng.sample(_DRUG_CHANNELS, k=rng.randint(1, 2))
    channels += ["SC", "SA"]
    props = {c: props_all[c] for c in channels}
    inv = set(inventory())
    output, labels = _render_output(steps, props, inv)
    return {
        "instruction": rng.choice(_INSTRUCTIONS),
        "input": "",
        "output": output,
        "property": props,
        "retro": labels,
    }


def generate_corpus(n_records: int, seed: int = 0,
                    material_frac: float = 0.15) -> List[Dict[str, Any]]:
    """n_records verified MolQA records (deduped by target molecule up
    to a point — targets may repeat with different property subsets,
    mirroring the real corpus' many-records-per-scaffold shape)."""
    rng = random.Random(seed)
    records: List[Dict[str, Any]] = []
    attempts = 0
    while len(records) < n_records and attempts < n_records * 30:
        attempts += 1
        kind = "material" if rng.random() < material_frac else "drug"
        rec = generate_record(rng, kind)
        if rec is not None:
            records.append(rec)
    if len(records) < n_records:
        logger.warning("generated %d/%d records (%d attempts)",
                       len(records), n_records, attempts)
    return records


def write_corpus(path: str, n_records: int, seed: int = 0) -> Dict[str, Any]:
    """Write corpus + sidecars (inventory, label->template map) next to
    it. Returns a small manifest."""
    records = generate_corpus(n_records, seed=seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    base = os.path.splitext(path)[0]
    inv = inventory()
    with open(base + ".inventory.json", "w") as f:
        json.dump(inv, f, indent=1)
    with open(base + ".templates.json", "w") as f:
        json.dump({str(k): v for k, v in LABEL_TO_TEMPLATE.items()}, f,
                  indent=1)
    targets = {r["output"].split("<mol_start>")[1].split("<mol_end>")[0]
               for r in records}
    manifest = {"records": len(records), "unique_targets": len(targets),
                "inventory": len(inv), "templates": len(LABEL_TO_TEMPLATE),
                "seed": seed}
    logger.info("synthetic corpus: %s", manifest)
    return manifest
