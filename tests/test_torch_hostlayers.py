"""The port's own copies of the JAX-free host layers (llamole_tpu_torch.chem,
.data, .planner, .config, .utils) agree with the JAX package's on the same
inputs: SMILES canonicalisation, featurisation and graph assembly,
template application, fingerprints, the tokenizer, the chat template, the
collator's batches, the argument parser and the Retro* search."""

import json
import os
import sys
import types

import numpy as np
import pytest

from llamole_tpu import chem as jchem
from llamole_tpu import config as jconfig
from llamole_tpu import planner as jplanner
from llamole_tpu.chem import assemble as jassemble
from llamole_tpu.chem import featurize as jfeat
from llamole_tpu.chem import reaction as jreaction
from llamole_tpu.data import collator as jcollator
from llamole_tpu.data import loader as jloader
from llamole_tpu.data import template as jtemplate
from llamole_tpu.data import tokenizer as jtokenizer
from llamole_tpu.models.loader import _FALLBACK_TEMPLATES as JAX_TEMPLATES
from llamole_tpu.utils import constants as jconst
from llamole_tpu_torch import chem as tchem
from llamole_tpu_torch import config as tconfig
from llamole_tpu_torch import planner as tplanner
from llamole_tpu_torch.chem import assemble as tassemble
from llamole_tpu_torch.chem import featurize as tfeat
from llamole_tpu_torch.chem import reaction as treaction
from llamole_tpu_torch.data import collator as tcollator
from llamole_tpu_torch.data import loader as tloader
from llamole_tpu_torch.data import template as ttemplate
from llamole_tpu_torch.data import tokenizer as ttokenizer
from llamole_tpu_torch.models.loader import _FALLBACK_TEMPLATES
from llamole_tpu_torch.utils import constants as tconst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


_SMOKE = _chip_smoke()
# chip_smoke.py's corpus and molecules, a stereocentre, a Kekulé ring, a
# charged atom, a wildcard, and three that must fail cleanly
MOLECULES = (list(_SMOKE.CORPUS) + list(_SMOKE.MOLECULES) + [
    "N[C@@H](C)C(=O)O", "C1=CC=CC=C1", "C[N+](C)(C)C", "*c1ccccc1",
    "not a molecule", "", "C1CC"])
VALID = [s for s in MOLECULES if jchem.canonical_smiles(s) is not None]
TEMPLATES = sorted(JAX_TEMPLATES.items())
PRODUCTS = ["CC(=O)OCC", "CC(=O)NCC", "COc1ccccc1", "CCO", "Brc1ccccc1",
            "CC(C)CO", "CC(=O)Oc1ccccc1C(=O)O"]


def test_constants_equal():
    for name in ("IGNORE_INDEX", "NO_LABEL_INDEX", "BOND_INDEX",
                 "MOL_PROPERTIES", "SPECIAL_TOKENS", "ATOM_TYPE_OFFSET",
                 "WILDCARD_ATOM_TYPE", "DATA_CONFIG"):
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("smiles", MOLECULES)
def test_canonical_smiles_and_recanonicalize_match(smiles):
    assert tchem.canonical_smiles(smiles) == jchem.canonical_smiles(smiles)
    assert tchem.recanonicalize(smiles) == jchem.recanonicalize(smiles)


@pytest.mark.parametrize("smiles", MOLECULES)
def test_smiles_to_graph_matches(smiles):
    ours, theirs = tfeat.smiles_to_graph(smiles), jfeat.smiles_to_graph(smiles)
    if theirs is None:
        assert ours is None
        return
    assert ours.n_nodes == theirs.n_nodes
    np.testing.assert_array_equal(ours.atom_types, theirs.atom_types)
    np.testing.assert_array_equal(ours.edge_classes, theirs.edge_classes)


@pytest.mark.parametrize("max_nodes", [16, 56])
def test_pad_graph_batch_matches(max_nodes):
    ours = tfeat.pad_graph_batch([tfeat.smiles_to_graph(s) for s in VALID],
                                 max_nodes)
    theirs = jfeat.pad_graph_batch([jfeat.smiles_to_graph(s) for s in VALID],
                                   max_nodes)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _decoder():
    """Atom-type code -> symbol over every code the molecules use."""
    from llamole_tpu.chem.periodic import Z_TO_SYMBOL
    return ["*" if c == jconst.WILDCARD_ATOM_TYPE
            else Z_TO_SYMBOL.get(c + jconst.ATOM_TYPE_OFFSET, "*")
            for c in range(jconst.WILDCARD_ATOM_TYPE + 1)]


@pytest.mark.parametrize("smiles", VALID)
def test_graph_to_smiles_and_check_valid_match(smiles):
    g = jfeat.smiles_to_graph(smiles)
    graphs = [(g.atom_types, g.edge_classes),
              # a corrupted copy: every bond raised to a triple bond
              (g.atom_types, np.where(g.edge_classes > 0, 3, 0))]
    ours = tassemble.graph_to_smiles(graphs, _decoder())
    theirs = jassemble.graph_to_smiles(graphs, _decoder())
    assert ours == theirs
    for s in ours + [smiles, None, "C1CC"]:
        assert tassemble.check_valid(s) == jassemble.check_valid(s)


def test_built_in_templates_equal():
    assert _FALLBACK_TEMPLATES == JAX_TEMPLATES


@pytest.mark.parametrize("label,template", TEMPLATES)
def test_apply_retro_template_matches(label, template):
    for product in PRODUCTS:
        ours = treaction.apply_retro_template(template, product)
        theirs = jreaction.apply_retro_template(template, product)
        assert ours == theirs, (label, product)


@pytest.mark.parametrize("radius,n_bits", [(2, 2048), (3, 1024)])
def test_morgan_fingerprint_matches(radius, n_bits):
    for smiles in MOLECULES:
        ours = tchem.morgan_fingerprint(smiles, radius=radius, n_bits=n_bits)
        theirs = jchem.morgan_fingerprint(smiles, radius=radius,
                                          n_bits=n_bits)
        if theirs is None:
            assert ours is None, smiles
        else:
            np.testing.assert_array_equal(ours, theirs, err_msg=smiles)


TEXTS = ["Design a molecule with <design_start> and <molecule>.",
         "CC(=O)Oc1ccccc1C(=O)O", "héllo ✓ 分子", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches(text):
    ours = ttokenizer.ByteTokenizer(tconst.SPECIAL_TOKENS)
    theirs = jtokenizer.ByteTokenizer(jconst.SPECIAL_TOKENS)
    assert ours.vocab_size == theirs.vocab_size
    assert ours.additional_special_tokens_ids == \
        theirs.additional_special_tokens_ids
    for special in (False, True):
        ids = ours.encode(text, add_special_tokens=special)
        assert ids == theirs.encode(text, add_special_tokens=special)
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                theirs.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("name", ["llama3", "default"])
def test_template_encodings_match(name):
    ours_tok = ttokenizer.ByteTokenizer(tconst.SPECIAL_TOKENS)
    theirs_tok = jtokenizer.ByteTokenizer(jconst.SPECIAL_TOKENS)
    ours = ttemplate.get_template(name, ours_tok)
    theirs = jtemplate.get_template(name, theirs_tok)
    messages = [{"role": "user", "content": "Design an aromatic amine."},
                {"role": "assistant", "content": "<design_start>CCN"},
                {"role": "user", "content": "And its route?"},
                {"role": "assistant", "content": "<retro_start> done"}]
    for system in (None, "You are a chemist."):
        assert ours.encode_multiturn(ours_tok, messages, system) == \
            theirs.encode_multiturn(theirs_tok, messages, system)
        assert ours.render_prompt(messages[:1], system) == \
            theirs.render_prompt(messages[:1], system)


def _batches(loader, collator, tokenizer_mod, const, template):
    tok = tokenizer_mod.ByteTokenizer(const.SPECIAL_TOKENS)
    data_args = types.SimpleNamespace(
        dataset="molqa_train_examples", dataset_dir=os.path.join(ROOT, "data"),
        max_samples=None, template=template, learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    bank, inputs = loader.get_dataset(None, data_args, None, tok)
    collate = collator.SeqGraphCollator(
        tokenizer=tok, mol_id_to_graph=bank, max_len=768, max_nodes=32,
        max_graphs=16, max_retro=16)
    return inputs, [collate(inputs[i:i + 2]) for i in range(0, len(inputs),
                                                             2)]


@pytest.mark.parametrize("template", ["llama3", "default"])
def test_collator_batches_match(template):
    ours_inputs, ours = _batches(tloader, tcollator, ttokenizer, tconst,
                                 template)
    theirs_inputs, theirs = _batches(jloader, jcollator, jtokenizer, jconst,
                                     template)
    assert len(ours_inputs) == len(theirs_inputs) == 5
    for a, b in zip(ours_inputs, theirs_inputs):
        assert a["input_ids"] == b["input_ids"]
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("path", ["config/smoke/tiny_train.yaml",
                                  "config/train/llama_lora.yaml"])
def test_train_args_match(path):
    ours = tconfig.get_train_args(os.path.join(ROOT, path))
    theirs = jconfig.get_train_args(os.path.join(ROOT, path))
    for a, b in zip(ours, theirs):
        assert vars(a) == vars(b)


def _toy_expand(reaction):
    """A deterministic expansion: every built-in template applied to the
    product, scored by its label."""
    def batch_expand(items):
        out = []
        for _, smiles in items:
            reactants, scores, templates = [], [], []
            for label, template in TEMPLATES:
                for r in reaction.apply_retro_template(template, smiles):
                    reactants.append(r)
                    scores.append(1.0 / (2 + label))
                    templates.append(template)
            out.append({"reactants": reactants, "scores": scores,
                        "templates": templates,
                        "analysis": [f"via {t}" for t in templates]}
                       if reactants else None)
        return out
    return batch_expand


def _routes(planner, reaction):
    known = {"CC(=O)O", "CCO", "CCN", "c1ccccc1", "CO"}
    searched = planner.retro_star_search_multi(
        ["CC(=O)OCC", "CC(=O)NCC", "CCCCO", "COc1ccccc1"], known,
        _toy_expand(reaction), lambda smiles, parent=None: 1.0,
        iterations=6, max_time=1e4, total_width=3)
    return {t: (ok, route.get_reaction_list() if route else None, n)
            for t, (ok, route, n) in searched.items()}


def test_retro_star_search_multi_routes_match():
    ours = _routes(tplanner, treaction)
    theirs = _routes(jplanner, jreaction)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    assert ours["CC(=O)OCC"][0] and ours["CC(=O)NCC"][0]


def _data_smiles():
    """Every molecule of the repo's MolQA files (data/*.json)."""
    from llamole_tpu.data.aligner import extract_all_smiles

    found = []
    for name in sorted(os.listdir(os.path.join(ROOT, "data"))):
        if not name.startswith("molqa_"):
            continue
        with open(os.path.join(ROOT, "data", name)) as f:
            for rec in json.load(f):
                for key in ("instruction", "input", "output"):
                    for smi in extract_all_smiles(rec.get(key) or ""):
                        if smi not in found:
                            found.append(smi)
    return found


def _depict_cases():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from test_depict import CASES
    finally:
        sys.path.pop(0)
    return list(CASES)


# the data's molecules, tests/test_depict.py's cases and its stereo
# molecules (wedges, a ring stereocentre), the smoke script's, and inputs
# that must give None
DEPICT = list(dict.fromkeys(
    _data_smiles() + _depict_cases() + [
        "N[C@@H](C)C(=O)O", "N[C@H](C)C(=O)O", "NC(C)C(=O)O",
        "F[C@](Cl)(Br)I", "F[C@@](Cl)(Br)I", "O=C(O)[C@@H]1CCCN1", "CCN"]
    + list(_SMOKE.MOLECULES) + ["garbage((", ""]))


@pytest.mark.parametrize("smiles", DEPICT)
def test_depiction_is_jax_byte_for_byte(smiles):
    """layout_2d's coordinates (the same floats) and mol_to_svg's text."""
    from llamole_tpu.chem import depict as jdepict
    from llamole_tpu.chem.smiles import parse_smiles as jparse
    from llamole_tpu_torch.chem import depict as tdepict
    from llamole_tpu_torch.chem.smiles import parse_smiles as tparse

    assert tdepict.mol_to_svg(smiles) == jdepict.mol_to_svg(smiles)
    assert tdepict.mol_to_svg(smiles, width=500, height=300) == \
        jdepict.mol_to_svg(smiles, width=500, height=300)
    if jchem.canonical_smiles(smiles) is not None:
        assert tdepict.layout_2d(tparse(smiles)) == \
            jdepict.layout_2d(jparse(smiles))


_REACTIONS = [
    ("CC(=O)Oc1ccccc1C(=O)O", ["CC(=O)O", "Oc1ccccc1C(=O)O"]),
    ("bad((", ["CCO"]),
    ("CCO", ["C=C", "O", "garbage(("]),
] + [(p, [r]) for p, r in zip(DEPICT[:6], DEPICT[1:7])]


@pytest.mark.parametrize("product,reactants", _REACTIONS)
def test_reaction_depiction_is_jax_byte_for_byte(product, reactants):
    from llamole_tpu.chem import depict as jdepict
    from llamole_tpu_torch.chem import depict as tdepict

    assert tdepict.reaction_to_svg(product, reactants) == \
        jdepict.reaction_to_svg(product, reactants)
