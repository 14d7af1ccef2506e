"""The plain reference against the port, at a tiny size on the CPU, in
float32: the decoder's logits, the denoiser (sampling and training with
the generator's draws), GraphCLIP, the predictor, and GraphLM.loss on a
collated training batch."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import program, weights
from perfbench.drivers import sft
from perfbench.reference import graph as ref_graph
from perfbench.reference import tokens as ref_tokens
from perfbench.reference.llm import Decoder

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
DATA = os.path.join(os.path.dirname(TINY), "..", "data", "molqa.json")
SEED = 2 ** 31 + 77


def tiny(name, dtype="float32"):
    with open(os.path.join(TINY, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["dtype"] = dtype
    return cfg


@pytest.fixture(scope="module")
def built():
    cfg = tiny("qwen2-7b")
    with open(DATA) as f:
        corpus = json.load(f)["molecules"]
    model, tok, spec = program.build(cfg, SEED, torch.device("cpu"), corpus,
                                     0.0025, {})
    w = weights.tensors(spec, SEED, torch.device("cpu"))
    return cfg, model, tok, spec, w


def test_weights_are_the_models(built):
    cfg, model, _, _, w = built
    params = dict(model.named_parameters())
    assert set(params) == set(w)
    for name, t in w.items():
        assert torch.equal(params[name].float(), t), name


def test_draws_repeat_by_group(built):
    _, _, _, spec, w = built
    again = weights.tensors(spec, SEED, torch.device("cpu"),
                            ("llm.layers.1",))
    for name, t in again.items():
        assert torch.equal(t, w[name])
    other = weights.tensors(spec, SEED + 1, torch.device("cpu"),
                            ("llm.layers.1",))
    assert not all(torch.equal(t, w[n]) for n, t in other.items())


def test_decoder_logits(built):
    cfg, model, _, _, w = built
    dec = Decoder(program.llm_fields(cfg), dict(w), program.lora_scale(cfg))
    ids = torch.randint(0, 268, (1, 37), generator=torch.Generator()
                        .manual_seed(3))
    with torch.no_grad():
        logits, hidden, _ = model.llm(input_ids=ids)
        want_h = dec.hidden(dec.embed(ids[0]))
        want = dec.logits(want_h)
    assert torch.allclose(hidden[0], want_h, atol=1e-5, rtol=1e-5)
    assert torch.allclose(logits[0], want, atol=1e-4, rtol=1e-4)


def test_byte_tokens(built):
    _, _, tok, _, _ = built
    text = "Design <design_start> a molecule. ünï"
    assert tok.encode(text) == ref_tokens.encode(
        text, tiny("qwen2-7b")["special_tokens"])


def _graphs(n_graphs, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    atoms = torch.randint(0, 8, (n_graphs, n), generator=g)
    sizes = torch.randint(3, n + 1, (n_graphs,), generator=g)
    mask = torch.arange(n)[None] < sizes[:, None]
    e = torch.randint(0, 5, (n_graphs, n, n), generator=g)
    e = torch.triu(e, 1)
    e = e + e.transpose(1, 2)
    return atoms, e.to(torch.int32), mask


def test_graphclip_and_predictor(built):
    cfg, model, _, _, w = built
    atoms, edges, mask = _graphs(3, 9)
    with torch.no_grad():
        got = model.graph_encoder(atoms, edges, mask)
        want = ref_graph.graphclip(w, atoms, edges, mask,
                                   cfg["graphclip"]["num_layer"])
        assert torch.allclose(got, want, atol=1e-5)
        cond = torch.randn(3, cfg["predictor"]["text_input_size"])
        got = model.graph_predictor(atoms, edges, mask, cond)
        want = ref_graph.predictor(w, atoms, edges, mask, cond,
                                   cfg["predictor"]["num_layer"])
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_denoiser(built, train):
    cfg, model, _, _, w = built
    dit = cfg["graphdit"]
    den = model.graph_decoder.denoiser
    b, n = 4, dit["max_n_nodes"]
    dx, de = den.cfg.Xdim, dit["Edim"]
    g = torch.Generator().manual_seed(5)
    mask = torch.arange(n)[None] < torch.tensor([[5], [9], [n], [1]])
    X = torch.nn.functional.one_hot(torch.randint(0, dx, (b, n), generator=g),
                                    dx).float() * mask[..., None]
    E = torch.nn.functional.one_hot(torch.randint(0, de, (b, n, n),
                                                  generator=g), de).float()
    y = torch.randn(b, dit["ydim"], generator=g)
    y[1, 3:] = float("nan")
    txt = torch.randn(b, dit["text_dim"], generator=g)
    txt[2] = float("nan")
    t = torch.rand(b, generator=g)
    gen_p = torch.Generator().manual_seed(9)
    gen_r = torch.Generator().manual_seed(9)
    with torch.no_grad():
        got = den(X, E, mask, y, txt, t, train=train, generator=gen_p)
        want = ref_graph.denoiser(
            w, X, E, mask, y, txt, t, dit,
            draws=ref_graph.generator_draws(gen_r, "cpu") if train else None)
    for a, b_ in zip(got, want):
        assert torch.allclose(a, b_, atol=2e-5, rtol=1e-4)


def test_training_loss_against_graphlm_loss():
    cfg = tiny("mistral-7b")
    with open(os.path.join(TINY, "sft.json")) as f:
        tr = json.load(f)
    from llamole_tpu_torch.chem.featurize import smiles_to_graph
    from llamole_tpu_torch.data.aligner import align_dataset
    from llamole_tpu_torch.data.collator import SeqGraphCollator
    from llamole_tpu_torch.data.loader import build_graph_bank
    from llamole_tpu_torch.data.processor import preprocess_examples
    from llamole_tpu_torch.data.template import get_template
    from perfbench import traffic
    with open(DATA) as f:
        data = json.load(f)
    dev = torch.device("cpu")
    model, tok, spec = program.build(cfg, SEED, dev, data["molecules"], 0.0025,
                                     {})
    template = get_template(cfg["template"], tok)

    recs = traffic.training_records(SEED, dict(tr, pool=2), data)
    ex, id_to_smiles = align_dataset(recs, 8)
    inputs = preprocess_examples(ex, template, tok, 512)
    collator = SeqGraphCollator(tokenizer=tok,
                                mol_id_to_graph=build_graph_bank(id_to_smiles),
                                max_len=512, max_nodes=24, max_graphs=16,
                                max_retro=16, pad_to_multiple_of=64)
    batch = collator(inputs)
    corpus = [smiles_to_graph(s) for s in data["molecules"]]
    active = sorted({int(a) for g in corpus for a in g.atom_types})
    noisy = sft.noised_design(batch, active, len(active), 5, 4,
                              np.random.default_rng(1))
    gen = torch.Generator().manual_seed(SEED)
    total, aux = model.loss(batch, gen, train=True,
                            noisy={k: torch.as_tensor(v) for k, v in
                                   noisy.items()})
    ref = sft.Reference(cfg, spec, SEED, dev, 10)
    want = ref.loss(batch, noisy, active)
    assert float(aux["lm_loss"]) == pytest.approx(float(want[1]), rel=1e-4)
    assert float(aux["design_loss"]) == pytest.approx(float(want[2]),
                                                      rel=1e-4)
    assert float(aux["retro_loss"]) == pytest.approx(float(want[3]), rel=1e-4)
    assert float(total) == pytest.approx(float(want[0]), rel=1e-4)
