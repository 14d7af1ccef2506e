"""The port's web UI (llamole_tpu_torch/webui) against the JAX package's
(llamole_tpu/webui and the repo's launch.py), on the CPU: the page byte
for byte, process_input's arrays, a CPU DesignUIServer answering the
page, /health, a design request (with an SVG when the molecule is valid)
and bad requests, build_app's gradio widgets and run() under a stub
gradio module, render_molecule_and_route, and the launcher's choice of
UI library."""

import importlib.util
import json
import os
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llamole_tpu.data import template as jtemplate
from llamole_tpu.data import tokenizer as jtokenizer
from llamole_tpu.utils import constants as jconst
from llamole_tpu.webui import server as jserver
from llamole_tpu.webui import workflow as jworkflow
from llamole_tpu_torch.data import template as ttemplate
from llamole_tpu_torch.data import tokenizer as ttokenizer
from llamole_tpu_torch.utils import constants as tconst
from llamole_tpu_torch.webui import __main__ as tlaunch
from llamole_tpu_torch.webui import server as tserver
from llamole_tpu_torch.webui import workflow as tworkflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = {
    "model_name_or_path": "",
    "dataset": "molqa_drug_examples",
    "dataset_dir": os.path.join(ROOT, "data"),
    "template": "default",
    "cutoff_len": 96,
    "learned_query_size": 4,
    "do_train": False,
    "output_dir": "",
    "max_new_tokens": 6,
    "temperature": 0.6,
    "top_p": 0.9,
}


def _launch():
    """The repo's launch.py as a module (its __main__ block does not run)."""
    spec = importlib.util.spec_from_file_location(
        "launch", os.path.join(ROOT, "launch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_render_page_is_jax_byte_for_byte():
    assert tserver._render_page() == jserver._render_page()
    assert (tserver.DRUG_PROPS, tserver.MATERIAL_PROPS,
            tserver.SYNTH_PROPS) == (jserver.DRUG_PROPS,
                                     jserver.MATERIAL_PROPS,
                                     jserver.SYNTH_PROPS)


def _state(tok_mod, tmpl_mod, const, template, cutoff):
    tok = tok_mod.ByteTokenizer(const.SPECIAL_TOKENS)
    return {"tokenizer": tok, "template": tmpl_mod.get_template(template, tok),
            "data_args": types.SimpleNamespace(cutoff_len=cutoff)}


@pytest.mark.parametrize("template", ["default", "llama3"])
@pytest.mark.parametrize("instruction,props", [
    ("Design a small polar molecule.", {"SC": 2.0, "SA": 2.0}),
    ("", {}),
    ("Design a membrane for CO2 " * 20, {"CO2": 3.5, "HIV": 1.0}),
])
def test_process_input_equals_jax(template, instruction, props):
    ours = tworkflow.process_input(
        _state(ttokenizer, ttemplate, tconst, template, 96), instruction,
        props)
    theirs = jworkflow.process_input(
        _state(jtokenizer, jtemplate, jconst, template, 96), instruction,
        props)
    assert ours.keys() == theirs.keys() == {"input_ids", "attention_mask",
                                            "property"}
    for k in ours:
        assert ours[k].shape[0] == 1
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.fixture(scope="module")
def server():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    srv = tserver.DesignUIServer(CONFIG, host="127.0.0.1", port=0,
                                 device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    torch.set_num_threads(threads)


def _get(srv, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=60) as r:
        return r.status, r.read().decode()


def _post(srv, path, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_state_is_built_on_the_cpu(server):
    state = server.state
    assert set(state) == {"model", "tokenizer", "template", "data_args",
                          "generating_args"}
    assert state["model"].device == torch.device("cpu")
    assert state["data_args"].cutoff_len == 96
    assert state["generating_args"].max_new_tokens == 6


def test_page_and_health(server):
    status, page = _get(server, "/")
    assert status == 200 and page == jserver._render_page()
    status, body = _get(server, "/health")
    assert status == 200 and json.loads(body)["ok"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_design_request_lands_svg(server):
    """Design + retro over HTTP with JAX's response keys; a valid
    molecule comes back with its SVG (random tiny weights: a few seeds
    are swept)."""
    got_svg = False
    for seed in range(8):
        status, out = _post(server, "/api/design", json.dumps({
            "instruction": "Design a small ester with low SA.",
            "properties": {"SA": 2.0, "SC": 2.0, "bogus": 1.0},
            "seed": seed}).encode())
        assert status == 200
        assert set(out) == {"smiles", "valid", "text_html",
                            "reactions_html", "mol_svg", "route_svg",
                            "route_found"}
        if out["valid"]:
            assert out["mol_svg"].startswith("<svg"), out["mol_svg"][:80]
            got_svg = True
            break
    assert got_svg, "no valid molecule in 8 seeds"


def test_bad_requests_are_isolated(server):
    """A malformed body answers 500 with an "error", an unknown endpoint
    404; the server keeps answering."""
    status, body = _post(server, "/api/design", b"{not json")
    assert status == 500 and "error" in json.loads(body)
    status, body = _post(server, "/api/unknown", b"{}")
    assert status == 404 and json.loads(body) == {"error": "unknown endpoint"}
    status, _ = _get(server, "/health")
    assert status == 200


class _Widget:
    def __init__(self, *args, **kwargs):
        self.spec = (type(self).__name__, args, kwargs)


def _stub_gradio():
    gr = types.ModuleType("gradio")
    for name in ("Textbox", "Radio", "Slider", "HTML"):
        setattr(gr, name, type(name, (_Widget,), {}))

    class Interface:
        def __init__(self, fn, inputs, outputs, title):
            self.fn = fn
            self.spec = ([w.spec for w in inputs], [w.spec for w in outputs],
                         title)
            self.launched = False

        def launch(self):
            self.launched = True

    gr.Interface = Interface
    return gr


_INFO = {"text_lists": [["Analysis: ", None, "an ester."]],
         "smiles_list": ["CC(=O)Oc1ccccc1C(=O)O"],
         "retro_plan_dict": {"CC(=O)Oc1ccccc1C(=O)O": {
             "success": True, "reaction_list": [
                 "CC(=O)Oc1ccccc1C(=O)O>>CC(=O)O.Oc1ccccc1C(=O)O"]}}}


def test_build_app_equals_launch_py(monkeypatch):
    """The same widgets, outputs and title; run() passes the same
    properties on and returns the same five outputs."""
    monkeypatch.setitem(sys.modules, "gradio", _stub_gradio())
    seen = {}
    apps = {}
    for key, module, launch in (("jax", jworkflow, _launch()),
                                ("port", tworkflow, tlaunch)):
        monkeypatch.setattr(module, "load_model_and_tokenizer",
                            lambda config, **kw: {"config": config, **kw})

        def process_input(state, instruction, props, _k=key):
            seen[_k] = (state, instruction, props)
            return {}

        monkeypatch.setattr(module, "process_input", process_input)
        monkeypatch.setattr(module, "generate",
                            lambda state, batch, **kw: _INFO)
        apps[key] = (launch.build_app("cfg.yaml") if key == "jax"
                     else launch.build_app("cfg.yaml", device="cpu"))
    assert apps["port"].spec == apps["jax"].spec
    assert len(apps["port"].spec[0]) == 11
    values = ("Design one.", "1", "NAN", "0", 2.5, 0.0, 0, 1.0, 0.3, 3.0,
              2.0)
    assert apps["port"].fn(*values) == apps["jax"].fn(*values)
    assert seen["port"][1:] == seen["jax"][1:]
    # "NAN" and 0 leave a channel unconditioned, the radio's "0" does not
    assert seen["port"][2] == {"BBBP": 1.0, "BACE": 0.0, "CO2": 2.5,
                               "FFV": 1.0, "TC": 0.3, "SC": 3.0, "SA": 2.0}
    assert seen["port"][0] == {"config": "cfg.yaml", "device": "cpu"}


@pytest.mark.parametrize("smiles,reactions", [
    ("CC(=O)Oc1ccccc1C(=O)O",
     ["CC(=O)Oc1ccccc1C(=O)O>>CC(=O)O.Oc1ccccc1C(=O)O"]),
    ("CCO", ["CCO>>C=C.O", "not a reaction", "bad((>>CCO"]),
    (None, None),
    ("garbage((", []),
])
def test_render_molecule_and_route_equals_launch_py(smiles, reactions):
    ours = tlaunch.render_molecule_and_route(smiles, reactions)
    assert ours == _launch().render_molecule_and_route(smiles, reactions)
    if smiles == "CCO":
        assert ours[0].startswith("<svg") and ours[1].count("<svg") == 1


def test_launcher_serves_the_stdlib_ui_without_gradio(monkeypatch):
    """No gradio: a logged notice, then the stdlib server on --port and
    --device; --no-gradio asks for it; with gradio the app launches."""
    calls = []

    class FakeServer:
        def serve_forever(self):
            calls.append("served")

    def build_server(config, port, device):
        calls.append((config, port, device))
        return FakeServer()

    monkeypatch.setattr(tserver, "build_server", build_server)
    notices = []
    monkeypatch.setattr(tlaunch.logger, "warning",
                        lambda msg, *args: notices.append(msg % args))
    monkeypatch.setitem(sys.modules, "gradio", None)   # import fails
    tlaunch.main(["cfg.yaml", "--port=1234", "--device", "cpu"])
    assert calls == [("cfg.yaml", 1234, "cpu"), "served"]
    assert len(notices) == 1 and "gradio not installed" in notices[0]
    calls.clear()
    monkeypatch.setitem(sys.modules, "gradio", _stub_gradio())
    tlaunch.main(["--no-gradio"])
    assert calls == [("config/generate/llama_drug.yaml", 7860, "cuda"),
                     "served"]
    apps = []

    def build_app(config, device):
        apps.append((config, device))
        return types.SimpleNamespace(launch=lambda: apps.append("launched"))

    monkeypatch.setattr(tlaunch, "build_app", build_app)
    tlaunch.main(["cfg.yaml"])
    assert apps == [("cfg.yaml", "cuda"), "launched"]
