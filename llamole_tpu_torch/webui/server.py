"""Dependency-free web UI: stdlib http.server + first-party SVG
(counterpart of llamole_tpu/webui/server.py, the same page and JSON).

The reference's UI is gradio (launch.py:116-238); this single-page
server serves the same design + retrosynthesis flow through the port's
own pieces (webui/workflow.py model state, chem/depict.py SVG). One lock
serializes generate() calls (one model on one device per process); the
HTTP layer is threaded so the page stays responsive.

Run: python -m llamole_tpu_torch.webui --no-gradio <config.yaml>
     [--device cpu]   (or build_server()).
"""

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)

DRUG_PROPS = ["BBBP", "HIV", "BACE"]
MATERIAL_PROPS = ["CO2", "N2", "O2", "FFV", "TC"]
SYNTH_PROPS = ["SC", "SA"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8">
<title>Llamole-TPU</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto;
        max-width: 60rem; color: #1a1a1a; }}
 fieldset {{ border: 1px solid #ccc; border-radius: 6px;
             margin-bottom: 1rem; }}
 label {{ display: inline-block; margin: 0.3rem 1rem 0.3rem 0; }}
 input[type=number] {{ width: 5rem; }}
 textarea {{ width: 100%; }}
 #result svg {{ border: 1px solid #eee; margin: 0.4rem; }}
 .muted {{ color: #777; }}
 pre {{ white-space: pre-wrap; background: #f6f6f6; padding: 0.6rem; }}
</style></head><body>
<h1>Llamole-TPU: inverse molecular design + retrosynthesis</h1>
<form id="f">
 <fieldset><legend>Instruction</legend>
  <textarea name="instruction" rows="3"
   placeholder="Design a molecule that ..."></textarea></fieldset>
 <fieldset><legend>Drug properties (blank = unconditioned)</legend>
  {drug}</fieldset>
 <fieldset><legend>Material properties (blank = unconditioned)</legend>
  {material}</fieldset>
 <fieldset><legend>Synthesis</legend>{synth}</fieldset>
 <button type="submit">Generate</button>
 <span id="status" class="muted"></span>
</form>
<div id="result"></div>
<script>
const f = document.getElementById('f');
f.addEventListener('submit', async (ev) => {{
  ev.preventDefault();
  const status = document.getElementById('status');
  status.textContent = 'generating (first call compiles; may take a while)...';
  const data = {{ instruction: f.instruction.value, properties: {{}} }};
  for (const el of f.querySelectorAll('input[name]')) {{
    if (el.value !== '') data.properties[el.name] = parseFloat(el.value);
  }}
  const r = await fetch('/api/design', {{ method: 'POST',
    headers: {{'Content-Type': 'application/json'}},
    body: JSON.stringify(data) }});
  const out = await r.json();
  status.textContent = r.ok ? '' : (out.error || 'error');
  const d = document.getElementById('result');
  if (!r.ok) {{ d.innerHTML = ''; return; }}
  d.innerHTML =
    '<h2>Molecule</h2><pre>' + (out.smiles || '&lt;NO MOLECULE&gt;') +
    '</pre>' + (out.mol_svg || '') +
    '<h2>LLM response</h2><pre>' + out.text_html + '</pre>' +
    '<h2>Retrosynthesis route</h2><pre>' +
    (out.reactions_html || '(no route found)') + '</pre>' +
    (out.route_svg || '');
}});
</script></body></html>
"""


def _field(name: str, lo: float, hi: float) -> str:
    return (f'<label>{name} <input type="number" name="{name}" '
            f'min="{lo}" max="{hi}" step="any" value=""></label>')


def _render_page() -> str:
    return _PAGE.format(
        drug="".join(_field(p, 0, 1) for p in DRUG_PROPS),
        material="".join(_field(p, 0, 10) for p in MATERIAL_PROPS),
        synth="".join(_field(p, 1, 10) for p in SYNTH_PROPS))


def render_route_svgs(reaction_list) -> str:
    """One SVG per 'product>>reactants' step of a route, joined by <br/>
    (steps that do not parse are left out)."""
    from ..chem.depict import reaction_to_svg

    steps = []
    for rxn in reaction_list or []:
        if ">>" not in rxn:
            continue
        product, reactants = rxn.split(">>", 1)
        svg = reaction_to_svg(product.strip(),
                              [r.strip() for r in reactants.split(".")])
        if svg:
            steps.append(svg)
    return "<br/>".join(steps)


class DesignUIServer:
    """Wraps the model state + a lock; serve_forever on demand. The model
    is built on `device` (default the card; without one it raises unless
    "cpu") unless a state is given."""

    def __init__(self, config_path_or_args: Any, host: str = "127.0.0.1",
                 port: int = 7860, state: Optional[Dict] = None,
                 device="cuda"):
        from .workflow import load_model_and_tokenizer
        self.state = state if state is not None else \
            load_model_and_tokenizer(config_path_or_args, device=device)
        self._gen_lock = threading.Lock()
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                logger.info("ui: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _render_page().encode(),
                               "text/html; charset=utf-8")
                elif self.path == "/health":
                    self._send(200, b'{"ok": true}', "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/api/design":
                    self._send(404, b'{"error": "unknown endpoint"}',
                               "application/json")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = ui.design(req.get("instruction") or "",
                                    req.get("properties") or {},
                                    seed=int(req.get("seed") or 0))
                    body = json.dumps(out).encode()
                    self._send(200, body, "application/json")
                except Exception as e:  # noqa: BLE001 — per-request isolation
                    logger.exception("ui design request failed")
                    self._send(500, json.dumps({"error": str(e)}).encode(),
                               "application/json")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    def design(self, instruction: str, properties: Dict[str, Any],
               seed: int = 0) -> Dict:
        """One design + retro request -> JSON-ready dict (SVGs inline)."""
        from ..chem.assemble import check_valid
        from ..chem.depict import mol_to_svg
        from .workflow import generate, process_input

        props = {k: float(v) for k, v in properties.items()
                 if k in DRUG_PROPS + MATERIAL_PROPS + SYNTH_PROPS
                 and v is not None}
        with self._gen_lock:
            batch = process_input(self.state, instruction, props)
            info = generate(self.state, batch, seed=seed)
        text = "".join(t for t in info["text_lists"][0] if t)
        smiles = info["smiles_list"][0]
        plan = info["retro_plan_dict"].get(smiles, {}) if smiles else {}
        reactions = plan.get("reaction_list") or []
        # rollback can surface the LLM's raw between-tags text as the
        # "molecule" (as the reference's rollback does); the valid flag
        # says what the page got
        valid = bool(smiles) and check_valid(smiles)
        return {
            "smiles": smiles,
            "valid": valid,
            "text_html": html.escape(text),
            "reactions_html": html.escape("\n".join(reactions)),
            "mol_svg": (mol_to_svg(smiles) if valid else "") or "",
            "route_svg": render_route_svgs(reactions),
            "route_found": bool(plan.get("success")),
        }

    def serve_forever(self):
        logger.info("UI at http://%s:%d/ (no gradio needed)",
                    self.host, self.port)
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def build_server(config_path: str, host: str = "127.0.0.1",
                 port: int = 7860, device="cuda") -> DesignUIServer:
    return DesignUIServer(config_path, host=host, port=port, device=device)
