"""python -m llamole_tpu_torch.webui [config.yaml] [--no-gradio] [--port=N]
[--device cpu]

Web UI entry point (counterpart of the repo's launch.py; reference
launch.py:212-238). The default is the gradio app, as the reference's;
--no-gradio serves the same design + retro flow through the stdlib
server (webui/server.py), and when gradio is not installed the entry
point logs a notice and serves the stdlib UI. That is a choice of UI
library: the model runs on --device (default cuda, which raises without
a card) either way.
"""

import argparse
import sys

from ..utils.logging import get_logger
from .server import DRUG_PROPS, MATERIAL_PROPS, SYNTH_PROPS, render_route_svgs

logger = get_logger(__name__)


def build_app(config_path: str, device="cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; install it, or "
            "use --no-gradio, or `python -m llamole_tpu_torch eval "
            "<config>` for batch runs.") from e

    from .workflow import generate, load_model_and_tokenizer, process_input

    state = load_model_and_tokenizer(config_path, device=device)

    def run(instruction, *prop_values):
        props = {}
        for name, val in zip(DRUG_PROPS + MATERIAL_PROPS + SYNTH_PROPS,
                             prop_values):
            if val is not None and val != "NAN" and val != 0:
                props[name] = float(val)
        batch = process_input(state, instruction, props)
        info = generate(state, batch)
        text = "".join(t for t in info["text_lists"][0] if t)
        smiles = info["smiles_list"][0]
        plan = info["retro_plan_dict"].get(smiles, {})
        reactions = "\n".join(plan.get("reaction_list") or [])
        mol_svg, rxn_svg = render_molecule_and_route(
            smiles, plan.get("reaction_list") or [])
        return smiles or "<NO MOLECULE>", text, reactions, mol_svg, rxn_svg

    # input widgets (reference webui/elements.py:21-95: drug radios
    # {0,1,NAN}, material sliders with 0 = unconditioned, SC/SA sliders)
    inputs = [gr.Textbox(label="Instruction", lines=3)]
    for p in DRUG_PROPS:
        inputs.append(gr.Radio(["0", "1", "NAN"], value="NAN", label=p))
    for p in MATERIAL_PROPS:
        inputs.append(gr.Slider(0.0, 10.0, value=0.0, label=f"{p} (0 = off)"))
    inputs.append(gr.Slider(1.0, 5.0, value=3.0, label="SC"))
    inputs.append(gr.Slider(1.0, 10.0, value=3.0, label="SA"))

    return gr.Interface(
        fn=run,
        inputs=inputs,
        outputs=[gr.Textbox(label="SMILES"),
                 gr.Textbox(label="LLM response"),
                 gr.Textbox(label="Retrosynthesis route"),
                 gr.HTML(label="Molecule"),
                 gr.HTML(label="Reactions")],
        title="Llamole-TPU: inverse molecular design + retrosynthesis",
    )


def render_molecule_and_route(smiles, reaction_list):
    """First-party SVG depictions of the designed molecule and each retro
    step (the reference renders these with RDKit Draw,
    launch.py:175-187)."""
    from ..chem.depict import mol_to_svg

    mol_svg = (mol_to_svg(smiles) if smiles else None) or ""
    return mol_svg, render_route_svgs(reaction_list)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m llamole_tpu_torch.webui")
    ap.add_argument("config", nargs="?",
                    default="config/generate/llama_drug.yaml")
    ap.add_argument("--no-gradio", action="store_true",
                    help="serve the stdlib UI (webui/server.py)")
    ap.add_argument("--port", type=int, default=7860,
                    help="stdlib UI port (default 7860)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    use_stdlib = args.no_gradio
    if not use_stdlib:
        try:
            import gradio  # noqa: F401
        except ImportError:
            logger.warning("gradio not installed; serving the stdlib UI "
                           "instead (--no-gradio)")
            use_stdlib = True
    if use_stdlib:
        from .server import build_server
        build_server(args.config, port=args.port,
                     device=args.device).serve_forever()
    else:
        build_app(args.config, device=args.device).launch()


if __name__ == "__main__":
    sys.exit(main())
