"""Command dispatcher of the port (counterpart of llamole_tpu/cli.py):
`python -m llamole_tpu_torch <command>`, installed as the
`llamole-torch` console script.

Usage:
    python -m llamole_tpu_torch train  config/train/llama_lora.yaml
    torchrun --nproc-per-node N -m llamole_tpu_torch train <yaml with mesh>
    python -m llamole_tpu_torch eval   config/generate/llama_drug.yaml
    torchrun --nproc-per-node N -m llamole_tpu_torch eval <yaml with mesh>
    python -m llamole_tpu_torch export config/export.yaml
    python -m llamole_tpu_torch serve  config/generate/llama_drug.yaml
                                       [--tcp [PORT]]
    python -m llamole_tpu_torch pretrain
        {graphdit|predictor|cost_mlp|graphclip|oracle}
        <corpus.json> <output_dir> [key=value ...]
    python -m llamole_tpu_torch parity --ckpt-dir ckpt/ [...]
    python -m llamole_tpu_torch validate_data <corpus.json>
    python -m llamole_tpu_torch env

Every command runs on the card unless `--device cpu` is given (anywhere
on the line); without a card the default raises. With LLAMOLE_TRACE_DIR
set, the command runs inside utils/profiling.trace() and writes a
torch.profiler trace there. download_data needs the network and refuses.
"""

import json
import sys
from typing import List, Tuple

USAGE = ("usage: python -m llamole_tpu_torch {train|eval|export|serve|"
         "pretrain|parity|validate_data|env|download_data} <config.yaml> "
         "[--device cpu]")


def _split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """(--device value, the other arguments); the device defaults to
    cuda."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device":
            if i + 1 == len(argv):
                raise SystemExit("--device needs a value (cuda or cpu)")
            device = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
        i += 1
    return device, rest


def run_parity_cli(argv, device="cuda") -> None:
    """`parity --ckpt-dir ckpt/ [...]`: the one-command 12-metric parity
    eval (eval/parity.py)."""
    import argparse

    from .eval.parity import run_parity
    p = argparse.ArgumentParser(prog="llamole-torch parity", description=(
        "Convert reference checkpoints, run the two-phase MolQA eval "
        "with the reference budgets, emit the 12-metric parity table."))
    p.add_argument("--ckpt-dir", help="directory holding the reference "
                   "HF checkout(s); kinds are discovered by content")
    p.add_argument("--base-llm", help="HF safetensors dir of the base LLM")
    p.add_argument("--graphdit")
    p.add_argument("--encoder")
    p.add_argument("--predictor")
    p.add_argument("--adapter")
    p.add_argument("--oracle", help="trained property-oracle dir")
    p.add_argument("--oracle-corpus", help="MolQA corpus to train the "
                   "property oracle on (when --oracle is absent)")
    p.add_argument("--dataset", default="molqa_drug_examples")
    p.add_argument("--dataset-dir", default="data")
    p.add_argument("--out", default="saves/parity")
    p.add_argument("--records", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--template", default="default")
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--max-planning-time", type=float, default=30.0)
    args = p.parse_args(argv)
    if not args.ckpt_dir and not (args.graphdit and args.encoder
                                  and args.predictor):
        p.error("pass --ckpt-dir or explicit --graphdit/--encoder/"
                "--predictor paths")
    run_parity(
        args.ckpt_dir, base_llm=args.base_llm, graphdit=args.graphdit,
        encoder=args.encoder, predictor=args.predictor,
        adapter=args.adapter, oracle=args.oracle,
        oracle_corpus=args.oracle_corpus, dataset=args.dataset,
        dataset_dir=args.dataset_dir, output_dir=args.out,
        records=args.records, batch_size=args.batch,
        template=args.template, expansion_topk=args.topk,
        iterations=args.iterations,
        max_planning_time=args.max_planning_time, device=device)


def run_pretrain(argv, device="cuda") -> None:
    """`pretrain <kind> <corpus> <outdir> [key=value ...]`: the extra
    arguments pass through as typed kwargs (steps=500 batch_size=16
    learning_rate=3e-4 ...)."""
    from .train import pretrain as pt
    kinds = {"graphdit": pt.pretrain_graphdit,
             "predictor": pt.pretrain_predictor,
             "cost_mlp": pt.pretrain_cost_mlp,
             "graphclip": pt.pretrain_graphclip,
             "oracle": pt.pretrain_property_oracle}
    if len(argv) < 3 or argv[0] not in kinds:
        raise SystemExit(
            "usage: python -m llamole_tpu_torch pretrain "
            f"{{{'|'.join(sorted(kinds))}}} <corpus.json> <output_dir> "
            "[key=value ...]")
    kind, corpus, outdir, *rest = argv
    kwargs = {}
    for item in rest:
        if "=" not in item:
            raise SystemExit(f"expected key=value, got {item!r}")
        key, value = item.split("=", 1)
        try:
            kwargs[key] = int(value)
        except ValueError:
            try:
                kwargs[key] = float(value)
            except ValueError:
                kwargs[key] = value
    metrics = kinds[kind](corpus, outdir, **{"device": device, **kwargs})
    print(metrics)


def download_data() -> None:
    """The JAX package fetches the full MolQA dataset from the HF hub
    here; the port never touches the network."""
    raise SystemExit(
        "download_data needs the network (the HF hub's "
        "liuganghuggingface/Llamole-MolQA) and the port fetches nothing. "
        "Place the dataset's JSON files under data/ yourself; the offline "
        "example datasets molqa_train_examples, molqa_drug_examples and "
        "molqa_material_examples (data/*.json) work as they are.")


def _config(args):
    return args[0] if args else None


def _train(args, device):
    """run_mmsft on the config. A config that sets `mesh` trains on a
    mesh, one process per rank started by torchrun (`torchrun
    --nproc-per-node N -m llamole_tpu_torch train <yaml>`, N the mesh's
    product): each rank joins the process group from torchrun's
    environment (NCCL on the card, gloo with --device cpu) and leaves it
    at the end."""
    import torch.distributed as dist

    from .config import get_train_args
    from .train.workflow import run_mmsft
    parsed = get_train_args(_config(args))
    try:
        run_mmsft(*parsed, device=device)
    finally:
        if parsed[2].mesh and dist.is_initialized():
            dist.destroy_process_group()


def _eval(args, device):
    """run_molqa on the config; with `mesh` one rank of mesh inference,
    started by torchrun as `train` is."""
    import torch.distributed as dist

    from .config import get_infer_args
    from .eval.workflow import run_molqa
    parsed = get_infer_args(_config(args))
    try:
        run_molqa(*parsed, device=device)
    finally:
        if parsed[2].mesh and dist.is_initialized():
            dist.destroy_process_group()


def _export(args, device):
    from .train.export import merge_adapter
    merge_adapter(_config(args), device=device)


def _serve(args, device):
    """JSONL over stdin / stdout, or TCP with --tcp [PORT] (serve.py)."""
    args = list(args)
    if "--tcp" in args:
        i = args.index("--tcp")
        port = 7733
        if i + 1 < len(args) and args[i + 1].isdigit():
            port = int(args.pop(i + 1))
        args.pop(i)
        from .serve import serve_tcp
        serve_tcp(_config(args), port=port, device=device)
    else:
        from .serve import serve_jsonl
        serve_jsonl(_config(args), device=device)


def _validate_data(args, device):
    """MolQA corpus preflight (scripts/REAL_WEIGHTS_RUNBOOK.md step 0):
    the report as JSON, exit code 2 when it is not ok."""
    from .data.validate import validate_molqa
    if not args:
        raise SystemExit("usage: python -m llamole_tpu_torch validate_data "
                         "<corpus.json>")
    report = validate_molqa(args[0])
    print(json.dumps(report, indent=1))
    if not report["ok"]:
        raise SystemExit(2)


def _env(args, device):
    """Environment dump for bug reports (reference extras/env.py:32-75)."""
    from .utils.misc import env_info
    for key, value in env_info(device).items():
        print(f"{key}: {value}")


COMMANDS = {
    "train": _train,
    "eval": _eval,
    "export": _export,
    "serve": _serve,
    "pretrain": run_pretrain,
    "parity": run_parity_cli,
    "validate_data": _validate_data,
    "env": _env,
    "download_data": lambda args, device: download_data(),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(USAGE)
    device, argv = _split_device(argv)
    command, args = argv[0], argv[1:]
    if command not in COMMANDS:
        raise SystemExit(f"unknown command {command!r}\n{USAGE}")
    from .utils.profiling import trace
    with trace():
        COMMANDS[command](args, device)
    return 0
