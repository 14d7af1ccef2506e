"""Reference-checkpoint converters: the reference's published torch state
dicts -> the JAX package's msgpack layout (counterpart of
llamole_tpu/models/refconvert.py; the port and the JAX package both load
the directories written here).

  Llamole-Pretrained-GraphDiT/     model.pt + config.yaml + data.meta.json
  Llamole-Pretrained-GraphEncoder/ model.pt + model_proj.pt
                                   + model_config.json
  Llamole-Pretrained-GNNPredictor/ model.pt + model_config.json
                                   + label_to_template.csv.gz
                                   + available.csv.gz (cost_model.pt is
                                   REFUSED before anything is written: it
                                   was trained on RDKit Morgan bits)
  *-Adapter/                       connector/*.pt

    python -m llamole_tpu_torch.models.refconvert \\
        {graphdit|encoder|predictor|connectors} SRC DST

Each state dict is read with torch.load(weights_only=True), its tensors
as f32; torch Linear [out, in] transposes to the JAX [in, out].
"""

import os
import re
import shutil
import sys
from typing import Dict

import torch

from ..utils.serialization import save_pytree

StateDict = Dict[str, torch.Tensor]


def _load_torch(path: str) -> StateDict:
    return {k: v.float().cpu() for k, v in torch.load(
        path, map_location="cpu", weights_only=True).items()}


def _lin(sd: StateDict, prefix: str) -> Dict:
    p = {"w": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd: StateDict, prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _count(sd: StateDict, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def convert_graphdit(src: str, dst: str) -> None:
    sd = _load_torch(os.path.join(src, "model.pt"))
    depth = _count(sd, r"blocks\.(\d+)\.")
    ydim = _count(sd, r"y_embedder\.mlps\.(\d+)\.")
    params = {
        "x_embedder": {
            "linear": {"w": sd["x_embedder.0.weight"].T},
            "norm": _ln(sd, "x_embedder.1"),
        },
        "t_embedder": {
            "fc1": _lin(sd, "t_embedder.mlp.0"),
            "fc2": _lin(sd, "t_embedder.mlp.2"),
        },
        "y_embedder": {
            "mlps": [
                {"fc1": _lin(sd, f"y_embedder.mlps.{d}.0"),
                 "fc2": _lin(sd, f"y_embedder.mlps.{d}.2")}
                for d in range(ydim)
            ],
            "null_embedding": sd["y_embedder.embedding_drop.weight"],
        },
        "txt_embedder": {
            "linear": _lin(sd, "txt_embedder.linear"),
            "null_embedding": sd["txt_embedder.embedding_drop.weight"],
        },
        "blocks": [
            {
                "attn": {
                    "qkv": _lin(sd, f"blocks.{i}.attn.qkv"),
                    "q_norm": _ln(sd, f"blocks.{i}.attn.q_norm"),
                    "k_norm": _ln(sd, f"blocks.{i}.attn.k_norm"),
                    "proj": _lin(sd, f"blocks.{i}.attn.proj"),
                },
                "mlp": {"fc1": _lin(sd, f"blocks.{i}.mlp.fc1"),
                        "fc2": _lin(sd, f"blocks.{i}.mlp.fc2")},
                "ada_fc1": _lin(sd, f"blocks.{i}.adaLN_modulation.0"),
                "ada_fc2": _lin(sd, f"blocks.{i}.adaLN_modulation.2"),
            }
            for i in range(depth)
        ],
        "output_layer": {
            "decoder": {"fc1": _lin(sd, "output_layer.xedecoder.fc1"),
                        "fc2": _lin(sd, "output_layer.xedecoder.fc2")},
            "ada_fc1": _lin(sd, "output_layer.adaLN_modulation.0"),
            "ada_fc2": _lin(sd, "output_layer.adaLN_modulation.2"),
        },
    }
    os.makedirs(dst, exist_ok=True)
    save_pytree(params, os.path.join(dst, "model.msgpack"))
    # the published checkpoint names its config config.yaml
    for name in ("model_config.yaml", "config.yaml"):
        if os.path.exists(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name),
                        os.path.join(dst, "model_config.yaml"))
            break
    if os.path.exists(os.path.join(src, "data.meta.json")):
        shutil.copy(os.path.join(src, "data.meta.json"),
                    os.path.join(dst, "data.meta.json"))
    print(f"GraphDiT converted: depth={depth} -> {dst}")


def _convert_gin_trunk(sd: StateDict, n_layers: int):
    convs, norms, vn = [], [], []
    for i in range(n_layers):
        convs.append({
            "bond_embedding": sd[f"convs.{i}.bond_encoder.weight"],
            "eps": sd[f"convs.{i}.eps"].reshape(()),
            "mlp": {"fc1": _lin(sd, f"convs.{i}.mlp.0"),
                    "norm": _ln(sd, f"convs.{i}.mlp.1"),
                    "fc2": _lin(sd, f"convs.{i}.mlp.4")},
        })
        if f"norms.{i}.weight" in sd:
            norms.append(_ln(sd, f"norms.{i}"))
        if f"mlp_virtualnode_list.{i}.0.weight" in sd:
            vn.append({"fc1": _lin(sd, f"mlp_virtualnode_list.{i}.0"),
                       "norm": _ln(sd, f"mlp_virtualnode_list.{i}.1"),
                       "fc2": _lin(sd, f"mlp_virtualnode_list.{i}.4")})
    return convs, norms, vn


def convert_encoder(src: str, dst: str) -> None:
    sd = _load_torch(os.path.join(src, "model.pt"))
    proj = _load_torch(os.path.join(src, "model_proj.pt"))
    n_layers = _count(sd, r"convs\.(\d+)\.")
    convs, norms, vn = _convert_gin_trunk(sd, n_layers)
    params = {
        "atom_encoder": sd["atom_encoder.weight"],
        "virtualnode": sd["virtualnode_embedding.weight"][0],
        "convs": convs, "norms": norms, "vn_mlps": vn,
        "projection": {"fc1": _lin(proj, "fc1"),
                       "norm": _ln(proj, "norm1"),
                       "fc2": _lin(proj, "fc2")},
    }
    os.makedirs(dst, exist_ok=True)
    save_pytree(params, os.path.join(dst, "model.msgpack"))
    if os.path.exists(os.path.join(src, "model_config.json")):
        shutil.copy(os.path.join(src, "model_config.json"),
                    os.path.join(dst, "model_config.json"))
    print(f"GraphCLIP converted: layers={n_layers} -> {dst}")


def _refuse_reference_cost_model(src: str) -> None:
    """Stop BEFORE any write when cost_model.pt is present: the reference
    CostMLP reads RDKit Morgan bits, which the port's first-party
    fingerprint (chem/fingerprint.py) does not reproduce, so converted
    weights would score synthesis costs wrongly with no error."""
    cost_file = os.path.join(src, "cost_model.pt")
    if os.path.exists(cost_file):
        raise SystemExit(
            f"REFUSING to convert {cost_file}: the reference CostMLP was "
            "trained on RDKit Morgan fingerprint bits, which this "
            "package's first-party Morgan hash does not reproduce "
            "(chem/fingerprint.py). Retrain the cost model on first-party "
            "features instead (llamole_tpu_torch.train.pretrain."
            "pretrain_cost_mlp), or remove cost_model.pt from the source "
            "directory to convert the predictor without it.")


def convert_predictor(src: str, dst: str) -> None:
    _refuse_reference_cost_model(src)
    sd = _load_torch(os.path.join(src, "model.pt"))
    n_layers = _count(sd, r"convs\.(\d+)\.")
    convs, _, vn = _convert_gin_trunk(sd, n_layers)
    params = {
        "atom_encoder": sd["atom_encoder.weight"],
        "virtualnode": sd["virtualnode_embedding.weight"][0],
        "text_dropping": sd["text_dropping.weight"],
        "convs": convs,
        "adapters": [_lin(sd, f"adapters.{i}.1") for i in range(n_layers)],
        "vn_mlps": vn,
        "decoder": {"fc1": _lin(sd, "decoder.0"),
                    "norm": _ln(sd, "decoder.1"),
                    "fc2": _lin(sd, "decoder.4")},
    }
    os.makedirs(dst, exist_ok=True)
    save_pytree(params, os.path.join(dst, "model.msgpack"))
    for extra in ("model_config.json", "label_to_template.csv.gz",
                  "available.csv.gz"):
        if os.path.exists(os.path.join(src, extra)):
            shutil.copy(os.path.join(src, extra), os.path.join(dst, extra))
    print(f"GraphPredictor converted: layers={n_layers} -> {dst}")


def convert_connectors(src: str, dst: str) -> None:
    os.makedirs(os.path.join(dst, "connector"), exist_ok=True)
    mapping = {
        "graph_to_lm_connector.pt": "graph_to_lm.msgpack",
        "lm_to_graph_decoder.pt": "lm_to_graph_decoder.msgpack",
        "lm_to_graph_predictor.pt": "lm_to_graph_predictor.msgpack",
    }
    for torch_name, out_name in mapping.items():
        sd = _load_torch(os.path.join(src, torch_name))
        save_pytree(_lin(sd, "0"), os.path.join(dst, "connector", out_name))
    print(f"connectors converted -> {dst}/connector")


CONVERTERS = {"graphdit": convert_graphdit, "encoder": convert_encoder,
              "predictor": convert_predictor,
              "connectors": convert_connectors}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] not in CONVERTERS:
        raise SystemExit(__doc__)
    kind, src, dst = argv
    CONVERTERS[kind](src, dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
