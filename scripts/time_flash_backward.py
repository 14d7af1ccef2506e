"""Time kernel E's forward and its two backward kernels on the card, one
JSON line.

Graph-replay device ms (chip_smoke.graph_ms) of `flash_forward`,
`flash_backward_dq` and `flash_backward_dkv` at phase 22's main shape,
(1, 2048, 32, 8, 128) bf16 with its padding (chip_smoke.PHASE22,
flash_inputs), of the two backward kernels together, and of
`flash_forward` at the main shape with no padding (the causal-LM step's
all-real rows), of the forward and each backward kernel at phase 22's
head_dim-256 check shape (gemma-7b's heads), and of the forward and each
backward kernel in f32 at F32_SHAPES (phase 22's f32 checks, written out
here so that an older tree times the same shapes) with its padding, with
the card's name and power limit. It imports only the tree it runs in, so
the same file copied into an unpacked older tree times that tree's
kernels; run trees in turns (old, new, new, old) in one call to compare
them on one card:

    python3 scripts/time_flash_backward.py [--label NAME] [--repeats N]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as s  # noqa: E402
from llamole_tpu_torch.ops import cuda_lib  # noqa: E402
from llamole_tpu_torch.ops import flash_attention as E  # noqa: E402

# (B, S, H, KV, D) in f32: the 8B's heads and 16 heads of 256 on 8 KV heads
F32_SHAPES = ((1, 1024, 32, 8, 128), (1, 1024, 16, 8, 256))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.getcwd())
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cuda_lib.library()
    shape = s.PHASE22["main"]
    wide = next(tuple(c[:5]) for c in s.PHASE22["checks"]
                if c[4] == 256 and c[5] == "bf16")
    q, k, v, dout, seg = s.flash_inputs(shape, torch.bfloat16, s.PHASE22)
    qw, kw, vw, doutw, segw = s.flash_inputs(wide, torch.bfloat16, s.PHASE22)
    real = s.flash_inputs(shape, torch.bfloat16,
                          {"left_pad": 0, "right_pad": 0})[4]
    out, lse = E.flash_forward(q, k, v, seg)
    _, delta = E.flash_backward_dq(q, k, v, seg, out, dout, lse)
    outw, lsew = E.flash_forward(qw, kw, vw, segw)
    _, deltaw = E.flash_backward_dq(qw, kw, vw, segw, outw, doutw, lsew)
    times = {"fwd": [], "dq": [], "dkv": [], "backward": [], "fwd_unpadded": [],
             "fwd_d256": [], "dq_d256": [], "dkv_d256": [], "backward_d256": []}
    f32 = []
    for shape32 in F32_SHAPES:
        q3, k3, v3, do3, sg3 = s.flash_inputs(shape32, torch.float32,
                                              s.PHASE22)
        o3, l3 = E.flash_forward(q3, k3, v3, sg3)
        de3 = E.flash_backward_dq(q3, k3, v3, sg3, o3, do3, l3)[1]
        f32.append((shape32[-1], (q3, k3, v3, do3, sg3), o3, l3, de3))
        for kind in ("fwd", "dq", "dkv", "backward"):
            times[f"f32_{kind}_d{shape32[-1]}"] = []
    for _ in range(args.repeats):
        times["fwd"].append(s.graph_ms(lambda: E.flash_forward(q, k, v, seg)))
        times["dq"].append(s.graph_ms(lambda: E.flash_backward_dq(
            q, k, v, seg, out, dout, lse)))
        times["dkv"].append(s.graph_ms(lambda: E.flash_backward_dkv(
            q, k, v, seg, dout, lse, delta)))
        times["backward"].append(s.graph_ms(lambda: E.flash_backward(
            q, k, v, seg, out, dout, lse)))
        times["fwd_unpadded"].append(s.graph_ms(lambda: E.flash_forward(
            q, k, v, real)))
        times["fwd_d256"].append(s.graph_ms(lambda: E.flash_forward(
            qw, kw, vw, segw)))
        times["dq_d256"].append(s.graph_ms(lambda: E.flash_backward_dq(
            qw, kw, vw, segw, outw, doutw, lsew)))
        times["dkv_d256"].append(s.graph_ms(lambda: E.flash_backward_dkv(
            qw, kw, vw, segw, doutw, lsew, deltaw)))
        times["backward_d256"].append(s.graph_ms(lambda: E.flash_backward(
            qw, kw, vw, segw, outw, doutw, lsew)))
        for d, (q3, k3, v3, do3, sg3), o3, l3, de3 in f32:
            few = {"launches": 5, "repeats": 5}  # up to ms a launch
            times[f"f32_fwd_d{d}"].append(s.graph_ms(
                lambda: E.flash_forward(q3, k3, v3, sg3), **few))
            times[f"f32_dq_d{d}"].append(s.graph_ms(
                lambda: E.flash_backward_dq(q3, k3, v3, sg3, o3, do3, l3),
                **few))
            times[f"f32_dkv_d{d}"].append(s.graph_ms(
                lambda: E.flash_backward_dkv(q3, k3, v3, sg3, do3, l3, de3),
                **few))
            times[f"f32_backward_d{d}"].append(s.graph_ms(
                lambda: E.flash_backward(q3, k3, v3, sg3, o3, do3, l3),
                **few))
    print(json.dumps({"label": args.label, "shape": list(shape),
                      "shape_d256": list(wide),
                      "shapes_f32": [list(x) for x in F32_SHAPES],
                      "device_ms": times,
                      "card": s.card_tag()}), flush=True)


if __name__ == "__main__":
    main()
