"""Time the late-interaction kernels (K3, K4, K5) at the FILIP training
path's shapes, in this checkout or in another one, on one CUDA card.

    python3 declip_tpu_torch/tools/time_late_interaction.py [--root DIR] [--tag T]

For each shape (B = GB = 128 with N1 = 49 and 77 against N2 = 16, D = 256,
the two calls of a FILIP step; and B = 8, GB = 128, N1 = N2 = 77, a key set
without top-k selection), in bf16, on continuous unit vectors
(chip_smoke.py's ``_li_inputs``) it runs the autograd route forward and
backward and prints the device time of each kernel kind the profiler saw
(chip_smoke.py's ``kernel_kind``: K3, K4, K5 and the split sums' reduction)
per call. Beside K3 it prints a yardstick: the device time of the product
alone, ``torch.matmul`` of d1 as [B*N1, D] by d2 as [D, GB*N2] in bf16
(cuBLAS; it writes the bf16 similarities, which K3 never does, and takes
no max). No PyTorch call computes K3's max-mean, so this is not a library
time for it: it says how far K3's product is from the card's own. Only
the autograd route is called, so any checkout's kernels can be timed,
whatever their wrappers' signatures. ``--root`` names the
checkout whose ``declip_tpu_torch`` is timed (default: this one), so that
two trees can be timed in turns, one process each, on one card. The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (B, N1, GB, N2, D)
SHAPES = [(128, 49, 128, 16, 256), (128, 77, 128, 16, 256),
          (8, 77, 128, 77, 256)]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose declip_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a label for the JSON line")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import declip_tpu_torch
    from declip_tpu_torch.ops import filip_late_interaction as fli

    pkg = os.path.dirname(os.path.abspath(declip_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"declip_tpu_torch came from {pkg}, not from "
                           f"{root}: run this file as a script")
    if not torch.cuda.is_available():
        raise RuntimeError("time_late_interaction times CUDA kernels: no "
                           "card")
    smoke = _smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for i, shape in enumerate(SHAPES):
        d1, d2, g = smoke._li_inputs(shape, torch.bfloat16, 300 + i,
                                     grid=False)
        leaves = [d1.requires_grad_(), d2.requires_grad_()]

        def call():
            raw = fli._LateInteraction.apply(*leaves)
            torch.autograd.grad(raw, leaves, g)

        by_kind = {}
        for e in smoke.device_events(call, args.iters):
            kind = smoke.kernel_kind(e.name)
            by_kind[kind] = (by_kind.get(kind, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / args.iters)
        a = d1.detach().reshape(-1, shape[4])
        bt = d2.detach().reshape(-1, shape[4]).t()

        def product():
            return torch.matmul(a, bt)

        gemm_ms = (smoke.device_ms(product, args.iters)[0]
                   or smoke.cuda_ms(product))
        row = {"shape": list(shape), "dtype": "bfloat16",
               "ms": {k: by_kind.get(k, 0.0)
                      for k in ("K3", "K4", "K5", "K4/K5 reduce")},
               "other_ms": {k: v for k, v in by_kind.items()
                            if k not in ("K3", "K4", "K5", "K4/K5 reduce")},
               "k3_product_matmul_ms": gemm_ms}
        rows.append(row)
        print(f"{args.tag} B={shape[0]} N1={shape[1]} GB={shape[2]} "
              f"N2={shape[3]} D={shape[4]} bf16: "
              + " ".join(f"{k} {v:.5f}" for k, v in row["ms"].items())
              + f" ms; K3's product alone in torch.matmul {gemm_ms:.5f} ms",
              flush=True)
    print(card)
    print(json.dumps({"tag": args.tag, "root": root, "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
