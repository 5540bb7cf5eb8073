"""Time K1's fp32 route (the serving forward) at the serving shapes, in this
checkout or in another one, on one CUDA card.

    python3 declip_tpu_torch/tools/time_attention.py [--root DIR] [--tag T]

For each serving shape (B = 1, 8 and 16 rows; the image tower's L=50 with
12 heads and the text tower's L=77 causal with 8 heads; Dh=64; fp32) it
prints the kernel's device time, the plain version's, that of one
``scaled_dot_product_attention`` call with the names of the library's
kernels (its backend), and the least time the card could take, as
chip_smoke.py's phase 2 measures one shape (``attention_row``, loaded from
the checkout that holds this script). ``--root`` names the checkout whose
``declip_tpu_torch`` is timed (default: this one), so that two trees can
be timed in turns, one process each, on one card. The last line is one JSON object.
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
# (B, H, L, Dh, causal): the serving path's two shapes at its three timed
# buckets
SHAPES = [(b, h, l, 64, causal) for b in (1, 8, 16)
          for h, l, causal in ((12, 50, False), (8, 77, True))]


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
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import declip_tpu_torch

    pkg = os.path.dirname(os.path.abspath(declip_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"declip_tpu_torch came from {pkg}, not from "
                           f"{root}: run this file as a script")
    if not torch.cuda.is_available():
        raise RuntimeError("time_attention times the CUDA kernel: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for i, (b, h, l, dh, causal) in enumerate(SHAPES):
        row = smoke.attention_row(b, h, l, dh, causal, torch.float32,
                                  500 + i)
        rows.append(row)
        print(f"{args.tag} B={b} H={h} L={l} causal={int(causal)}: kernel "
              f"{row['ms']:.5f} ms  plain {row['plain_ms']:.5f}  sdpa "
              f"{row['library_ms']:.5f}  bound {row['bound_ms']:.5f}  err "
              f"{row['max_abs_err']:.2e}", flush=True)
    print(card)
    print(json.dumps({"tag": args.tag, "root": root, "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
