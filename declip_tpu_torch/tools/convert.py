"""Serving export: the CLIP towers as ``torch.export`` artifacts (port of
``declip_tpu/tools/convert.py --export-serving``).

    python -m declip_tpu_torch.tools.convert --export-serving \
        --config <exp>/config.yaml --out <dir> [--serving-batch N] \
        [--quantize int8] [--device cuda|cpu]

writes ``<dir>/encode_image.pt2`` (``[B, H, W, 3]`` float32 NHWC images)
and ``<dir>/encode_text.pt2`` (``[B, 77]`` int64 tokens) with
``torch.export.export`` and ``torch.export.save``, from the experiment's
newest ``checkpoints/ckpt*.pth.tar`` through ``tools/_common.
load_eval_model``, or from seeded random weights where there is none, as
the JAX package does. The batch dim is symbolic (any B >= 1, one-row
requests included) unless ``--serving-batch`` pins it. ``--quantize int8``
exports under ``ops.quant.int8_inference``, so the artifact holds the int8
Dense products, each weight's quantization included: it runs at every
call (the live model keeps each weight's codes; an export keeps none).
``serve --exported <dir>`` serves the artifacts.

Where the JAX package differs: it pins its attention to XLA so that its
StableHLO runs on any platform. Here the artifact calls the
``declip_tpu_torch::flash_attn_fwd`` operator (K1, ops/flash_attention.py),
so serving it launches K1 on the card, and loading it needs
``declip_tpu_torch`` importable (the import registers the operator). An
artifact runs on the device it was exported on.

The checkpoint bridges, ``--from_pth`` (a torch ``.pth.tar`` to flax
msgpack) and ``--to_pth`` (msgpack to ``.pth.tar``), stay in the JAX
package (``python -m declip_tpu.tools.convert``): the port never parses
flax's msgpack format.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import List, Union

import torch

from declip_tpu_torch.ops import flash_attention  # noqa: F401  (K1's op)
from declip_tpu_torch.ops.quant import int8_inference
from declip_tpu_torch.tools._common import load_eval_model

__all__ = ["ARTIFACTS", "export_serving", "main"]

# kind -> artifact file name
ARTIFACTS = {"image": "encode_image.pt2", "text": "encode_text.pt2"}
CONTEXT_LENGTH = 77


def export_serving(config_path: str, out_dir: str, batch: int = 0,
                   quantize: str = "",
                   device: Union[str, torch.device] = "cuda") -> List[str]:
    """Export both towers (see the module docstring) -> the files
    written. ``batch`` 0 exports a symbolic batch dim."""
    if quantize not in ("", "int8"):
        raise ValueError(f"unknown --quantize {quantize!r} (only 'int8')")
    if batch < 0:
        raise ValueError(f"--serving-batch must be >= 0; got {batch}")
    model = load_eval_model(config_path, device)
    device = next(model.parameters()).device
    res = model.visual.input_resolution
    # a symbolic batch traces at 2 rows: a sample of 1 would pin it
    rows = batch or 2
    samples = {
        "image": torch.zeros(rows, res, res, 3, device=device),
        "text": torch.ones(rows, CONTEXT_LENGTH, dtype=torch.int64,
                           device=device),
    }
    # one entry for the tower's one input
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if not batch \
        else None
    quant_ctx = int8_inference if quantize == "int8" \
        else contextlib.nullcontext
    # each model's encode_image is its visual tower, and its text tower is
    # the module encode_text: each artifact holds its own tower's weights
    towers = {"image": model.visual, "text": model.encode_text}
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for kind, fname in ARTIFACTS.items():
        # the int8 route is taken while tracing, so it wraps the export
        with torch.no_grad(), quant_ctx():
            program = torch.export.export(towers[kind], (samples[kind],),
                                          dynamic_shapes=dynamic)
        path = os.path.join(out_dir, fname)
        torch.export.save(program, path)
        written.append(path)
    return written


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser(
        description="Export the CLIP towers for serving (torch.export). "
                    "The --from_pth/--to_pth checkpoint bridges are the "
                    "JAX package's: python -m declip_tpu.tools.convert.")
    ap.add_argument("--export-serving", action="store_true", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--serving-batch", type=int, default=0,
                    help="pin the serving batch dim (default: symbolic)")
    ap.add_argument("--quantize", default="", choices=("", "int8"),
                    help="'int8': export with the int8 Dense products "
                         "(ops/quant.py); the artifact quantizes its "
                         "weights at every call, 2.7-4.3x the fp32 "
                         "artifact's wall time on an H100 today")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)
    written = export_serving(args.config, args.out, args.serving_batch,
                             args.quantize, args.device)
    for path in written:
        print(f"exported {path}")
    return written


if __name__ == "__main__":
    main()
