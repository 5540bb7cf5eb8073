"""The full DeCLIP recipe learns colored shapes (port of
experiments/learnability_tpu.py).

    python -m declip_tpu_torch.tools.learnability [--steps 600] [--batch 128] \
        [--recipe clip|declip] [--pool N] [--seed 0] [--device cuda|cpu]

Trains ``declip_vitb32`` (two image views, EDA-style second captions, MLM,
SimSiam and the NN bank: the recipe of declip_solver.py:442-533) or
``clip_vitb32`` on the colored shapes of ``data/synthetic_shapes.py``, in
bf16, through ``make_train_step``, then classifies 512 fresh renderings
zero-shot against the 16 class prompts. Chance is 1/16; with no pool the
run must clear a zero-shot top-1 of 0.40, the JAX script's own bound. One
JSON line: the recipe, the pool, the seed, ``backend`` (the device), the
steps and batch, the first and last loss, ``zero_shot_top1``, ``chance``
and ``train_steps_per_s`` (the host's clock over steps 2..N, the last loss
read ending it).

The model is the JAX script's: towers 64 wide with 2 layers of 2 heads
(ViT patch 8 at 32 px, so the image tower runs at L = 17 and the text
tower at L = 77, causal; heads of 32, which K1 and K2 take on the card),
embedding dim 64, a bank of 1024; AdamW at 5e-4 with weight decay 0.02 and
the JAX script's pconfig, a Cosine schedule from 2e-3 with 30 warm-up
steps, the ``logit_scale_param_value`` clip, and for DeCLIP the loss
weights 0.4/0.2/0.2/0.2.

``--pool N`` trains on a fixed pool of N renderings (the limited-data A/B
regime of the JAX script; a second view pairs each sample with another
pool member of its class) and checks no bound. Batches come from
``np.random.default_rng(seed)`` as in the JAX script, the first one drawn
for its model init and dropped here too, so both packages train on the
same stream; the weights come from ``torch.Generator`` seeds. The batches
are built ahead by one worker process (``data/shapes_batches.py``'s
``batch_stream``), the same ones in the same order, so that rendering
them does not hold up the steps.
"""

from __future__ import annotations

import argparse
import json
import time
from contextlib import closing
from typing import List, Optional

import numpy as np
import torch

from declip_tpu_torch.config import parse_config
from declip_tpu_torch.data.shapes_batches import (
    RES,
    Pool,
    batch_arrays,
    batch_stream,
)
from declip_tpu_torch.data.synthetic_shapes import (
    class_prompts,
    render_class_batch,
)
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.memory_bank import init_bank
from declip_tpu_torch.optim import optim_entry, scheduler_entry
from declip_tpu_torch.tokenizer import get_tokenizer
from declip_tpu_torch.tools._common import resolve_device
from declip_tpu_torch.train import make_train_step, new_train_state

DIM = 64
BANK = 1024
PCONFIG = {"ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
           "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}
CLIP_CFG = """
grad_clip: {type: logit_scale_param_value, value: 2, max_value: 5}
"""
DECLIP_CFG = """
clip_simsiam_loss_weight: {clip_loss: 0.4, nn_text: 0.2, simsiam_loss: 0.2, masking_language: 0.2}
data: {train: {image_text_two_view: True}}
""" + CLIP_CFG


def make_batch(rng, tok, n, pool=None, recipe="declip", device="cpu"):
    """The JAX script's ``make_batch``: :func:`batch_arrays` as tensors on
    ``device``. -> (the batch, the class indices)."""
    arrays, idx = batch_arrays(rng, tok, n, pool, recipe)
    return _to_device(arrays, device), idx


def _to_device(arrays, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def build_model(recipe: str, vocab_size: int, device):
    """The JAX script's model in bf16 (fp32 parameters), seeded weights."""
    clip_kwargs = {"use_allgather": False}
    if recipe == "declip":
        clip_kwargs.update(text_mask_type="MLM", return_nn_bank=True,
                           feature_dim=DIM)
    model = model_entry({
        "type": f"{recipe}_vitb32",
        "kwargs": {
            "image_encode": {"embed_dim": DIM, "input_resolution": RES,
                             "patch_size": 8, "width": 64, "layers": 2,
                             "heads": 2, "freeze_conv1": False},
            "text_encode": {"embed_dim": DIM, "transformer_width": 64,
                            "transformer_heads": 2, "transformer_layers": 2,
                            "vocab_size": vocab_size},
            "clip": clip_kwargs,
            "dtype": "bfloat16",
        },
    })
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device)


def zero_shot_top1(model, tok, device) -> float:
    """Top-1 of 512 fresh renderings (seed 999) against the 16 class
    prompts (clip_solver.py:675-737's protocol)."""
    model.eval()
    with torch.no_grad():
        prompts = torch.from_numpy(tok.tokenize(class_prompts())).to(device)
        t_feat = model.encode_text(prompts).float()
        t_feat = t_feat / (torch.linalg.vector_norm(
            t_feat, dim=-1, keepdim=True) + 1e-10)
        imgs, idx = render_class_batch(np.random.default_rng(999), 512,
                                       res=RES)
        i_feat = model.encode_image(torch.from_numpy(imgs).to(device)).float()
        i_feat = i_feat / torch.linalg.vector_norm(i_feat, dim=-1,
                                                   keepdim=True)
        pred = (i_feat @ t_feat.T).argmax(dim=-1).cpu().numpy()
    return float((pred == idx).mean())


def main(argv: Optional[List[str]] = None) -> dict:
    """The CLI -> the JSON object printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--recipe", default="declip", choices=["clip", "declip"])
    ap.add_argument("--pool", type=int, default=0,
                    help="fixed training-pool size (0: unlimited fresh "
                         "renderings), the data-efficiency A/B regime")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tok = get_tokenizer(None)  # hermetic byte-level vocab
    model = build_model(args.recipe, tok.vocab_size, device)
    cfg = parse_config(DECLIP_CFG if args.recipe == "declip" else CLIP_CFG)
    rng = np.random.default_rng(args.seed)
    pool = (Pool(np.random.default_rng(1234), args.pool, RES)
            if args.pool else None)
    batch_arrays(rng, tok, args.batch, pool, args.recipe)  # the JAX init's
    sched = scheduler_entry(
        {"type": "Cosine", "kwargs": {"base_lr": 5e-4, "warmup_lr": 2e-3,
                                      "warmup_steps": 30}},
        max_iter=args.steps)
    tx = optim_entry(
        {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.02}},
        model, sched, pconfig=PCONFIG)
    bank = (init_bank(torch.Generator().manual_seed(1), BANK, DIM,
                      device=device)
            if args.recipe == "declip" else None)
    state = new_train_state(
        model=model, opt_state=tx.init(dict(model.named_parameters())),
        bank_text=bank)
    step = make_train_step(model, tx, cfg, sched, method=args.recipe,
                           total_steps=args.steps)

    first_loss = t0 = None
    with closing(batch_stream(rng, args.batch, args.steps, pool,
                              args.recipe)) as stream:
        for i, arrays in enumerate(stream):
            state, metrics = step(state, _to_device(arrays, device))
            if i == 0:
                first_loss = float(metrics["loss"])
                t0 = time.perf_counter()
    last_loss = float(metrics["loss"])
    steps_per_s = (args.steps - 1) / (time.perf_counter() - t0)

    top1 = zero_shot_top1(model, tok, device)
    result = {
        "recipe": ("declip (2 views + MLM + SimSiam + NN bank), bf16"
                   if args.recipe == "declip" else "clip, bf16"),
        "pool": args.pool, "seed": args.seed,
        "backend": str(device),
        "steps": args.steps, "batch": args.batch,
        "first_loss": round(first_loss, 3), "last_loss": round(last_loss, 3),
        "zero_shot_top1": round(top1, 4), "chance": 1 / 16,
        "train_steps_per_s": round(steps_per_s, 2),
    }
    print(json.dumps(result))
    if not args.pool and top1 <= 0.40:
        raise SystemExit(f"zero-shot top-1 {top1:.1%}: not learning")
    return result


if __name__ == "__main__":
    main()
