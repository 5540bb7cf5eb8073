#!/usr/bin/env python3
"""Smoke run of the PyTorch port (declip_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. card and build: the card's name and power limit, nvcc's version, and a
   fresh nvcc build of every CUDA kernel (sm_90a), one nvcc per source, all
   started together (phase 7's corpus is written meanwhile, and K3-K5's
   source, the slowest, builds on through phases 2 and 2b); ptxas' registers and spills per kernel; the toolkit's
   ``cuobjdump -sass`` of the libraries, which must show HMMA (tensor-core)
   instructions in K1's bf16 and fp32 (split TF32) kernels, in K2's bf16
   kernels and in K3's bf16 kernels, and no ptxas spill in any of them or
   in any other kernel that takes bf16;
2. K1 vs plain: the forward kernel's wrapper against its plain PyTorch
   version on the card, at the shapes the serving path gives it (fp32 at
   B = 1, 8 and 16), at the learnability eval's (phase 15a: 512 images at
   L = 17 and 16 prompts at L = 77, heads of 32) and at longer sequences,
   in fp32 and bf16; times for
   the kernel, the plain version and one PyTorch library call (with the
   library's kernels, which name its backend), beside the least time the
   card could take; and at the serving shapes, the plain version on
   TF32-rounded inputs must miss the fp32 limit, which shows that the limit
   would fail a kernel that dropped the split;
2b. K2 vs plain: the backward kernel against ``attention_bwd_plain`` at the
   training path's shapes (B=128), at the learnability run's (B=128, heads
   of 32, L = 17 and 77 causal) and at longer sequences, in fp32 and bf16,
   dq, dk and dv each within tolerance; the same four times, K2's time by
   kernel, and K1's times as the training forward runs it (with its
   log-sum-exp output);
3. the serving slice: CLIP ViT-B/32 at full width from seeded weights,
   served over HTTP on 127.0.0.1 by the port's ServingHost; image and text
   requests (some concurrent, one normalized); shapes, finiteness, unit
   norm; every attention of both towers counted through the kernel; one
   batch re-run through the plain attention path and compared; serving
   latencies;
4. the training slice: CLIP ViT-B/32 at full width in bf16 from seeded
   weights, trained by the port's ``make_train_step`` with the YFCC15M
   recipe (inlined below) at batch 128 on one repeated seeded batch; finite
   and falling losses, no skipped update, the logit scale in [3, 6], 24 K1
   and 24 K2 calls per step and no plain-path attention; step time, device
   busy time and the largest kernels; the cost of the step's one host read
   (the step against the same device work without it); then one fp32 step
   and one bf16 step (K1 and K2's tensor-core route) through the kernels
   against the plain attention path under torch autograd, from the same
   weights and batch;
2c. K3, K4 and K5 vs plain: the late-interaction forward against
   ``late_interaction_raw_plain``, its winner mask bit for bit against
   ``late_interaction_winners_plain``, and the two backward kernels, on
   K3's winners, against ``late_interaction_bwd_plain`` (the winners from
   the similarities) and their own plain versions on the same mask, at the
   FILIP training path's two shapes
   (B = GB = 128: image queries N1=49 and text queries N1=77 against 16
   selected key tokens, D=256), at the JAX tests' awkward shapes, at a wide
   key set without selection and at exact ties, in fp32 and bf16, and with
   a NaN key token or query row (NaN where the plain versions give it); the
   kernel, plain and bound times of each, and the plain backward from the
   similarities;
2d. K3 alone at the dense zero-shot eval's ImageNet shape (B=128, N1=49,
   C=1000, N2=77, D=256, bf16) against its plain version, with its device
   time, its bound and the time of its product alone in ``torch.matmul``;
5. the FILIP training slice: FILIP ViT-B/32 at full width in bf16 from
   seeded weights with the YFCC15M FILIP recipe (inlined below: MLM-masked
   text, top-k 16 token selection, dense loss only), trained by
   ``make_train_step`` at batch 128 on one repeated seeded batch; finite and
   falling losses, no skipped update, the logit scale in [3, 6], per step
   24 K1, 24 K2, 2 K3, 2 K4 and 2 K5 calls and no plain-version call;
   pairs/s, device busy time and the late interaction's share of it; then
   one fp32 step through the kernels against the plain path (plain
   attention and the chunked late interaction), with the parameters that
   only the weight-0 loss terms reach getting exactly zero from both, and
   K3-K5 against the chunked late interaction behind the same K1 and K2.

6. the DeCLIP-ResNet-50 training slice: ``declip_res50`` at full width in
   bf16 from seeded weights and a seeded 2^16 x 1024 NN text bank, with
   the YFCC15M DeCLIP recipe (inlined below: MLM-masked text, EDA
   captions, two image views, SimSiam, the NN-bank InfoNCE), trained by
   ``make_train_step`` at batch 128 on one repeated seeded batch; every loss
   term finite, no skipped update, the bank pointer 2B further each step,
   the BatchNorm running statistics moved and finite, the logit scale in
   [3, 6], per step 24 K1 and 24 K2 calls and no self-attention on the
   plain path (the pooled query of AttentionPool2d is the plain path's by
   design, 2 a step); step time, pairs/s, device busy and idle, time by
   kind, the bank query's time and peak memory; then one fp32 step through
   K1/K2 against the plain attention path from the same weights and bank
   (each bn3 at a seeded non-zero scale, so that every tower parameter has
   a gradient): the loss, each parameter's gradient, the bank's neighbour
   indices and the BatchNorm statistics (the image side's only: the recipe
   has no BatchNorm after the text tower);
7. the solver: ``python -m declip_tpu_torch.solver``'s ``main``, in this
   process, trains the YFCC15M DeCLIP-ResNet-50 recipe as its config file
   has it (bf16, B=128, MOCOV2 views, EDA and MLM captions, the 2^16 bank,
   7 loader workers) from a seeded corpus of 1,024 JPEGs on disk (a
   JSONL metafile read with fseek) for 6 steps, saving at 3 and 6, and
   validates zero-shot on 10 x 16 images with prompt80; only the data
   paths, max_iter, print_freq, save_freq, save_many and val_freq are
   set. Every loss finite and no update skipped, the bank pointer 2B a
   step further, both checkpoints and ckpt_meta.json, 160 result lines
   with top-1 and top-5 in [0, 100], at least 24 K1 and 24 K2 calls a
   step; then a second main() auto-resumes at 6 and ends at 8, and the
   CLI itself (``python -m declip_tpu_torch.solver ... --evaluate``) runs
   once and prints a metric. The solver's step time and pairs/s at steps
   4-6 beside phase 6's, the wait for data and its share of the step, the
   host-to-device copy, os.cpu_count(), the checkpoint's size and write
   time and the eval's time; the loader alone for two rounds of its 7
   workers' batches (they land in rounds), its rate over the second;
8. the fast input path: the same recipe and corpus through ``main`` with
   ``data.train.device_aug=true`` on webdataset shards (the corpus packed
   into 4 by ``python -m declip_tpu_torch.tools.make_wds``'s ``pack``) read
   by process workers, the loader shipping uint8 geometry crops and the
   step running MOCOV2's photometrics on the card, for 6 steps; phase 7's
   checks (losses, no skipped update, the bank pointer, K1 and K2's exact
   launches, no plain self-attention), the batch on the card checked to be
   uint8 [128, 224, 224, 6]; steps 4-6, the wait for data, the copy; the
   photometrics on the card against the CPU on the same parameters (fp32,
   1e-5) and their device time; the loader alone with device_aug's crops,
   (a) thread workers on the JSONL metafile, (b) process workers, (c)
   process workers on the shards, each over its second round as in phase
   7, beside phase 7's host-MOCOV2 loader, and
   one batch of (a) on one thread. Every input decodes with PIL: the
   card's host has no libjpeg headers to build the native decoder with;
9. the DeFILIP and SLIP training slices: ``defilip_vitb32`` and
   ``slip_vitb32`` at full width in bf16 from seeded weights with the
   YFCC15M recipes (inlined below: DeFILIP with MLM, EDA captions, two
   views, SimSiam, the 2^16 x 512 bank and the filip term on top-k 16;
   SLIP with three views and loss_weight 1/1), trained by
   ``make_train_step`` at batch 128 on one repeated seeded batch; losses
   finite and falling, no skipped update, the logit scale in [3, 6],
   DeFILIP's bank pointer 2B a step further, SLIP's ``predictor_sim``
   BatchNorm statistics moved and finite; the exact launches a step
   (DeFILIP 48 K1, 48 K2, 2 each of K3-K5; SLIP 48 K1, 48 K2) and no plain
   version; step time, pairs/s, device busy and idle, the late
   interaction's share, peak memory; DeFILIP again under ``dense_aug``
   (8 each of K3-K5 a step); then one fp32 step of each through the
   kernels against the plain path (the loss within phase 5's 1e-4; each
   gradient as STEP_GRAD_ATTN64_FACTOR says), and again with a planted
   fault that the check must fail;
10. the other methods through the solver, on phase 7's corpus: ``main``
   trains the yfcc15m_vit_defilip recipe as its file has it for 4 steps
   and evaluates zero-shot dense through K3 (160 images, prompt80), and
   yfcc15m_r50_slip for 2 steps (SLIP's three views from the loader) with
   its pooled eval; only the data paths, max_iter, print_freq, save_freq
   and val_freq are set. Losses finite, no skipped update, a checkpoint,
   160 result lines with top-1 and top-5 in [0, 100], the exact launches
   (K3 once an eval batch); one eval batch's K3 logits against the chunked
   plain late interaction on the same features; whether the profiler
   still sees device events before and after it. The corpus is deleted at
   the end.

11. data-parallel training (declip_tpu_torch.parallel), each part's ranks
   started by ``python -m torch.distributed.run`` on this script's rank
   entries, with a deadline after which they are stopped: (a)
   ``--nproc_per_node 1`` drives the solver's ``main`` on phase 7's corpus
   with the DeCLIP-ResNet-50 recipe (bf16, B=128) under NCCL at world 1:
   6 steps saved at the end, the zero-shot eval merged through
   ``gather_object``, an auto-resume for one step; steps 4-6 beside
   phase 7's, the gradient all-reduce's device time a step (CUDA events)
   and the exact K1/K2 launches; (b) two ranks on the one card over gloo,
   each on half of phase 6's batch, one fp32 step of
   DeCLIP-ResNet-50 at full width with BatchNorm over the global batch and
   with ``use_sync_bn: false`` (each rank's own rows), and of FILIP
   ViT-B/32 (K3-K5 at 64 queries against 128 keys), against one process
   on the whole batch from the same weights: the loss, each parameter's
   gradient norm, the bank rows the step wrote and every BatchNorm
   statistic within 1e-4, the ranks bit for bit alike, and each rank's
   exact launches of K1-K5; the step times of (b) are two ranks sharing
   one card over gloo, not a performance number; (c) the same over NCCL
   on two cards where the machine has them, else one line saying that it
   did not run; (b) also runs phase 12d's cases;
12. the last two reference configs and the loss modes: (a) ``main``
   trains the yfcc15m_vit_siglip recipe as its file has it (CLIP
   ViT-B/32, bf16, B=128, ``sigmoid_ring`` at world 1, logit_bias_init
   -10, Adafactor, the norm clip) on phase 7's corpus for 6 steps, saved
   at the end, with its zero-shot eval, then resumes for one step with
   Adafactor's slots restored bit for bit; losses finite, the logged bias
   moving from -10, the exact launches (24 K1 and 24 K2 a step); steps
   4-6 beside phase 4's step; one Adafactor update's device ms and state
   MiB beside AdamW's on the same model; (b) ``main`` trains the
   declip88m_vitb32_declip recipe (DeCLIP ViT-B/32 at embed 3072, the
   2^16 x 3072 bank, SGD with nesterov, the abs-min guard, batch 64) for
   4 steps with its eval: losses finite, the bank pointer, the logit scale
   at or above 3, 48 K1 and 48 K2 a step; (c) one fp32 loss and gradient
   of CLIP ViT-B/32 at B=128 through K1/K2 under chunked (chunk 32) and
   ring against full, sigmoid_chunked and sigmoid_ring against sigmoid,
   then GradCache (4 chunks) against the unchunked step: the loss within
   1e-5, each parameter's ||g - g_ref|| <= 1e-4 ||g_ref||, the
   re-forward's outputs bit for bit the embedding pass's; then the bf16
   train step with and without GradCache, its peak device memory and step
   time; (d) inside 11b's launch, ``ring`` and ``sigmoid_ring`` on CLIP
   ViT-B/32, fp32, two gloo ranks at 2 x 64 against one process at 128,
   within 1e-4;
13. the SSL builders (models/ssl_builders.py): (a) ``moco_vitb32``,
   ``simclr_vitb32`` and ``clsa_vitb32`` at full width (ViT-B/32, embed
   2048, the head 2048 -> 128) with MoCo-v2's recipe (dim 128, K 2^16,
   m 0.999, T 0.2; SGD lr 0.03, momentum 0.9, wd 1e-4), bf16, B=128,
   CLSA with its five strong views (96-224 px), trained by
   ``make_train_step`` on one repeated seeded batch: losses finite, no
   skipped update, the queue pointer 128 further a step, the exact
   launches a step (the key encoder runs K1 without a graph, never K2:
   MoCo 24 K1 and 12 K2, SimCLR 24 and 24, CLSA 84 and 72) and no plain
   version; step time and device busy; (b) ``moco_vitb32`` and
   ``clsa_vitb32`` in fp32 at SSL_CHECK_LAYERS layers, one step through
   K1/K2 against the plain attention path: the loss, each parameter's
   gradient within 1e-4 of its norm, the queue rows the step wrote and
   the key parameters; K1 and K2 alone at the strong views' lengths (L =
   10, 17, 26, 37) in fp32 and bf16, as phases 2 and 2b hold them; (c)
   ``main`` trains ``moco_res50`` with MoCo-v2's recipe (MOCOV2 views
   from phase 7's corpus, inlined below) for SSL_SOLVER_STEPS steps,
   saved at the end, then auto-resumes for one step: the queue, its
   pointer, the key parameters and the key encoder's BatchNorm
   statistics restored bit for bit; (d) ``main`` trains ``clsa_res50``
   with ``CLSA5`` views for CLSA_SOLVER_STEPS steps: the strong views'
   shapes, the DDM term; for each, the first step's wait for the
   loader's first round (with its workers' start-up) and one batch built
   on one thread. ``python3 chip_smoke.py --ssl-loader-rates`` runs the
   two loaders alone for three rounds instead, on the host only: their
   ms a batch over the last two;
14. the serving tools, on phase 3's CLIP ViT-B/32 at full width, fp32,
   in two parts: (b) live, (d), (e) and (f) right after phase 6, so that
   the profiler trace comes early in the run; the two exports as
   ``python -m declip_tpu_torch.tools.convert`` processes beside phase
   11b (no performance numbers there: they took 36 s in line), then
   (a), (b)'s artifacts and (c) after it. (a) ``convert
   --export-serving`` with a symbolic batch, fp32 and ``--quantize
   int8``, each process's seconds and the MiB; each
   ``torch.export`` artifact at B = 1, 8 and 16 against the live model
   within 1e-5 of each row's norm, 12 K1 launches a tower call; (b) which
   shapes ``torch._int_mm`` takes on the card, then int8, live and
   exported, against fp32 at B = 1 and 8: each row's cosine above 0.995,
   the artifact against the live int8 at 0.9999, the numbers moved, and
   the ms a call (CUDA events; for the live int8 also profiler device
   time) beside phase 3's fp32 towers;
   (c) ``ServingHost.from_exported`` and ``from_config(int8=True)``, the
   hosts ``serve --exported`` and ``serve --int8`` build, answer one-row
   and batched HTTP requests, 12 K1 launches a batch, p50 and p95;
   (d) ``tools.inference --saliency`` on 4 of phase 7's JPEGs: 12 + 24
   K1 an image and 12 fp32 K2 an image, the probabilities within 1e-5 of
   the live model's zero-shot on the same crops, each saliency map
   [224, 224], finite and not all zero; (e) the FLOPs of one bf16 step
   of phases 4 and 6 (``utils/flops.py``; K1-K5 by their registered
   formulas) and the MFU of their step times against the H100 SXM5's
   dense bf16 peak (NVIDIA's datasheet); (f) the yfcc15m_vit_siglip
   recipe through ``main`` for 5 steps with ``profile: {enable: true,
   start_step: 3, num_steps: 2}``: one trace under
   ``<event_path>/profile`` whose device kernels include K1's;
15. the last single-card modules, after phase 13: (a) ``python -m
   declip_tpu_torch.tools.learnability``'s ``main`` as the JAX script's
   defaults run it (DeCLIP with two views, MLM, SimSiam and the NN bank,
   bf16, 600 steps at B=128 on fresh colored shapes; towers 64 wide, 2
   layers, heads of 32 at L = 17 and 77 causal): zero-shot top-1 above
   0.40, the first and last loss and steps/s, 8 K1 and 8 K2 a step and 4
   K1 for the eval, no plain-version call (phases 2 and 2b hold K1 and K2
   against their plain versions at these shapes); (b) ``linear_probe.main`` on
   phase 3's CLIP ViT-B/32 from a config through ``load_eval_model``,
   on 512 + 128 ``--read-from synthetic`` rows: 12 K1 an embedding
   batch, one batch against the plain attention path within phase 3's
   tolerance, the top-1 and the embedding's time; (c)
   ``text_visualize.main`` on that model: the JSON, a symmetric cosine
   matrix with a unit diagonal within 1e-5, 12 K1; (d) where
   ``transformers`` imports, ``declip_vitb32`` with a BERT-base text
   tower from ``BertConfig()`` with seeded weights saved under the run's
   temporary directory, 3 bf16 steps at B=128: finite losses, 24 K1 and
   24 K2 a step, the image tower's only; where it does not, one line
   says so.

16. MoE towers, after phase 15: ``main`` trains CLIP ViT-B/32 at full
   width with both towers MoE (8 experts, top-2, capacity factor 1.25,
   aux weight 0.01; 24 MoE blocks, about 0.8 B parameters) on the YFCC15M
   CLIP recipe as its file has it (bf16, B=128, AdamW) on phase 7's
   corpus for MOE_STEPS steps, saved at the end, with its zero-shot eval:
   losses finite, no skipped update, ``moe_aux_loss`` logged and above 0,
   a router's and an expert's weights moved, 24 K1 and 24 K2 a step and
   K1 for the eval, no plain version; the share of token choices the
   capacity dropped, each block and step; steps 4-6, the device's busy
   time and idle share over repeated-batch steps, the index kernels that
   dispatch and combine, peak memory; then one fp32 step through K1/K2
   against the plain attention path (the loss within 1e-4, each
   gradient's ||g_k - g_p|| <= 1e-4 ||g_p||), the plain path routed as
   the kernels' path routed, with the count of routing choices its own
   routers would have made otherwise. Phase 11b also runs
   two new cases on its two gloo ranks: CLIP ViT-B/32 fp32 under
   ``parallelism: {fsdp: true}`` (with an EMA; each rank's resident
   parameter, slot and EMA bytes printed) and a MoE CLIP under ``{ep:
   2}`` at a capacity that drops tokens, each against one process.

The three last lines are the card's name and power limit as nvidia-smi
prints them, one JSON object with every kernel's numbers, and the ok/device
JSON object. Full results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate, fp32
# outside the tensor cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# (rtol, atol, atol share): an element's limit is rtol * |want| plus the
# larger of atol and the share of the compared tensor's largest magnitude.
# fp32: the kernel and the plain version differ in summation order only.
# bf16: one bf16 rounding of P (before P.V) and of O on each side, each
# 2^-9 of the value at most, so rtol 1e-2 with an atol of 1% of max |want|
# (for elements near zero, whose rounding follows P's scale). The 1e-6
# floor is for a tensor that is exactly zero: at L=1, dq and dk are zero in
# exact arithmetic, and K2's row term leaves a rounding residue in them.
TOLERANCE = {"float32": (2e-5, 2e-5, 0.0), "bfloat16": (1e-2, 1e-6, 1e-2)}
# the served towers vs the same weights through the plain attention path:
# fp32, 12 layers of summation-order differences (kernel vs plain, and
# GEMM algorithms that differ with the bucket's batch size)
TOWER_TOLERANCE = (1e-4, 1e-4)  # (rtol, atol)
# K2 vs attention_bwd_plain: fp32, summation order over three chained
# contractions and the row term taken from O instead of P (equal in exact
# arithmetic); bf16, a bf16 rounding of P, dS and O on either side (as
# TOLERANCE's bf16 entry)
BWD_TOLERANCE = {"float32": (1e-4, 1e-4, 0.0), "bfloat16": (1e-2, 1e-6, 1e-2)}
# one fp32 training step through the kernels vs the plain attention path
# under torch autograd (24 layers, then InfoNCE over 128 pairs): the loss;
# each gradient element; and each parameter's gradient as a whole,
# ||g_kernels - g_plain|| <= STEP_GRAD_REL_NORM * ||g_plain||, which a
# gradient of zeros or a miswired backward fails however small its elements
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOLERANCE = (1e-3, 1e-5)  # (rtol, atol)
STEP_GRAD_REL_NORM = 1e-4
# one bf16 step (the training dtype) through K1/K2's bf16 route vs the plain
# attention path: the loss, and the worst parameter's relative gradient
# norm. The paths round to bf16 at other places (the plain path's autograd
# rounds dP too, and P after normalising), and 24 layers carry it on: with
# the CUDA-core kernels of the previous design the loss differed by 2.7e-5
# and the worst parameter by 0.0432, with the tensor-core kernels by 1.1e-4
# and 0.0433. The check is also run on planted faults, K2's dK scaled in
# every layer (STEP_BF16_FAULTS), and must fail the one of STEP_BF16_FAULT:
# dK x 1.02, 1.05, 1.1 read 0.0440, 0.0494, 0.0721 (NVIDIA H100, 700 W;
# the loss does not see dK). The gradient limit lies between 0.0433 and
# 0.0494: a dK fault of 2% passes this check, and phase 2b holds K2 itself.
STEP_BF16_LOSS_RTOL = 1e-3
STEP_BF16_GRAD_REL_NORM = 0.046
STEP_BF16_FAULTS = (1.02, 1.05, 1.1)
STEP_BF16_FAULT = 1.05
# FILIP's fp32 step: K3-K5 against the chunked late interaction behind the
# same K1 and K2 towers, so that the features agree exactly and only the
# similarities' summation order differs. The 1e-4 above, kernels against the
# whole plain path, also takes in the towers' ~1e-6 differences, which can
# move a max's winner where two similarities nearly tie.
STEP_LI_GRAD_REL_NORM = 1e-5

# (B, H, L, Dh, causal): the serving path's two shapes first
ATTN_CASES = [
    (8, 12, 50, 64, False),   # ViT-B/32 image tower, 224 px
    (8, 8, 77, 64, True),     # text tower
    (4, 16, 257, 64, False),  # ViT-L/14, 224 px
    (2, 16, 577, 64, False),  # ViT-L/14, 336 px
    (8, 8, 77, 32, True),     # head dim 32 (the tiny unit widths)
    (512, 2, 17, 32, False),  # learnability eval: 512 renderings, 32 px
    (16, 2, 77, 32, True),    # learnability eval: the 16 class prompts
]
MAIN_PATH_CASES = ATTN_CASES[:2]
# the serving batcher's other buckets that phase 3 times (1 and 16 rows), at
# the serving shapes, in fp32 only (serving's dtype)
SERVE_BUCKET_CASES = [
    (1, 12, 50, 64, False),
    (1, 8, 77, 64, True),
    (16, 12, 50, 64, False),
    (16, 8, 77, 64, True),
]
# the kernels' sources in two build groups: the attention kernels, which
# phases 2 and 2b need first, and K3-K5's, which builds on beside them
BUILD_GROUPS = (["flash_attn_fwd", "flash_attn_bwd"], ["filip_li"])
# (B, H, L, Dh, causal): the training path's two shapes first, at the
# YFCC15M recipe's batch of 128 per card (bench.py:726)
TRAIN_BATCH = 128
BWD_CASES = [
    (TRAIN_BATCH, 12, 50, 64, False),  # ViT-B/32 image tower, 224 px
    (TRAIN_BATCH, 8, 77, 64, True),    # text tower
    (4, 16, 257, 64, False),           # ViT-L/14, 224 px
    (2, 16, 577, 64, False),           # ViT-L/14, 336 px
    (8, 8, 77, 32, True),              # head dim 32
    (TRAIN_BATCH, 2, 17, 32, False),   # learnability image tower, 32 px
    (TRAIN_BATCH, 2, 77, 32, True),    # learnability text tower
]
TRAIN_CASES = BWD_CASES[:2]
TRAIN_WARMUP_STEPS = 3
TRAIN_STEPS = 20
FILIP_TRAIN_STEPS = 10
SEED = 0
# (B, N1, GB, N2, D): the FILIP training path's two late interactions first
# (image queries against the 16 selected text tokens of every item, text
# queries against the 16 selected image tokens, dense_embed_dim 256), then
# tests/test_filip_pallas.py's awkward shapes and a wide key set without
# selection (every text token a key)
LI_CASES = [
    (TRAIN_BATCH, 49, TRAIN_BATCH, 16, 256),
    (TRAIN_BATCH, 77, TRAIN_BATCH, 16, 256),
    (8, 50, 130, 16, 256),
    (6, 5, 40, 3, 64),
    (8, 25, 128, 16, 128),
    (8, 77, 128, 77, 256),
]
LI_MAIN_CASES = LI_CASES[:2]
# key items with duplicated tokens, so that maxima tie exactly
LI_TIES_CASE = (16, 49, 64, 16, 256)
# ((rtol, atol) of K3, (rtol, atol) of K4 and K5) against the plain
# versions on grid inputs (every similarity exact in fp32): fp32 differs in
# summation order (tests/test_filip_pallas.py:37, 55); raw is fp32 in both
# dtypes and held alike; bf16 dd1 and dd2 by one rounding of fp32 sums that
# differ in order, at most one bf16 ulp (2^-7 of the value at most)
LI_TOLERANCE = {"float32": ((1e-5, 1e-5), (2e-4, 2e-5)),
                "bfloat16": ((1e-5, 1e-5), (8e-3, 1e-6))}

# the 49409-entry vocab ends <|mask|>, <|startoftext|>, <|endoftext|>
# (declip_tpu_torch/tokenizer/bpe.py:128-130)
MASK, SOT, EOT, VOCAB = 49406, 49407, 49408, 49409
CONFIG = """
model:
    type: clip_vitb32
    kwargs:
        image_encode: {embed_dim: 512}
        text_encode: {embed_dim: 512, vocab_size: 49409}
        clip: {use_allgather: True}
"""
# experiments/clip_experiments/yfcc15m/yfcc15m_vit_clip/config.yaml, with the
# vocab the BPE asset gives (the repository carries no asset, so the seeded
# run names its size) and precision.dtype put into the model kwargs, as the
# JAX solver does (solver/__init__.py:232-233)
TRAIN_CONFIG = """
model:
    type: clip_vitb32
    kwargs:
        image_encode: {embed_dim: 512}
        text_encode: {embed_dim: 512, vocab_size: 49409}
        clip: {use_allgather: True}
precision: {dtype: bfloat16}
grad_clip: {type: logit_scale_param_value, value: 3, max_value: 6}
optimizer:
    type: AdamW
    kwargs: {lr: 0.0001, weight_decay: 0.1, betas: [0.9, 0.98],
             eps: 0.00000001}
    pconfig:
        bn_w: {weight_decay: 0}
        bn_b: {weight_decay: 0}
        ln_w: {weight_decay: 0}
        ln_b: {weight_decay: 0}
        linear_b: {weight_decay: 0}
        conv_b: {weight_decay: 0}
        logit_scale: {weight_decay: 0}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0001, warmup_lr: 0.001, min_lr: 0.0,
             warmup_steps: 2500, max_iter: 128001}
"""
# experiments/filip_experiments/yfcc15m/yfcc15m_vit_filip/config.yaml, cut
# and completed as TRAIN_CONFIG is (top_k 16 and dense_embed_dim 256 are
# the model's defaults there)
FILIP_CONFIG = """
model:
    type: filip_vitb32
    kwargs:
        image_encode: {embed_dim: 768}
        text_encode: {embed_dim: 768, vocab_size: 49409}
        clip: {use_allgather: True, text_mask_type: MLM, return_dense: True,
               select_topk: True, feature_dim: 768}
clip_simsiam_loss_weight: {clip_loss: 0.0, clip_dense_loss: 1.0,
                           masking_language: 0.0}
precision: {dtype: bfloat16}
grad_clip: {type: logit_scale_param_value, value: 3, max_value: 6}
optimizer:
    type: AdamW
    kwargs: {lr: 0.0001, weight_decay: 0.5, betas: [0.9, 0.98],
             eps: 0.00000001}
    pconfig:
        bn_w: {weight_decay: 0}
        bn_b: {weight_decay: 0}
        ln_w: {weight_decay: 0}
        ln_b: {weight_decay: 0}
        linear_b: {weight_decay: 0}
        conv_b: {weight_decay: 0}
        logit_scale: {weight_decay: 0}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0001, warmup_lr: 0.001, min_lr: 0.0,
             warmup_steps: 2500, max_iter: 128001}
"""

# experiments/declip_experiments/yfcc15m/yfcc15m_r50_declip/config.yaml, cut
# and completed as TRAIN_CONFIG is (the reference's image_text_two_view data
# setting is the default of the loss)
DECLIP_CONFIG = """
model:
    type: declip_res50
    kwargs:
        image_encode: {embed_dim: 1024}
        text_encode: {embed_dim: 1024, vocab_size: 49409}
        clip: {use_allgather: True, text_mask_type: MLM,
               return_nn_bank: True, feature_dim: 1024, EDA: True}
clip_simsiam_loss_weight: {clip_loss: 0.4, nn_text: 0.2, simsiam_loss: 0.2,
                           masking_language: 0.2}
precision: {dtype: bfloat16}
grad_clip: {type: logit_scale_param_value, value: 3, max_value: 6}
optimizer:
    type: AdamW
    kwargs: {lr: 0.0001, weight_decay: 0.1, betas: [0.9, 0.98],
             eps: 0.00000001}
    pconfig:
        bn_w: {weight_decay: 0}
        bn_b: {weight_decay: 0}
        ln_w: {weight_decay: 0}
        ln_b: {weight_decay: 0}
        linear_b: {weight_decay: 0}
        conv_b: {weight_decay: 0}
        logit_scale: {weight_decay: 0}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0001, warmup_lr: 0.001, min_lr: 0.0,
             warmup_steps: 2500, max_iter: 128001}
"""
# the reference's NN bank (declip.py, nn_size 2^16) over embed_dim 1024
DECLIP_BANK = 2 ** 16
DECLIP_TRAIN_STEPS = 10
# DeCLIP's fp32 step: BatchNorm running statistics after the forward of the
# kernel path against the plain path's, as ||a - b|| <= this * ||b|| (the
# recipe has no BatchNorm after the text tower: a check of the image side)
STEP_BN_REL_NORM = 1e-5
# parameters whose gradient is 0 in exact arithmetic: a bias right before a
# BatchNorm (the batch mean removes it) and attnpool's key bias (the softmax
# removes it). Their gradients are rounding noise on either path, held to
# STEP_NOISE_REL_NORM of the gradient of the layer's weight, not to the plain
# path's noise.
NOISE_GRADS = ("projector.linear1.bias", "projector.linear2.bias",
               "projector.linear3.bias", "predictor.linear1.bias",
               "visual.attnpool.k_proj.bias")
STEP_NOISE_REL_NORM = 1e-4

# phase 7: the YFCC15M DeCLIP-ResNet-50 recipe as a user runs it, through
# python -m declip_tpu_torch.solver's main(), over a seeded JPEG corpus on
# disk: 1,024 images whose long side spans 256-640 px and aspect 0.75-1.33
# (as YFCC's do), captions of 5-20 words from EDA's synonym vocabulary, a
# 10-class x 16-image zero-shot set
DECLIP_RECIPE = os.path.join(
    "experiments", "declip_experiments", "yfcc15m", "yfcc15m_r50_declip",
    "config.yaml")
SOLVER_IMAGES = 1024
SOLVER_CLASSES, SOLVER_PER_CLASS = 10, 16
SOLVER_PROMPTS = 80  # the recipe's label_texts_ensemble, prompt80
SOLVER_STEPS, SOLVER_SAVE_FREQ, SOLVER_RESUME_STEPS = 6, 3, 8
# steps whose wall times are read (the first ones wait for the loader's
# first batches and for cuDNN's first calls)
SOLVER_TIMED = (4, 6)
# the recipe's loader alone: the batches it builds, two rounds of its
# num_workers = 7 (its workers build a batch each side by side, so the
# batches land in rounds; the second round gives the steady rate)
SOLVER_LOADER_BATCHES = 14
# phase 8: the same recipe and corpus on the fast input path; the corpus
# packed into this many webdataset shards
FAST_SHARDS = 4
# photometric_apply on the card against the CPU on the same parameters:
# fp32, the luma sums, the 3x3 hue product and the blur's taps summed in
# other orders, a few ulps of values in [-2.2, 2.7]
AUG_ATOL = 1e-5

# phase 9: experiments/defilip_experiments/yfcc15m/yfcc15m_vit_defilip and
# experiments/slip_experiments/yfcc15m/yfcc15m_vit_slip, cut and completed as
# TRAIN_CONFIG is (top_k 16 and dense_embed_dim 256 are DEFILIP's
# defaults, sim_dim 256 and return_sim the file's; the reference's
# image_text_two_view data setting is the default of the loss)
DEFILIP_CONFIG = """
model:
    type: defilip_vitb32
    kwargs:
        image_encode: {embed_dim: 512}
        text_encode: {embed_dim: 512, vocab_size: 49409}
        clip: {use_allgather: True, text_mask_type: MLM,
               return_nn_bank: True, return_filip: True, select_topk: True,
               feature_dim: 512, EDA: True}
clip_simsiam_loss_weight: {clip_loss: 0.4, nn_text: 0.2, simsiam_loss: 0.2,
                           masking_language: 0.2, filip: 0.2}
precision: {dtype: bfloat16}
grad_clip: {type: logit_scale_param_value, value: 3, max_value: 6}
optimizer:
    type: AdamW
    kwargs: {lr: 0.0001, weight_decay: 0.1, betas: [0.9, 0.98],
             eps: 0.00000001}
    pconfig:
        bn_w: {weight_decay: 0}
        bn_b: {weight_decay: 0}
        ln_w: {weight_decay: 0}
        ln_b: {weight_decay: 0}
        linear_b: {weight_decay: 0}
        conv_b: {weight_decay: 0}
        logit_scale: {weight_decay: 0}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0001, warmup_lr: 0.001, min_lr: 0.0,
             warmup_steps: 2500, max_iter: 128001}
"""
SLIP_CONFIG = """
model:
    type: slip_vitb32
    kwargs:
        image_encode: {embed_dim: 512}
        text_encode: {embed_dim: 512, vocab_size: 49409}
        clip: {use_allgather: True, return_sim: True, feature_dim: 768,
               sim_dim: 256}
loss_weight: {clip_loss: 1, simclr_loss: 1}
precision: {dtype: bfloat16}
grad_clip: {type: logit_scale_param_value, value: 3, max_value: 6}
optimizer:
    type: AdamW
    kwargs: {lr: 0.0001, weight_decay: 0.5, betas: [0.9, 0.98],
             eps: 0.00000001}
    pconfig:
        bn_w: {weight_decay: 0}
        bn_b: {weight_decay: 0}
        ln_w: {weight_decay: 0}
        ln_b: {weight_decay: 0}
        linear_b: {weight_decay: 0}
        conv_b: {weight_decay: 0}
        logit_scale: {weight_decay: 0}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0001, warmup_lr: 0.001, min_lr: 0.0,
             warmup_steps: 2500, max_iter: 128001}
"""
# the DeFILIP recipe's bank: nn_size 2^16 over feature_dim 512
DEFILIP_BANK_DIM = 512
METHOD_TRAIN_STEPS = 6
# the launches of one step: DeFILIP's two text passes and two image views,
# 12 layers each, and its filip term (image queries against the selected
# text keys, text queries against the selected image keys); under
# dense_aug the four pairings' eight late interactions. SLIP's one text
# pass and three image views.
DEFILIP_PER_STEP = {"K1": 48, "K2": 48, "K3": 2, "K4": 2, "K5": 2}
DEFILIP_AUG_PER_STEP = {"K1": 48, "K2": 48, "K3": 8, "K4": 8, "K5": 8}
SLIP_PER_STEP = {"K1": 48, "K2": 48, "K3": 0, "K4": 0, "K5": 0}
# phase 9's fp32 steps: a parameter's gradient through the kernels may
# differ from the plain path's by STEP_GRAD_REL_NORM of its norm, or by this
# many times the plain path's own move when its attention alone runs in
# fp64, whichever is more, and never by more than STEP_GRAD_ATTN64_CAP of
# it. DeFILIP's and SLIP's gradients are ill-conditioned (BatchNorm over
# the batch in the heads, SimCLR at temperature 0.1, the late interaction's
# near ties), and attention through K1 and K2 sits further from fp64 than
# the plain fp32 path's at these score sizes, so the kernels may move a
# gradient by a few times what the plain path's own attention rounding
# does; 4 leaves room for that. The check is run once more on a planted
# fault, K1/K2's inputs rounded to bf16 (their gradients too), which it
# must fail.
STEP_GRAD_ATTN64_FACTOR = 4
STEP_GRAD_ATTN64_CAP = 1e-3
PLANTED = "planted fault, K1/K2 on bf16-rounded inputs"
# biases right before a BatchNorm in the heads, and the projector's output
# bias (the predictor's first BatchNorm removes a constant shift of its
# input): a gradient of 0 in exact arithmetic (see NOISE_GRADS)
METHOD_NOISE_GRADS = {
    "defilip": ("projector.linear1.bias", "projector.linear2.bias",
                "projector.linear3.bias", "predictor.linear1.bias",
                "projector.bn3.bias"),
    "slip": ("predictor_sim.linear1.bias", "predictor_sim.linear2.bias")}
# phase 10: the recipes through the solver, on phase 7's corpus
DEFILIP_RECIPE = os.path.join(
    "experiments", "defilip_experiments", "yfcc15m", "yfcc15m_vit_defilip",
    "config.yaml")
SLIP_R50_RECIPE = os.path.join(
    "experiments", "slip_experiments", "yfcc15m", "yfcc15m_r50_slip",
    "config.yaml")
DEFILIP_SOLVER_STEPS, SLIP_SOLVER_STEPS = 4, 2
# K3 at the dense zero-shot eval's ImageNet shape: B=128 image queries of
# 49 tokens against 1000 classes of 77 tokens, D=256, in the recipes' bf16
LI_EVAL_CASE = (TRAIN_BATCH, 49, 1000, 77, 256)
# K3 against the chunked plain late interaction on one eval batch's
# features (bf16 products exact in fp32; the sums in other orders)
EVAL_LI_TOLERANCE = (1e-5, 1e-5)
# phase 11: data-parallel training. 11a: the DeCLIP recipe through
# torch.distributed.run at world 1 (NCCL): SOLVER_STEPS steps as phase 7
# runs them (so that steps SOLVER_TIMED compare), saved once at the end,
# then resumed for one step; the ranks' deadline
DP_RESUME_STEPS = SOLVER_STEPS + 1
DP_LAUNCH_TIMEOUT_S = 420
# 11b: two ranks on the one card over gloo (11c: over NCCL on two cards),
# each with half of phase 6's and phase 5's batches, one fp32 step against
# one process on the whole batch; the join deadline of the ranks
DP_WORLD = 2
DP_JOIN_TIMEOUT_S = 300
# (rtol, atol) of the loss, of each parameter's gradient norm, of the bank
# rows the step wrote and of each BatchNorm statistic (as ||a - b|| <= rtol
# ||b||, a running mean against the larger of its norm and its deviation's,
# sqrt(running_var)): phase 5's 1e-4. A parameter whose gradient is 0 in exact
# arithmetic (a bias before a BatchNorm, attnpool's key bias; NOISE_GRADS)
# is rounding noise on either side: one whose one-process gradient norm is
# under STEP_NOISE_REL_NORM of the whole gradient's is held below that on
# both sides instead.
DP_RTOL = 1e-4
DP_BANK_ATOL = 1e-5
# phase 12: the last two reference configs and the loss modes. 12a: the
# SigLIP recipe through the solver (CLIP ViT-B/32, sigmoid_ring,
# logit_bias_init -10, Adafactor), saved at the end and resumed for a step;
# 12b: the DeCLIP-88M ViT-B/32 recipe (embed 3072, the 2^16 x 3072 bank,
# SGD with nesterov, the abs-min guard, batch 64 as its file has it)
SIGLIP_RECIPE = os.path.join(
    "experiments", "clip_experiments", "yfcc15m", "yfcc15m_vit_siglip",
    "config.yaml")
DECLIP88M_RECIPE = os.path.join(
    "experiments", "declip_experiments", "declip88m",
    "declip88m_vitb32_declip", "config.yaml")
SIGLIP_STEPS, DECLIP88M_STEPS = 6, 4
CLIP_PER_STEP = {"K1": 24, "K2": 24, "K3": 0, "K4": 0, "K5": 0}
# phase 16: CLIP ViT-B/32 with both towers MoE, through the solver on
# the YFCC15M CLIP recipe (bf16, B=128)
CLIP_RECIPE = os.path.join(
    "experiments", "clip_experiments", "yfcc15m", "yfcc15m_vit_clip",
    "config.yaml")
MOE = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25,
       "aux_weight": 0.01}
MOE_STEPS = 6
MOE_TIMED_STEPS = 3
# 11b's expert-parallel case: the MoE CLIP cut to DP_EP_LAYERS layers a
# tower, at a capacity of 0.5 that drops tokens
DP_EP_MOE = dict(MOE, capacity_factor=0.5)
DP_EP_LAYERS = 4
DECLIP_VIT_PER_STEP = {"K1": 48, "K2": 48, "K3": 0, "K4": 0, "K5": 0}
# 12c: one fp32 step of CLIP ViT-B/32 at B=128 under each loss kind against
# its full kind, and GradCache's step against the unchunked one: the loss
# within LOSS_IMPL_RTOL, each parameter's gradient as ||g - g_ref|| <=
# LOSS_IMPL_GRAD_REL_NORM ||g_ref|| (the same sums in other orders)
LOSS_IMPL_CHUNK = 32
LOSS_IMPL_CASES = (("chunked", "full"), ("ring", "full"),
                   ("sigmoid_chunked", "sigmoid"), ("sigmoid_ring", "sigmoid"))
LOSS_IMPL_RTOL = 1e-5
LOSS_IMPL_GRAD_REL_NORM = 1e-4
GRAD_CACHE_CHUNKS = 4
GRAD_CACHE_TIMED_STEPS = 5
# 12d: phase 11b's ranks also run the ring kinds, CLIP ViT-B/32 in fp32 at
# 2 x 64 against one process at 128, within DP_RTOL
DP_RING_CASES = ("ring", "sigmoid_ring")


# phase 13: the SSL builders at full width, with MoCo-v2's recipe (dim 128,
# K 2^16, m 0.999, T 0.2; SGD lr 0.03, momentum 0.9, weight decay 1e-4;
# SimCLR keeps its T 0.5) and CLSA's five strong resolutions, bf16, B=128
SSL_KWARGS = {"moco": {"dim": 128, "K": 65536, "m": 0.999, "T": 0.2},
              "clsa": {"dim": 128, "K": 65536, "m": 0.999, "T": 0.2},
              "simclr": {"dim": 128}}
SSL_STRONG = (96, 128, 160, 192, 224)
SSL_OPT = {"type": "SGD", "kwargs": {"lr": 0.03, "momentum": 0.9,
                                     "weight_decay": 1e-4}}
SSL_SCHED = {"type": "Cosine", "kwargs": {"base_lr": 0.0, "warmup_lr": 0.03,
                                          "warmup_steps": 0}}
SSL_WARMUP_STEPS, SSL_STEPS = 1, 4
# the launches of a ViT-B/32 step, 12 layers a forward: the query's view,
# the key encoder's without a graph (K1, no K2), SimCLR's second view, and
# CLSA's five strong views
SSL_PER_STEP = {"moco": {"K1": 24, "K2": 12, "K3": 0, "K4": 0, "K5": 0},
                "simclr": {"K1": 24, "K2": 24, "K3": 0, "K4": 0, "K5": 0},
                "clsa": {"K1": 84, "K2": 72, "K3": 0, "K4": 0, "K5": 0}}
# 13b: the fp32 steps' depth, and the strong views' sequence lengths on
# ViT-B/32 (96-192 px: 3 x 3 to 6 x 6 patches and the class token)
SSL_CHECK_LAYERS = 4
SSL_SHORT_CASES = [(TRAIN_BATCH, 12, n, 64, False) for n in (10, 17, 26, 37)]
# 13c-d: MoCo-v2's recipe for the solver (phase 7's corpus gives the data
# paths; MODEL and VIEWS are filled in)
SSL_RECIPE = """
model:
    type: MODEL
    kwargs: {dim: 128, K: 65536, m: 0.999, T: 0.2}
precision: {dtype: bfloat16}
optimizer:
    type: SGD
    kwargs: {lr: 0.03, momentum: 0.9, weight_decay: 0.0001}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0, warmup_lr: 0.03, warmup_steps: 0, max_iter: 200}
data:
    type: clip
    read_from: fs
    batch_size: 128
    num_workers: 7
    train:
        sampler: {type: distributed_iteration}
        transforms: {type: VIEWS}
        fseek: True
saver: {print_freq: 1, save_many: True}
"""
# 13c's steps before its save (and one more after the resume), 13d's
SSL_SOLVER_STEPS, CLSA_SOLVER_STEPS = 3, 2
# --ssl-loader-rates: the batches each of 13c-d's loaders builds alone,
# three rounds of its 7 workers (the rate is read over the last two)
SSL_LOADER_BATCHES = 21

# phase 15: the last single-card modules. (a) the learnability run, the
# JAX script's defaults: DeCLIP, bf16, 600 steps at B=128, no pool; a step
# runs 2 image views and 2 text passes (the MLM and EDA captions) through
# towers of 2 layers, and the zero-shot eval the 16 prompts and the 512
# renderings once each
LEARN_STEPS, LEARN_BATCH, LEARN_TOP1 = 600, 128, 0.40
LEARN_PER_STEP = {"K1": 8, "K2": 8, "K3": 0, "K4": 0, "K5": 0}
LEARN_EVAL_K1 = 4
# (b) the linear probe on phase 3's model: synthetic ImageNet-layout metas
# over PROBE_CLASSES labels, 128 images an embedding batch (12 K1 each)
PROBE_TRAIN, PROBE_VAL, PROBE_CLASSES, PROBE_EPOCHS = 512, 128, 10, 10
PROBE_TEXTS = ("a photo of a cat,a photo of a dog,a red square,"
               "a blue circle,a photo of a car,a diagram")
# (d) declip_vitb32 with a BERT-base text tower (BertConfig()'s defaults,
# seeded weights saved under the run's temporary directory) for HF_STEPS
# bf16 steps: K1 and K2 from the image tower's 12 layers and 2 views only
HF_STEPS = 3
HF_PER_STEP = {"K1": 24, "K2": 24, "K3": 0, "K4": 0, "K5": 0}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters):
    """The device events (kernels, copies) the profiler saw over ``iters``
    calls of ``fn``, after one warm-up call, in time order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_ms(fn, iters=20):
    """Device time per call: the kernels the profiler saw, summed, over
    ``iters`` calls -> (ms per call, {kernel name: ms per call}). At these
    sizes a call's host overhead can exceed its kernels' time, so CUDA
    events around back-to-back calls measure the host; this does not.
    (None, {}) where the profiler saw no device events."""
    by_name = {}
    for e in device_events(fn, iters):
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / iters)
    if not by_name:
        return None, {}
    return sum(by_name.values()), by_name


def attention_bound(b, h, l, dh, causal, dtype_name):
    """Least time (ms) for one call: each input read once and the output
    written once, against the two matmuls' FLOPs over the dtype's peak.
    Causal counts only the unmasked (query, key) pairs this call needs."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = 4 * b * h * l * dh * elem
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 2 * 2 * b * h * pairs * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(b, h, l, dh, causal, dtype_name):
    """Least time (ms) for one K2 call: what the function needs, q, k, v and
    do read once and dq, dk and dv written once, plus the fp32 row
    log-sum-exp read, against the four contractions (dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q) over the dtype's peak. The TPU
    kernel reads no o and takes the row term from P and dP, so reading o
    (for the row term rowsum(dO o O)) and the recompute of Q K^T are a
    kernel's own costs, not the bound's. Causal counts only the unmasked
    pairs."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = 7 * b * h * l * dh * elem + b * h * l * 4
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 4 * 2 * b * h * pairs * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def late_interaction_bound(b, n1, gb, n2, d, dtype_name, which,
                           winners=None):
    """Least time (ms) for one K3 (``which`` "fwd"), K4 ("d1") or K5 ("d2")
    call. K3: d1 and d2 read once, the fp32 raw logits and the int32 winner
    mask [B*N1, GB, ceil(N2/32)] written, against the similarities'
    2*B*N1*GB*N2*D FLOPs over the dtype's peak. K4: the mask, the fp32 g
    and d2 read and dd1 written; K5: the mask, g and d1 read and dd2
    written; each against 2*D FLOPs per winner (``winners``: the winning
    (query row, key item, key token) triples this data has, ties
    included)."""
    elem = 4 if dtype_name == "float32" else 2
    mask = b * n1 * gb * ((n2 + 31) // 32) * 4
    if which == "fwd":
        nbytes = (b * n1 + gb * n2) * d * elem + b * gb * 4 + mask
        flops = 2 * b * n1 * gb * n2 * d
    else:
        nbytes = mask + b * gb * 4 + (b * n1 + gb * n2) * d * elem
        flops = 2 * winners * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _within(got, want, rtol, atol, atol_share=0.0):
    """(all close, max abs err, the largest share of its limit that an
    element's error takes) of two tensors, compared in fp32. An element's
    limit is max(atol, atol_share * max |want|) + rtol * |want|."""
    want = want.float()
    if atol_share:
        atol = max(atol, atol_share * want.abs().max().item())
    err = (got.float() - want).abs()
    limit = atol + rtol * want.abs()
    ok = not (err > limit).any().item()
    share = (err / limit.clamp_min(1e-30)).max().item()
    return ok, err.max().item(), share


def phase_card_and_build(tmp):
    """The card's name and power limit, and the kernels' build: one nvcc
    for each source, all started together. The attention sources build in
    a thread while this one writes phases 7 and 8's corpus under ``tmp``;
    K3-K5's source, the slowest, builds on in the background through
    phases 2 and 2b (``finish_build`` waits for it). -> (card, corpus, the
    pending build)."""
    from declip_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print("nvcc:", [ln for ln in nvcc.splitlines() if "release" in ln][0])
    for name in BUILD_GROUPS[0] + BUILD_GROUPS[1]:
        # build from the sources, not from a stale library
        if os.path.exists(_build.library_path(name)):
            os.remove(_build.library_path(name))
    pending = {"t0": time.perf_counter(), "secs": {}, "errors": []}

    def build(names):
        try:
            pending["secs"].update(_build.build(names))
        except Exception as e:  # reported by finish_build
            pending["errors"].append(e)

    threads = [threading.Thread(target=build, args=(g,))
               for g in BUILD_GROUPS]
    for th in threads:
        th.start()
    pending["thread"] = threads[1]
    corpus = solver_corpus(tmp)
    threads[0].join()
    check(not pending["errors"], f"the build failed: {pending['errors']}")
    print(f"built {BUILD_GROUPS[0]} in "
          f"{time.perf_counter() - pending['t0']:.1f} s, beside phases 7 "
          f"and 8's corpus (written in {corpus['seconds']:.1f} s)",
          flush=True)
    return card, corpus, pending


def finish_build(pending):
    """Waits for ``phase_card_and_build``'s background build: -> each
    source's ptxas report."""
    from declip_tpu_torch.ops import _build

    pending["thread"].join()
    check(not pending["errors"], f"the build failed: {pending['errors']}")
    names = BUILD_GROUPS[0] + BUILD_GROUPS[1]
    print(f"built {names}: {BUILD_GROUPS[1]} ready "
          f"{time.perf_counter() - pending['t0']:.1f} s after the builds "
          f"started (per source: {pending['secs']})", flush=True)
    ptxas = {name: ptxas_report(_build.build_log[name]) for name in names}
    for name, kernels in ptxas.items():
        for fn, rep in kernels.items():
            print(f"  {name}: {fn}: {rep}")
    return ptxas


def ptxas_report(log):
    """{function: {"registers", "spill_stores", "spill_loads"}} from the
    ``-Xptxas -v`` lines of an nvcc build log (bytes for the spills)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def hmma_counts(sass):
    """{function: HMMA instructions} from ``cuobjdump -sass`` output."""
    parts = re.split(r"Function : ([\w$]+)", sass)
    return {fn: body.count("HMMA")
            for fn, body in zip(parts[1::2], parts[2::2])}


# the kernels phase 1 holds to the tensor cores, by library: each name mark
# must match at least one kernel, and every kernel it matches must show
# HMMA in its SASS (TF32 mma.sync appears as HMMA.1688.F32.TF32) and no
# ptxas spill
TENSOR_CORE_KERNELS = {"flash_attn_fwd": ("_bf16_kernel", "_tf32_kernel"),
                       "flash_attn_bwd": ("_bf16_kernel",),
                       "filip_li": ("li_fwd_bf16_kernel",)}


def tensor_core_faults(name, hmma, ptxas):
    """What phase 1 finds wrong with library ``name``'s tensor-core kernels,
    from its SASS HMMA counts (``hmma_counts``) and its ptxas report
    (``ptxas_report``): a missing kernel, one without HMMA, and a spill in a
    tensor-core kernel or in any other kernel that takes bf16 (the row-term
    pre-pass has no product for the tensor cores). -> (faults, {kernel:
    HMMA count} of the tensor-core kernels)."""
    faults, found = [], {}
    for mark in TENSOR_CORE_KERNELS[name]:
        mine = {fn: n for fn, n in hmma.items() if mark in fn}
        if not mine:
            faults.append(f"{name}: no tensor-core kernel *{mark} in the "
                          f"SASS (functions: {sorted(hmma)})")
        faults += [f"{name}: {fn} has no HMMA instruction"
                   for fn, n in mine.items() if n == 0]
        found.update(mine)
    for fn, rep in ptxas.items():
        if fn in found or any(w in fn for w in ("bf16", "bfloat16", "tf32")):
            if rep.get("spill_stores", 0) or rep.get("spill_loads", 0):
                faults.append(f"{name}: ptxas spilled in {fn}: {rep}")
    return faults, found


def check_tensor_cores(ptxas, names=tuple(TENSOR_CORE_KERNELS)):
    """Phase 1's check of the libraries' tensor-core routes: the toolkit's
    ``cuobjdump -sass`` of each built library, HMMA instructions counted
    per kernel. Fails unless K1 has its bf16 kernel and its fp32 (split
    TF32) kernel, K2 its bf16 kernel and K3 its bf16 kernel, each holding
    HMMA, or if ptxas spilled in any of them or in another kernel that
    takes bf16 (``tensor_core_faults``). -> {kernel: HMMA count}."""
    from declip_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    hmma, faults = {}, []
    for name in names:
        counts = hmma_counts(subprocess.run(
            [cuobjdump, "-sass", _build.library_path(name)],
            capture_output=True, text=True, check=True).stdout)
        bad, found = tensor_core_faults(name, counts, ptxas[name])
        faults += bad
        hmma.update(found)
    check(not faults, "; ".join(faults))
    print(f"tensor cores: HMMA instructions per tensor-core kernel {hmma}; "
          f"no ptxas spill in them or in a bf16 kernel", flush=True)
    return hmma


def round_tf32(x):
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 11 significant bits, ties away from zero."""
    import torch

    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_plain_check(q, k, v, causal, scale):
    """The plain version on q, k, v rounded to TF32 against the plain
    version in fp32: what a kernel that dropped the split of its fp32 route
    would be off by. It must lie beyond TOLERANCE["float32"], or that limit
    could not catch such a kernel. -> (max abs err, share of the limit)."""
    from declip_tpu_torch.ops.flash_attention import attention_plain

    ok, err, share = _within(
        attention_plain(*(round_tf32(x) for x in (q, k, v)), causal, scale),
        attention_plain(q, k, v, causal, scale), *TOLERANCE["float32"])
    check(not ok, f"plain attention on TF32-rounded inputs is within the fp32 "
                  f"limit {TOLERANCE['float32']} (max abs err {err:.3g}): the "
                  f"limit would not catch a kernel without the split")
    return err, share


def attention_row(b, h, l, dh, causal, dtype, seed):
    """K1's wrapper against attention_plain on seeded inputs of one shape,
    checked at TOLERANCE, then timed beside the plain version and one
    ``scaled_dot_product_attention`` call (whose kernels, by name, name
    the library's backend) and the bound. At the serving shapes in fp32
    also ``tf32_plain_check``. -> the row of phase 2."""
    import torch
    import torch.nn.functional as F

    from declip_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    dname = str(dtype).replace("torch.", "")
    tol = TOLERANCE[dname]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, dh, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    scale = dh ** -0.5
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    ref = attention_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == dtype,
          f"kernel output {out.shape} {out.dtype}")
    check(torch.isfinite(out).all().item(), "kernel output not finite")
    ok, max_err, share = _within(out, ref, *tol)
    check(ok, f"kernel vs plain at {(b, h, l, dh, causal, dname)}: "
              f"max abs err {max_err:.3g} beyond (rtol, atol, atol "
              f"share of max |plain|) {tol}")
    fns = {
        "ms": lambda: flash_attention(q, k, v, causal=causal, scale=scale),
        "plain_ms": lambda: attention_plain(q, k, v, causal, scale),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale)}
    # device time where the profiler sees the card, else CUDA events
    row = {"shape": [b, h, l, dh], "causal": causal, "dtype": dname,
           "max_abs_err": max_err, "limit_share": share, "tolerance": tol,
           "max_abs_ref": ref.float().abs().max().item()}
    for key, fn in fns.items():
        ms, by_name = device_ms(fn)
        row[key] = ms or cuda_ms(fn)
        if key == "library_ms":
            row["library_kernels"] = sorted(by_name)
    row["call_ms"] = cuda_ms(fns["ms"])  # the wrapper's call, host included
    row["bound_ms"], row["bound_by"] = attention_bound(b, h, l, dh, causal,
                                                       dname)
    if dname == "float32" and (b, h, l, dh, causal) in MAIN_PATH_CASES:
        row["tf32_plain_err"], row["tf32_plain_limit_share"] = \
            tf32_plain_check(q, k, v, causal, scale)
    return row


def phase_kernel_vs_plain():
    import torch

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = ATTN_CASES + (SERVE_BUCKET_CASES if dtype == torch.float32
                              else [])
        for i, (b, h, l, dh, causal) in enumerate(cases):
            row = attention_row(b, h, l, dh, causal, dtype, 100 + i)
            rows.append(row)
            tf32_note = ("" if "tf32_plain_err" not in row else
                         f"  plain on TF32 inputs err "
                         f"{row['tf32_plain_err']:.2e} "
                         f"({row['tf32_plain_limit_share']:.0f}x limit)")
            print(f"attn B={b} H={h} L={l} Dh={dh} causal={int(causal)} "
                  f"{row['dtype']:8s} err {row['max_abs_err']:.2e} "
                  f"({row['limit_share']:.1%} of limit)  kernel "
                  f"{row['ms']:.4f} ms (call {row['call_ms']:.4f})  plain "
                  f"{row['plain_ms']:.4f}  sdpa {row['library_ms']:.4f}  "
                  f"bound {row['bound_ms']:.5f} ({row['bound_by']})  "
                  f"{row['bound_ms'] / row['ms']:.1%} of bound{tf32_note}  "
                  f"sdpa kernels {[n[:60] for n in row['library_kernels']]}",
                  flush=True)
    return rows


def backward_row(b, h, l, dh, causal, dtype, seed):
    """K2 against attention_bwd_plain, and K1 as the training forward runs
    it (with its log-sum-exp), on seeded inputs of one shape, checked at
    BWD_TOLERANCE and TOLERANCE, then timed beside the plain versions, the
    library's and the bounds. -> the row of phase 2b."""
    import torch
    import torch.nn.functional as F

    from declip_tpu_torch.ops.flash_attention import (
        _forward_kernel,
        attention_bwd_plain,
        attention_plain,
        flash_attention_bwd,
    )

    dname = str(dtype).replace("torch.", "")
    tol = BWD_TOLERANCE[dname]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, l, dh, generator=g,
                               device="cuda").to(dtype)
                   for _ in range(4))
    scale = dh ** -0.5
    o, lse = _forward_kernel(q, k, v, causal, scale, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              scale=scale)
    want = attention_bwd_plain(q, k, v, do, causal, scale)
    # K1's output as the training forward launches it (with lse)
    check(o.shape == q.shape and o.dtype == dtype
          and torch.isfinite(o).all().item(),
          f"K1+lse output {o.shape} {o.dtype}, or not finite")
    fwd_ok, fwd_err, fwd_share = _within(
        o, attention_plain(q, k, v, causal, scale), *TOLERANCE[dname])
    check(fwd_ok, f"K1+lse vs plain at {(b, h, l, dh, causal, dname)}"
                  f": max abs err {fwd_err:.3g} beyond (rtol, atol, "
                  f"atol share) {TOLERANCE[dname]}")
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool,
                                      device="cuda").tril(),
                          float("-inf"))
    lse_ok, lse_err, _ = _within(lse, torch.logsumexp(s, -1), 1e-5,
                                 1e-5)
    torch.cuda.synchronize()
    check(lse_ok, f"K1 lse at {(b, h, l, dh, causal, dname)}: max "
                  f"abs err {lse_err:.3g}")
    errs, shares = {}, {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        check(a.shape == q.shape and a.dtype == dtype,
              f"K2 {name} {a.shape} {a.dtype}")
        check(torch.isfinite(a).all().item(), f"K2 {name} not finite")
        ok, errs[name], shares[name] = _within(a, w, *tol)
        check(ok, f"K2 vs plain at {(b, h, l, dh, causal, dname)}: "
                  f"{name} max abs err {errs[name]:.3g} beyond "
                  f"(rtol, atol, atol share) {tol}")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(
        *leaves, is_causal=causal, scale=scale)
    fns = {
        "ms": lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, scale=scale),
        "plain_ms": lambda: attention_bwd_plain(q, k, v, do, causal,
                                                scale),
        # the library's backward kernels alone, a yardstick
        "library_ms": lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True),
        "fwd_ms": lambda: _forward_kernel(q, k, v, causal, scale,
                                          with_lse=True),
        "fwd_plain_ms": lambda: attention_plain(q, k, v, causal,
                                                scale),
        "fwd_library_ms": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale)}
    times = {key: device_ms(fn)[0] or cuda_ms(fn)
             for key, fn in fns.items()}
    # K2's time by kernel (the row-term pre-pass, dk/dv, dq)
    split = {re.search(r"flash_attn_\w+", n).group(0): round(t, 5)
             for n, t in device_ms(fns["ms"])[1].items()}
    bound_ms, bound_by = attention_bwd_bound(b, h, l, dh, causal,
                                             dname)
    fwd_bound_ms, fwd_bound_by = attention_bound(b, h, l, dh, causal,
                                                 dname)
    row = {"shape": [b, h, l, dh], "causal": causal, "dtype": dname,
           "max_abs_err": max(errs.values()), "errs": errs,
           "limit_shares": shares, "fwd_max_abs_err": fwd_err,
           "fwd_limit_share": fwd_share, "lse_max_abs_err": lse_err,
           "tolerance": tol,
           **times, "split_ms": split,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fwd_bound_ms": fwd_bound_ms,
           "fwd_bound_by": fwd_bound_by}
    del lib_out, leaves
    return row


def print_backward_row(row):
    (b, h, l, dh), errs = row["shape"], row["errs"]
    print(f"attn bwd B={b} H={h} L={l} Dh={dh} causal={int(row['causal'])} "
          f"{row['dtype']:8s} err dq {errs['dq']:.2e} dk {errs['dk']:.2e} "
          f"dv {errs['dv']:.2e} ({max(row['limit_shares'].values()):.1%} "
          f"of limit)  K2 {row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  "
          f"sdpa bwd {row['library_ms']:.4f}  bound {row['bound_ms']:.5f} "
          f"({row['bound_by']})  {row['bound_ms'] / row['ms']:.1%} of "
          f"bound | K1+lse err o {row['fwd_max_abs_err']:.2e} "
          f"({row['fwd_limit_share']:.1%}) lse "
          f"{row['lse_max_abs_err']:.2e}  {row['fwd_ms']:.4f} ms  plain "
          f"{row['fwd_plain_ms']:.4f}  sdpa {row['fwd_library_ms']:.4f}  "
          f"bound {row['fwd_bound_ms']:.5f} | K2 by kernel "
          f"{row['split_ms']}", flush=True)


def phase_backward():
    """K2 against attention_bwd_plain, and K1 as the training forward runs
    it (with its log-sum-exp), at BWD_CASES in fp32 and bf16."""
    import torch

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(BWD_CASES):
            rows.append(backward_row(*case, dtype, 200 + i))
            print_backward_row(rows[-1])
    return rows


def _li_inputs(shape, dtype, seed, grid):
    """Unit-vector d1 [B, N1, D] and d2 [GB, N2, D], as the FILIP heads give
    them, and an fp32 upstream gradient g [B, GB]. With ``grid`` the vectors
    are rounded to multiples of 1/64 (numerators of at most 64, exact in
    bf16): every similarity is then exact in fp32 whatever the summation
    order (D <= 256 products of at most 2^12 / 2^12), so the kernels and the
    plain versions must pick the same max winners. With continuous inputs a
    near tie (a gap below fp32's rounding) may go either way, which moves a
    winner's whole gradient share (about |g| / N1)."""
    import torch
    import torch.nn.functional as F

    b, n1, gb, n2, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d1, d2 = (F.normalize(torch.randn(*s, d, generator=gen, device="cuda"),
                          dim=-1) for s in ((b, n1), (gb, n2)))
    if grid:
        d1, d2 = (torch.round(x * 64) / 64 for x in (d1, d2))
    g = torch.randn(b, gb, generator=gen, device="cuda")
    return d1.to(dtype), d2.to(dtype), g


def _li_plain_fwd(d1, d2):
    """K3's plain version: the raw logits and the winner mask."""
    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_raw_plain,
        late_interaction_winners_plain,
    )

    return (late_interaction_raw_plain(d1, d2),
            late_interaction_winners_plain(d1, d2))


def _li_kernel_outputs(d1, d2, g):
    """K3, then K4 and K5 on K3's winners: (raw, winners, dd1, dd2)."""
    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_bwd_d1,
        late_interaction_bwd_d2,
        late_interaction_fwd,
    )

    raw, winners = late_interaction_fwd(d1, d2)
    return (raw, winners, late_interaction_bwd_d1(winners, d2, g),
            late_interaction_bwd_d2(winners, d1, g, d2.shape[1]))


def phase_late_interaction():
    """K3 against late_interaction_raw_plain and its winner mask against
    late_interaction_winners_plain (bit for bit); K4 and K5, on K3's
    winners, against late_interaction_bwd_plain (which forms the winners
    from the similarities) and against their own plain versions on the same
    mask; at LI_CASES and the ties case in fp32 and bf16: checked on grid
    inputs (see ``_li_inputs``), K3 also on the continuous unit vectors
    that are timed."""
    import torch

    from declip_tpu_torch.ops.filip_late_interaction import (
        _similarities,
        late_interaction_bwd_d1,
        late_interaction_bwd_d1_plain,
        late_interaction_bwd_d2,
        late_interaction_bwd_d2_plain,
        late_interaction_bwd_plain,
        late_interaction_fwd,
        late_interaction_raw_plain,
    )

    rows = []
    cases = [(shape, False) for shape in LI_CASES] + [(LI_TIES_CASE, True)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        (frtol, fatol), (grtol, gatol) = LI_TOLERANCE[dname]
        for i, (shape, ties) in enumerate(cases):
            b, n1, gb, n2, d = shape
            tag = f"{shape} {dname}{' ties' if ties else ''}"
            d1, d2, g = _li_inputs(shape, dtype, 300 + i, grid=True)
            if ties:  # two-way ties in every key item, three-way in half
                d2[:, 4] = d2[:, 1]
                d2[::2, 7] = d2[::2, 1]
            raw, winners, dd1, dd2 = _li_kernel_outputs(d1, d2, g)
            want_raw, want_win = _li_plain_fwd(d1, d2)
            want1, want2 = late_interaction_bwd_plain(d1, d2, g)
            torch.cuda.synchronize()
            check(winners.dtype == want_win.dtype
                  and torch.equal(winners, want_win),
                  f"K3's winners at {tag}: "
                  f"{int((winners != want_win).sum())} of {want_win.numel()} "
                  f"mask words differ from the plain version's")
            errs = {}
            for name, got, want, (rtol, atol) in (
                    ("raw", raw, want_raw, (frtol, fatol)),
                    ("dd1", dd1, want1, (grtol, gatol)),
                    ("dd2", dd2, want2, (grtol, gatol)),
                    ("dd1_mask", dd1,
                     late_interaction_bwd_d1_plain(winners, d2, g),
                     (grtol, gatol)),
                    ("dd2_mask", dd2,
                     late_interaction_bwd_d2_plain(winners, d1, g, n2),
                     (grtol, gatol))):
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"late interaction {name} at {tag}: {got.shape} "
                      f"{got.dtype}, want {want.shape} {want.dtype}")
                check(torch.isfinite(got).all().item(),
                      f"late interaction {name} at {tag}: not finite")
                ok, errs[name], _ = _within(got, want, rtol, atol)
                check(ok, f"late interaction {name} at {tag}: kernel vs "
                          f"plain max abs err {errs[name]:.3g} beyond rtol "
                          f"{rtol} atol {atol}")
            if ties:
                check(torch.equal(dd2[:, 4], dd2[:, 1])
                      and dd2[:, 1].abs().max().item() > 0,
                      "K5 did not split tied winners evenly")
            # the timed inputs: continuous unit vectors, as on the main path
            if not ties:
                d1, d2, g = _li_inputs(shape, dtype, 300 + i, grid=False)
                ok, errs["raw_unit"], _ = _within(
                    late_interaction_fwd(d1, d2)[0],
                    late_interaction_raw_plain(d1, d2), frtol, fatol)
                check(ok, f"K3 at {tag}, unit vectors: max abs err "
                          f"{errs['raw_unit']:.3g}")
            sim = _similarities(d1, d2)
            n_win = int((sim == sim.amax(dim=-1, keepdim=True)).sum())
            del sim
            _, winners = late_interaction_fwd(d1, d2)
            fns = {"K3": lambda: late_interaction_fwd(d1, d2),
                   "K4": lambda: late_interaction_bwd_d1(winners, d2, g),
                   "K5": lambda: late_interaction_bwd_d2(winners, d1, g, n2),
                   "K3_plain": lambda: _li_plain_fwd(d1, d2),
                   "K4_plain": lambda: late_interaction_bwd_d1_plain(
                       winners, d2, g),
                   "K5_plain": lambda: late_interaction_bwd_d2_plain(
                       winners, d1, g, n2),
                   "bwd_plain": lambda: late_interaction_bwd_plain(d1, d2,
                                                                   g)}
            times = {key: device_ms(fn)[0] or cuda_ms(fn)
                     for key, fn in fns.items()}
            row = {"shape": list(shape), "dtype": dname, "ties": ties,
                   "winners": n_win, "errs": errs,
                   "bwd_plain_ms": times["bwd_plain"]}
            for kname, which, err_key in (("K3", "fwd", "raw"),
                                          ("K4", "d1", "dd1"),
                                          ("K5", "d2", "dd2")):
                bound_ms, bound_by = late_interaction_bound(
                    *shape, dname, which, n_win)
                row[kname] = {"ms": times[kname],
                              "plain_ms": times[kname + "_plain"],
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "max_abs_err": errs[err_key]}
            rows.append(row)
            print(f"late interaction B={b} N1={n1} GB={gb} N2={n2} D={d} "
                  f"{dname:8s}{' ties' if ties else ''} winners exact; err "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" | K3 {times['K3']:.5f} ms K4 {times['K4']:.5f} K5 "
                  f"{times['K5']:.5f}; plain K3 {times['K3_plain']:.4f} K4 "
                  f"{times['K4_plain']:.4f} K5 {times['K5_plain']:.4f}, "
                  f"bwd from the similarities {times['bwd_plain']:.4f}; "
                  f"bound "
                  + " ".join(f"{k} {row[k]['bound_ms']:.5f} "
                             f"({row[k]['bound_by']})"
                             for k in ("K3", "K4", "K5"))
                  + f"; winners {n_win}",
                  flush=True)
        _li_nan_check(dtype)
    return rows


def _li_nan_check(dtype):
    """A NaN key token and a NaN query row: K3 sets no winner bit where the
    max is NaN, as the plain mask does, and K3-K5 give NaN exactly where the
    plain versions do (a NaN similarity wins its max, and its pair's
    gradient weights are all NaN), and the plain values elsewhere."""
    import torch

    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_bwd_plain,
    )

    dname = str(dtype).replace("torch.", "")
    (frtol, fatol), (grtol, gatol) = LI_TOLERANCE[dname]
    shape = LI_CASES[3]
    for where in ("key", "query"):
        d1, d2, g = _li_inputs(shape, dtype, 400, grid=True)
        if where == "key":
            d2[3, 1, 5] = float("nan")
        else:
            d1[2, 4, 7] = float("nan")
        raw, winners, dd1, dd2 = _li_kernel_outputs(d1, d2, g)
        want_raw, want_win = _li_plain_fwd(d1, d2)
        want1, want2 = late_interaction_bwd_plain(d1, d2, g)
        check(torch.equal(winners, want_win),
              f"K3's winners at {shape} {dname}, NaN {where}: differ from "
              f"the plain mask")
        for name, got, want, (rtol, atol) in (
                ("raw", raw, want_raw, (frtol, fatol)),
                ("dd1", dd1, want1, (grtol, gatol)),
                ("dd2", dd2, want2, (grtol, gatol))):
            nan = torch.isnan(want)
            check(torch.equal(torch.isnan(got), nan),
                  f"late interaction {name} at {shape} {dname}, NaN {where}: "
                  f"NaN at {int(torch.isnan(got).sum())} entries, the plain "
                  f"version at {int(nan.sum())}")
            if not nan.all().item():
                ok, err, _ = _within(got[~nan], want[~nan], rtol, atol)
                check(ok, f"late interaction {name} at {shape} {dname}, NaN "
                          f"{where}: max abs err {err:.3g} off the NaNs")
    print(f"late interaction {dname}: NaN in a key token and in a query row "
          f"propagate as in the plain versions", flush=True)


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def _concurrent(url, path, payloads):
    results, errors = [None] * len(payloads), []

    def one(i):
        try:
            results[i] = _post(url, path, payloads[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        check(not t.is_alive(), f"{path}: a request did not return")
    if errors:
        raise errors[0]
    return results


def _tokens(rng, n):
    import numpy as np

    toks = np.zeros((n, 77), np.int64)
    for r in range(n):
        length = int(rng.integers(3, 77))
        toks[r, 0] = SOT
        toks[r, 1:length - 1] = rng.integers(1, MASK, size=length - 2)
        toks[r, length - 1] = EOT
    return toks


def _check_embeddings(out, n, normalized=False):
    import numpy as np

    emb = np.asarray(out["embeddings"], np.float32)
    check(emb.shape == (n, 512) and out["dim"] == 512,
          f"embedding shape {emb.shape}")
    check(np.isfinite(emb).all(), "embeddings not finite")
    if normalized:
        norms = np.linalg.norm(emb, axis=-1)
        check(np.allclose(norms, 1.0, atol=1e-5), f"norms {norms}")
    return emb


def phase_k3_eval_shape():
    """Phase 2d: K3 alone at the dense zero-shot eval's ImageNet shape
    (LI_EVAL_CASE) in the recipes' bf16, against its plain version on grid
    inputs and on unit vectors; its device time (the profiler; CUDA events
    where the profiler sees no device events), its bound, its plain
    version's time and that of its product alone in ``torch.matmul``."""
    import torch

    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_fwd,
        late_interaction_raw_plain,
    )

    b, n1, gb, n2, d = LI_EVAL_CASE
    d1, d2, _ = _li_inputs(LI_EVAL_CASE, torch.bfloat16, 700, grid=True)
    raw, winners = late_interaction_fwd(d1, d2)
    ok, err_grid, _ = _within(raw, late_interaction_raw_plain(d1, d2),
                              *LI_TOLERANCE["bfloat16"][0])
    check(ok, f"K3 at the eval shape, grid inputs: max abs err "
              f"{err_grid:.3g}")
    del raw, winners
    d1, d2, _ = _li_inputs(LI_EVAL_CASE, torch.bfloat16, 701, grid=False)
    ok, err, _ = _within(late_interaction_fwd(d1, d2)[0],
                         late_interaction_raw_plain(d1, d2),
                         *LI_TOLERANCE["bfloat16"][0])
    check(ok, f"K3 at the eval shape, unit vectors: max abs err {err:.3g}")
    a, bt = d1.reshape(b * n1, d), d2.reshape(gb * n2, d).t()
    timer = "profiler"
    ms, kernels = device_ms(lambda: late_interaction_fwd(d1, d2), iters=10)
    plain_ms, _ = device_ms(lambda: late_interaction_raw_plain(d1, d2),
                            iters=3)
    matmul_ms, _ = device_ms(lambda: torch.matmul(a, bt), iters=10)
    if None in (ms, plain_ms, matmul_ms):
        # the profiler saw no device time: CUDA events around the calls
        print("K3 at the eval shape: the profiler saw no device events; "
              "timing with CUDA events", flush=True)
        timer = "CUDA events"
        ms = cuda_ms(lambda: late_interaction_fwd(d1, d2), iters=10)
        plain_ms = cuda_ms(lambda: late_interaction_raw_plain(d1, d2),
                           iters=3, warmup=1)
        matmul_ms = cuda_ms(lambda: torch.matmul(a, bt), iters=10)
    bound, bound_by = late_interaction_bound(b, n1, gb, n2, d, "bfloat16",
                                             "fwd")
    out = {"shape": list(LI_EVAL_CASE), "dtype": "bfloat16", "ms": ms,
           "by_kernel": kernels, "plain_ms": plain_ms,
           "matmul_ms": matmul_ms, "bound_ms": bound, "bound_by": bound_by,
           "max_abs_err": max(err, err_grid),
           "mask_mb": b * n1 * gb * ((n2 + 31) // 32) * 4 / 1e6,
           "timer": timer}
    print(f"K3 at the eval shape {LI_EVAL_CASE} bf16 ({timer}): {ms:.4f} ms "
          f"({', '.join(f'{k[:40]} {v:.4f}' for k, v in kernels.items())}), "
          f"bound {bound:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, its "
          f"product alone in torch.matmul {matmul_ms:.4f} ms; max abs err "
          f"{max(err, err_grid):.3g}; winner mask "
          f"{out['mask_mb']:.1f} MB", flush=True)
    del d1, d2, a, bt
    torch.cuda.empty_cache()
    return out


def profiler_sees_device():
    """Whether ``torch.profiler`` sees the card's kernels at this point of
    the run: a probe of ten calls of one elementwise kernel over 64 MB."""
    import torch

    x = torch.ones(1 << 24, device="cuda")
    return bool(device_events(lambda: x.mul(2), iters=10))


def phase_slice():
    import numpy as np
    import torch

    from declip_tpu_torch.models.layers import MultiHeadAttention
    from declip_tpu_torch.ops.flash_attention import flash_attention
    from declip_tpu_torch.tools.serve import ServingHost

    with tempfile.TemporaryDirectory() as exp:
        cfg = os.path.join(exp, "config.yaml")
        with open(cfg, "w") as f:
            f.write(CONFIG)
        t0 = time.perf_counter()
        host = ServingHost.from_config(cfg, device="cuda", max_batch=16,
                                       max_wait_ms=20.0)
        load_s = time.perf_counter() - t0
    model = host.model
    vis, txt = model.visual, model.encode_text
    check((vis.width, len(vis.transformer.resblocks), vis.input_resolution,
           txt.ln_final.normalized_shape[0], len(txt.transformer.resblocks),
           txt.vocab_size) == (768, 12, 224, 512, 12, VOCAB),
          "model is not CLIP ViT-B/32 at full width")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"clip_vitb32: {n_params / 1e6:.1f} M params, seeded init, "
          f"loaded in {load_s:.1f} s on {host.meta['device']}", flush=True)

    stop = threading.Event()
    compute = threading.Thread(target=host.batcher.run_forever, args=(stop,),
                               daemon=True)
    compute.start()
    url = f"http://127.0.0.1:{host.start_http('127.0.0.1', 0)}"
    rng = np.random.default_rng(0)
    stats = host.batcher.stats

    def images(n):
        return rng.normal(size=(n, 224, 224, 3)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # main path starts
    served = {}
    # image tower: one warm-up row, 4 concurrent 2-row requests, a
    # normalized 3-row request
    b0, l0 = stats["batches"], flash_attention.launches
    _check_embeddings(_post(url, "/v1/encode_image",
                            {"arrays": images(1).tolist()}), 1)
    served["images"] = images(2)
    outs = _concurrent(url, "/v1/encode_image",
                       [{"arrays": served["images"].tolist()}]
                       + [{"arrays": images(2).tolist()} for _ in range(3)])
    served["image_embed"] = _check_embeddings(outs[0], 2)
    for o in outs[1:]:
        _check_embeddings(o, 2)
    _check_embeddings(_post(url, "/v1/encode_image",
                            {"arrays": images(3).tolist(),
                             "normalize": True}), 3, normalized=True)
    img_batches = stats["batches"] - b0
    img_launches = flash_attention.launches - l0
    check(img_launches == 12 * img_batches,
          f"image tower: {img_launches} kernel launches for {img_batches} "
          f"batches (want 12 per batch)")
    # text tower: 6 concurrent one-row requests, a 5-row request, a
    # normalized request
    b0, l0 = stats["batches"], flash_attention.launches
    served["tokens"] = _tokens(rng, 5)
    outs = _concurrent(url, "/v1/encode_text",
                       [{"tokens": _tokens(rng, 1).tolist()}
                        for _ in range(6)])
    for o in outs:
        _check_embeddings(o, 1)
    served["text_embed"] = _check_embeddings(
        _post(url, "/v1/encode_text", {"tokens": served["tokens"].tolist()}),
        5)
    _check_embeddings(_post(url, "/v1/encode_text",
                            {"tokens": _tokens(rng, 2).tolist(),
                             "normalize": True}), 2, normalized=True)
    txt_batches = stats["batches"] - b0
    txt_launches = flash_attention.launches - l0
    check(txt_launches == 12 * txt_batches,
          f"text tower: {txt_launches} kernel launches for {txt_batches} "
          f"batches (want 12 per batch)")
    # latency: one-row requests one after another
    lat = {"image": [], "text": []}
    for _ in range(10):
        for kind, payload in (("image", {"arrays": images(1).tolist()}),
                              ("text", {"tokens": _tokens(rng, 1).tolist()})):
            t = time.perf_counter()
            _post(url, f"/v1/encode_{kind}", payload)
            lat[kind].append((time.perf_counter() - t) * 1e3)
    launches = flash_attention.launches  # main path ends
    check(launches == 12 * stats["batches"],
          f"{launches} kernel launches for {stats['batches']} batches")
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        served_stats = json.loads(r.read())
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    check(health["device"].startswith("cuda"), f"healthz {health}")
    stop.set()
    host.shutdown()
    compute.join(timeout=30)
    check(not compute.is_alive(), "compute thread did not stop")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"served: {img_batches} image batches, {txt_batches} text batches, "
          f"{launches} kernel launches (12 per batch); stats "
          f"p50 {served_stats['latency_ms']['p50']} ms, p95 "
          f"{served_stats['latency_ms']['p95']} ms, mean rows/batch "
          f"{served_stats.get('mean_rows_per_batch')}, padded rows "
          f"{served_stats['padded_rows']}; peak device memory "
          f"{peak_mb:.0f} MiB", flush=True)
    client = {k: {"p50_ms": float(np.median(v)), "max_ms": float(np.max(v))}
              for k, v in lat.items()}
    print(f"one-row requests, client side (HTTP+JSON+model): {client}")

    # the same rows through the plain attention path (impl 'xla')
    with torch.inference_mode():
        imgs = torch.from_numpy(served["images"]).cuda()
        toks = torch.from_numpy(served["tokens"]).cuda()
        mhas = [m for m in model.modules()
                if isinstance(m, MultiHeadAttention)]
        for m in mhas:
            m.attn_impl = "xla"
        l0 = flash_attention.launches
        plain = {"image_embed": model.encode_image(imgs).cpu().numpy(),
                 "text_embed": model.encode_text(toks).cpu().numpy()}
        check(flash_attention.launches == l0, "plain path launched the kernel")
        for m in mhas:
            m.attn_impl = "auto"
    rtol, atol = TOWER_TOLERANCE
    tower_err = {}
    for key, ref in plain.items():
        err = np.abs(served[key] - ref)
        tower_err[key] = float(err.max())
        check((err <= atol + rtol * np.abs(ref)).all(),
              f"{key}: served (kernel) vs plain path max abs err "
              f"{err.max():.3g} beyond rtol {rtol} atol {atol}")
    print(f"served embeddings vs plain attention path: max abs err "
          f"{tower_err} (rtol {rtol}, atol {atol})")

    # time of each tower per batch at a few buckets (no HTTP, no JSON):
    # CUDA events around back-to-back batches (the stream's wall time), and
    # the profiler's device busy time with the largest kernels
    towers = {}
    with torch.inference_mode():
        for bsz in (1, 8, 16):
            x = torch.from_numpy(images(bsz)).cuda()
            t = torch.from_numpy(_tokens(rng, bsz)).cuda()
            towers[bsz] = {}
            for kind, fn in (("image", lambda: model.encode_image(x)),
                             ("text", lambda: model.encode_text(t))):
                wall = cuda_ms(fn, 20, 3)
                busy, by_name = device_ms(fn, 10)
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
                towers[bsz][kind] = {
                    "wall_ms": wall, "busy_ms": busy,
                    "idle_share": None if busy is None else 1 - busy / wall,
                    "attention_ms": sum(v for n, v in by_name.items()
                                        if "flash_attn_fwd" in n),
                    "top_kernels_ms": [[n[:80], v] for n, v in top]}
                print(f"{kind} tower B={bsz}: {towers[bsz][kind]}")
    # the JSON codec of one one-row image request, on the host
    img = images(1)
    t0 = time.perf_counter()
    blob = json.dumps({"arrays": img.tolist()})
    t1 = time.perf_counter()
    rows = np.asarray(json.loads(blob)["arrays"], np.float32)
    t2 = time.perf_counter()
    check(np.array_equal(rows, img), "JSON round trip changed the image")
    codec = {"request_bytes": len(blob), "encode_ms": (t1 - t0) * 1e3,
             "decode_ms": (t2 - t1) * 1e3}
    print(f"one 224x224x3 image request, host JSON codec: {codec}",
          flush=True)
    return {"launches": launches, "image_batches": img_batches,
            "text_batches": txt_batches, "stats": served_stats,
            "client_latency": client, "tower_ms": towers,
            "image_json_codec": codec,
            "tower_max_abs_err": tower_err, "peak_device_mib": peak_mb,
            "load_s": load_s}


def kernel_kind(name):
    """A device event's kind, by its name."""
    n = name.lower()
    if "flash_attn_fwd" in n:
        return "K1"
    if "flash_attn_bwd" in n:
        return "K2"
    if ("li_fwd_kernel" in n or "li_fwd_bf16_kernel" in n
            or "li_mean_kernel" in n):
        return "K3"
    if "li_bwd_d1_kernel" in n:
        return "K4"
    if "li_bwd_d2_kernel" in n:
        return "K5"
    if "li_reduce_kernel" in n:  # the split sums of K4 and of K5
        return "K4/K5 reduce"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if any(t in n for t in ("batch_norm", "batchnorm", "bn_fw", "bn_bw")):
        return "BatchNorm"
    if any(t in n for t in ("fprop", "dgrad", "wgrad", "convolve", "cudnn")):
        return "conv (cuDNN)"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "GEMM"
    if "multi_tensor_apply" in n or "foreach" in n:
        return "optimizer (multi-tensor)"
    if "layer_norm" in n:
        return "LayerNorm"
    if "copy" in n:
        return "copies and casts"
    if "reduce" in n:
        return "reductions"
    return "other elementwise"


def profile_steps(fn, iters, step_ms):
    """The profiler's device time over ``iters`` calls of one training step:
    busy ms per step, idle share against ``step_ms`` (CUDA events, no
    profiler), K1/K2 and per-kind sums, the largest kernels, and the mean
    device gap between the step's device-to-host read and the next device
    event (the idle time the host check exposes)."""
    dev = device_events(fn, iters)
    check(dev, "the profiler saw no device time")
    by_name, by_kind = {}, {}
    for e in dev:
        ms = e.time_range.elapsed_us() / 1e3 / iters
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    gaps = [(nxt.time_range.start - e.time_range.end) / 1e3
            for e, nxt in zip(dev, dev[1:]) if "dtoh" in e.name.lower()]
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    li_ms = sum(by_kind.get(k, 0.0) for k in ("K3", "K4", "K5",
                                                "K4/K5 reduce"))
    return {"busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "li_ms": li_ms, "li_share": li_ms / busy,
            "k1_ms": by_kind.get("K1", 0.0),
            "k1_share": by_kind.get("K1", 0.0) / busy,
            "k2_ms": by_kind.get("K2", 0.0),
            "k2_share": by_kind.get("K2", 0.0) / busy,
            "by_kind_ms": {k: round(v, 3) for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])},
            "host_reads": len(gaps) / iters,
            "host_read_gap_ms": sum(gaps) / max(len(gaps), 1),
            "kernels": len(by_name),
            "top_kernels_ms": [[n[:90], v] for n, v in top]}


def step_flops(fn):
    """FLOPs of one call of a training step (``utils/flops.py``: PyTorch's
    counter for products and convolutions, K1-K5 by their registered
    formulas) -> {"total", "kernels" (K1-K5's share of it),
    "by_operator"}. The step runs once more for it."""
    from declip_tpu_torch.utils.flops import flops_by_operator

    by_op = flops_by_operator(fn)
    total = sum(by_op.values())
    kernels = sum(v for k, v in by_op.items()
                  if k.startswith("declip_tpu_torch."))
    return {"total": total, "kernels": kernels,
            "kernels_share": kernels / max(total, 1), "by_operator": by_op}


def step_without_read(loss_fn, tx, grad_clip):
    """The train step's device work with its one host read taken out, and
    with it the non-finite check: for timing what that read costs, never
    for training. Its update needs no norm on the host, so ``grad_clip``
    must not be the norm clip."""
    import torch

    from declip_tpu_torch.optim import global_norm
    from declip_tpu_torch.train.train_step import logit_scale_guard

    check(grad_clip.get("type") != "norm", "the norm clip reads the host")

    def step(state, batch):
        params = state.params
        total, _ = loss_fn(state.model, state, batch)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        global_norm(list(grads.values()))  # the metric, left on the card
        s_old = params["logit_scale"].detach().clone()
        tx.update_(grads, state.opt_state, params)
        state.logit_ema_buffer, state.logit_clip_count = logit_scale_guard(
            s_old, params["logit_scale"], grad_clip, state)
        state.step += 1

    return step


def host_read_cost(step, no_read, rounds, n):
    """CUDA-event ms per step of the train step and of ``no_read`` (the
    same step without its host read), alternated ``rounds`` times over
    ``n`` steps each, the one first in even rounds and the other in odd
    ones (ABBA), so that a drift of the host's speed falls alike on both."""
    import torch

    times = {"with_read": [], "without_read": []}
    pair = (("with_read", step), ("without_read", no_read))
    for r in range(rounds):
        for key, fn in (pair if r % 2 == 0 else pair[::-1]):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end) / n)
    return times


def launch_counters():
    """Every kernel wrapper, by kernel: each counts its own launches."""
    from declip_tpu_torch.ops import filip_late_interaction as fli
    from declip_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.flash_attention, "K2": fa.flash_attention_bwd,
            "K3": fli.late_interaction_fwd, "K4": fli.late_interaction_bwd_d1,
            "K5": fli.late_interaction_bwd_d2}


def reset_launches():
    """Every kernel's count to 0, just before a main path is driven."""
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in launch_counters().items()}


class _CallCounter:
    """Counts the calls of the plain attention and late-interaction
    functions where the port's modules look them up, for the length of a
    ``with`` block: ``calls``, and apart from them ``cross``, the plain
    attention calls whose queries and keys differ in length (the pooled
    query of AttentionPool2d, which no kernel serves, as in the JAX
    package)."""

    def __init__(self):
        from declip_tpu_torch.ops import (
            attention,
            filip_late_interaction,
            filip_ops,
            flash_attention,
        )

        self.sites = [(attention, "attention_plain"),
                      (flash_attention, "attention_plain"),
                      (flash_attention, "attention_bwd_plain"),
                      (filip_late_interaction, "late_interaction_raw_plain"),
                      (filip_late_interaction,
                       "late_interaction_winners_plain"),
                      (filip_late_interaction,
                       "late_interaction_bwd_d1_plain"),
                      (filip_late_interaction,
                       "late_interaction_bwd_d2_plain"),
                      (filip_late_interaction, "late_interaction_bwd_plain"),
                      (filip_ops, "late_interaction_logits")]
        self.calls = self.cross = 0

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.sites]
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def wrapper(*args, **kwargs):
            if (fn.__name__ == "attention_plain"
                    and args[0].shape[-2] != args[1].shape[-2]):
                self.cross += 1
            else:
                self.calls += 1
            return fn(*args, **kwargs)
        return wrapper

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)


def step_kernels_vs_plain(model, loss_fn, batch):
    """One loss and gradient of ``model`` on ``batch`` through K1/K2
    (attn_impl "auto") and through the plain attention path under torch
    autograd ("xla"): -> ({impl: loss}, {impl: gradients in parameter
    order}). Checks that the kernels ran 24 times each, and not at all on
    the plain path."""
    import torch

    from declip_tpu_torch.models.layers import MultiHeadAttention
    from declip_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    params = list(model.parameters())
    grads, totals = {}, {}
    for impl in ("auto", "xla"):
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = impl
        before = (flash_attention.launches, flash_attention_bwd.launches)
        total, _ = loss_fn(model, None, batch)
        grads[impl] = torch.autograd.grad(total, params)
        totals[impl] = float(total.detach())
        used = (flash_attention.launches - before[0],
                flash_attention_bwd.launches - before[1])
        check(used == ((24, 24) if impl == "auto" else (0, 0)),
              f"{model.visual.dtype} step with attn_impl {impl}: K1/K2 "
              f"calls {used}")
    return totals, grads


def step_with_dk_fault(model, loss_fn, batch, factor):
    """One loss and gradient of ``model`` through K1/K2 with every K2 dK
    scaled by ``factor``: a planted fault for the bf16 step check."""
    import torch

    import declip_tpu_torch.ops.flash_attention as fa
    from declip_tpu_torch.models.layers import MultiHeadAttention

    real = fa.flash_attention_bwd

    def faulty(*args, **kwargs):
        dq, dk, dv = real(*args, **kwargs)
        return dq, dk * factor, dv

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "auto"
    # the wrapper counts its launches on the module's name, here faulty's
    faulty.launches = real.launches
    fa.flash_attention_bwd = faulty
    try:
        total, _ = loss_fn(model, None, batch)
        grads = torch.autograd.grad(total, list(model.parameters()))
    finally:
        fa.flash_attention_bwd = real
        real.launches = faulty.launches
    return float(total.detach()), grads


def bf16_step_errors(names, loss, grads, plain_loss, plain_grads):
    """The bf16 step check's readings: the loss's relative error, and each
    parameter's ||g - g_plain|| / ||g_plain||, their max (checked) and
    median (reported)."""
    import numpy as np
    import torch

    rel = {}
    for name, a, b in zip(names, grads, plain_grads):
        norm = torch.linalg.vector_norm(b.float()).item()
        check(norm > 0, f"bf16 grad {name}: zero on the plain path")
        rel[name] = torch.linalg.vector_norm((a - b).float()).item() / norm
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    return {"loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
            "max": worst[0][1], "median": float(np.median(list(rel.values()))),
            "largest": [(n, round(r, 4)) for n, r in worst], "rel": rel}


def bf16_step_passes(c):
    return (c["loss_rel_err"] <= STEP_BF16_LOSS_RTOL
            and c["max"] <= STEP_BF16_GRAD_REL_NORM)


def build_clip(cfg, dtype):
    """Phase 4's model (``cfg``'s CLIP ViT-B/32 in ``dtype``, fp32
    parameters) from the seeded weights, on the card."""
    import torch

    from declip_tpu_torch.models import model_entry

    kwargs = dict(cfg.model.kwargs)
    kwargs["dtype"] = dtype
    model = model_entry({"type": cfg.model.type, "kwargs": kwargs})
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.cuda()


def clip_train_step(cfg, model):
    """Phase 4's optimizer, train state, step and batch (TRAIN_BATCH seeded
    images and texts on the card) for ``model`` -> (tx, state, step,
    batch)."""
    import numpy as np
    import torch

    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import make_train_step, new_train_state

    named = dict(model.named_parameters())
    sched = scheduler_entry(cfg.lr_scheduler,
                            max_iter=int(cfg.lr_scheduler.kwargs.max_iter))
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip),
                     frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    state = new_train_state(model=model, opt_state=tx.init(named))
    step = make_train_step(model, tx, cfg, sched)
    rng = np.random.default_rng(SEED)
    batch = {
        "images": torch.from_numpy(rng.normal(
            size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
        "tokens": torch.from_numpy(_tokens(rng, TRAIN_BATCH)).cuda()}
    return tx, state, step, batch


def phase_train():
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from declip_tpu_torch.train import make_loss_fn

    cfg = parse_config(TRAIN_CONFIG)

    def build(dtype):
        return build_clip(cfg, dtype)

    t0 = time.perf_counter()
    model = build(cfg.precision.dtype)
    vis, txt = model.visual, model.encode_text
    check((vis.width, len(vis.transformer.resblocks), vis.input_resolution,
           txt.ln_final.normalized_shape[0], len(txt.transformer.resblocks),
           txt.vocab_size, vis.dtype, txt.dtype)
          == (768, 12, 224, 512, 12, VOCAB, torch.bfloat16, torch.bfloat16),
          "model is not CLIP ViT-B/32 at full width in bf16")
    named = dict(model.named_parameters())
    check(all(p.dtype == torch.float32 for p in named.values()),
          "parameters are not fp32")
    tx, state, step, batch = clip_train_step(cfg, model)
    no_read = step_without_read(make_loss_fn(cfg), tx, dict(cfg.grad_clip))
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in named.values())
    print(f"train: clip_vitb32 bf16, {n_params / 1e6:.1f} M fp32 params, "
          f"batch {TRAIN_BATCH}, set up in {setup_s:.1f} s", flush=True)

    history = []

    def run(n):
        """n steps; metrics stay on the card until the loop ends, as a
        training loop reads them only every print_freq steps."""
        steps = []
        for _ in range(n):
            _, metrics = step(state, batch)
            steps.append((metrics, model.logit_scale.detach().clone()))
        for metrics, scale in steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["logit_scale_param"] = float(scale)
            history.append(m)
            check(m["update_skipped"] == 0.0, f"a step was skipped: {m}")
            check(3.0 <= m["logit_scale_param"] <= 6.0,
                  f"logit_scale param outside [3, 6]: {m}")

    run(TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # main path starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _CallCounter() as plain:
        t0 = time.perf_counter()
        start.record()
        run(TRAIN_STEPS)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    launches = (flash_attention.launches, flash_attention_bwd.launches)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    losses = [m["loss"] for m in history]
    check(np.isfinite(losses).all(), f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == (24 * TRAIN_STEPS, 24 * TRAIN_STEPS),
          f"{launches} K1/K2 calls in {TRAIN_STEPS} steps (want 24 each "
          f"per step)")
    check(plain.calls + plain.cross == 0,
          f"{plain.calls + plain.cross} plain-path attention calls")
    print(f"train: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"train: {TRAIN_STEPS} steps, {step_ms:.2f} ms/step (CUDA events; "
          f"host {wall_s * 1e3 / TRAIN_STEPS:.2f}), "
          f"{TRAIN_BATCH * 1e3 / step_ms:.1f} pairs/s, K1/K2 calls "
          f"{launches}, peak device memory {peak_mib:.0f} MiB", flush=True)

    breakdown = profile_steps(lambda: step(state, batch), 3, step_ms)
    flops = step_flops(lambda: step(state, batch))  # after the counts
    print(f"train: device busy {breakdown['busy_ms']:.2f} ms/step, idle "
          f"share {breakdown['idle_share']:.1%}, K1 "
          f"{breakdown['k1_ms']:.2f} ms ({breakdown['k1_share']:.1%}), K2 "
          f"{breakdown['k2_ms']:.2f} ms ({breakdown['k2_share']:.1%}); "
          f"device gap after the step's host read "
          f"{breakdown['host_read_gap_ms']:.3f} ms", flush=True)
    print(f"  by kind: {breakdown['by_kind_ms']}")
    for n, v in breakdown["top_kernels_ms"]:
        print(f"  {v:8.3f} ms  {n[:110]}")

    # what the step's one host read (the non-finite check) costs: the step
    # against the same device work without the read, alternated
    rounds, n = 6, 6
    read_cost = host_read_cost(
        lambda: step(state, batch),
        lambda: no_read(state, batch), rounds=rounds, n=n)
    diffs = np.subtract(read_cost["with_read"], read_cost["without_read"])
    read_cost["diff_ms"] = diffs.tolist()
    read_cost["cost_ms"] = float(np.median(diffs))
    print(f"train: host read's cost {read_cost['cost_ms']:.2f} ms/step "
          f"(median difference of {rounds} ABBA rounds of {n} steps; per "
          f"round {diffs.round(2).tolist()}; ms/step with the read "
          f"{[round(t, 2) for t in read_cost['with_read']]}, without "
          f"{[round(t, 2) for t in read_cost['without_read']]})", flush=True)
    del state, step, no_read, tx, model, named
    torch.cuda.empty_cache()

    # one fp32 step from the same seeded weights: kernels vs plain attention
    loss_fn = make_loss_fn(cfg)
    model = build("float32")
    totals, grads = step_kernels_vs_plain(model, loss_fn, batch)
    loss_err = abs(totals["auto"] - totals["xla"]) / abs(totals["xla"])
    check(loss_err <= STEP_LOSS_RTOL,
          f"fp32 loss kernels {totals['auto']} vs plain {totals['xla']}")
    rtol, atol = STEP_GRAD_TOLERANCE
    grad_err, rel_norm_err, scales = 0.0, 0.0, []
    for (name, _), a, b in zip(model.named_parameters(), grads["auto"],
                               grads["xla"]):
        ok, err, _ = _within(a, b, rtol, atol)
        grad_err = max(grad_err, err)
        check(ok, f"fp32 grad {name}: kernels vs plain max abs err "
                  f"{err:.3g} beyond rtol {rtol} atol {atol}")
        norm = torch.linalg.vector_norm(b).item()
        rel = torch.linalg.vector_norm(a - b).item() / max(norm, 1e-30)
        rel_norm_err = max(rel_norm_err, rel)
        check(norm > 0 and rel <= STEP_GRAD_REL_NORM,
              f"fp32 grad {name}: ||kernels - plain|| / ||plain|| = "
              f"{rel:.3g} (||plain|| {norm:.3g}), limit {STEP_GRAD_REL_NORM}")
        scales.append((b.abs().max().item(),
                       torch.sqrt(b.pow(2).mean()).item()))
    median_max, median_rms = (float(np.median([s[i] for s in scales]))
                              for i in range(2))
    print(f"train fp32 step, kernels vs plain attention: loss "
          f"{totals['auto']:.6f} vs {totals['xla']:.6f} (rel err "
          f"{loss_err:.2e}); over {len(scales)} parameters: max grad abs "
          f"err {grad_err:.3g}, max relative norm err {rel_norm_err:.3g} "
          f"(limit {STEP_GRAD_REL_NORM}); median parameter's grad max abs "
          f"{median_max:.3g}, rms {median_rms:.3g}", flush=True)
    del model, grads
    torch.cuda.empty_cache()

    # one bf16 step, the training dtype, from the same seeded weights and
    # batch: the bf16 route of K1 and K2 against the plain attention path;
    # then the same check on planted faults in K2's dK
    model = build(cfg.precision.dtype)
    totals16, grads16 = step_kernels_vs_plain(model, loss_fn, batch)
    names = [name for name, _ in model.named_parameters()]
    bf16_check = bf16_step_errors(names, totals16["auto"], grads16["auto"],
                                  totals16["xla"], grads16["xla"])
    fault_checks = {}
    for factor in STEP_BF16_FAULTS:
        fault_total, fault_grads = step_with_dk_fault(model, loss_fn, batch,
                                                      factor)
        fault_checks[factor] = bf16_step_errors(
            names, fault_total, fault_grads, totals16["xla"], grads16["xla"])
        del fault_grads
    fault_check = fault_checks[STEP_BF16_FAULT]
    for what, c in (("kernels", bf16_check),
                    *((f"planted fault (dK x {f})", fault_checks[f])
                      for f in STEP_BF16_FAULTS)):
        print(f"train bf16 step, {what} vs plain attention: loss rel err "
              f"{c['loss_rel_err']:.2e} (limit {STEP_BF16_LOSS_RTOL}); "
              f"relative gradient norm err max {c['max']:.4g} (limit "
              f"{STEP_BF16_GRAD_REL_NORM}; largest {c['largest']}), median "
              f"{c['median']:.4g}", flush=True)
    check(bf16_step_passes(bf16_check),
          f"bf16 step, kernels {totals16['auto']} vs plain "
          f"{totals16['xla']}: {dict(bf16_check, rel=None)}")
    check(not bf16_step_passes(fault_check),
          f"the bf16 step check passes a planted fault, dK x "
          f"{STEP_BF16_FAULT}: {dict(fault_check, rel=None)}")
    del model, grads16
    torch.cuda.empty_cache()
    return {"launches": launches[0], "bwd_launches": launches[1],
            "steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP_STEPS,
            "losses": losses, "history": history, "step_ms": step_ms,
            "host_step_ms": wall_s * 1e3 / TRAIN_STEPS,
            "pairs_per_s": TRAIN_BATCH * 1e3 / step_ms, "flops": flops,
            "peak_device_mib": peak_mib, "setup_s": setup_s, **breakdown,
            "host_read_cost": read_cost,
            "fp32_loss": totals, "fp32_loss_rel_err": loss_err,
            "fp32_max_grad_abs_err": grad_err,
            "fp32_max_grad_rel_norm_err": rel_norm_err,
            "fp32_median_grad_max_abs": median_max,
            "fp32_median_grad_rms": median_rms,
            "bf16_loss": totals16, "bf16_check": bf16_check,
            "bf16_fault_checks": fault_checks}


def _filip_batch(rng):
    """B=128 seeded images, SOT/EOT token rows and their MLM masking by the
    port's ``mask_tokens`` (15%, of which 80% mask, 10% random, 10% kept)."""
    import numpy as np
    import torch

    from declip_tpu_torch.tokenizer.mlm import mask_tokens

    tokens = _tokens(rng, TRAIN_BATCH)
    mlm_tokens, mlm_labels = mask_tokens(
        tokens, mask_id=MASK, vocab_size=VOCAB, special_ids=(SOT, EOT),
        rng=rng)
    check((mlm_tokens == MASK).any() and (mlm_labels != -100).any(),
          "MLM masking selected nothing")
    check((tokens[:, 0] == SOT).all() and (mlm_tokens[:, 0] == SOT).all(),
          "token rows do not begin with the start-of-text id")
    return {"images": torch.from_numpy(rng.normal(
                size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
            "tokens": torch.from_numpy(tokens).cuda(),
            "mlm_tokens": torch.from_numpy(mlm_tokens).cuda(),
            "mlm_labels": torch.from_numpy(mlm_labels).cuda()}


def phase_train_filip():
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.layers import MultiHeadAttention
    from declip_tpu_torch.ops.filip_late_interaction import _similarities
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import (
        make_loss_fn,
        make_train_step,
        method_of,
        new_train_state,
    )

    cfg = parse_config(FILIP_CONFIG)

    def build(dtype):
        kwargs = dict(cfg.model.kwargs)
        kwargs["dtype"] = dtype
        model = model_entry({"type": cfg.model.type, "kwargs": kwargs})
        model.init_weights(torch.Generator().manual_seed(SEED))
        return model.cuda()

    t0 = time.perf_counter()
    model = build(cfg.precision.dtype)
    vis, txt = model.visual, model.encode_text
    check((vis.width, len(vis.transformer.resblocks), vis.input_resolution,
           txt.ln_final.normalized_shape[0], len(txt.transformer.resblocks),
           txt.vocab_size, vis.dtype, txt.dtype, method_of(model),
           model.top_k, model.select_topk, model.image_mapping.out_features,
           model.text_label_predictor.out_features)
          == (768, 12, 224, 512, 12, VOCAB, torch.bfloat16, torch.bfloat16,
              "filip", 16, True, 256, VOCAB),
          "model is not FILIP ViT-B/32 at full width in bf16")
    named = dict(model.named_parameters())
    check(all(p.dtype == torch.float32 for p in named.values()),
          "parameters are not fp32")
    sched = scheduler_entry(cfg.lr_scheduler,
                            max_iter=int(cfg.lr_scheduler.kwargs.max_iter))
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip),
                     frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    state = new_train_state(model=model, opt_state=tx.init(named))
    step = make_train_step(model, tx, cfg, sched)
    batch = _filip_batch(np.random.default_rng(SEED))
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in named.values())
    print(f"train filip: filip_vitb32 bf16, {n_params / 1e6:.1f} M fp32 "
          f"params, batch {TRAIN_BATCH}, set up in {setup_s:.1f} s",
          flush=True)

    history = []

    def run(n):
        steps = []
        for _ in range(n):
            _, metrics = step(state, batch)
            steps.append((metrics, model.logit_scale.detach().clone()))
        for metrics, scale in steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["logit_scale_param"] = float(scale)
            history.append(m)
            check(m["update_skipped"] == 0.0, f"a step was skipped: {m}")
            check(3.0 <= m["logit_scale_param"] <= 6.0,
                  f"logit_scale param outside [3, 6]: {m}")

    run(TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # main path starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _CallCounter() as plain:
        t0 = time.perf_counter()
        start.record()
        run(FILIP_TRAIN_STEPS)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    launches = read_launches()  # main path ends
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = start.elapsed_time(end) / FILIP_TRAIN_STEPS
    losses = [m["loss"] for m in history]
    dense = [m["clip_dense_loss"] for m in history]
    check(np.isfinite(losses).all(), f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    per_step = {"K1": 24, "K2": 24, "K3": 2, "K4": 2, "K5": 2}
    check(launches == {k: n * FILIP_TRAIN_STEPS for k, n in per_step.items()},
          f"{launches} kernel calls in {FILIP_TRAIN_STEPS} steps (want "
          f"{per_step} per step)")
    check(plain.calls + plain.cross == 0,
          f"{plain.calls + plain.cross} plain-version calls")
    print(f"train filip: losses {[round(x, 4) for x in losses]} (dense "
          f"{[round(x, 4) for x in dense]}, mlm "
          f"{round(history[-1]['text_mlm_loss'], 4)}, clip "
          f"{round(history[-1]['clip_loss'], 4)}, weights 0)", flush=True)
    print(f"train filip: {FILIP_TRAIN_STEPS} steps, {step_ms:.2f} ms/step "
          f"(CUDA events; host {wall_s * 1e3 / FILIP_TRAIN_STEPS:.2f}), "
          f"{TRAIN_BATCH * 1e3 / step_ms:.1f} pairs/s, kernel calls "
          f"{launches}, peak device memory {peak_mib:.0f} MiB", flush=True)

    breakdown = profile_steps(lambda: step(state, batch), 3, step_ms)
    print(f"train filip: device busy {breakdown['busy_ms']:.2f} ms/step, "
          f"idle share {breakdown['idle_share']:.1%}, K3+K4+K5 "
          f"{breakdown['li_ms']:.3f} ms ({breakdown['li_share']:.1%}), K1 "
          f"{breakdown['k1_ms']:.2f} ms, K2 {breakdown['k2_ms']:.2f} ms",
          flush=True)
    print(f"  by kind: {breakdown['by_kind_ms']}")
    for n, v in breakdown["top_kernels_ms"]:
        print(f"  {v:8.3f} ms  {n[:110]}")
    del state, step, tx, model, named
    torch.cuda.empty_cache()

    # one fp32 step from the same seeded weights: the kernels (K1-K5)
    # against the plain path (plain attention, chunked late interaction);
    # and, to part the late interaction's own difference from the towers',
    # against K1 and K2 with the chunked late interaction
    model = build("float32")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    plain_cfg = parse_config(FILIP_CONFIG)
    plain_cfg["filip_dense"] = {"impl": "xla"}
    grads, totals = {}, {}
    attn_only = {**per_step, "K3": 0, "K4": 0, "K5": 0}
    for path, attn_impl, run_cfg, want in (
            ("kernels", "auto", cfg, per_step),
            ("attention kernels", "auto", plain_cfg, attn_only),
            ("plain", "xla", plain_cfg, dict.fromkeys(per_step, 0))):
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = attn_impl
        before = read_launches()
        total, _ = make_loss_fn(run_cfg, "filip")(model, None, batch)
        grads[path] = [torch.zeros_like(p) if g is None else g
                       for p, g in zip(params, torch.autograd.grad(
                           total, params, allow_unused=True))]
        totals[path] = float(total.detach())
        used = {k: n - before[k] for k, n in read_launches().items()}
        check(used == want, f"fp32 step through the {path}: kernel calls "
                            f"{used}, want {want}")
    loss_err = abs(totals["kernels"] - totals["plain"]) / abs(totals["plain"])
    check(loss_err <= STEP_LOSS_RTOL,
          f"fp32 loss kernels {totals['kernels']} vs plain {totals['plain']}")
    rel_norm_err, zero, worst = 0.0, [], []
    for name, a, b in zip(names, grads["kernels"], grads["plain"]):
        norm = torch.linalg.vector_norm(b).item()
        if norm == 0.0:
            check(not a.any().item(),
                  f"fp32 grad {name}: zero on the plain path, not through "
                  f"the kernels")
            zero.append(name)
            continue
        rel = torch.linalg.vector_norm(a - b).item() / norm
        rel_norm_err = max(rel_norm_err, rel)
        worst = sorted(worst + [(rel, name, norm)], reverse=True)[:3]
        check(rel <= STEP_GRAD_REL_NORM,
              f"fp32 grad {name}: ||kernels - plain|| / ||plain|| = "
              f"{rel:.3g} (||plain|| {norm:.3g}), limit {STEP_GRAD_REL_NORM}")
    check(zero, "no parameter got a zero gradient under weights of 0")
    li_rel_norm_err = max(
        (torch.linalg.vector_norm(a - b).item()
         / torch.linalg.vector_norm(b).item())
        for a, b in zip(grads["kernels"], grads["attention kernels"])
        if b.any().item())
    check(li_rel_norm_err <= STEP_LI_GRAD_REL_NORM,
          f"fp32 step, K3-K5 vs the chunked late interaction behind K1 and "
          f"K2: max relative gradient norm err {li_rel_norm_err:.3g}, limit "
          f"{STEP_LI_GRAD_REL_NORM}")
    # near ties of the late interaction's maxima on the plain path: where
    # the top two similarities of a (query row, key item) lie closer than
    # the two paths' features differ, the paths may pick different winners
    with torch.no_grad():
        out = model(batch)
        gaps = []
        for q, keys in ((out["dense_image"], out["dense_text_sel"]),
                        (out["dense_text"], out["dense_image_sel"])):
            top2 = _similarities(q, keys).topk(2, dim=-1).values
            gaps.append((top2[..., 0] - top2[..., 1]).flatten())
        gaps = torch.cat(gaps)
        near_ties = {f"{t:g}": int((gaps < t).sum()) for t in (1e-7, 1e-6)}
        del out, gaps
    print(f"train filip fp32 step, kernels vs plain path: loss "
          f"{totals['kernels']:.6f} vs {totals['plain']:.6f} (rel err "
          f"{loss_err:.2e}); over {len(names) - len(zero)} parameters with a "
          f"gradient, max relative norm err {rel_norm_err:.3g} (limit "
          f"{STEP_GRAD_REL_NORM}; largest "
          f"{[(n, f'{r:.3g}') for r, n, _ in worst]}); max-winner gaps "
          f"below 1e-7 / 1e-6 on the plain path: {near_ties['1e-07']} / "
          f"{near_ties['1e-06']} of {TRAIN_BATCH ** 2 * (49 + 77)}; "
          f"exactly zero on both paths: {zero}; K3-K5 against the chunked "
          f"late interaction, both behind K1 and K2: max relative norm err "
          f"{li_rel_norm_err:.3g} (limit {STEP_LI_GRAD_REL_NORM})",
          flush=True)
    del model, grads, params
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": FILIP_TRAIN_STEPS,
            "warmup_steps": TRAIN_WARMUP_STEPS, "losses": losses,
            "history": history, "step_ms": step_ms,
            "host_step_ms": wall_s * 1e3 / FILIP_TRAIN_STEPS,
            "pairs_per_s": TRAIN_BATCH * 1e3 / step_ms,
            "peak_device_mib": peak_mib, "setup_s": setup_s, **breakdown,
            "fp32_loss": totals, "fp32_loss_rel_err": loss_err,
            "fp32_max_grad_rel_norm_err": rel_norm_err,
            "fp32_worst_grad_rel_norm_errs": worst,
            "fp32_near_ties": near_ties,
            "fp32_li_only_max_grad_rel_norm_err": li_rel_norm_err,
            "fp32_zero_grad_params": zero}


def _declip_batch(rng, tok=None):
    """B=128 seeded two-view images [B, 224, 224, 6], each view noise around
    a colour of its own image (pure noise gives a random tower nearly equal
    embeddings, whose BatchNorm in the SimSiam heads then divides by a tiny
    batch deviation), the captions, a second draw standing in for their EDA
    versions, and the MLM masking of the captions. With a tokenizer
    ``tok``, the captions are colored-shapes captions in its vocabulary
    and their "a photo of a ..." versions in place of the random ids."""
    import numpy as np
    import torch

    from declip_tpu_torch.data.synthetic_shapes import captions
    from declip_tpu_torch.tokenizer.mlm import mask_tokens

    if tok is None:
        tokens = _tokens(rng, TRAIN_BATCH)
        tokens_aug = _tokens(rng, TRAIN_BATCH)
        mask, vocab, special = MASK, VOCAB, (SOT, EOT)
    else:
        idx = rng.integers(0, 16, TRAIN_BATCH)
        tokens = tok.tokenize(captions(idx))
        tokens_aug = tok.tokenize(captions(idx, "a photo of a {} {}"))
        mask, vocab = tok.mask_id, tok.vocab_size
        special = (tok.sot_id, tok.eot_id, tok.mask_id)
    mlm_tokens, mlm_labels = mask_tokens(
        tokens, mask_id=mask, vocab_size=vocab, special_ids=special, rng=rng)
    check((mlm_tokens == mask).any() and (mlm_labels != -100).any(),
          "MLM masking selected nothing")
    images = (rng.standard_normal((TRAIN_BATCH, 224, 224, 6), np.float32)
              + rng.standard_normal((TRAIN_BATCH, 1, 1, 6), np.float32))
    return {"images": torch.from_numpy(images).cuda(),
            "tokens": torch.from_numpy(tokens).cuda(),
            "tokens_aug": torch.from_numpy(tokens_aug).cuda(),
            "mlm_tokens": torch.from_numpy(mlm_tokens).cuda(),
            "mlm_labels": torch.from_numpy(mlm_labels).cuda()}


def _rel_norm(a, b):
    import torch

    norm = torch.linalg.vector_norm(b.float()).item()
    return torch.linalg.vector_norm((a - b).float()).item() / norm, norm


def declip_step_kernels_vs_plain(model, from_out, state, batch):
    """One fp32 loss and gradient of the DeCLIP ``model`` through K1/K2
    (attn_impl "auto") and through the plain attention path ("xla"), from
    the same weights and bank: -> {impl: (loss, gradients in parameter
    order, the bank's neighbour indices of both captions [B, 2], each
    BatchNorm's new running statistics)}. Checks K1/K2's calls on each
    path, and that only the plain path made plain self-attention calls."""
    import torch

    from declip_tpu_torch.models.layers import (
        BatchNorm,
        MultiHeadAttention,
        discard_bn_stats,
    )
    from declip_tpu_torch.models.memory_bank import nearest_indices

    params = list(model.parameters())
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    out_by_impl = {}
    for impl, want in (("auto", (24, 24)), ("xla", (0, 0))):
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = impl
        discard_bn_stats(model)
        before = read_launches()
        with _CallCounter() as plain:
            out = model(batch)
            idx = torch.cat([nearest_indices(state.bank_text, out[key])
                             for key in ("text_embed", "text_embed_aug")],
                            dim=1)
            total, _ = from_out(model, state, out)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(
                         total, params, allow_unused=True))]
        used = tuple(read_launches()[k] - before[k] for k in ("K1", "K2"))
        check(used == want, f"fp32 DeCLIP step with attn_impl {impl}: "
                            f"K1/K2 calls {used}, want {want}")
        check((plain.calls == 0) == (impl == "auto"),
              f"fp32 DeCLIP step with attn_impl {impl}: {plain.calls} "
              f"plain self-attention calls")
        out_by_impl[impl] = (float(total.detach()), grads, idx,
                             [m.pending for m in bns])
        del out, total
    discard_bn_stats(model)
    return out_by_impl


def phase_train_declip():
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.layers import BatchNorm
    from declip_tpu_torch.models.memory_bank import init_bank, query_topk
    from declip_tpu_torch.models.resnet import ModifiedResNet
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import (
        make_losses_from_out,
        make_train_step,
        method_of,
        new_train_state,
    )

    cfg = parse_config(DECLIP_CONFIG)
    max_iter = int(cfg.lr_scheduler.kwargs.max_iter)

    def build(dtype):
        kwargs = dict(cfg.model.kwargs)
        kwargs["dtype"] = dtype
        model = model_entry({"type": cfg.model.type, "kwargs": kwargs})
        model.init_weights(torch.Generator().manual_seed(SEED))
        return model.cuda()

    def seeded_bank():
        return init_bank(torch.Generator().manual_seed(SEED + 1),
                         DECLIP_BANK, 1024, device="cuda")

    t0 = time.perf_counter()
    model = build(cfg.precision.dtype)
    vis, txt = model.visual, model.encode_text
    check(isinstance(vis, ModifiedResNet)
          and (vis.layers, vis.width, vis.embed_dim, vis.heads,
               vis.input_resolution, txt.ln_final.normalized_shape[0],
               len(txt.transformer.resblocks), txt.vocab_size, vis.dtype,
               txt.dtype, method_of(model), model.return_nn_bank,
               model.text_label_predictor.out_features)
          == ((3, 4, 6, 3), 64, 1024, 32, 224, 512, 12, VOCAB,
              torch.bfloat16, torch.bfloat16, "declip", True, VOCAB),
          "model is not DeCLIP-ResNet-50 at full width in bf16")
    named = dict(model.named_parameters())
    check(all(p.dtype == torch.float32 for p in named.values()),
          "parameters are not fp32")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    sched = scheduler_entry(cfg.lr_scheduler, max_iter=max_iter)
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip),
                     frozen_mask=path_prefix_mask(
                         named, vis.frozen_param_paths()))
    state = new_train_state(model=model, opt_state=tx.init(named),
                            bank_text=seeded_bank())
    step = make_train_step(model, tx, cfg, sched, total_steps=max_iter)
    batch = _declip_batch(np.random.default_rng(SEED))
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in named.values())
    print(f"train declip: declip_res50 bf16, {n_params / 1e6:.1f} M fp32 "
          f"params, {len(bns)} BatchNorms, bank {DECLIP_BANK} x 1024, batch "
          f"{TRAIN_BATCH}, set up in {setup_s:.1f} s", flush=True)

    history = []
    terms = ("clip_loss", "simsiam_loss", "text_mlm_loss",
             "clip_nn_text_loss")

    def run(n):
        steps = []
        for _ in range(n):
            _, metrics = step(state, batch)
            steps.append((metrics, model.logit_scale.detach().clone()))
        for metrics, scale in steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["logit_scale_param"] = float(scale)
            history.append(m)
            check(m["update_skipped"] == 0.0, f"a step was skipped: {m}")
            check(all(np.isfinite(m[k]) for k in ("loss",) + terms),
                  f"a loss term is not finite: {m}")
            check(3.0 <= m["logit_scale_param"] <= 6.0,
                  f"logit_scale param outside [3, 6]: {m}")

    run(TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ptr0 = state.bank_text.ptr
    reset_launches()  # main path starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _CallCounter() as plain:
        t0 = time.perf_counter()
        start.record()
        run(DECLIP_TRAIN_STEPS)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    launches = read_launches()  # main path ends
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = start.elapsed_time(end) / DECLIP_TRAIN_STEPS
    losses = [m["loss"] for m in history]
    per_step = {"K1": 24, "K2": 24, "K3": 0, "K4": 0, "K5": 0}
    check(launches == {k: n * DECLIP_TRAIN_STEPS
                       for k, n in per_step.items()},
          f"{launches} kernel calls in {DECLIP_TRAIN_STEPS} steps (want "
          f"{per_step} per step)")
    check(plain.calls == 0, f"{plain.calls} plain self-attention calls")
    check(plain.cross == 2 * DECLIP_TRAIN_STEPS,
          f"{plain.cross} pooled-query attention calls in "
          f"{DECLIP_TRAIN_STEPS} steps (want 2 a step)")
    want_ptr = (ptr0 + 2 * TRAIN_BATCH * DECLIP_TRAIN_STEPS) % DECLIP_BANK
    check(state.bank_text.ptr == want_ptr,
          f"bank pointer {state.bank_text.ptr}, want {want_ptr}")
    moved = 0
    for m, (mean0, var0) in zip(bns, stats0):
        check(bool(torch.isfinite(m.running_mean).all()
                   and torch.isfinite(m.running_var).all()),
              "BatchNorm running statistics not finite")
        moved += int(not torch.equal(m.running_mean, mean0)
                     and not torch.equal(m.running_var, var0))
    check(moved == len(bns), f"{len(bns) - moved} of {len(bns)} BatchNorms "
                             f"kept their running statistics")
    print(f"train declip: losses {[round(x, 4) for x in losses]}; last "
          f"step's terms {({k: round(history[-1][k], 4) for k in terms})}",
          flush=True)
    print(f"train declip: {DECLIP_TRAIN_STEPS} steps, {step_ms:.2f} ms/step "
          f"(CUDA events; host {wall_s * 1e3 / DECLIP_TRAIN_STEPS:.2f}), "
          f"{TRAIN_BATCH * 1e3 / step_ms:.1f} pairs/s, kernel calls "
          f"{launches}, pooled-query attention calls {plain.cross}, bank "
          f"pointer {ptr0} -> {state.bank_text.ptr}, peak device memory "
          f"{peak_mib:.0f} MiB", flush=True)

    breakdown = profile_steps(lambda: step(state, batch), 3, step_ms)
    flops = step_flops(lambda: step(state, batch))  # after the counts
    query = torch.nn.functional.normalize(torch.randn(
        TRAIN_BATCH, 1024, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED)), dim=-1).to(torch.bfloat16)
    bank_ms, bank_kernels = device_ms(
        lambda: query_topk(state.bank_text, query, 1))
    print(f"train declip: device busy {breakdown['busy_ms']:.2f} ms/step, "
          f"idle share {breakdown['idle_share']:.1%}, K1 "
          f"{breakdown['k1_ms']:.2f} ms, K2 {breakdown['k2_ms']:.2f} ms; "
          f"one bank query (bf16, B={TRAIN_BATCH}, 2 a step) "
          f"{bank_ms:.3f} ms of device time", flush=True)
    print(f"  by kind: {breakdown['by_kind_ms']}")
    for n, v in breakdown["top_kernels_ms"]:
        print(f"  {v:8.3f} ms  {n[:110]}")
    del state, step, tx, model, named, bns, stats0
    torch.cuda.empty_cache()

    # one fp32 step from the same seeded weights and bank: K1/K2 against
    # the plain attention path. Each block's bn3 starts at zero scale, which
    # leaves every layer of its residual branch without a gradient; a
    # seeded scale in [0.1, 0.5] gives the whole tower one, so that the
    # image side's gradients, which reach the text tower through the
    # contrastive terms, are compared too
    model = build("float32")
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.zero_scale:
                m.weight.copy_(0.1 + 0.4 * torch.rand(
                    m.weight.shape, generator=gen).to(m.weight.device))
    state = new_train_state(model=model, opt_state=None,
                            bank_text=seeded_bank())
    from_out = make_losses_from_out(cfg, "declip", total_steps=max_iter)
    res = declip_step_kernels_vs_plain(model, from_out, state, batch)
    (k_loss, k_grads, k_idx, k_stats), (p_loss, p_grads, p_idx, p_stats) = \
        res["auto"], res["xla"]
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    check(loss_err <= STEP_LOSS_RTOL,
          f"fp32 DeCLIP loss kernels {k_loss} vs plain {p_loss}")
    names = [n for n, _ in model.named_parameters()]
    grads_k, grads_p = dict(zip(names, k_grads)), dict(zip(names, p_grads))
    rel_norm_err, worst, noise, zero = 0.0, [], {}, []
    for name in names:
        a, b = grads_k[name], grads_p[name]
        if name in NOISE_GRADS:
            weight = name[: -len("bias")] + "weight"
            for path, grads in (("kernels", grads_k), ("plain", grads_p)):
                noise[f"{path} {name}"] = (
                    torch.linalg.vector_norm(grads[name]).item()
                    / torch.linalg.vector_norm(grads[weight]).item())
                check(noise[f"{path} {name}"] <= STEP_NOISE_REL_NORM,
                      f"fp32 grad {name} ({path}): not at the noise level "
                      f"of {weight}'s: {noise[f'{path} {name}']:.3g}")
            continue
        if not b.any().item():
            check(not a.any().item(), f"fp32 grad {name}: zero on the "
                                      f"plain path, not through the kernels")
            zero.append(name)
            continue
        rel, norm = _rel_norm(a, b)
        rel_norm_err = max(rel_norm_err, rel)
        worst = sorted(worst + [(rel, name)], reverse=True)[:3]
        check(rel <= STEP_GRAD_REL_NORM,
              f"fp32 grad {name}: ||kernels - plain|| / ||plain|| = "
              f"{rel:.3g}, limit {STEP_GRAD_REL_NORM}")
    idx_diff = int((k_idx != p_idx).sum())
    check(idx_diff == 0, f"fp32 DeCLIP step: {idx_diff} of {k_idx.numel()} "
                         f"bank neighbour indices differ between the paths")
    # structural: no BatchNorm of this recipe sits after the text tower
    # (no return_simsiam_text / return_simsiam_nn_text), so K1/K2 cannot move
    # these statistics; the check holds that both paths ran the same image
    # side, not the kernels
    bn_err = 0.0
    for (km, kv), (pm, pv) in zip(k_stats, p_stats):
        bn_err = max(bn_err, _rel_norm(km, pm)[0], _rel_norm(kv, pv)[0])
    check(bn_err <= STEP_BN_REL_NORM,
          f"fp32 DeCLIP step: BatchNorm statistics kernels vs plain "
          f"{bn_err:.3g}, limit {STEP_BN_REL_NORM}")
    print(f"train declip fp32 step, kernels vs plain attention: loss "
          f"{k_loss:.6f} vs {p_loss:.6f} (rel err {loss_err:.2e}); over "
          f"{len(names) - len(NOISE_GRADS) - len(zero)} parameters with a "
          f"gradient max relative norm err {rel_norm_err:.3g} (limit "
          f"{STEP_GRAD_REL_NORM}; largest "
          f"{[(n, f'{r:.3g}') for r, n in worst]}); {len(zero)} exactly zero "
          f"on both paths; the {len(NOISE_GRADS)} "
          f"zero-in-exact-arithmetic biases at most "
          f"{max(noise.values()):.3g} of their weights' gradient norm; bank "
          f"neighbour indices differing {idx_diff} of {k_idx.numel()}; "
          f"BatchNorm statistics max relative norm err {bn_err:.3g} (limit "
          f"{STEP_BN_REL_NORM})", flush=True)
    del model, state, res, k_grads, p_grads, grads_k, grads_p
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": DECLIP_TRAIN_STEPS,
            "warmup_steps": TRAIN_WARMUP_STEPS, "losses": losses,
            "history": history, "step_ms": step_ms,
            "host_step_ms": wall_s * 1e3 / DECLIP_TRAIN_STEPS,
            "pairs_per_s": TRAIN_BATCH * 1e3 / step_ms, "flops": flops,
            "peak_device_mib": peak_mib, "setup_s": setup_s, **breakdown,
            "bank_query_ms": bank_ms, "bank_query_kernels": bank_kernels,
            "pooled_query_calls": plain.cross,
            "fp32_loss": {"kernels": k_loss, "plain": p_loss},
            "fp32_loss_rel_err": loss_err,
            "fp32_max_grad_rel_norm_err": rel_norm_err,
            "fp32_worst_grad_rel_norm_errs": worst,
            "fp32_noise_grads": noise, "fp32_zero_grad_params": zero,
            "fp32_bank_index_diffs": idx_diff,
            "fp32_bn_stats_rel_norm_err": bn_err}


def write_corpus(root, n_images, classes, per_class, seed):
    """The phase's image-text corpus under ``root``: ``train/`` JPEGs
    (quality 90) with a JSONL metafile read with fseek, and ``val/`` with
    ``label``/``label_name``. Each image is a smooth field (an 8 x 8 grid
    of random colours, upsampled) with noise on top; written by 8 threads
    (PIL's encoder releases the GIL). -> (train meta, val meta)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from declip_tpu_torch.tokenizer.eda import default_synonym_table

    rng = np.random.default_rng(seed)
    vocab = sorted(default_synonym_table())
    names = [str(w) for w in rng.choice(vocab, size=classes, replace=False)]

    def spec():
        long_side = int(rng.integers(256, 641))
        aspect = float(rng.uniform(0.75, 1.33))
        w, h = ((long_side, int(round(long_side / aspect))) if aspect >= 1
                else (int(round(long_side * aspect)), long_side))
        return w, h, int(rng.integers(2 ** 31))

    def write(path, w, h, s):
        r = np.random.default_rng(s)
        grid = Image.fromarray(r.integers(0, 256, (8, 8, 3), np.uint8))
        field = np.asarray(grid.resize((w, h), Image.BILINEAR), np.int16)
        noise = r.integers(-12, 13, (h, w, 3), np.int16)
        Image.fromarray(np.clip(field + noise, 0, 255).astype(np.uint8)
                        ).save(path, "JPEG", quality=90)

    jobs, train, val = [], [], []
    for sub in ("train", "val"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n_images):
        name = f"train/{i:05d}.jpg"
        jobs.append((os.path.join(root, name), *spec()))
        words = rng.choice(vocab, size=int(rng.integers(5, 21)))
        train.append({"filename": name, "caption": " ".join(words)})
    for c in range(classes):
        for j in range(per_class):
            name = f"val/{c:02d}_{j:02d}.jpg"
            jobs.append((os.path.join(root, name), *spec()))
            val.append({"filename": name, "caption": f"a photo of a "
                        f"{names[c]}", "label": c, "label_name": names[c]})
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: write(*job), jobs))
    metas = []
    for sub, rows in (("train", train), ("val", val)):
        path = os.path.join(root, f"{sub}.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        metas.append(path)
    return metas


def scalars_by_tag(path):
    """events/scalars.jsonl as {tag: [(step, value), ...]}."""
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append((row["step"], row["value"]))
    return out


def solver_window(timings, first, last, batch):
    """The solver's per-print timings (print_freq 1: one step each) over
    steps ``first``..``last``: mean step seconds and pairs/s, also without
    the synchronous part of the saves that fell in the window; the mean
    wait for data and its share of the step; the host-to-device copy's
    median and largest over every step."""
    rows = [t for t in timings if first <= t["step"] <= last]
    check(len(rows) == last - first + 1 and all(t["steps"] == 1
                                                for t in rows),
          f"solver timings for steps {first}-{last} missing: {timings}")
    step_s = sum(t["batch_time"] for t in rows) / len(rows)
    data_s = sum(t["data_time"] for t in rows) / len(rows)
    save_s = sum(t["save_time"] for t in rows) / len(rows)
    h2d = sorted(t["h2d_ms"] for t in timings)
    return {"steps": [first, last], "step_s": step_s,
            "pairs_per_s": batch / step_s, "save_s": save_s,
            "step_s_without_saves": step_s - save_s,
            "pairs_per_s_without_saves": batch / (step_s - save_s),
            "data_s": data_s, "data_share": data_s / step_s,
            "h2d_ms_median": h2d[len(h2d) // 2], "h2d_ms_max": h2d[-1]}


def loader_rate(arrivals, workers, batch):
    """Batches/s and pairs/s of a loader from the host times its batches
    arrived at. Its ``workers`` build a batch each side by side, so the
    batches land in rounds of ``workers``: the rate is read over whole
    rounds past the first, from the first round's last arrival to the last
    round's (a span that starts or ends inside a round reads the spread of
    the round's arrivals, not the loader's rate)."""
    n = len(arrivals)
    check(n >= 2 * workers and n % workers == 0,
          f"{n} batches, want whole rounds of {workers}, two at least")
    rate = (n - workers) / (arrivals[-1] - arrivals[workers - 1])
    return {"batches": n, "first_batch_s": arrivals[0],
            "first_round_s": arrivals[workers - 1], "batches_per_s": rate,
            "pairs_per_s": rate * batch, "ms_per_batch": 1e3 / rate}


def solver_kernel_calls(solver, steps):
    """The launches a solver run of ``steps`` steps makes: K1 and K2 24 a
    step (both text passes, as phase 6 counts them), and K1 once a text
    layer for each class-embedding chunk of each zero-shot eval (the
    solver packs min(2048 // prompts, classes) classes into a chunk)."""
    layers = len(solver.model.encode_text.transformer.resblocks)
    per_chunk = min(2048 // SOLVER_PROMPTS, SOLVER_CLASSES)
    chunks = -(-SOLVER_CLASSES // per_chunk)
    evals = len(solver.eval_seconds)
    return {"K1": 24 * steps + evals * chunks * layers, "K2": 24 * steps,
            "K3": 0, "K4": 0, "K5": 0}


def solver_corpus(tmp):
    """Phases 7 and 8's corpus under ``tmp``: -> {"root", "train_meta",
    "val_meta", "seconds"}."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "corpus")
    train_meta, val_meta = write_corpus(root, SOLVER_IMAGES, SOLVER_CLASSES,
                                        SOLVER_PER_CLASS, SEED)
    return {"root": root, "train_meta": train_meta, "val_meta": val_meta,
            "seconds": time.perf_counter() - t0}


def solver_experiment(tmp, name, corpus, recipe=DECLIP_RECIPE,
                      save_freq=SOLVER_SAVE_FREQ, save_many=True):
    """An experiment directory ``tmp/name`` holding ``recipe``'s config,
    and the --set arguments phase 7 gives it (the corpus's paths, print,
    save and val frequencies, and ``save_many`` unless it is None).
    -> (config path, sets)."""
    from declip_tpu_torch.config import parse_config

    exp = os.path.join(tmp, name)
    os.makedirs(exp)
    cfg_path = os.path.join(exp, "config.yaml")
    shutil.copy(os.path.join(ROOT, recipe), cfg_path)
    recipe = parse_config(cfg_path)
    tests = []
    for entry in recipe.data.test:
        entry = json.loads(json.dumps(entry))
        entry["test"].update(root_dir=corpus["root"],
                             meta_file=corpus["val_meta"])
        tests.append(entry)
    sets = [f"data.train.root_dir={json.dumps([corpus['root']])}",
            f"data.train.meta_file={json.dumps([corpus['train_meta']])}",
            f"data.test={json.dumps(tests)}",
            "saver.print_freq=1", f"saver.save_freq={save_freq}",
            "saver.val_freq=0"]
    if save_many:
        sets.append("saver.save_many=true")
    return cfg_path, sets


def phase_solver(declip_result, tmp, corpus):
    """Phase 7: ``declip_tpu_torch.solver.main`` trains the recipe from the
    corpus on disk, saves, validates, resumes, and the CLI evaluates. Only
    the data paths, max_iter, print_freq, save_freq, save_many and val_freq
    are set. The launch counts are the kernels' over the first run (and,
    apart, the resume)."""
    import numpy as np
    import torch

    from declip_tpu_torch.solver import main as solver_main

    corpus_s = corpus["seconds"]
    cfg_path, sets = solver_experiment(tmp, "exp", corpus)
    exp = os.path.dirname(cfg_path)

    def run(max_iter):
        argv = ["--config", cfg_path, "--device", "cuda", "--set",
                *sets, f"lr_scheduler.kwargs.max_iter={max_iter}"]
        reset_launches()  # a main path starts
        t = time.perf_counter()
        solver = solver_main(argv)
        wall = time.perf_counter() - t
        return solver, read_launches(), wall  # ... and ends

    solver, launches, wall_s = run(SOLVER_STEPS)
    st = solver.state
    batch, bank_rows = solver.global_batch, st.bank_text.bank.shape[0]
    vis = solver.model.visual  # the recipe as its file has it
    check((vis.layers, vis.width, vis.embed_dim, vis.dtype,
           solver.method, batch, bank_rows,
           solver.train_cfg["num_workers"],
           solver.train_cfg["transforms"])
          == ((3, 4, 6, 3), 64, 1024, torch.bfloat16, "declip",
              TRAIN_BATCH, DECLIP_BANK, 7, {"type": "MOCOV2"}),
          "phase 7 does not run the DeCLIP-ResNet-50 recipe")
    scalars = scalars_by_tag(os.path.join(exp, "events",
                                          "scalars.jsonl"))
    losses = [v for _, v in scalars["loss"]]
    check(len(losses) == SOLVER_STEPS and np.isfinite(losses).all(),
          f"solver losses {losses}")
    skipped = [v for _, v in scalars["update_skipped"]]
    check(skipped == [0.0] * SOLVER_STEPS, f"skipped updates {skipped}")
    want_ptr = 2 * batch * SOLVER_STEPS % bank_rows
    check(st.step == SOLVER_STEPS and st.bank_text.ptr == want_ptr,
          f"solver at step {st.step}, bank pointer {st.bank_text.ptr} "
          f"(want {SOLVER_STEPS}, {want_ptr})")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == [f"ckpt_{SOLVER_SAVE_FREQ}.pth.tar",
                    f"ckpt_{SOLVER_STEPS}.pth.tar", "ckpt_meta.json"],
          f"checkpoints {ckpts}")
    with open(os.path.join(exp, "results", "results.txt.rank0")) as f:
        n_results = sum(1 for _ in f)
    n_val = SOLVER_CLASSES * SOLVER_PER_CLASS
    top = {k: scalars[f"eval0/{k}"][-1][1] for k in ("top1", "top5")}
    check(n_results == n_val and all(0 <= v <= 100 for v in
                                     top.values()),
          f"{n_results} zero-shot results (want {n_val}), {top}")
    want = solver_kernel_calls(solver, SOLVER_STEPS)
    check(launches == want,
          f"solver path kernel calls {launches}, want {want}")
    window = solver_window(solver.timings, *SOLVER_TIMED, batch)
    ckpt = os.path.join(exp, "checkpoints",
                        f"ckpt_{SOLVER_STEPS}.pth.tar")
    out = {"device": str(solver.device), "batch": batch,
           "cpu_count": os.cpu_count(), "corpus_s": corpus_s,
           "images": SOLVER_IMAGES, "wall_s": wall_s,
           "launches": launches,
           "losses": losses, "timings": solver.timings, **window,
           "bank_ptr": st.bank_text.ptr, "top1": top["top1"],
           "top5": top["top5"], "ckpt_bytes": os.path.getsize(ckpt),
           "ckpt_write_s": solver.save_seconds[-1],
           "eval_s": solver.eval_seconds[-1],
           "phase6": {k: declip_result.get(k) for k in
                      ("step_ms", "host_step_ms", "pairs_per_s")}}
    print(f"solver: {SOLVER_STEPS} steps of {DECLIP_RECIPE} from "
          f"{SOLVER_IMAGES} JPEGs on disk (corpus written in {corpus_s:.1f} s),"
          f" run in {wall_s:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; bank pointer "
          f"{st.bank_text.ptr}; zero-shot top1 {top['top1']:.2f} top5 "
          f"{top['top5']:.2f} over {n_results}; kernel calls "
          f"{launches}", flush=True)
    print(f"solver: steps {SOLVER_TIMED[0]}-{SOLVER_TIMED[1]}: "
          f"{window['step_s'] * 1e3:.2f} ms/step, "
          f"{window['pairs_per_s']:.1f} pairs/s; without the saves' "
          f"synchronous {window['save_s'] * 1e3:.2f} ms/step: "
          f"{window['step_s_without_saves'] * 1e3:.2f} ms/step, "
          f"{window['pairs_per_s_without_saves']:.1f} pairs/s "
          f"(phase 6, one repeated "
          f"batch: {declip_result.get('step_ms', float('nan')):.2f} "
          f"ms/step device, {declip_result.get('host_step_ms', float('nan')):.2f} "
          f"host, {declip_result.get('pairs_per_s', float('nan')):.1f} "
          f"pairs/s); waiting for data {window['data_s'] * 1e3:.2f} "
          f"ms/step ({window['data_share']:.1%} of the step); "
          f"host-to-device copy median {window['h2d_ms_median']:.3f} "
          f"ms, largest {window['h2d_ms_max']:.3f} ms; "
          f"os.cpu_count() {os.cpu_count()}; checkpoint "
          f"{out['ckpt_bytes'] / 2 ** 20:.1f} MiB written in "
          f"{out['ckpt_write_s']:.2f} s; eval {out['eval_s']:.2f} s",
          flush=True)

    # the recipe's loader alone, longer than the run: 6 steps end
    # before its workers' first round does
    solver.max_iter = SOLVER_LOADER_BATCHES
    t = time.perf_counter()
    arrivals = [time.perf_counter() - t
                for _ in solver._train_loader(-1)]
    out["loader"] = loader_rate(
        arrivals, int(solver.train_cfg["num_workers"]), batch)
    # one batch built on this thread alone, and its images' decode and
    # two MOCOV2 views apart: how far the workers scale, and where a
    # batch's host time goes
    loader = solver._train_loader(-1)
    ds = solver.train_dataset
    t = time.perf_counter()
    loader._build_batch(list(range(batch)), 0)
    out["loader"]["one_thread_batch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pics = [ds._load_image(i, ds._meta(i)) for i in range(32)]
    out["loader"]["decode_ms_per_image"] = (time.perf_counter() - t) * 1e3 / 32
    t = time.perf_counter()
    for pic in pics:
        ds.transform(pic)
    out["loader"]["views_ms_per_image"] = (time.perf_counter() - t) * 1e3 / 32
    lo = out["loader"]
    print(f"solver loader alone ({solver.train_cfg['num_workers']} "
          f"thread workers, {os.cpu_count()} CPUs): the first round "
          f"{lo['first_round_s']:.2f} s, then {lo['ms_per_batch']:.1f} "
          f"ms a batch over the second, {lo['pairs_per_s']:.1f} pairs/s; "
          f"one batch on "
          f"one thread {lo['one_thread_batch_s']:.2f} s (a JPEG decode "
          f"{lo['decode_ms_per_image']:.2f} ms, its two MOCOV2 views "
          f"{lo['views_ms_per_image']:.2f} ms)", flush=True)
    del solver, st

    resumed, out["resume_launches"], out["resume_wall_s"] = run(
        SOLVER_RESUME_STEPS)
    check(resumed.start_step == SOLVER_STEPS
          and resumed.state.step == SOLVER_RESUME_STEPS,
          f"resume started at {resumed.start_step}, ended at "
          f"{resumed.state.step} (want {SOLVER_STEPS}, "
          f"{SOLVER_RESUME_STEPS})")
    want = solver_kernel_calls(resumed, SOLVER_RESUME_STEPS - SOLVER_STEPS)
    check(out["resume_launches"] == want,
          f"resume path kernel calls {out['resume_launches']}, want "
          f"{want}")
    with open(os.path.join(exp, "log.txt")) as f:
        check(re.search(r"auto-resumed from \S+ckpt_%d\.pth\.tar at "
                        r"step %d\b" % (SOLVER_STEPS, SOLVER_STEPS),
                        f.read()) is not None,
              "no auto-resume at the last save in log.txt")
    print(f"solver resume: from step {resumed.start_step} to "
          f"{resumed.state.step} in {out['resume_wall_s']:.1f} s",
          flush=True)
    del resumed
    torch.cuda.empty_cache()

    out["cli_argv"] = [
        sys.executable, "-m", "declip_tpu_torch.solver", "--config",
        cfg_path, "--evaluate", "--device", "cuda", "--set", *sets,
        f"lr_scheduler.kwargs.max_iter={SOLVER_RESUME_STEPS}"]
    return out


def start_solver_cli(solver_result, tmp):
    """Phase 7's last part, started: the CLI's ``--evaluate`` of the
    resumed checkpoint, in a process of its own (``main`` runs it beside
    phase 11b, whose times are no performance numbers) -> the pending
    launch."""
    log = open(os.path.join(tmp, "cli_evaluate.log"), "w")
    proc = subprocess.Popen(
        solver_result["cli_argv"], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")])))
    return proc, log, time.perf_counter()


def finish_solver_cli(pending, solver_result):
    """Waits for ``start_solver_cli``'s launch and checks its metric."""
    proc, log, t = pending
    try:
        proc.wait(600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    solver_result["cli_s"] = time.perf_counter() - t
    with open(log.name) as f:
        text = f.read()
    metric = re.search(r'"top1": ([0-9.]+)', text)
    check(proc.returncode == 0 and metric is not None,
          f"the CLI --evaluate: rc {proc.returncode}, output "
          f"{text[-3000:]}")
    solver_result["cli_top1"] = float(metric.group(1))
    print(f"solver CLI --evaluate (phase 7, run beside phase 11b): top1 "
          f"{solver_result['cli_top1']:.2f} in {solver_result['cli_s']:.1f} "
          f"s", flush=True)



def loader_configs(train_cfg, shards):
    """Phase 8's three loaders of the recipe's train split, each with
    device_aug's geometry crops: (a) thread workers, PIL, the JSONL
    metafile; (b) the same with process workers; (c) the webdataset shards
    with process workers. The card's host has no libjpeg headers (jpeglib.h
    is absent there, so the native decoder cannot be built), so every input
    decodes with PIL."""
    jsonl = {k: v for k, v in train_cfg.items()
             if k not in ("type", "tar_files", "worker_type")}
    jsonl.update(device_aug=True, image_reader={"type": "pil"})
    wds = {k: v for k, v in jsonl.items()
           if k not in ("root_dir", "meta_file", "fseek", "read_from")}
    return {"a": {**jsonl, "worker_type": "thread"},
            "b": {**jsonl, "worker_type": "process"},
            "c": {**wds, "type": "clip_wds", "tar_files": shards,
                  "worker_type": "process"}}


def phase_fast_input(solver_result, tmp, corpus):
    """Phase 8: the recipe of phase 7 through ``declip_tpu_torch.solver.main``
    on the fast input path: the corpus packed into webdataset shards by the
    port's make_wds, ``train.device_aug`` (uint8 geometry crops from the
    loader, MOCOV2's photometrics on the card), process workers. The loader
    alone in configurations (a)-(c) (``loader_configs``) beside phase 7's
    host-MOCOV2 loader; the solver's steps 4-6, its wait for data, the copy
    of a uint8 batch; the checks of phase 7; the photometrics on the card
    against the CPU and their device time."""
    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod
    from declip_tpu_torch.data import device_aug
    from declip_tpu_torch.data.dataloader import build_clip_dataset
    from declip_tpu_torch.tools import make_wds

    t = time.perf_counter()
    shard_dir = os.path.join(tmp, "shards")
    os.makedirs(shard_dir)
    per_shard = -(-SOLVER_IMAGES // FAST_SHARDS)
    packed = make_wds.pack(corpus["train_meta"], corpus["root"],
                           os.path.join(shard_dir, "s-%05d.tar"), per_shard)
    pack_s = time.perf_counter() - t
    check(packed == (SOLVER_IMAGES, FAST_SHARDS, 0),
          f"make_wds packed {packed}")
    shards = os.path.join(shard_dir, "s-{00000..%05d}.tar" % (FAST_SHARDS - 1))

    cfg_path, sets = solver_experiment(tmp, "exp_fast", corpus)
    exp = os.path.dirname(cfg_path)
    sets += ["data.train.device_aug=true", "data.train.type=clip_wds",
             f"data.train.tar_files={shards}",
             "data.train.worker_type=process",
             'data.train.image_reader={"type": "pil"}']

    # the batches the step receives, as they lie on the card
    seen = []
    make_step = solver_mod.make_train_step

    def recording_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, batch):
            if not seen:
                seen.append(batch["images"].clone())
            return step(state, batch)
        return recorded

    solver_mod.make_train_step = recording_make_train_step
    try:
        with _CallCounter() as plain:
            reset_launches()  # a main path starts
            t = time.perf_counter()
            solver = solver_mod.main(
                ["--config", cfg_path, "--device", "cuda", "--set", *sets,
                 f"lr_scheduler.kwargs.max_iter={SOLVER_STEPS}"])
            wall_s = time.perf_counter() - t
            launches = read_launches()  # ... and ends
    finally:
        solver_mod.make_train_step = make_step
    st = solver.state
    batch, bank_rows = solver.global_batch, st.bank_text.bank.shape[0]
    vis = solver.model.visual
    check((vis.layers, vis.width, vis.embed_dim, vis.dtype, solver.method,
           batch, bank_rows, solver.train_cfg["num_workers"],
           solver.device_aug, type(solver.train_dataset).__name__)
          == ((3, 4, 6, 3), 64, 1024, torch.bfloat16, "declip",
              TRAIN_BATCH, DECLIP_BANK, 7, {"views": 2, "preset": "MOCOV2"},
              "WdsClipDataset"),
          "phase 8 does not run the DeCLIP-ResNet-50 recipe on the fast "
          "input path")
    images = seen[0]
    check(images.dtype == torch.uint8 and images.is_cuda
          and tuple(images.shape) == (TRAIN_BATCH, 224, 224, 6),
          f"the step's images on the card: {images.dtype} "
          f"{tuple(images.shape)} on {images.device}")
    scalars = scalars_by_tag(os.path.join(exp, "events", "scalars.jsonl"))
    losses = [v for _, v in scalars["loss"]]
    check(len(losses) == SOLVER_STEPS and np.isfinite(losses).all(),
          f"fast-input solver losses {losses}")
    skipped = [v for _, v in scalars["update_skipped"]]
    check(skipped == [0.0] * SOLVER_STEPS, f"skipped updates {skipped}")
    want_ptr = 2 * batch * SOLVER_STEPS % bank_rows
    check(st.step == SOLVER_STEPS and st.bank_text.ptr == want_ptr,
          f"solver at step {st.step}, bank pointer {st.bank_text.ptr} "
          f"(want {SOLVER_STEPS}, {want_ptr})")
    want = solver_kernel_calls(solver, SOLVER_STEPS)
    check(launches == want,
          f"fast-input solver kernel calls {launches}, want {want}")
    check(plain.calls == 0, f"{plain.calls} plain-path attention calls")
    window = solver_window(solver.timings, *SOLVER_TIMED, batch)
    # the copies of steps 4-6 apart: the first round's overlap the workers'
    # start and cuDNN's first calls
    timed_h2d = sorted(t["h2d_ms"] for t in solver.timings
                       if SOLVER_TIMED[0] <= t["step"] <= SOLVER_TIMED[1])
    window["h2d_ms_timed"] = timed_h2d
    out = {"shards": FAST_SHARDS, "pack_s": pack_s, "wall_s": wall_s,
           "launches": launches, "pooled_query_calls": plain.cross,
           "losses": losses, "timings": solver.timings, **window,
           "bank_ptr": st.bank_text.ptr,
           "images": {"dtype": str(images.dtype),
                      "shape": list(images.shape),
                      "bytes": images.numel() * images.element_size()}}
    print(f"fast input: {SOLVER_IMAGES} JPEGs packed into {FAST_SHARDS} "
          f"shards in {pack_s:.2f} s; {SOLVER_STEPS} steps with "
          f"train.device_aug on input (c) in {wall_s:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; kernel calls {launches}; the "
          f"step's images on the card {images.dtype} "
          f"{tuple(images.shape)} ({out['images']['bytes'] / 1e6:.1f} MB)",
          flush=True)
    print(f"fast input: steps {SOLVER_TIMED[0]}-{SOLVER_TIMED[1]}: "
          f"{window['step_s'] * 1e3:.2f} ms/step, "
          f"{window['pairs_per_s']:.1f} pairs/s; without the saves' "
          f"synchronous {window['save_s'] * 1e3:.2f} ms/step: "
          f"{window['step_s_without_saves'] * 1e3:.2f} ms/step, "
          f"{window['pairs_per_s_without_saves']:.1f} pairs/s (phase 7: "
          f"{solver_result['step_s'] * 1e3:.2f} and "
          f"{solver_result['step_s_without_saves'] * 1e3:.2f} ms/step); "
          f"waiting for data {window['data_s'] * 1e3:.2f} ms/step "
          f"({window['data_share']:.1%} of the step); host-to-device copy "
          f"median {window['h2d_ms_median']:.3f} ms, largest "
          f"{window['h2d_ms_max']:.3f} ms, steps 4-6 "
          f"{[round(x, 3) for x in timed_h2d]} ms (phase 7: median "
          f"{solver_result['h2d_ms_median']:.3f} ms)", flush=True)

    # the photometrics on the card: against the CPU on the same drawn
    # parameters (fp32, TF32 off since main()), and their device time for
    # one step's two views in the model's dtype
    params = device_aug.photometric_params(
        torch.Generator(device=images.device).manual_seed(SEED),
        images.shape[0])
    got = device_aug.photometric_apply(images[..., :3], params)
    want_cpu = device_aug.photometric_apply(
        images[..., :3].cpu(), {k: v.cpu() for k, v in params.items()})
    aug_err = (got.cpu() - want_cpu).abs().max().item()
    check(aug_err <= AUG_ATOL, f"photometric_apply on the card vs the CPU: "
                               f"{aug_err:.3g} > {AUG_ATOL}")

    def step_views():
        return device_aug.augment_views(images, views=2, seed=SEED, step=1,
                                        dtype=vis.dtype)

    aug_ms, aug_kernels = device_ms(step_views)
    aug_wall_ms = cuda_ms(step_views, iters=20, warmup=3)
    out["augment"] = {"max_abs_err": aug_err, "device_ms": aug_ms,
                      "stream_ms": aug_wall_ms,
                      "by_kernel": dict(sorted(aug_kernels.items(),
                                               key=lambda kv: -kv[1])[:8])}
    top = ", ".join(f"{k[:60]} {v:.3f}" for k, v in
                    list(out["augment"]["by_kernel"].items())[:4])
    print(f"fast input: augment_views on the card (two MOCOV2 views, B="
          f"{images.shape[0]}, bf16 out): {aug_ms} ms device, "
          f"{aug_wall_ms:.3f} ms on the stream; vs the CPU, fp32, max abs "
          f"err {aug_err:.3g} (limit {AUG_ATOL}); largest kernels: {top}",
          flush=True)

    # the loader alone, past its first round, in configurations (a)-(c),
    # through the solver's own loader builder
    solver.max_iter = SOLVER_LOADER_BATCHES
    out["loader"] = {}
    configs = loader_configs(solver.train_cfg, shards)
    for name, cfg in configs.items():
        solver.train_cfg = cfg
        solver.train_dataset = build_clip_dataset(
            cfg, transform=solver.train_transform)
        t = time.perf_counter()
        arrivals = []
        for b in solver._train_loader(-1):
            arrivals.append(time.perf_counter() - t)
            check(b["images"].dtype == np.uint8
                  and b["images"].shape == (batch, 224, 224, 6),
                  f"loader ({name}) gave {b['images'].dtype} "
                  f"{b['images'].shape}")
        out["loader"][name] = loader_rate(
            arrivals, int(cfg["num_workers"]), batch)
    # one batch of (a) built on this thread alone, and its images' decode
    # and two geometry crops apart
    solver.train_cfg = configs["a"]
    ds = solver.train_dataset = build_clip_dataset(
        configs["a"], transform=solver.train_transform)
    loader = solver._train_loader(-1)
    t = time.perf_counter()
    loader._build_batch(list(range(batch)), 0)
    one = {"one_thread_batch_s": time.perf_counter() - t}
    t = time.perf_counter()
    pics = [ds._load_image(i, ds._meta(i)) for i in range(32)]
    one["decode_ms_per_image"] = (time.perf_counter() - t) * 1e3 / 32
    t = time.perf_counter()
    for pic in pics:
        ds.transform(pic)
    one["crops_ms_per_image"] = (time.perf_counter() - t) * 1e3 / 32
    out["loader"]["a"].update(one)
    lo, ref = out["loader"], solver_result["loader"]
    print(f"fast input, the loader alone ({solver.train_cfg['num_workers']} "
          f"workers, {os.cpu_count()} CPUs, ms a batch over the second "
          f"round, "
          f"pairs/s): phase 7's host MOCOV2 {ref['ms_per_batch']:.1f}, "
          f"{ref['pairs_per_s']:.1f}; (a) device_aug crops, threads, "
          f"JSONL {lo['a']['ms_per_batch']:.1f}, {lo['a']['pairs_per_s']:.1f}"
          f"; (b) processes {lo['b']['ms_per_batch']:.1f}, "
          f"{lo['b']['pairs_per_s']:.1f}; (c) shards, processes "
          f"{lo['c']['ms_per_batch']:.1f}, {lo['c']['pairs_per_s']:.1f}; "
          f"the first round {lo['a']['first_round_s']:.2f} / "
          f"{lo['b']['first_round_s']:.2f} / {lo['c']['first_round_s']:.2f}"
          f" s; one batch of (a) on one thread "
          f"{one['one_thread_batch_s']:.2f} s (a JPEG decode "
          f"{one['decode_ms_per_image']:.2f} ms, its two geometry crops "
          f"{one['crops_ms_per_image']:.2f} ms; phase 7: "
          f"{ref['one_thread_batch_s']:.2f} s, "
          f"{ref['decode_ms_per_image']:.2f} ms, "
          f"{ref['views_ms_per_image']:.2f} ms)", flush=True)
    del solver, st, images, seen
    torch.cuda.empty_cache()
    return out

def _method_batch(rng, views):
    """B=128 seeded images [B, 224, 224, 3 * views], each view noise around
    a colour of its own image; the captions, a second draw standing in for
    their EDA versions, and the MLM masking of the captions (phase 6's)."""
    import numpy as np
    import torch

    batch = _declip_batch(rng)
    if views != 2:
        images = (rng.standard_normal((TRAIN_BATCH, 224, 224, 3 * views),
                                      np.float32)
                  + rng.standard_normal((TRAIN_BATCH, 1, 1, 3 * views),
                                        np.float32))
        batch["images"] = torch.from_numpy(images).cuda()
    return batch


def _method_build(cfg, dtype):
    import torch

    from declip_tpu_torch.models import model_entry

    kwargs = dict(cfg.model.kwargs)
    kwargs["dtype"] = dtype
    model = model_entry({"type": cfg.model.type, "kwargs": kwargs})
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.cuda()


def _seeded_method_bank(model):
    import torch

    from declip_tpu_torch.models.memory_bank import init_bank

    if not getattr(model, "return_nn_bank", False):
        return None
    return init_bank(torch.Generator().manual_seed(SEED + 1),
                     int(model.nn_size), int(model.feature_dim),
                     device="cuda")


def _selected_tokens(model, out):
    """The token ids of DeFILIP's two top-k selections, as
    ``topk_token_select`` takes them from ``out``: (image tokens [B, k],
    text tokens [B, k])."""
    import torch

    cross = torch.einsum("bnd,bmd->bnm", out["dense_image_1"].float(),
                         out["dense_text"].float())
    return (torch.topk(cross.sum(2), model.top_k, dim=1).indices,
            torch.topk(cross.sum(1), model.top_k, dim=1).indices)


def _winner_tokens(winners, keys, n_tokens):
    """K3's packed winners [B*N1, GB, words] over each key item's selected
    tokens ``keys`` [GB, N2] as a mask over the item's own tokens [B*N1,
    GB, n_tokens], so that another path, which may hold the same tokens in
    another order, can take the same winners."""
    import torch

    r, gb, _ = winners.shape
    n2 = keys.shape[1]
    bits = torch.arange(32, dtype=torch.int32, device=winners.device)
    win = ((winners[..., None] >> bits) & 1).reshape(r, gb, -1)[..., :n2]
    mask = torch.zeros(r, gb, n_tokens, dtype=win.dtype, device=win.device)
    return mask.scatter_(2, keys[None].expand(r, -1, -1), win).bool()


class _RecordLateInteraction:
    """Stands in for ``method_losses.dispatch_late_interaction`` for the
    length of a ``with`` block: each call runs ``late`` and keeps its
    inputs. With ``pinned`` (a token mask a call, from ``_winner_tokens``)
    and ``keys`` (the key tokens a call, in this path's order) set, each
    call takes the max winners the mask names instead of its own: a near
    tie that rounds the other way on another path would move a winner's
    whole gradient share, so two paths are compared on the same winners."""

    def __init__(self, late, pinned=None):
        self.late, self.pinned, self.keys, self.inputs = late, pinned, None, []

    def __enter__(self):
        from declip_tpu_torch.train import method_losses

        self.module = method_losses
        self.saved = method_losses.dispatch_late_interaction
        method_losses.dispatch_late_interaction = lambda cfg=None: self
        return self

    def __call__(self, d1, d2, scale):
        import torch

        from declip_tpu_torch.ops.filip_late_interaction import (
            _similarities,
        )

        i = len(self.inputs)
        self.inputs.append((d1.detach(), d2.detach()))
        if self.pinned is None:
            return self.late(d1, d2, scale)
        b, n1, _ = d1.shape
        gb, n2, _ = d2.shape
        keys = self.keys[i]
        win = torch.gather(self.pinned[i], 2,
                           keys[None].expand(b * n1, -1, -1)).float()
        win = win.reshape(b, n1, gb, n2).permute(0, 2, 1, 3)
        raw = (_similarities(d1, d2) * win).sum(-1) / win.sum(-1)
        return scale.float() * raw.mean(-1)

    def __exit__(self, *exc):
        self.module.dispatch_late_interaction = self.saved


class _Bf16RoundedAttention:
    """K1/K2 with their inputs rounded to bf16 and back (and, through the
    casts' backward, their input gradients too), for the length of a
    ``with`` block: a planted fault for phase 9's fp32 step check."""

    def __enter__(self):
        import torch

        from declip_tpu_torch.ops import attention

        real = attention.flash_attention

        def rounded(q, k, v, **kwargs):
            q, k, v = (t.to(torch.bfloat16).to(t.dtype) for t in (q, k, v))
            return real(q, k, v, **kwargs)

        self.module, self.saved = attention, real
        attention.flash_attention = rounded
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.saved


class _Fp64Attention:
    """The plain attention path with its scores, softmax and P.V in
    float64 (the output back in the input's dtype), for the length of a
    ``with`` block: the yardstick of how far the attention's own fp32
    rounding moves a gradient (STEP_GRAD_ATTN64_FACTOR)."""

    def __enter__(self):
        from declip_tpu_torch.ops import attention

        def fp64(q, k, v, causal=False, scale=None):
            import torch

            if scale is None:
                scale = q.shape[-1] ** -0.5
            s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
            if causal:
                keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                                  device=s.device).tril()
                s = s.masked_fill(~keep, float("-inf"))
            return torch.matmul(torch.softmax(s, dim=-1),
                                v.double()).to(q.dtype)

        self.module, self.saved = attention, attention.attention_plain
        attention.attention_plain = fp64
        return self

    def __exit__(self, *exc):
        self.module.attention_plain = self.saved


def _method_fp32_step(config, method, batch, per_step):
    """One fp32 loss and gradient of ``method`` from the seeded weights
    (and bank) through the kernels, through K1/K2 with the chunked late
    interaction (DeFILIP), and through the plain path (plain attention, the
    chunked late interaction), with the kernels' calls checked on each: ->
    the readings; and through the plain path with its attention in fp64,
    the yardstick of how far the attention's own rounding moves each
    gradient. Both plain paths take the kernels' late-interaction max
    winners, token by token (``_RecordLateInteraction``), and how many of
    their own would differ is reported. Checks the loss within
    STEP_LOSS_RTOL; each parameter's ||g_k - g_p|| within the larger of
    STEP_GRAD_REL_NORM ||g_p|| and STEP_GRAD_ATTN64_FACTOR times its
    fp64-attention move, and never above STEP_GRAD_ATTN64_CAP ||g_p||,
    which a planted fault (``_Bf16RoundedAttention``) must fail; the
    biases before a BatchNorm at the noise level of their weights'
    gradients; zero gradients zero on both; and K3-K5
    against the chunked late interaction behind the same K1 and K2 within
    STEP_LI_GRAD_REL_NORM. Reads first, checks after, so that a failure
    reports every reading, the argmax choices of each path among them (the
    bank's neighbours, the top-k token selections)."""
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models.layers import (
        MultiHeadAttention,
        discard_bn_stats,
    )
    from declip_tpu_torch.models.memory_bank import nearest_indices
    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_fwd,
        late_interaction_logits_kernel,
        late_interaction_winners_plain,
    )
    from declip_tpu_torch.ops.filip_ops import late_interaction_logits
    from declip_tpu_torch.train import make_losses_from_out, new_train_state

    cfg = parse_config(config)
    model = _method_build(cfg, "float32")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    plain_cfg = parse_config(config)
    plain_cfg["filip_dense"] = {"impl": "xla"}
    li = per_step["K3"] > 0
    attn_only = {**per_step, "K3": 0, "K4": 0, "K5": 0}
    runs = [("kernels", "auto", cfg, per_step)]
    if li:
        runs.append(("attention kernels", "auto", plain_cfg, attn_only))
    runs.append(("plain", "xla", plain_cfg, dict.fromkeys(per_step, 0)))
    runs.append(("plain, fp64 attention", "xla", plain_cfg,
                 dict.fromkeys(per_step, 0)))
    runs.append((PLANTED, "auto", cfg, per_step))
    grads, totals, choices, calls, li_inputs, li_keys = {}, {}, {}, {}, {}, {}
    pinned = None
    for path, attn_impl, run_cfg, want in runs:
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = attn_impl
        discard_bn_stats(model)
        state = new_train_state(model=model, opt_state=None,
                                bank_text=_seeded_method_bank(model))
        recorder = _RecordLateInteraction(
            late_interaction_logits_kernel if path in ("kernels", PLANTED)
            else late_interaction_logits,
            pinned if li and path.startswith("plain") else None)
        attention = (_Fp64Attention() if path == "plain, fp64 attention"
                     else _Bf16RoundedAttention() if path == PLANTED
                     else contextlib.nullcontext())
        before = read_launches()
        with _CallCounter() as plain, recorder, attention:
            out = model(batch)
            if li:
                # the key tokens of the two late interactions: the text
                # selection for the image queries, then the image
                # selection for the text queries (defilip_losses' order)
                recorder.keys = _selected_tokens(model, out)[::-1]
            total, _ = make_losses_from_out(run_cfg, method)(model, state,
                                                             out)
            grads[path] = [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, torch.autograd.grad(
                               total, params, allow_unused=True))]
        totals[path] = float(total.detach())
        calls[path] = ({k: n - before[k] for k, n in read_launches().items()},
                       want, plain.calls)
        li_inputs[path], li_keys[path] = recorder.inputs, recorder.keys
        if li and path == "kernels":
            # K3's own winners there (launches outside the count), by token
            pinned = [_winner_tokens(late_interaction_fwd(d1, d2)[1], keys,
                                     n_tokens)
                      for (d1, d2), keys, n_tokens in zip(
                          recorder.inputs, recorder.keys,
                          (out["dense_text"].shape[1],
                           out["dense_image_1"].shape[1]))]
        with torch.no_grad():
            chosen = {}
            if state.bank_text is not None:
                for key in ("text_embed", "text_embed_aug"):
                    chosen[f"bank {key}"] = nearest_indices(
                        state.bank_text, out[key])
            if "dense_image_1" in out:
                img, txt = out["dense_image_1"], out["dense_text"]
                cross = torch.einsum("bnd,bmd->bnm", img.float(),
                                     txt.float())
                for key, mass in (("top-k image", cross.sum(2)),
                                  ("top-k text", cross.sum(1))):
                    chosen[key] = torch.topk(mass, model.top_k,
                                             dim=1).indices.sort(1).values
            choices[path] = chosen
        del total, state, out
    discard_bn_stats(model)
    flips = {key: int((choices["kernels"][key]
                       != choices["plain"][key]).any(-1).sum())
             for key in choices["plain"]}
    gq = dict(zip(names, grads["plain, fp64 attention"]))
    # (query row, key item) pairs whose own max winner (by token) on a
    # plain path's features differs from the kernels': the near ties that
    # the pinning takes out of the comparison
    with torch.no_grad():
        li_flips = {path: sum(
            int((_winner_tokens(late_interaction_winners_plain(d1, d2),
                                keys, pin.shape[2]) != pin).any(-1).sum())
            for (d1, d2), keys, pin in zip(li_inputs[path],
                                           li_keys[path], pinned))
            for path in ("plain", "plain, fp64 attention") if li}
    loss_err = abs(totals["kernels"] - totals["plain"]) / abs(totals["plain"])
    gk, gp = dict(zip(names, grads["kernels"])), dict(zip(names,
                                                         grads["plain"]))
    rel, floor, noise, zero = {}, {}, {}, []
    for name in names:
        a, b = gk[name], gp[name]
        if name in METHOD_NOISE_GRADS[method]:
            weight = name[: -len("bias")] + "weight"
            for path, g in (("kernels", gk), ("plain", gp)):
                noise[f"{path} {name}"] = (
                    torch.linalg.vector_norm(g[name]).item()
                    / torch.linalg.vector_norm(g[weight]).item())
            continue
        if not b.any().item():
            zero.append(name)
            rel[name] = 0.0 if not a.any().item() else float("inf")
            continue
        rel[name] = _rel_norm(a, b)[0]
        floor[name] = _rel_norm(gq[name], b)[0]
    limit = {n: min(STEP_GRAD_ATTN64_CAP, max(
        STEP_GRAD_REL_NORM, STEP_GRAD_ATTN64_FACTOR * floor[n]))
        for n in floor}
    worst = sorted(((r / limit[n], n, r, floor[n])
                    for n, r in rel.items() if n in limit), reverse=True)[:5]
    by_attn64 = sum(lim > STEP_GRAD_REL_NORM for lim in limit.values())
    gf = dict(zip(names, grads[PLANTED]))
    planted_shares = sorted(
        ((_rel_norm(gf[n], gp[n])[0] / limit[n], n) for n in limit),
        reverse=True)
    planted_over = sum(q > 1.0 for q, _ in planted_shares)
    planted_loss_err = (abs(totals[PLANTED] - totals["plain"])
                        / abs(totals["plain"]))
    li_err = None
    if li:
        li_err = max(_rel_norm(a, b)[0] for a, b in zip(
            grads["kernels"], grads["attention kernels"]) if b.any().item())
    print(f"train {method} fp32 step, kernels vs plain path: loss "
          f"{totals['kernels']:.6f} vs {totals['plain']:.6f} (rel err "
          f"{loss_err:.2e}); relative gradient norm errs: max "
          f"{max(rel.values()):.3g}, median "
          f"{float(np.median(list(rel.values()))):.3g}; the plain path's "
          f"own move with its attention in fp64: max "
          f"{max(floor.values()):.3g}, median "
          f"{float(np.median(list(floor.values()))):.3g}; limit each "
          f"min({STEP_GRAD_ATTN64_CAP}, max({STEP_GRAD_REL_NORM}, "
          f"{STEP_GRAD_ATTN64_FACTOR} x that move)), {by_attn64} of "
          f"{len(limit)} above {STEP_GRAD_REL_NORM}; "
          f"nearest their limits (share, name, err, fp64-attention move): "
          f"{[(f'{q:.2f}', n, f'{r:.3g}', f'{f:.3g}') for q, n, r, f in worst]}; "
          f"{len(zero)} exactly "
          f"zero on the plain path; the biases before a BatchNorm at most "
          f"{max(noise.values()):.3g} of their weights' gradient norm; "
          f"rows whose argmax choice differs between the paths {flips}; "
          f"(query row, key item) pairs whose own max winner differs from "
          f"the kernels' (pinned to the kernels') {li_flips}"
          + (f"; K3-K5 against the chunked late interaction, both behind "
             f"K1 and K2: max relative norm err {li_err:.3g} (limit "
             f"{STEP_LI_GRAD_REL_NORM})" if li else "")
          + f"; {PLANTED}: loss rel err {planted_loss_err:.2e}, "
          f"{planted_over} of {len(limit)} parameters over their limits "
          f"(the largest shares "
          f"{[(f'{q:.3g}', n) for q, n in planted_shares[:3]]})",
          flush=True)
    for path, (used, want, n_plain) in calls.items():
        check(used == want, f"fp32 {method} step through the {path}: "
                            f"kernel calls {used}, want {want}")
        check(n_plain == 0 if path == "kernels" else
              n_plain > 0 if path == "plain" else True,
              f"fp32 {method} step through the {path}: {n_plain} plain "
              f"calls")
    check(loss_err <= STEP_LOSS_RTOL,
          f"fp32 {method} loss kernels {totals['kernels']} vs plain "
          f"{totals['plain']}")
    for key, r in noise.items():
        check(r <= STEP_NOISE_REL_NORM,
              f"fp32 {method} grad {key}: not at the noise level of its "
              f"weight's")
    for share, name, r, f in worst:
        check(share <= 1.0,
              f"fp32 {method} grad {name}: ||kernels - plain|| / ||plain|| "
              f"= {r:.3g}, limit min({STEP_GRAD_ATTN64_CAP}, "
              f"max({STEP_GRAD_REL_NORM}, {STEP_GRAD_ATTN64_FACTOR} x "
              f"{f:.3g}))")
    check(planted_over > 0 or planted_loss_err > STEP_LOSS_RTOL,
          f"the fp32 {method} step check passes a planted fault, "
          f"{PLANTED}: largest shares {planted_shares[:3]}")
    if li:
        check(li_err <= STEP_LI_GRAD_REL_NORM,
              f"fp32 {method} step, K3-K5 vs the chunked late interaction "
              f"behind K1 and K2: {li_err:.3g}, limit "
              f"{STEP_LI_GRAD_REL_NORM}")
    del model, grads, params, gk, gp, gf
    torch.cuda.empty_cache()
    return {"fp32_loss": totals, "fp32_loss_rel_err": loss_err,
            "fp32_max_grad_rel_norm_err": max(rel.values()),
            "fp32_median_grad_rel_norm_err": float(np.median(
                list(rel.values()))),
            "fp32_attn64_move_max": max(floor.values()),
            "fp32_attn64_move_median": float(np.median(
                list(floor.values()))),
            "fp32_params_over_1e-4": by_attn64,
            "fp32_nearest_limit": worst,
            "fp32_noise_grads": noise, "fp32_zero_grad_params": zero,
            "fp32_argmax_flips": flips,
            "fp32_li_winner_flips": li_flips,
            "fp32_li_only_max_grad_rel_norm_err": li_err,
            "fp32_planted_loss_rel_err": planted_loss_err,
            "fp32_planted_params_over_limit": planted_over,
            "fp32_planted_largest_shares": planted_shares[:5]}


def _method_train(method, cfg, views, per_step):
    """``method``'s recipe at full width in bf16: warm-up steps, then
    METHOD_TRAIN_STEPS counted and timed as the main path; checks the
    losses, the updates, the logit scale and the launches. -> (result,
    model, step, state, batch)."""
    import numpy as np
    import torch

    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import (
        make_train_step,
        method_of,
        new_train_state,
    )

    t0 = time.perf_counter()
    model = _method_build(cfg, cfg.precision.dtype)
    vis, txt = model.visual, model.encode_text
    check((vis.width, len(vis.transformer.resblocks), vis.patch_size,
           vis.input_resolution, txt.ln_final.normalized_shape[0],
           len(txt.transformer.resblocks), txt.vocab_size, vis.dtype,
           txt.dtype, method_of(model))
          == (768, 12, 32, 224, 512, 12, VOCAB, torch.bfloat16,
              torch.bfloat16, method),
          f"model is not {cfg.model.type} at full width in bf16")
    named = dict(model.named_parameters())
    max_iter = int(cfg.lr_scheduler.kwargs.max_iter)
    sched = scheduler_entry(cfg.lr_scheduler, max_iter=max_iter)
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip),
                     frozen_mask=path_prefix_mask(
                         named, vis.frozen_param_paths()))
    state = new_train_state(model=model, opt_state=tx.init(named),
                            bank_text=_seeded_method_bank(model))
    step = make_train_step(model, tx, cfg, sched, total_steps=max_iter)
    batch = _method_batch(np.random.default_rng(SEED), views)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in named.values())
    print(f"train {method}: {cfg.model.type} bf16, {n_params / 1e6:.1f} M "
          f"fp32 params, batch {TRAIN_BATCH}, set up in {setup_s:.1f} s",
          flush=True)
    history = []

    def run(n):
        steps = []
        for _ in range(n):
            _, metrics = step(state, batch)
            steps.append((metrics, model.logit_scale.detach().clone()))
        for metrics, scale in steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["logit_scale_param"] = float(scale)
            history.append(m)
            check(m["update_skipped"] == 0.0, f"a step was skipped: {m}")
            check(all(np.isfinite(v) for k, v in m.items()
                      if k.endswith("loss")), f"a loss is not finite: {m}")
            check(3.0 <= m["logit_scale_param"] <= 6.0,
                  f"logit_scale param outside [3, 6]: {m}")

    run(TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ptr0 = state.bank_text.ptr if state.bank_text is not None else None
    reset_launches()  # main path starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _CallCounter() as plain:
        t0 = time.perf_counter()
        start.record()
        run(METHOD_TRAIN_STEPS)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    launches = read_launches()  # main path ends
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = start.elapsed_time(end) / METHOD_TRAIN_STEPS
    losses = [m["loss"] for m in history]
    check(losses[-1] < losses[0], f"{method} loss did not fall: {losses}")
    check(launches == {k: n * METHOD_TRAIN_STEPS
                       for k, n in per_step.items()},
          f"{method}: {launches} kernel calls in {METHOD_TRAIN_STEPS} steps "
          f"(want {per_step} per step)")
    check(plain.calls + plain.cross == 0,
          f"{method}: {plain.calls + plain.cross} plain-version calls")
    result = {"launches": launches, "per_step": per_step,
              "steps": METHOD_TRAIN_STEPS,
              "warmup_steps": TRAIN_WARMUP_STEPS, "losses": losses,
              "history": history, "step_ms": step_ms,
              "host_step_ms": wall_s * 1e3 / METHOD_TRAIN_STEPS,
              "pairs_per_s": TRAIN_BATCH * 1e3 / step_ms,
              "peak_device_mib": peak_mib, "setup_s": setup_s}
    if ptr0 is not None:
        want_ptr = (ptr0 + 2 * TRAIN_BATCH * METHOD_TRAIN_STEPS) % \
            state.bank_text.bank.shape[0]
        check(state.bank_text.ptr == want_ptr,
              f"{method} bank pointer {state.bank_text.ptr}, want "
              f"{want_ptr}")
        result["bank_ptr"] = [ptr0, state.bank_text.ptr]
    print(f"train {method}: losses {[round(x, 4) for x in losses]}; last "
          f"step's terms {({k: round(v, 4) for k, v in history[-1].items() if k.endswith('loss')})}",
          flush=True)
    print(f"train {method}: {METHOD_TRAIN_STEPS} steps, {step_ms:.2f} "
          f"ms/step (CUDA events; host "
          f"{wall_s * 1e3 / METHOD_TRAIN_STEPS:.2f}), "
          f"{TRAIN_BATCH * 1e3 / step_ms:.1f} pairs/s, kernel calls "
          f"{launches}, peak device memory {peak_mib:.0f} MiB", flush=True)
    return result, model, step, state, batch


def _profile_method(method, result, step, state, batch):
    breakdown = profile_steps(lambda: step(state, batch), 3,
                              result["step_ms"])
    print(f"train {method}: device busy {breakdown['busy_ms']:.2f} ms/step, "
          f"idle share {breakdown['idle_share']:.1%}, K3+K4+K5 "
          f"{breakdown['li_ms']:.3f} ms ({breakdown['li_share']:.1%}), K1 "
          f"{breakdown['k1_ms']:.2f} ms, K2 {breakdown['k2_ms']:.2f} ms",
          flush=True)
    print(f"  by kind: {breakdown['by_kind_ms']}")
    for n, v in breakdown["top_kernels_ms"]:
        print(f"  {v:8.3f} ms  {n[:110]}")
    result.update(breakdown)


def phase_train_methods():
    """Phase 9: the DeFILIP and SLIP ViT-B/32 training slices (see the
    module docstring)."""
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models.layers import BatchNorm

    out = {}
    cfg = parse_config(DEFILIP_CONFIG)
    res, model, step, state, batch = _method_train(
        "defilip", cfg, 2, DEFILIP_PER_STEP)
    check((model.top_k, model.select_topk, model.return_filip,
           model.image_mapping.out_features,
           tuple(state.bank_text.bank.shape))
          == (16, True, True, 256, (2 ** 16, DEFILIP_BANK_DIM)),
          "the DeFILIP recipe's dense head or bank")
    _profile_method("defilip", res, step, state, batch)
    # the same model under dense_aug: the four pairings, each with its own
    # top-k selections
    model.dense_aug = True
    reset_launches()  # a main path starts
    for _ in range(2):
        _, m = step(state, batch)
        check(float(m["update_skipped"]) == 0.0
              and torch.isfinite(m["filip_loss"]).item(),
              f"dense_aug step: {m}")
    aug = read_launches()  # ... and ends
    check(aug == {k: 2 * n for k, n in DEFILIP_AUG_PER_STEP.items()},
          f"DeFILIP with dense_aug: {aug} kernel calls in 2 steps (want "
          f"{DEFILIP_AUG_PER_STEP} a step)")
    res["dense_aug_launches"] = aug
    print(f"train defilip with dense_aug: kernel calls {aug} in 2 steps",
          flush=True)
    del model, step, state
    torch.cuda.empty_cache()
    res.update(_method_fp32_step(DEFILIP_CONFIG, "defilip", batch,
                                 DEFILIP_PER_STEP))
    out["defilip"] = res
    del batch
    torch.cuda.empty_cache()

    cfg = parse_config(SLIP_CONFIG)
    res, model, step, state, batch = _method_train(
        "slip", cfg, 3, SLIP_PER_STEP)
    check((model.predictor_sim.linear1.in_features,
           model.predictor_sim.linear3.out_features,
           hasattr(model.predictor_sim, "bn3")) == (768, 256, False),
          "SLIP's predictor_sim is not the recipe's")
    bns = [m for m in model.predictor_sim.modules()
           if isinstance(m, BatchNorm)]
    stats0 = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    step(state, batch)
    for m, (mean0, var0) in zip(bns, stats0):
        check(bool(torch.isfinite(m.running_mean).all()
                   and torch.isfinite(m.running_var).all())
              and not torch.equal(m.running_mean, mean0)
              and not torch.equal(m.running_var, var0),
              "predictor_sim's BatchNorm statistics did not move, or are "
              "not finite")
    _profile_method("slip", res, step, state, batch)
    del model, step, state, bns, stats0
    torch.cuda.empty_cache()
    res.update(_method_fp32_step(SLIP_CONFIG, "slip", batch,
                                 SLIP_PER_STEP))
    out["slip"] = res
    del batch
    torch.cuda.empty_cache()
    return out


def solver_method_calls(solver, steps, per_step, dense, eval_batches):
    """The launches a solver run of ``method`` makes: ``per_step`` a step,
    and for the zero-shot eval at its end K1 once a text layer for each
    class-embedding chunk (min(512 // prompts, classes) classes a chunk
    when dense, 2048 // prompts pooled) and once an image layer for each
    eval batch (a ViT's), and K3 once an eval batch when dense."""
    model = solver.model
    layers = len(model.encode_text.transformer.resblocks)
    per_chunk = min((512 if dense else 2048) // SOLVER_PROMPTS,
                    SOLVER_CLASSES)
    chunks = -(-SOLVER_CLASSES // per_chunk)
    vis = getattr(model.visual, "transformer", None)
    image_layers = len(vis.resblocks) if vis is not None else 0
    want = {k: n * steps for k, n in per_step.items()}
    want["K1"] += chunks * layers + eval_batches * image_layers
    if dense:
        want["K3"] += eval_batches
    return want


def phase_solver_methods(tmp, corpus):
    """Phase 10: DeFILIP and SLIP-ResNet-50 through
    ``declip_tpu_torch.solver.main`` on phase 7's corpus, DeFILIP's
    zero-shot eval dense through K3."""
    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod
    from declip_tpu_torch.models.clip_model import l2_normalize
    from declip_tpu_torch.ops.filip_late_interaction import (
        late_interaction_logits_kernel,
    )
    from declip_tpu_torch.ops.filip_ops import late_interaction_logits

    out = {}
    n_val = SOLVER_CLASSES * SOLVER_PER_CLASS
    for name, recipe, steps in (("defilip", DEFILIP_RECIPE,
                                 DEFILIP_SOLVER_STEPS),
                                ("slip_r50", SLIP_R50_RECIPE,
                                 SLIP_SOLVER_STEPS)):
        cfg_path, sets = solver_experiment(tmp, f"exp_{name}", corpus,
                                           recipe, save_freq=2,
                                           save_many=None)
        exp = os.path.dirname(cfg_path)
        seen = []
        make_step = solver_mod.make_train_step

        def recording_make_train_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def recorded(state, batch):
                seen.append((batch["images"].dtype,
                             tuple(batch["images"].shape)))
                return step(state, batch)
            return recorded

        solver_mod.make_train_step = recording_make_train_step
        try:
            with _CallCounter() as plain:
                reset_launches()  # a main path starts
                t = time.perf_counter()
                solver = solver_mod.main(
                    ["--config", cfg_path, "--device", "cuda", "--set",
                     *sets, f"lr_scheduler.kwargs.max_iter={steps}"])
                wall_s = time.perf_counter() - t
                launches = read_launches()  # ... and ends
        finally:
            solver_mod.make_train_step = make_step
        st = solver.state
        tcfg = solver.test_cfgs[0]
        dense = solver.dense_eval(tcfg)
        method = "defilip" if name == "defilip" else "slip"
        views = 2 if method == "defilip" else 3
        check((solver.method, dense, solver.global_batch, st.step)
              == (method, method == "defilip", TRAIN_BATCH, steps),
              f"phase 10 {name}: method {solver.method}, dense {dense}, "
              f"batch {solver.global_batch}, step {st.step}")
        check(seen == [(torch.float32, (TRAIN_BATCH, 224, 224, 3 * views))]
              * steps, f"phase 10 {name}: the step's images {seen}")
        scalars = scalars_by_tag(os.path.join(exp, "events",
                                              "scalars.jsonl"))
        terms = [t for t in scalars if t.endswith("loss")]
        check(("filip_loss" if method == "defilip" else "simclr_loss")
              in terms, f"phase 10 {name}: loss terms {terms}")
        for tag in terms:
            values = [v for _, v in scalars[tag]]
            check(len(values) == steps and np.isfinite(values).all(),
                  f"phase 10 {name}: {tag} {values}")
        check([v for _, v in scalars["update_skipped"]] == [0.0] * steps,
              f"phase 10 {name}: skipped updates")
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        check(f"ckpt_{steps}.pth.tar" in ckpts, f"checkpoints {ckpts}")
        with open(os.path.join(exp, "results", "results.txt.rank0")) as f:
            n_results = sum(1 for _ in f)
        top = {k: scalars[f"eval0/{k}"][-1][1] for k in ("top1", "top5")}
        check(n_results == n_val and all(0 <= v <= 100
                                         for v in top.values()),
              f"phase 10 {name}: {n_results} results (want {n_val}), {top}")
        eval_batches = -(-n_val // int(tcfg["batch_size"]))
        per_step = DEFILIP_PER_STEP if method == "defilip" else {
            "K1": 12, "K2": 12, "K3": 0, "K4": 0, "K5": 0}
        want = solver_method_calls(solver, steps, per_step, dense,
                                   eval_batches)
        check(launches == want,
              f"phase 10 {name}: kernel calls {launches}, want {want}")
        check(plain.calls == 0, f"phase 10 {name}: {plain.calls} plain "
                                f"calls")
        res = {"launches": launches, "steps": steps, "wall_s": wall_s,
               "losses": [v for _, v in scalars["loss"]],
               "terms": {t: scalars[t][-1][1] for t in terms},
               "top1": top["top1"], "top5": top["top5"], "dense": dense,
               "eval_batches": eval_batches, "eval_s": solver.eval_seconds,
               "pooled_query_calls": plain.cross}
        if dense:
            # one eval batch's logits through K3 against the chunked plain
            # late interaction on the same features
            dataset, bs = solver._eval_loader(tcfg)
            label_texts, ensemble = dataset.get_label_texts()
            imgs = solver._padded(np.stack(
                [dataset[i]["image"] for i in range(bs)]), bs)
            with solver._eval_mode() as model:
                feats = l2_normalize(model.encode_image_dense(imgs))
                cls = solver.dense_class_embeddings(
                    model, label_texts, ensemble.shape[0])
                one = torch.ones((), device="cuda")
                k = late_interaction_logits_kernel(feats, cls, one)
                p = late_interaction_logits(feats, cls, one)
            ok, err, _ = _within(k, p, *EVAL_LI_TOLERANCE)
            check(ok and feats.dtype == cls.dtype == torch.bfloat16,
                  f"phase 10: an eval batch's K3 logits against the "
                  f"chunked plain late interaction: max abs err {err:.3g} "
                  f"(rtol, atol {EVAL_LI_TOLERANCE}); features "
                  f"{feats.dtype} x {cls.dtype}")
            res["eval_li_max_abs_err"] = err
            res["eval_li_shape"] = [*feats.shape, *cls.shape]
        out[name] = res
        print(f"solver {name}: {steps} steps of {recipe} in {wall_s:.1f} s; "
              f"losses {[round(x, 4) for x in res['losses']]}; zero-shot "
              f"({'dense, K3' if dense else 'pooled'}) top1 {top['top1']:.2f}"
              f" top5 {top['top5']:.2f} over {n_results}; kernel calls "
              f"{launches}; eval {solver.eval_seconds[-1]:.2f} s"
              + (f"; one eval batch, K3 vs the chunked plain late "
                 f"interaction: max abs err {res['eval_li_max_abs_err']:.3g}"
                 if dense else ""), flush=True)
        del solver, st
        torch.cuda.empty_cache()

    return out


# ---------------------------------------------------------------- phase 11
def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(nproc, entry, spec, timeout_s, during=None):
    """``python -m torch.distributed.run --nproc_per_node nproc`` on this
    script's rank entry ``entry`` with ``spec`` (which names the ranks'
    output directory, ``spec["out"]``); ``during()`` runs here while the
    ranks run. Every rank writes its pid and then its result there. A
    launch that fails or outlives ``timeout_s`` fails the phase, and its
    ranks are stopped: torchrun passes SIGTERM on to them, and any rank
    still running after that is killed. -> ([each rank's result], wall s,
    during's result)."""
    import pickle
    import signal

    out = spec["out"]
    os.makedirs(out)
    log = os.path.join(out, "launch.log")
    t = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
             "--master_port", str(free_port()),
             os.path.join(ROOT, "chip_smoke.py"), entry, json.dumps(spec)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            env={"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1)
                                            // nproc)),
                 **os.environ, "PYTHONPATH": os.pathsep.join(
                     [ROOT, os.environ.get("PYTHONPATH", "")])})
    try:
        done = during() if during is not None else None
        proc.wait(max(1.0, timeout_s - (time.perf_counter() - t)))
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            for r in range(nproc):
                try:
                    with open(os.path.join(out, f"pid{r}")) as f:
                        os.kill(int(f.read()), signal.SIGKILL)
                except (OSError, ValueError):  # gone, or never started
                    pass
    wall = time.perf_counter() - t
    with open(log) as f:
        tail = f.read()[-4000:]
    check(proc.returncode == 0, f"{entry}: torch.distributed.run rc "
                                f"{proc.returncode}: {tail}")
    results = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results, wall, done


def _rank_begin(spec):
    """The start of a rank entry: its pid where ``run_ranks`` reads it, no
    TF32 (fp32 means fp32), the checkout on the path -> the rank."""
    import torch

    rank = int(os.environ["RANK"])
    with open(os.path.join(spec["out"], f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return rank


def _rank_end(spec, rank, result):
    import pickle

    path = os.path.join(spec["out"], f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    return 0


def dp_launcher_rank(spec):
    """Phase 11a's rank: the solver's ``main`` to SOLVER_STEPS and again
    to DP_RESUME_STEPS (an auto-resume), with the gradient all-reduce
    timed by CUDA events and the eval's merges counted."""
    import torch

    rank = _rank_begin(spec)
    from declip_tpu_torch.parallel import comms
    from declip_tpu_torch.solver import main as solver_main
    from declip_tpu_torch.train import train_step

    events, merges = [], []
    inner_mean, inner_gather = train_step.mean_over_ranks, comms.gather_object

    def timed_mean(tensors, group):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner_mean(tensors, group)
        end.record()
        events.append((start, end))
        return out

    def counted_gather(obj, group=None):
        merges.append(1)
        return inner_gather(obj, group)

    train_step.mean_over_ranks = timed_mean
    comms.gather_object = counted_gather
    out = {}
    for name, max_iter in (("first", SOLVER_STEPS),
                           ("resume", DP_RESUME_STEPS)):
        del merges[:]
        reset_launches()  # a main path starts
        t = time.perf_counter()
        solver = solver_main(["--config", spec["cfg"], "--set",
                              *spec["sets"],
                              f"lr_scheduler.kwargs.max_iter={max_iter}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = solver.state.step - solver.start_step
        out[name] = {
            "launches": read_launches(), "wall_s": wall,
            "want": solver_kernel_calls(solver, steps),
            "start_step": solver.start_step, "step": solver.state.step,
            "world": solver.world, "rank": solver.rank,
            "device": str(solver.device),
            "backend": solver.group.backend if solver.group else None,
            "merges": len(merges), "timings": solver.timings,
            "batch": solver.global_batch,
            "grad_elems": sum(p.numel() for p in solver.model.parameters())}
    out["allreduce_ms"] = [s.elapsed_time(e) for s, e in events]
    return _rank_end(spec, rank, out)


def phase_dp_launcher(solver_result, tmp, corpus):
    """Phase 11a: ``python -m torch.distributed.run --nproc_per_node 1`` on
    this script's ``dp_launcher_rank``, which drives the solver's ``main``
    on phase 7's corpus with the DeCLIP-R50 recipe as its file has it
    (bf16, B=128): NCCL at world 1 through the real launcher, SOLVER_STEPS
    steps saved at the end, the zero-shot eval merged through
    ``gather_object``, and an auto-resume for one step."""
    import numpy as np

    cfg_path, sets = solver_experiment(tmp, "dp_exp", corpus, save_freq=0)
    exp = os.path.dirname(cfg_path)
    (res,), wall, _ = run_ranks(
        1, "--phase-11a-rank", {"cfg": cfg_path, "sets": sets,
                                "out": os.path.join(tmp, "dp_out")},
        DP_LAUNCH_TIMEOUT_S)
    first, resume = res["first"], res["resume"]
    for run in (first, resume):
        check((run["world"], run["rank"], run["backend"], run["device"])
              == (1, 0, "nccl", "cuda:0"),
              f"phase 11a: not NCCL at world 1 on cuda:0: {run}")
        check(run["launches"] == run["want"],
              f"phase 11a kernel calls {run['launches']}, want "
              f"{run['want']}")
        check(run["merges"] >= 1, "phase 11a: the eval merged nothing "
                                  "through gather_object")
    check((first["start_step"], first["step"], resume["start_step"],
           resume["step"]) == (0, SOLVER_STEPS, SOLVER_STEPS,
                               DP_RESUME_STEPS),
          f"phase 11a: runs {first['start_step']}->{first['step']}, "
          f"{resume['start_step']}->{resume['step']}")
    scalars = scalars_by_tag(os.path.join(exp, "events", "scalars.jsonl"))
    losses = [v for _, v in scalars["loss"]]
    skipped = [v for _, v in scalars["update_skipped"]]
    top = {k: scalars[f"eval0/{k}"][-1][1] for k in ("top1", "top5")}
    check(len(losses) == DP_RESUME_STEPS and np.isfinite(losses).all()
          and skipped == [0.0] * DP_RESUME_STEPS
          and all(0 <= v <= 100 for v in top.values()),
          f"phase 11a: losses {losses}, skipped {skipped}, eval {top}")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == sorted([f"ckpt_{SOLVER_STEPS}.pth.tar",
                           f"ckpt_{DP_RESUME_STEPS}.pth.tar",
                           "ckpt_meta.json"]),
          f"phase 11a checkpoints {ckpts}")
    window = solver_window(first["timings"], SOLVER_TIMED[0],
                           SOLVER_TIMED[1], first["batch"])
    ar = sorted(res["allreduce_ms"])
    launches = {k: first["launches"][k] + resume["launches"][k]
                for k in first["launches"]}
    out = {"wall_s": wall, "losses": losses, "top1": top["top1"],
           "top5": top["top5"], "launches": launches,
           "first_launches": first["launches"],
           "resume_launches": resume["launches"],
           "first_wall_s": first["wall_s"], "resume_wall_s": resume["wall_s"],
           "allreduce_ms": res["allreduce_ms"],
           "allreduce_ms_median": ar[len(ar) // 2],
           "grad_elems": first["grad_elems"], **window,
           "phase7_step_s": solver_result["step_s"],
           "phase7_step_s_without_saves":
               solver_result["step_s_without_saves"]}
    print(f"phase 11a: torch.distributed.run --nproc_per_node 1, NCCL at "
          f"world 1: {SOLVER_STEPS} steps of {DECLIP_RECIPE} (saved at "
          f"{SOLVER_STEPS}, then resumed to {DP_RESUME_STEPS}), zero-shot "
          f"top1 {top['top1']:.2f} top5 {top['top5']:.2f} merged through "
          f"gather_object, in {wall:.1f} s (the two runs "
          f"{first['wall_s']:.1f} s and {resume['wall_s']:.1f} s); steps "
          f"{SOLVER_TIMED[0]}-{SOLVER_TIMED[1]} (no save among them): "
          f"{window['step_s'] * 1e3:.2f} ms/step "
          f"({window['data_s'] * 1e3:.2f} waiting for data) beside phase "
          f"7's {solver_result['step_s_without_saves'] * 1e3:.2f} without "
          f"its save ({solver_result['step_s'] * 1e3:.2f} with it, "
          f"{solver_result['data_s'] * 1e3:.2f} waiting); the "
          f"gradient all-reduce of {first['grad_elems'] / 1e6:.1f} M fp32 "
          f"(flatten, all-reduce, unflatten) {out['allreduce_ms_median']:.3f}"
          f" ms a step on the device (median of {len(ar)}); kernel calls "
          f"{launches} (first run {first['launches']}, resume "
          f"{resume['launches']})", flush=True)
    return out


def _dp_case(name, world):
    """Phase 11b's case ``name`` ("declip", "declip_per_rank_bn",
    "filip", phase 12d's "ring" and "sigmoid_ring", and phase 16's
    "fsdp" and "ep") for a world of ``world``: (config text, overrides by
    tower, batch builder). The per-rank BatchNorm's one-process
    counterpart is the same batch in two BatchNorm groups; "ep" is the
    MoE CLIP at DP_EP_LAYERS layers a tower and a capacity that drops
    tokens."""
    if name == "filip":
        return FILIP_CONFIG, {}, _filip_batch
    if name in DP_RING_CASES:
        return clip_loss_config(name), {}, _clip_batch
    if name == "fsdp":
        return TRAIN_CONFIG, {}, _clip_batch
    if name == "ep":
        moe = {"moe": DP_EP_MOE}
        return TRAIN_CONFIG, {
            "image_encode": {"layers": DP_EP_LAYERS, **moe},
            "text_encode": {"transformer_layers": DP_EP_LAYERS, **moe}}, \
            _clip_batch
    extra = {}
    if name == "declip_per_rank_bn":
        extra = ({"use_sync_bn": False} if world > 1
                 else {"bn_stats_groups": DP_WORLD})
    return DECLIP_CONFIG, {"image_encode": extra}, _declip_batch


def dp_step(name, group):
    """One fp32 step of phase 11b's case ``name`` over ``group`` (None: one
    process on the whole batch) on this process's card: -> the loss,
    metrics, each parameter's gradient norm (averaged over the ranks), the
    bank rows the step wrote, the BatchNorm statistics, the launches and
    the step's wall ms."""
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.parallel.fsdp import (
        ShardPlan,
        make_plan,
        shard_train_state,
    )
    from declip_tpu_torch.parallel.mesh import bind_experts, make_mesh
    from declip_tpu_torch.train import (
        EmaConfig,
        init_ema,
        make_train_step,
        new_train_state,
    )

    world = 1 if group is None else group.size
    text, towers, make_batch = _dp_case(name, world)
    cfg = parse_config(text)
    kwargs = dict(cfg.model.kwargs)
    kwargs["dtype"] = "float32"
    for tower, extra in towers.items():
        kwargs[tower] = {**kwargs[tower], **extra}
    mcfg = {"type": cfg.model.type, "kwargs": kwargs}
    model = model_entry(mcfg, data_group=group)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model = model.cuda()
    named = dict(model.named_parameters())
    max_iter = int(cfg.lr_scheduler.kwargs.max_iter)
    sched = scheduler_entry(cfg.lr_scheduler, max_iter=max_iter)
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip),
                     frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    norms = {}
    update = tx.update_

    def capture(grads, *args, **kwargs):
        # a shard's norm over its group (every rank, in one order)
        plan = state.shards
        norms.update({n: (plan.global_norm({n: g}) if plan and n in
                          plan.shards else torch.linalg.vector_norm(
                              g.float())).item()
                      for n, g in grads.items()})
        return update(grads, *args, **kwargs)

    tx.update_ = capture
    # the FSDP case keeps an EMA, which FSDP shards too
    ema_cfg = EmaConfig(decay=0.999) if name == "fsdp" else None
    state = new_train_state(model=model, opt_state=tx.init(named),
                            ema_params=(init_ema(named, ema_cfg)
                                        if ema_cfg else None),
                            bank_text=_seeded_method_bank(model))
    if name in ("fsdp", "ep") and group is not None:
        mesh = make_mesh(group, group.size if name == "ep" else 1)
        bind_experts(model, mesh)
        shard_train_state(state, make_plan(
            model, group, fsdp=name == "fsdp", mesh=mesh), tx)
    held = (state.shards.resident_bytes(state) if state.shards
            else ShardPlan(model, {}).resident_bytes(state))
    step = make_train_step(model, tx, cfg, sched, total_steps=max_iter,
                           axis_name=group, ema_cfg=ema_cfg)
    batch = make_batch(np.random.default_rng(SEED))
    if group is not None:
        b = TRAIN_BATCH // group.size
        batch = {k: v[group.rank * b:(group.rank + 1) * b]
                 for k, v in batch.items()}
    ptr = None if state.bank_text is None else state.bank_text.ptr
    torch.cuda.synchronize()
    reset_launches()  # a main path starts
    t = time.perf_counter()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launches = read_launches()  # ... and ends
    written = 2 * TRAIN_BATCH
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grad_norms": norms, "launches": launches, "step_ms": step_ms,
           "held": held, "kept": [[int(x) for x in m.kept.tolist()]
                                  for _, m in _moe_blocks(model)],
           "bn": {k: v.cpu().numpy() for k, v in model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))},
           "bank": None if ptr is None else
           state.bank_text.bank[ptr:ptr + written].cpu().numpy()}
    del model, state, step, tx
    torch.cuda.empty_cache()
    return out


def dp_rank(spec):
    """Phase 11b's (and 11c's) rank: joins the group torchrun set up, on
    cuda:0 for gloo (two ranks sharing the one card) or cuda:<rank> for
    NCCL, and runs ``dp_step`` on each case."""
    rank = _rank_begin(spec)
    from declip_tpu_torch.parallel import data_group, init_distributed, \
        shutdown

    backend = spec["backend"]
    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    init_distributed(device, backend=backend, timeout_s=120)
    group = data_group()
    out = {name: dp_step(name, group) for name in spec["cases"]}
    shutdown()
    return _rank_end(spec, rank, out)


def _dp_compare(name, ranks, whole):
    """Phase 11b's checks of one case: -> the worst share of each limit."""
    import numpy as np

    r0 = ranks[0]
    for r in ranks[1:]:
        check(r["metrics"] == r0["metrics"]
              and r["grad_norms"] == r0["grad_norms"],
              f"phase 11 {name}: the ranks disagree on the step")
    loss, want = r0["metrics"]["loss"], whole["metrics"]["loss"]
    worst = {"loss": abs(loss - want) / (DP_RTOL * abs(want))}
    check(worst["loss"] <= 1, f"phase 11 {name}: loss {loss} vs one "
                              f"process {want}")
    total = sum(v * v for v in whole["grad_norms"].values()) ** 0.5
    floor = STEP_NOISE_REL_NORM * total
    shares = {}
    for p, n1 in whole["grad_norms"].items():
        n2 = r0["grad_norms"][p]
        if n1 <= floor:
            shares[p] = n2 / floor
        else:
            shares[p] = abs(n2 - n1) / (DP_RTOL * n1)
    top = sorted(shares.items(), key=lambda kv: -kv[1])[:5]
    worst["grad_norms"] = top[0][1]
    worst["grad_norms_top"] = top
    check(top[0][1] <= 1, f"phase 11 {name}: gradient norms over their "
                          f"limits (share of the limit): {top}")
    if whole["bank"] is not None:
        got, ref = r0["bank"], whole["bank"]
        for r in ranks[1:]:
            check(np.array_equal(r["bank"], got),
                  f"phase 11 {name}: the ranks' banks differ")
        err = np.abs(got - ref)
        limit = DP_BANK_ATOL + DP_RTOL * np.abs(ref)
        worst["bank"] = float((err / limit).max())
        check(worst["bank"] <= 1, f"phase 11 {name}: bank rows differ by "
                                  f"{err.max()}")
    shares = {}
    for k, ref in whole["bn"].items():
        got = r0["bn"][k]
        for r in ranks[1:]:
            check(np.array_equal(r["bn"][k], got),
                  f"phase 11 {name}: the ranks' {k} differ")
        # a running mean in units of its feature's deviation: after a
        # BatchNorm the next one's input mean is 0 up to rounding
        scale = np.linalg.norm(ref)
        if k.endswith("running_mean"):
            var = whole["bn"][k[:-len("mean")] + "var"]
            scale = max(scale, np.linalg.norm(np.sqrt(var)))
        shares[k] = float(np.linalg.norm(got - ref) / (DP_RTOL * scale))
    if shares:
        top = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
        worst["bn"], worst["bn_top"] = top[0][1], top
        check(top[0][1] <= 1, f"phase 11 {name}: BatchNorm statistics "
                              f"over their limits (share of the limit): "
                              f"{top}")
    return worst


def phase_dp_two_ranks(tmp, backend="gloo", cases=None):
    """Phase 11b (gloo, two ranks sharing the one card) or 11c (NCCL, one
    card a rank): DeCLIP-R50 at full width in fp32 with BatchNorm over the
    global batch and, ``use_sync_bn: false``, over each rank's rows, then
    FILIP ViT-B/32 (K3-K5 at 64 queries against 128 keys), then phase
    12d's CLIP ViT-B/32 under ``loss_impl`` ring and sigmoid_ring (the
    blocks moving by the differentiable shift, through host memory under
    gloo), each rank on
    half of the batch, one step against one process on the whole batch
    from the same weights (the MLM masks are the batch's, no draw is
    keyed by the rank)."""
    import torch

    cases = cases or ("declip", "declip_per_rank_bn", "filip",
                      *DP_RING_CASES, "fsdp", "ep")
    # the one-process references run here while the ranks run
    ranks, wall, wholes = run_ranks(
        DP_WORLD, "--phase-11b-rank",
        {"cases": cases, "backend": backend,
         "out": os.path.join(tmp, f"dp_{backend}")},
        DP_JOIN_TIMEOUT_S,
        during=lambda: {name: dp_step(name, None) for name in cases})
    out = {"backend": backend, "wall_s": wall}
    failed = []
    for name in cases:
        whole = wholes.pop(name)
        rows = [r[name] for r in ranks]
        try:
            worst = _dp_compare(name, rows, whole)
        except AssertionError as e:  # the other cases still report
            failed.append(str(e))
            worst = {"failed": str(e)}
        per_step = {"declip": 24, "declip_per_rank_bn": 24, "filip": 24,
                    "ring": 24, "sigmoid_ring": 24, "fsdp": 24,
                    "ep": 2 * DP_EP_LAYERS}
        li = 2 if name == "filip" else 0
        want = {"K1": per_step[name], "K2": per_step[name], "K3": li,
                "K4": li, "K5": li}
        for i, r in enumerate(rows):
            check(r["launches"] == want,
                  f"phase 11 {name}: rank {i} kernel calls "
                  f"{r['launches']}, want {want}")
        out[name] = {"launches": [r["launches"] for r in rows],
                     "step_ms": [r["step_ms"] for r in rows],
                     "one_process_step_ms": whole["step_ms"],
                     "loss": rows[0]["metrics"]["loss"],
                     "one_process_loss": whole["metrics"]["loss"],
                     "worst_share": worst}
        if name in ("fsdp", "ep"):
            out[name]["held_by_rank"] = [r["held"] for r in rows]
            out[name]["held_one_process"] = whole["held"]
            share = {k: [r["held"][k] / max(whole["held"][k], 1)
                         for r in rows] for k in whole["held"]}
            out[name]["held_share"] = share
            print(f"phase 11 ({backend}) {name}: bytes each rank holds "
                  f"(params, parameter slots, Adafactor's leaf slots, EMA) "
                  f"{[r['held'] for r in rows]} against one process's "
                  f"{whole['held']}: shares {share}", flush=True)
            if name == "fsdp":
                check(all(0.45 < x < 0.75 for k in ("params", "slots",
                                                    "ema")
                          for x in share[k]),
                      f"phase 11 fsdp: each rank should hold about half: "
                      f"{share}")
        if name == "ep":
            # every rank counts the global batch's choices; one process's
            # may differ by a near tie in a router (printed)
            kept = rows[0]["kept"]
            check(all(r["kept"] == kept for r in rows),
                  f"phase 11 ep: kept choices by rank "
                  f"{[r['kept'] for r in rows]}")
            out[name]["kept_one_process"] = whole["kept"]
            tokens = [TRAIN_BATCH * (50 if i < DP_EP_LAYERS else 77)
                      for i in range(len(kept))]
            drops = [_dropped_share(k, n, MOE["top_k"])
                     for k, n in zip(kept, tokens)]
            out[name]["dropped_share"] = drops
            check(max(drops) > 0, f"phase 11 ep: no token dropped {drops}")
            print(f"phase 11 ({backend}) ep: dropped share by block "
                  f"{[round(d, 4) for d in drops]}; kept choices by block "
                  f"{kept}, one process {whole['kept']}", flush=True)
        print(f"phase 11 ({backend}, {DP_WORLD} ranks) {name}: loss "
              f"{rows[0]['metrics']['loss']:.6f} vs one process "
              f"{whole['metrics']['loss']:.6f}; the worst share of each "
              f"limit {worst}; kernel calls by rank "
              f"{out[name]['launches']}; step ms by rank "
              f"{[round(x, 1) for x in out[name]['step_ms']]}"
              + (" (two ranks sharing one card over gloo, not a "
                 "performance number)" if backend == "gloo" else ""),
              flush=True)
        del whole
        torch.cuda.empty_cache()
    check(not failed, f"phase 11 ({backend}): {failed}")
    return out


def phase_data_parallel(solver_result, tmp, corpus, tools_result):
    """Phase 11: 11a, 11b (with phase 7's CLI evaluation and phase 14's
    exports beside it) and 11c -> (its result, the exports still to be
    read by :func:`phase_serving_exports`)."""
    import torch

    out = {"launcher": phase_dp_launcher(solver_result, tmp, corpus)}
    cli = start_solver_cli(solver_result, tmp)
    exports = start_serving_exports(tools_result)
    try:
        out["gloo_one_card"] = phase_dp_two_ranks(tmp, "gloo")
    except BaseException:
        stop_serving_exports(exports)
        raise
    finally:
        finish_solver_cli(cli, solver_result)
    n = torch.cuda.device_count()
    if n >= DP_WORLD:
        out["nccl"] = phase_dp_two_ranks(tmp, "nccl")
    else:
        out["nccl"] = None
        print(f"phase 11c (NCCL at world {DP_WORLD}): not run, this "
              f"machine has {n} card(s) and NCCL refuses two ranks on one "
              f"device; not counted as passed", flush=True)
    return out, exports


# ---------------------------------------------------------------- phase 12
def clip_loss_config(kind):
    """TRAIN_CONFIG (the YFCC15M ViT-CLIP recipe) under ``loss_impl``
    ``kind`` (chunk LOSS_IMPL_CHUNK), with a SigLIP logit bias (-10) for
    the sigmoid kinds."""
    text = TRAIN_CONFIG
    if kind.startswith("sigmoid"):
        text = text.replace("clip: {use_allgather: True}",
                            "clip: {use_allgather: True, "
                            "logit_bias_init: -10.0}")
    return text + (f"loss_impl: {{type: {kind}, "
                   f"chunk_size: {LOSS_IMPL_CHUNK}}}\n")


def _clip_batch(rng):
    """B=128 seeded images and SOT/EOT token rows, on the card."""
    import numpy as np
    import torch

    return {"images": torch.from_numpy(rng.normal(
                size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
            "tokens": torch.from_numpy(_tokens(rng, TRAIN_BATCH)).cuda()}


def _host_slots(opt_state):
    return {slot: {k: t.detach().cpu().clone() for k, t in tensors.items()}
            for slot, tensors in opt_state.slots.items()}


def _solver_checks(label, solver, exp, steps, per_step, eval_batches,
                   launches):
    """The checks phases 10 and 12 make of a solver run of ``steps`` steps:
    losses finite, no update skipped, the exact launches, 160 zero-shot
    results in range -> (scalars, top-1/top-5)."""
    import numpy as np

    scalars = scalars_by_tag(os.path.join(exp, "events", "scalars.jsonl"))
    for tag in [t for t in scalars if t.endswith("loss")]:
        values = [v for _, v in scalars[tag]]
        check(len(values) == steps and np.isfinite(values).all(),
              f"{label}: {tag} {values}")
    check([v for _, v in scalars["update_skipped"]] == [0.0] * steps,
          f"{label}: skipped updates")
    want = solver_method_calls(solver, steps, per_step, False, eval_batches)
    check(launches == want, f"{label}: kernel calls {launches}, want {want}")
    n_val = SOLVER_CLASSES * SOLVER_PER_CLASS
    with open(os.path.join(exp, "results", "results.txt.rank0")) as f:
        n_results = sum(1 for _ in f)
    top = {k: scalars[f"eval0/{k}"][-1][1] for k in ("top1", "top5")}
    check(n_results == n_val and all(0 <= v <= 100 for v in top.values()),
          f"{label}: {n_results} results (want {n_val}), {top}")
    return scalars, top


def phase_siglip_solver(tmp, corpus, train_result):
    """Phase 12a: the yfcc15m_vit_siglip recipe through the solver's
    ``main`` on phase 7's corpus (only the data paths and frequencies
    set): SIGLIP_STEPS steps, saved at the end, the zero-shot eval, then a
    run resumed from that checkpoint for one step, whose restored
    Adafactor slots must equal the saved ones bit for bit."""
    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod

    cfg_path, sets = solver_experiment(tmp, "exp_siglip", corpus,
                                       SIGLIP_RECIPE, save_freq=SIGLIP_STEPS)
    exp = os.path.dirname(cfg_path)
    restored = {}
    real_restore = solver_mod.restore_checkpoint

    def recording_restore(path, state):
        out = real_restore(path, state)
        restored["slots"] = _host_slots(state.opt_state)
        restored["counts"] = (state.opt_state.count,
                              state.opt_state.sched_count, state.step)
        return out

    runs = {}
    solver_mod.restore_checkpoint = recording_restore
    try:
        for name, steps in (("first", SIGLIP_STEPS),
                            ("resume", SIGLIP_STEPS + 1)):
            with _CallCounter() as plain:
                reset_launches()  # a main path starts
                t = time.perf_counter()
                solver = solver_mod.main(
                    ["--config", cfg_path, "--device", "cuda", "--set",
                     *sets, f"lr_scheduler.kwargs.max_iter={steps}"])
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                launches = read_launches()  # ... and ends
            check(plain.calls == 0, f"phase 12a {name}: {plain.calls} plain "
                                    f"calls")
            st = solver.state
            eval_batches = -(-SOLVER_CLASSES * SOLVER_PER_CLASS
                             // TRAIN_BATCH)
            runs[name] = {"launches": launches, "wall_s": wall_s,
                          "start_step": solver.start_step, "step": st.step,
                          "timings": list(solver.timings),
                          "want": solver_method_calls(
                              solver, st.step - solver.start_step,
                              CLIP_PER_STEP, False, eval_batches)}
            if name == "first":
                vis = solver.model.visual
                check((solver.method, type(solver.tx).__name__,
                       solver.config.loss_impl.type, solver.global_batch,
                       vis.width, len(vis.transformer.resblocks), vis.dtype,
                       st.step)
                      == ("clip", "AdafactorRule", "sigmoid_ring",
                          TRAIN_BATCH, 768, 12, torch.bfloat16,
                          SIGLIP_STEPS),
                      f"phase 12a: not the SigLIP recipe at full width")
                saved = _host_slots(st.opt_state)
                scalars, top = _solver_checks(
                    "phase 12a", solver, exp, SIGLIP_STEPS, CLIP_PER_STEP,
                    eval_batches, launches)
                bias = [v for _, v in scalars["logit_bias"]]
                check(len(bias) == SIGLIP_STEPS and bias[0] == -10.0
                      and bias[-1] != -10.0 and np.isfinite(bias).all(),
                      f"phase 12a: logit_bias {bias}")
                runs[name].update(
                    losses=[v for _, v in scalars["loss"]], logit_bias=bias,
                    top1=top["top1"], top5=top["top5"],
                    window=solver_window(solver.timings, *SOLVER_TIMED,
                                         TRAIN_BATCH),
                    state_mib=state_bytes_mib(st.opt_state))
            del solver, st
            torch.cuda.empty_cache()
    finally:
        solver_mod.restore_checkpoint = real_restore
    resume = runs["resume"]
    check((resume["start_step"], resume["step"], restored.get("counts"))
          == (SIGLIP_STEPS, SIGLIP_STEPS + 1, (SIGLIP_STEPS,) * 3),
          f"phase 12a: resumed {resume['start_step']} -> {resume['step']}, "
          f"restored counts {restored.get('counts')}")
    check(sorted(saved) == sorted(restored["slots"]) and all(
        torch.equal(t, restored["slots"][slot][k])
        for slot, tensors in saved.items() for k, t in tensors.items()),
        "phase 12a: the resumed run's Adafactor slots differ from the "
        "saved ones")
    check(resume["launches"] == resume["want"],
          f"phase 12a resume: kernel calls {resume['launches']}, want "
          f"{resume['want']}")
    first = runs["first"]
    window = first["window"]
    out = {**first, "resume": resume, "slots": sorted(saved),
           "phase4_step_ms": train_result["step_ms"],
           "step_ratio_to_phase4": window["step_s_without_saves"] * 1e3
           / train_result["step_ms"]}
    print(f"phase 12a: {SIGLIP_STEPS} steps of {SIGLIP_RECIPE} in "
          f"{first['wall_s']:.1f} s; losses "
          f"{[round(x, 4) for x in first['losses']]}; logit_bias "
          f"{[round(x, 4) for x in first['logit_bias']]}; zero-shot top1 "
          f"{first['top1']:.2f} top5 {first['top5']:.2f}; steps "
          f"{SOLVER_TIMED[0]}-{SOLVER_TIMED[1]}: "
          f"{window['step_s'] * 1e3:.2f} ms/step, "
          f"{window['pairs_per_s']:.1f} pairs/s "
          f"({window['step_s_without_saves'] * 1e3:.2f} ms without the "
          f"save, {window['data_s'] * 1e3:.2f} waiting for data), against "
          f"phase 4's repeated-batch step {train_result['step_ms']:.2f} ms "
          f"(ratio {out['step_ratio_to_phase4']:.3f}); Adafactor state "
          f"{first['state_mib']:.1f} MiB; kernel calls {first['launches']}; "
          f"resumed at {SIGLIP_STEPS} with its slots {sorted(saved)} bit "
          f"for bit, kernel calls {resume['launches']}", flush=True)
    return out


def state_bytes_mib(opt_state):
    from declip_tpu_torch.optim import state_bytes

    return state_bytes(opt_state) / 2 ** 20


def optimizer_cost():
    """Phase 12a's optimizer numbers: one update of the SigLIP recipe's
    Adafactor and of the ViT-CLIP recipe's AdamW on CLIP ViT-B/32 at full
    width (seeded gradients): device ms by the profiler (CUDA-event ms
    beside it) and the state's MiB, with AdamW's 2 x |P| fp32."""
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )

    siglip = parse_config(os.path.join(ROOT, SIGLIP_RECIPE))
    clip = parse_config(TRAIN_CONFIG)
    kwargs = dict(siglip.model.kwargs)
    kwargs["dtype"] = siglip.precision.dtype
    model = model_entry({"type": siglip.model.type, "kwargs": kwargs})
    model.init_weights(torch.Generator().manual_seed(SEED))
    model = model.cuda()
    named = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = {n: 1e-3 * torch.randn(p.shape, device="cuda", generator=gen)
             for n, p in named.items()}
    n_params = sum(p.numel() for p in named.values())
    out = {"params": n_params, "adamw_2p_mib": 2 * 4 * n_params / 2 ** 20}
    for label, cfg in (("Adafactor", siglip), ("AdamW", clip)):
        sched = scheduler_entry(cfg.lr_scheduler,
                                max_iter=int(cfg.lr_scheduler.kwargs.max_iter))
        tx = optim_entry(cfg.optimizer, model, sched,
                         pconfig=cfg.optimizer.pconfig,
                         grad_clip=dict(cfg.grad_clip),
                         frozen_mask=path_prefix_mask(
                             named, model.visual.frozen_param_paths()))
        st = tx.init(named)

        def update(tx=tx, st=st):
            tx.update_(grads, st, named, grad_norm=0.5)

        dev_ms, _ = device_ms(update, iters=5)
        out[label] = {"device_ms": dev_ms,
                      "event_ms": cuda_ms(update, iters=5, warmup=1),
                      "state_mib": state_bytes_mib(st)}
        del tx, st
    print(f"phase 12a optimizers on CLIP ViT-B/32 ({n_params / 1e6:.1f} M "
          f"fp32 params): Adafactor {out['Adafactor']} against AdamW "
          f"{out['AdamW']} (device ms by the profiler, None where it saw no "
          f"device events; CUDA-event ms; state MiB; AdamW's 2 x |P| fp32 "
          f"{out['adamw_2p_mib']:.1f} MiB)", flush=True)
    del model, grads
    torch.cuda.empty_cache()
    return out


def phase_declip88m_solver(tmp, corpus):
    """Phase 12b: the declip88m_vitb32_declip recipe through the solver's
    ``main`` on phase 7's corpus (the data paths, frequencies and its
    pretrain path, a file this machine has not, set): DECLIP88M_STEPS
    steps of DeCLIP ViT-B/32 at embed 3072 with the 2^16 x 3072 bank, SGD
    with nesterov and the abs-min guard, then its zero-shot eval."""
    import torch

    from declip_tpu_torch import solver as solver_mod

    cfg_path, sets = solver_experiment(tmp, "exp_declip88m", corpus,
                                       DECLIP88M_RECIPE, save_freq=0,
                                       save_many=None)
    exp = os.path.dirname(cfg_path)
    with _CallCounter() as plain:
        reset_launches()  # a main path starts
        t = time.perf_counter()
        solver = solver_mod.main(
            ["--config", cfg_path, "--device", "cuda", "--set", *sets,
             "saver.pretrain.path=null",
             f"lr_scheduler.kwargs.max_iter={DECLIP88M_STEPS}"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = read_launches()  # ... and ends
    check(plain.calls == 0, f"phase 12b: {plain.calls} plain calls")
    st, model = solver.state, solver.model
    batch = solver.global_batch
    tx = solver.tx
    check((solver.method, type(tx).__name__, tx.nesterov, tx.momentum,
           model.visual.width, len(model.visual.transformer.resblocks),
           tuple(st.bank_text.bank.shape), st.step)
          == ("declip", "SGDRule", True, 0.9, 768, 12, (2 ** 16, 3072),
              DECLIP88M_STEPS),
          "phase 12b: not the DeCLIP-88M ViT-B/32 recipe at full width")
    check(st.bank_text.ptr == 2 * batch * DECLIP88M_STEPS % 2 ** 16,
          f"phase 12b: bank pointer {st.bank_text.ptr}")
    scale = float(st.params["logit_scale"].detach()[0])
    check(scale >= 3.0, f"phase 12b: logit_scale {scale} under the "
                        f"abs-min guard's 3")
    scalars, top = _solver_checks(
        "phase 12b", solver, exp, DECLIP88M_STEPS, DECLIP_VIT_PER_STEP,
        -(-SOLVER_CLASSES * SOLVER_PER_CLASS // batch), launches)
    out = {"launches": launches, "wall_s": wall_s, "batch": batch,
           "losses": [v for _, v in scalars["loss"]],
           "terms": {t: scalars[t][-1][1] for t in scalars
                     if t.endswith("loss")},
           "logit_scale": scale, "bank_ptr": st.bank_text.ptr,
           "top1": top["top1"], "top5": top["top5"],
           "state_mib": state_bytes_mib(st.opt_state),
           "params": sum(p.numel() for p in model.parameters())}
    print(f"phase 12b: {DECLIP88M_STEPS} steps of {DECLIP88M_RECIPE} "
          f"(batch {batch}, {out['params'] / 1e6:.1f} M params, bank "
          f"{tuple(st.bank_text.bank.shape)}) in {wall_s:.1f} s; losses "
          f"{[round(x, 4) for x in out['losses']]}; logit_scale {scale:.4f}; "
          f"bank pointer {st.bank_text.ptr}; zero-shot top1 "
          f"{top['top1']:.2f} top5 {top['top5']:.2f}; SGD state "
          f"{out['state_mib']:.1f} MiB; kernel calls {launches}", flush=True)
    del solver, st, model, tx
    torch.cuda.empty_cache()
    return out


def _grads_rel(label, names, grads, ref):
    """Each parameter's ||g - g_ref|| / ||g_ref|| (0 where both are 0),
    checked against LOSS_IMPL_GRAD_REL_NORM -> the worst three."""
    import torch

    rel = {}
    for n, a, b in zip(names, grads, ref):
        norm = torch.linalg.vector_norm(b).item()
        diff = torch.linalg.vector_norm(a - b).item()
        rel[n] = diff / norm if norm > 0 else diff
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    check(worst[0][1] <= LOSS_IMPL_GRAD_REL_NORM,
          f"{label}: gradients beyond {LOSS_IMPL_GRAD_REL_NORM} of their "
          f"reference's norm: {worst}")
    return worst


def phase_loss_impl():
    """Phase 12c: one fp32 loss and gradient of CLIP ViT-B/32 at B=128
    through the kernels under each chunked and ring kind against its full
    kind, then GradCache's three passes against the unchunked step (the
    re-forward's outputs bit for bit the embedding pass's); then the bf16
    train step with and without GradCache: peak device memory and step
    time, and its device busy time by the profiler."""
    import numpy as np
    import torch

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import (
        make_losses_from_out,
        make_train_step,
        new_train_state,
    )
    from declip_tpu_torch.train.grad_cache import cached_value_and_grad

    batch = _clip_batch(np.random.default_rng(SEED))

    def build(kind, dtype):
        cfg = parse_config(clip_loss_config(kind))
        kwargs = dict(cfg.model.kwargs)
        kwargs["dtype"] = dtype
        model = model_entry({"type": cfg.model.type, "kwargs": kwargs})
        model.init_weights(torch.Generator().manual_seed(SEED))
        return cfg, model.cuda()

    def loss_grads(kind, model):
        from_out = make_losses_from_out(parse_config(clip_loss_config(kind)),
                                        "clip")
        total, _ = from_out(model, None, model(batch))
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return float(total.detach()), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]

    out = {"kinds": {}}
    with _CallCounter() as plain:
        reset_launches()  # a main path starts
        for ref_kind in ("full", "sigmoid"):
            _, model = build(ref_kind, "float32")
            names = [n for n, _ in model.named_parameters()]
            ref_loss, ref = loss_grads(ref_kind, model)
            for kind, base in LOSS_IMPL_CASES:
                if base != ref_kind:
                    continue
                loss, grads = loss_grads(kind, model)
                err = abs(loss - ref_loss) / abs(ref_loss)
                check(err <= LOSS_IMPL_RTOL, f"phase 12c {kind}: loss {loss} "
                                             f"vs {base} {ref_loss}")
                worst = _grads_rel(f"phase 12c {kind}", names, grads, ref)
                out["kinds"][kind] = {"loss": loss, "ref_loss": ref_loss,
                                      "loss_rel_err": err,
                                      "worst_grad_rel_norm": worst}
                del grads
            if ref_kind == "full":
                # GradCache's three passes against the unchunked step
                diff = {}
                named = dict(model.named_parameters())
                total, _, _, cached = cached_value_and_grad(
                    model, make_losses_from_out(
                        parse_config(clip_loss_config("full")), "clip"),
                    None, batch, GRAD_CACHE_CHUNKS, named,
                    reforward_diff=diff)
                total = float(total.detach())
                err = abs(total - ref_loss) / abs(ref_loss)
                check(err <= LOSS_IMPL_RTOL, f"phase 12c grad_cache: loss "
                                             f"{total} vs {ref_loss}")
                worst = _grads_rel("phase 12c grad_cache", names,
                                   [cached[n] for n in names], ref)
                check(diff["max_abs"] == 0.0,
                      f"phase 12c grad_cache: the re-forward differs from "
                      f"the embedding pass by {diff['max_abs']}")
                out["grad_cache_fp32"] = {
                    "loss_rel_err": err, "worst_grad_rel_norm": worst,
                    "reforward_max_abs_diff": diff["max_abs"]}
                del cached
            del model, ref
            torch.cuda.empty_cache()
        launches = read_launches()  # ... and ends
    # six losses of 24 K1 and 24 K2; GradCache's M chunks twice forward
    # and once backward
    want = {"K1": 6 * 24 + 2 * GRAD_CACHE_CHUNKS * 24,
            "K2": 6 * 24 + GRAD_CACHE_CHUNKS * 24, "K3": 0, "K4": 0, "K5": 0}
    check(launches == want and plain.calls == 0,
          f"phase 12c: kernel calls {launches}, want {want}; plain calls "
          f"{plain.calls}")
    out["launches"] = launches

    # the bf16 train step of the recipe with and without GradCache
    steps = {}
    for label, chunks in (("unchunked", 0), ("grad_cache", GRAD_CACHE_CHUNKS)):
        cfg, model = build("full", "bfloat16")
        if chunks:
            cfg["grad_cache"] = {"chunks": chunks}
        named = dict(model.named_parameters())
        sched = scheduler_entry(cfg.lr_scheduler,
                                max_iter=int(cfg.lr_scheduler.kwargs.max_iter))
        tx = optim_entry(cfg.optimizer, model, sched,
                         pconfig=cfg.optimizer.pconfig,
                         grad_clip=dict(cfg.grad_clip),
                         frozen_mask=path_prefix_mask(
                             named, model.visual.frozen_param_paths()))
        state = new_train_state(model=model, opt_state=tx.init(named))
        step = make_train_step(model, tx, cfg, sched)
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # a main path starts
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        for _ in range(GRAD_CACHE_TIMED_STEPS):
            _, metrics = step(state, batch)
            losses.append(metrics["loss"])
        end.record()
        end.synchronize()
        launches = read_launches()  # ... and ends
        n = GRAD_CACHE_TIMED_STEPS
        per = ({"K1": 2 * chunks * 24, "K2": chunks * 24} if chunks
               else {"K1": 24, "K2": 24})
        check(launches == {"K1": n * per["K1"], "K2": n * per["K2"],
                           "K3": 0, "K4": 0, "K5": 0},
              f"phase 12c bf16 {label}: kernel calls {launches}")
        losses = [float(x) for x in losses]
        check(np.isfinite(losses).all(), f"phase 12c bf16 {label}: losses "
                                         f"{losses}")
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        # device busy a step (None where the profiler saw no device event)
        busy_ms, _ = device_ms(lambda: step(state, batch), iters=2)
        steps[label] = {"step_ms": start.elapsed_time(end) / n,
                        "peak_mib": peak_mib, "busy_ms": busy_ms,
                        "launches": launches, "losses": losses}
        del state, step, tx, model, named
        torch.cuda.empty_cache()
    out["bf16"] = steps
    out["bf16"]["step_ratio"] = (steps["grad_cache"]["step_ms"]
                                 / steps["unchunked"]["step_ms"])
    out["bf16"]["peak_ratio"] = (steps["grad_cache"]["peak_mib"]
                                 / steps["unchunked"]["peak_mib"])
    print(f"phase 12c: fp32 CLIP ViT-B/32 at B={TRAIN_BATCH}, each kind "
          f"against its full kind: "
          + "; ".join(f"{k} loss rel err {v['loss_rel_err']:.2e}, worst "
                      f"grad {v['worst_grad_rel_norm'][0]}"
                      for k, v in out["kinds"].items())
          + f"; grad_cache ({GRAD_CACHE_CHUNKS} chunks) loss rel err "
          f"{out['grad_cache_fp32']['loss_rel_err']:.2e}, worst grad "
          f"{out['grad_cache_fp32']['worst_grad_rel_norm'][0]}, re-forward "
          f"max abs diff {out['grad_cache_fp32']['reforward_max_abs_diff']}"
          f"; kernel calls {out['launches']}", flush=True)
    print(f"phase 12c: bf16 train step, unchunked "
          f"{steps['unchunked']['step_ms']:.2f} ms (device busy "
          f"{steps['unchunked']['busy_ms']}) and "
          f"{steps['unchunked']['peak_mib']:.0f} MiB peak; grad_cache "
          f"{steps['grad_cache']['step_ms']:.2f} ms (device busy "
          f"{steps['grad_cache']['busy_ms']}) and "
          f"{steps['grad_cache']['peak_mib']:.0f} MiB peak (step x"
          f"{out['bf16']['step_ratio']:.3f}, peak x"
          f"{out['bf16']['peak_ratio']:.3f})", flush=True)
    return out


def phase_last_configs(tmp, corpus, train_result):
    """Phase 12a-c (12d runs inside phase 11b's launch)."""
    return {"siglip": phase_siglip_solver(tmp, corpus, train_result),
            "optimizers": optimizer_cost(),
            "declip88m": phase_declip88m_solver(tmp, corpus),
            "loss_impl": phase_loss_impl()}


# ---------------------------------------------------------------- phase 13
def _ssl_model(name, dtype, **image_encode):
    """``name`` (e.g. ``moco_vitb32``) with SSL_KWARGS, from seeded weights,
    on the card."""
    import torch

    from declip_tpu_torch.models import model_entry

    kwargs = {"dtype": dtype, **SSL_KWARGS[name.split("_")[0]]}
    if image_encode:
        kwargs["image_encode"] = image_encode
    model = model_entry({"type": name, "kwargs": kwargs})
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.cuda()


def _ssl_setup(model):
    """MoCo-v2's SGD, the train state (with the seeded key encoder and
    queue for MoCo and CLSA) and the step. -> (state, step, tx)."""
    import torch

    from declip_tpu_torch.models.ssl_builders import init_moco_state
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.train import (
        make_train_step,
        method_of,
        new_train_state,
    )

    sched = scheduler_entry(SSL_SCHED, max_iter=100)
    named = dict(model.named_parameters())
    tx = optim_entry(SSL_OPT, model, sched, frozen_mask=path_prefix_mask(
        named, model.visual.frozen_param_paths()))
    ssl = None
    if method_of(model) != "simclr":
        ssl = init_moco_state(model, torch.Generator().manual_seed(SEED + 2),
                              model.K, model.dim)
    state = new_train_state(model=model, opt_state=tx.init(named), ssl=ssl)
    return state, make_train_step(model, tx, {}, sched), tx


def _ssl_batch(seed, strong):
    """B=128 seeded two-view images [B, 224, 224, 6] on the card, each view
    noise around a colour of its own, and a strong view [B, r, r, 3] for
    each r of ``strong``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def views(res, c):
        return (torch.randn(TRAIN_BATCH, res, res, c, generator=g,
                            device="cuda")
                + torch.randn(TRAIN_BATCH, 1, 1, c, generator=g,
                              device="cuda"))

    batch = {"images": views(224, 6)}
    for i, r in enumerate(strong):
        batch[f"images_strong_{i}"] = views(r, 3)
    return batch


def _ssl_train(name, profile):
    """13a: ``name`` at full width in bf16, SSL_WARMUP_STEPS, then SSL_STEPS
    counted and timed as the main path; with ``profile`` (the profiler
    sees the card), the device's busy time."""
    import numpy as np
    import torch

    from declip_tpu_torch.train import method_of

    method = name.split("_")[0]
    strong = SSL_STRONG if method == "clsa" else ()
    t0 = time.perf_counter()
    model = _ssl_model(name, "bfloat16")
    vis = model.visual
    check((vis.width, len(vis.transformer.resblocks), vis.patch_size,
           vis.input_resolution, vis.embed_dim, model.hidden_dim, model.dim,
           vis.dtype, method_of(model))
          == (768, 12, 32, 224, 2048, 2048, 128, torch.bfloat16, method),
          f"{name} is not ViT-B/32 at full width in bf16")
    state, step, _ = _ssl_setup(model)
    batch = _ssl_batch(SEED, strong)
    setup_s = time.perf_counter() - t0
    history = []
    for _ in range(SSL_WARMUP_STEPS):
        step(state, batch)
    torch.cuda.synchronize()
    ptr0 = None if state.ssl is None else state.ssl.queue_ptr
    reset_launches()  # the main path starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _CallCounter() as plain:
        t = time.perf_counter()
        start.record()
        for _ in range(SSL_STEPS):
            history.append(step(state, batch)[1])
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t
    launches = read_launches()  # ... and ends
    step_ms = start.elapsed_time(end) / SSL_STEPS
    history = [{k: float(v) for k, v in m.items()} for m in history]
    for m in history:
        check(m["update_skipped"] == 0.0 and all(
            np.isfinite(v) for k, v in m.items() if k.endswith("loss")),
            f"{name}: a skipped or non-finite step {m}")
    want = {k: n * SSL_STEPS for k, n in SSL_PER_STEP[method].items()}
    check(launches == want, f"{name}: kernel calls {launches} in "
                            f"{SSL_STEPS} steps, want {want}")
    check(plain.calls + plain.cross == 0,
          f"{name}: {plain.calls + plain.cross} plain-version calls")
    result = {"launches": launches, "per_step": SSL_PER_STEP[method],
              "steps": SSL_STEPS, "history": history, "step_ms": step_ms,
              "host_step_ms": wall_s * 1e3 / SSL_STEPS,
              "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
              "setup_s": setup_s, "strong": list(strong)}
    if ptr0 is not None:
        want_ptr = (ptr0 + TRAIN_BATCH * SSL_STEPS) % model.K
        check(state.ssl.queue_ptr == want_ptr,
              f"{name}: queue pointer {state.ssl.queue_ptr}, want {want_ptr}")
        result["queue_ptr"] = [ptr0, state.ssl.queue_ptr]
    busy = "device busy not measured (the profiler sees no device event)"
    if profile:
        result.update(profile_steps(lambda: step(state, batch), 2, step_ms))
        busy = (f"device busy {result['busy_ms']:.2f} ms/step (idle "
                f"{result['idle_share']:.1%}; K1 {result['k1_ms']:.2f} ms, "
                f"K2 {result['k2_ms']:.2f} ms; by kind "
                f"{result['by_kind_ms']})")
    print(f"ssl {name}: {SSL_STEPS} steps, {step_ms:.2f} ms/step (CUDA "
          f"events; host {result['host_step_ms']:.2f}), "
          f"{result['images_per_s']:.1f} images/s, {busy}; losses "
          f"{[round(m['loss'], 4) for m in history]}; kernel calls "
          f"{launches}", flush=True)
    del model, state, step, batch
    torch.cuda.empty_cache()
    return result


def _ssl_fp32_step(name):
    """13b: one fp32 step of ``name`` at SSL_CHECK_LAYERS layers through
    K1/K2 and through the plain attention path, from the same seeded
    weights, key encoder and queue: -> the readings; checks the loss
    within STEP_LOSS_RTOL, each parameter's ||g_k - g_p|| within
    STEP_GRAD_REL_NORM ||g_p||, the queue rows the step wrote (the key
    encoder's K1 forward) within STEP_GRAD_TOLERANCE's atol, and each
    path's launches. The key parameters after the step must be equal too,
    but no kernel reaches them: the momentum update takes them from the
    parameters before the step's update, so that check holds the step's
    order, not the attention path."""
    import torch

    from declip_tpu_torch.models.layers import MultiHeadAttention

    method = name.split("_")[0]
    strong = SSL_STRONG if method == "clsa" else ()
    batch = _ssl_batch(SEED + 1, strong)
    runs = {}
    for impl in ("auto", "xla"):
        model = _ssl_model(name, "float32", layers=SSL_CHECK_LAYERS)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = impl
        state, step, tx = _ssl_setup(model)
        grads = []
        update = tx.update_

        def capturing(g, *args, update=update, **kwargs):
            grads.append([t.detach().clone() for t in g.values()])
            return update(g, *args, **kwargs)

        tx.update_ = capturing
        ptr = state.ssl.queue_ptr
        before = read_launches()
        _, metrics = step(state, batch)
        used = {k: n - before[k] for k, n in read_launches().items()}
        views = 2 + len(strong)  # the query's, the key's, the strong ones
        want = ({"K1": SSL_CHECK_LAYERS * views,
                 "K2": SSL_CHECK_LAYERS * (views - 1)}
                if impl == "auto" else {"K1": 0, "K2": 0})
        check({k: used[k] for k in ("K1", "K2")} == want,
              f"fp32 {name} step with attn_impl {impl}: K1/K2 calls {used}"
              f", want {want}")
        check(float(metrics["update_skipped"]) == 0.0,
              f"fp32 {name} step skipped: {metrics}")
        runs[impl] = {"loss": float(metrics["loss"]), "grads": grads[0],
                      "names": list(dict(model.named_parameters())),
                      "queue": state.ssl.queue[ptr:ptr + TRAIN_BATCH].clone(),
                      "keys": [p.detach().clone() for p in
                               state.ssl.key_model.parameters()]}
        del model, state, step, tx
        torch.cuda.empty_cache()
    k, p = runs["auto"], runs["xla"]
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    rel = {}
    for n, a, b in zip(p["names"], k["grads"], p["grads"]):
        norm = torch.linalg.vector_norm(b).item()
        check(norm > 0, f"fp32 {name}: {n}'s gradient is 0 on the plain "
                        f"path")
        rel[n] = torch.linalg.vector_norm(a - b).item() / norm
    queue_err = (k["queue"] - p["queue"]).abs().max().item()
    keys_equal = all(torch.equal(a, b) for a, b in zip(k["keys"], p["keys"]))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    out = {"loss": {"kernels": k["loss"], "plain": p["loss"]},
           "loss_rel_err": loss_err, "max_grad_rel_norm_err": worst[0][1],
           "largest": worst, "queue_max_abs_err": queue_err,
           "key_params_equal": keys_equal, "layers": SSL_CHECK_LAYERS}
    print(f"ssl {name} fp32 at {SSL_CHECK_LAYERS} layers, kernels vs plain: "
          f"loss rel err {loss_err:.3g}, worst gradient {worst}, queue rows "
          f"max abs err {queue_err:.3g}; the key parameters (the momentum "
          f"update's order, no kernel) equal {keys_equal}", flush=True)
    check(loss_err <= STEP_LOSS_RTOL,
          f"fp32 {name}: loss rel err {loss_err:.3g}")
    check(worst[0][1] <= STEP_GRAD_REL_NORM,
          f"fp32 {name}: gradients beyond {STEP_GRAD_REL_NORM} of their "
          f"norms: {worst}")
    check(queue_err <= STEP_GRAD_TOLERANCE[1],
          f"fp32 {name}: the enqueued keys differ by {queue_err:.3g}")
    check(keys_equal, f"fp32 {name}: the key parameters differ")
    return out


def _ssl_short_rows():
    """13b: K1 (as the key encoder runs it, and with its log-sum-exp) and
    K2 at SSL_SHORT_CASES in fp32 and bf16, held as phases 2 and 2b hold
    them."""
    import torch

    fwd, bwd = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SSL_SHORT_CASES):
            row = attention_row(*case, dtype, 300 + i)
            fwd.append(row)
            print(f"attn B={case[0]} H={case[1]} L={case[2]} Dh={case[3]} "
                  f"{row['dtype']:8s} err {row['max_abs_err']:.2e} "
                  f"({row['limit_share']:.1%} of limit)  kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  sdpa "
                  f"{row['library_ms']:.4f}  bound {row['bound_ms']:.5f} "
                  f"({row['bound_by']})", flush=True)
            bwd.append(backward_row(*case, dtype, 400 + i))
            print_backward_row(bwd[-1])
    return {"fwd": fwd, "bwd": bwd}


def ssl_experiment(tmp, name, corpus, model_type, views):
    """SSL_RECIPE for ``model_type`` with ``views`` in ``tmp/name``, and
    the --set arguments phase 7 gives its data paths and frequencies. ->
    (config path, sets)."""
    exp = os.path.join(tmp, name)
    os.makedirs(exp)
    cfg_path = os.path.join(exp, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(SSL_RECIPE.replace("MODEL", model_type)
                .replace("VIEWS", views))
    return cfg_path, [
        f"data.train.root_dir={json.dumps([corpus['root']])}",
        f"data.train.meta_file={json.dumps([corpus['train_meta']])}",
        "saver.val_freq=0"]


def _ssl_host(ssl):
    """The SSL state on the host: the key encoder's state dict, the queue,
    the pointer."""
    return ({k: v.detach().cpu().clone()
             for k, v in ssl.key_model.state_dict().items()},
            ssl.queue.detach().cpu().clone(), ssl.queue_ptr)


def _ssl_solver(tmp, corpus, method, views, steps, resume):
    """13c-d: ``main`` trains ``<method>_res50`` with SSL_RECIPE and
    ``views`` for ``steps`` steps (the solver saves at its end), checks its
    run and reads the loader's time a batch from it, and with ``resume``
    auto-resumes for one step whose restored SSL state must equal the
    saved one bit for bit."""
    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod

    cfg_path, sets = ssl_experiment(tmp, f"exp_{method}", corpus,
                                    f"{method}_res50", views)
    exp = os.path.dirname(cfg_path)
    seen, restored, saved = [], {}, None
    make_step = solver_mod.make_train_step
    real_restore = solver_mod.restore_checkpoint

    def recording_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, batch):
            seen.append({k: (v.dtype, tuple(v.shape))
                         for k, v in batch.items() if k.startswith("images")})
            return step(state, batch)
        return recorded

    def recording_restore(path, state):
        out = real_restore(path, state)
        restored["ssl"] = _ssl_host(state.ssl)
        return out

    solver_mod.make_train_step = recording_make_train_step
    solver_mod.restore_checkpoint = recording_restore
    runs = {}
    try:
        for run, max_iter in (("first", steps), ("resume", steps + 1)):
            if run == "resume" and not resume:
                break
            with _CallCounter() as plain:
                reset_launches()  # a main path starts
                t = time.perf_counter()
                solver = solver_mod.main(
                    ["--config", cfg_path, "--device", "cuda", "--set",
                     *sets, "saver.save_freq=0",
                     f"lr_scheduler.kwargs.max_iter={max_iter}"])
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                launches = read_launches()  # ... and ends
            runs[run] = {"solver": solver, "wall_s": wall_s,
                         "launches": launches, "plain": plain.calls}
            if run == "first" and resume:
                saved = _ssl_host(solver.state.ssl)
    finally:
        solver_mod.make_train_step = make_step
        solver_mod.restore_checkpoint = real_restore
    solver = runs["first"]["solver"]
    st, vis = solver.state, solver.model.visual
    label = f"phase 13 {method}_res50"
    check((solver.method, solver.global_batch, st.step, vis.layers,
           vis.embed_dim, vis.dtype, solver.train_cfg["transforms"])
          == (method, TRAIN_BATCH, steps, (3, 4, 6, 3), 2048,
              torch.bfloat16, {"type": views}),
          f"{label}: not the recipe at full width")
    for run in runs.values():
        check(run["launches"] == dict.fromkeys(("K1", "K2", "K3", "K4",
                                                 "K5"), 0)
              and run["plain"] == 0,
              f"{label}: kernel calls {run['launches']}, plain self-"
              f"attention {run['plain']} (a ResNet has none)")
    strong = SSL_STRONG if method == "clsa" else ()
    want_views = {"images": (torch.float32, (TRAIN_BATCH, 224, 224, 6)),
                  **{f"images_strong_{i}": (torch.float32,
                                            (TRAIN_BATCH, r, r, 3))
                     for i, r in enumerate(strong)}}
    check(seen[:steps] == [want_views] * steps,
          f"{label}: the step's images {seen[:steps]}")
    check(st.ssl.queue_ptr == steps * TRAIN_BATCH,
          f"{label}: queue pointer {st.ssl.queue_ptr}")
    # the first run's steps (a resume appends its own to the file)
    scalars = {tag: [v for i, v in rows if i <= steps] for tag, rows in
               scalars_by_tag(os.path.join(exp, "events",
                                           "scalars.jsonl")).items()}
    terms = ["loss", "moco_loss", "top1"] + (["ddm_loss"] if strong else [])
    for tag in terms:
        values = scalars.get(tag, [])
        check(len(values) == steps and np.isfinite(values).all(),
              f"{label}: {tag} {values}")
    check(scalars["update_skipped"] == [0.0] * steps,
          f"{label}: skipped updates")
    window = solver_window(solver.timings, 2, steps, TRAIN_BATCH)
    out = {"steps": steps, "wall_s": runs["first"]["wall_s"],
           "launches": runs["first"]["launches"], "window": window,
           "terms": {t: scalars[t] for t in terms},
           "views": {k: list(v[1]) for k, v in want_views.items()}}
    if resume:
        again = runs["resume"]["solver"]
        check((again.start_step, again.state.step) == (steps, steps + 1),
              f"{label}: resumed {again.start_step} -> {again.state.step}")
        keys, queue, ptr = restored["ssl"]
        check(ptr == saved[2] and torch.equal(queue, saved[1])
              and sorted(keys) == sorted(saved[0])
              and all(torch.equal(v, saved[0][k]) for k, v in keys.items()),
              f"{label}: the resumed key encoder, queue or pointer differ "
              f"from the saved ones")
        out["resume"] = {"wall_s": runs["resume"]["wall_s"],
                         "restored": sorted(keys)[:3] + ["..."]}
        del again
    # the loader: a run of ``steps`` steps asks it for ``steps`` batches,
    # which its thread workers build side by side from their start, so the
    # first step's wait is that round with the workers' start-up, not a
    # rate (--ssl-loader-rates reads the steady rate); one batch built on
    # this thread alone is what each worker builds a round
    workers = int(solver.train_cfg["num_workers"])
    wait_s = solver.timings[0]["data_time"]
    t = time.perf_counter()
    solver._train_loader(-1)._build_batch(list(range(TRAIN_BATCH)), 0)
    lo = out["loader"] = {"workers": workers,
                          "first_round_batches": min(steps, workers),
                          "first_wait_s": wait_s,
                          "one_thread_batch_s": time.perf_counter() - t}
    last = " ".join(f"{t} {v[-1]:.4f}" for t, v in out["terms"].items())
    print(f"{label}: {steps} steps of MoCo-v2's recipe ({views} views) in "
          f"{out['wall_s']:.1f} s; last step {last}; steps 2-{steps} "
          f"{window['step_s'] * 1e3:.2f} ms/step, of which "
          f"{window['data_s'] * 1e3:.2f} waiting for data; the first step "
          f"waited {wait_s:.2f} s for the loader's first round "
          f"({lo['first_round_batches']} batches side by side on its "
          f"{workers} thread workers, their start-up included); one batch "
          f"on one thread {lo['one_thread_batch_s']:.2f} s"
          + (f"; resumed at {steps} with the queue, pointer, key "
             f"parameters and key statistics bit for bit in "
             f"{out['resume']['wall_s']:.1f} s" if resume else ""),
          flush=True)
    del solver, st, runs
    torch.cuda.empty_cache()
    return out


def ssl_loader_rates():
    """``python3 chip_smoke.py --ssl-loader-rates``: 13c-d's two loaders
    (SSL_RECIPE's 7 thread workers, B=128, MOCOV2 and CLSA5 views of phase
    7's corpus) alone, SSL_LOADER_BATCHES batches each through the
    solver's own loader builder; the model stays on the CPU and the card
    is not used. Prints each loader's ms a batch over the rounds of its
    workers' batches after the first (``loader_rate``), and writes
    chiprun_out/ssl_loader_rates.json."""
    sys.path.insert(0, ROOT)
    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.solver import Solver

    tmp = tempfile.mkdtemp(prefix="chip_smoke_loaders_")
    out = {"cpu_count": os.cpu_count()}
    try:
        corpus = solver_corpus(tmp)
        for method, views in (("moco", "MOCOV2"), ("clsa", "CLSA5")):
            cfg_path, sets = ssl_experiment(tmp, f"rate_{method}", corpus,
                                            f"{method}_res50", views)
            cfg = parse_config(cfg_path)
            for kv in sets:
                key, _, value = kv.partition("=")
                cfg = override(cfg, key, json.loads(value))
            cfg["_config_path"] = cfg_path
            solver = Solver(cfg, device="cpu")
            solver.max_iter = SSL_LOADER_BATCHES
            keys = {"images"} | {f"images_strong_{i}" for i in
                                 range(len(SSL_STRONG) if views == "CLSA5"
                                       else 0)}
            t = time.perf_counter()
            arrivals = []
            for b in solver._train_loader(-1):
                arrivals.append(time.perf_counter() - t)
                check(keys <= set(b), f"{views} batch keys {sorted(b)}")
            workers = int(solver.train_cfg["num_workers"])
            out[views] = loader_rate(arrivals, workers, TRAIN_BATCH)
            out[views]["arrivals_s"] = arrivals
            lo = out[views]
            print(f"ssl loader alone, {views} ({workers} thread workers, "
                  f"{os.cpu_count()} CPUs): the first round of {workers} "
                  f"batches in {lo['first_round_s']:.2f} s, then "
                  f"{lo['ms_per_batch']:.1f} ms a batch over the next "
                  f"{SSL_LOADER_BATCHES - workers}, {lo['pairs_per_s']:.1f} "
                  f"images/s; arrivals (s) "
                  f"{[round(a, 2) for a in arrivals]}", flush=True)
            del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ssl_loader_rates.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


def phase_ssl(tmp, corpus):
    """Phase 13: the SSL builders (see the module docstring)."""
    profile = profiler_sees_device()
    out = {"train": {name: _ssl_train(name, profile) for name in
                     ("moco_vitb32", "simclr_vitb32", "clsa_vitb32")}}
    out["fp32"] = {name: _ssl_fp32_step(name)
                   for name in ("moco_vitb32", "clsa_vitb32")}
    out["short"] = _ssl_short_rows()
    out["moco_solver"] = _ssl_solver(tmp, corpus, "moco", "MOCOV2",
                                     SSL_SOLVER_STEPS, resume=True)
    out["clsa_solver"] = _ssl_solver(tmp, corpus, "clsa", "CLSA5",
                                     CLSA_SOLVER_STEPS, resume=False)
    return out


# phase 14: the serving tools on phase 3's CLIP ViT-B/32 at full width, fp32
TOOLS_BATCHES = (1, 8, 16)
TOOLS_INT8_BATCHES = (1, 8)
# an artifact against the live model, each row's max abs err over its norm
# (the same kernels on the same inputs: what differs is only fusion order)
EXPORT_REL_ERR = 1e-5
# each row's cosine, int8 against fp32 (tests/test_quant.py:63-64's bound)
INT8_COSINE = 0.995
# the same int8 graph exported and live: activations that differ by fp32
# rounding may flip a code
INT8_ARTIFACT_COSINE = 0.9999
# the H100 SXM5's dense bf16 tensor-core peak, NVIDIA's datasheet (at the
# full 700 W; the card's power limit is printed beside every number)
H100_BF16_DENSE_FLOPS = 989e12
INFERENCE_IMAGES = 4
INFERENCE_CLASSES = "cat,dog,car,tree"
PROFILE_KEY = {"enable": True, "start_step": 3, "num_steps": 2}
PROFILE_MAX_ITER = 5


def int_mm_probe():
    """What ``torch._int_mm`` takes on this card, shape by shape ({name:
    "ok" or the error's first line}): the row count at 1, 16 and 17 with
    the second operand row-major and column-major ("_t"), and an inner or
    outer width off a multiple of 8. ops/quant.py pads every product to
    what the card takes, its second operand column-major."""
    import torch

    shapes = {"m1": (1, 64, 64), "m16": (16, 64, 64), "m17": (17, 64, 64),
              "m1_t": (1, 64, 64), "m16_t": (16, 64, 64),
              "m17_t": (17, 64, 64), "k12_t": (32, 12, 64),
              "n12_t": (32, 64, 12)}
    out = {}
    for name, (m, k, n) in shapes.items():
        a = torch.ones(m, k, dtype=torch.int8, device="cuda")
        b = (torch.ones(n, k, dtype=torch.int8, device="cuda").t()
             if name.endswith("_t") else
             torch.ones(k, n, dtype=torch.int8, device="cuda"))
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).strip().splitlines()[0][:160]
    return out


def _rows_cos(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                 dim=-1)


def _serve_requests(host, rng):
    """One compute thread and the HTTP front end on ``host``; one-row
    requests one after another (5 images and 10 texts, their latencies;
    an image request is mostly its JSON codec, phase 3), then
    batched ones (4 concurrent 2-row image requests, a 5-row text
    request). -> {"batches", "launches", "client_ms", "stats"}; K1
    launches 12 a batch or the phase fails."""
    import numpy as np

    from declip_tpu_torch.ops.flash_attention import flash_attention

    stop = threading.Event()
    compute = threading.Thread(target=host.batcher.run_forever, args=(stop,),
                               daemon=True)
    compute.start()
    url = f"http://127.0.0.1:{host.start_http('127.0.0.1', 0)}"
    b0, l0 = host.batcher.stats["batches"], flash_attention.launches

    def images(n):
        return rng.normal(size=(n, 224, 224, 3)).astype(np.float32)

    try:
        lat = {"image": [], "text": []}
        for i in range(10):
            for kind, payload in (
                    ("image", {"arrays": images(1).tolist()} if i < 5
                     else None),
                    ("text", {"tokens": _tokens(rng, 1).tolist()})):
                if payload is None:
                    continue
                t = time.perf_counter()
                _check_embeddings(_post(url, f"/v1/encode_{kind}", payload),
                                  1)
                lat[kind].append((time.perf_counter() - t) * 1e3)
        for out in _concurrent(url, "/v1/encode_image",
                               [{"arrays": images(2).tolist()}
                                for _ in range(4)]):
            _check_embeddings(out, 2)
        _check_embeddings(_post(url, "/v1/encode_text",
                                {"tokens": _tokens(rng, 5).tolist()}), 5)
        stats = host.stats()
    finally:
        stop.set()
        host.shutdown()
        compute.join(timeout=30)
    check(not compute.is_alive(), "compute thread did not stop")
    batches = host.batcher.stats["batches"] - b0
    launches = flash_attention.launches - l0
    check(launches == 12 * batches,
          f"{launches} K1 launches for {batches} batches (want 12 a batch)")
    client = {k: {"p50_ms": float(np.percentile(v, 50)),
                  "p95_ms": float(np.percentile(v, 95))}
              for k, v in lat.items()}
    return {"batches": batches, "launches": launches, "client_ms": client,
            "latency_ms": stats["latency_ms"],
            "mean_rows_per_batch": stats.get("mean_rows_per_batch")}


def _tools_inputs():
    """Phase 14's seeded tower inputs on the card, {(kind, B): rows} for
    B in TOOLS_BATCHES, the same in both of its parts, and the generator
    after them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    inputs = {}
    for kind in ("image", "text"):
        for b in TOOLS_BATCHES:
            rows = (rng.normal(size=(b, 224, 224, 3)).astype(np.float32)
                    if kind == "image" else _tokens(rng, b))
            inputs[(kind, b)] = torch.from_numpy(rows).cuda()
    return inputs, rng


def phase_serving_tools(tmp, corpus, slice_result, train_result,
                        declip_result):
    """Phase 14's first part, on weights drawn from the seed once and
    saved as the experiment's checkpoint, which every tool then loads:
    (b) int8 live against fp32 and its ms beside fp32's (phase 3's);
    (d) ``tools.inference --saliency`` on phase 7's JPEGs, K2 in fp32 12
    times an image; (e) the FLOPs of phases 4 and 6's steps and an MFU
    from their step times; (f) the solver's ``profile`` key, whose trace
    must hold K1's kernel. The exports run beside phase 11b
    (:func:`start_serving_exports`), and what reads them after it
    (:func:`phase_serving_exports`)."""
    import glob

    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod
    from declip_tpu_torch.data.dataset import pil_loader
    from declip_tpu_torch.data.transforms import build_common_augmentation
    from declip_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from declip_tpu_torch.ops.quant import int8_inference
    from declip_tpu_torch.tools import inference
    from declip_tpu_torch.tools._common import load_eval_model

    exp = os.path.join(tmp, "exp_serving")
    os.makedirs(os.path.join(exp, "checkpoints"))
    cfg = os.path.join(exp, "config.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG)
    out = {"exp": exp, "config": cfg, "int_mm": int_mm_probe(),
           "part_s": {}}
    print(f"phase 14: torch._int_mm on this card: {out['int_mm']}",
          flush=True)
    part_t = time.perf_counter()

    def part(name):
        nonlocal part_t
        now = time.perf_counter()
        out["part_s"][name] = now - part_t
        part_t = now

    # the seeded weights once, saved where the tools look for a trained
    # experiment's (the newest checkpoints/ckpt*.pth.tar), so that each
    # tool below reads them instead of drawing 151 M weights again
    model = load_eval_model(cfg, "cuda")
    torch.save({"model": {k: v.cpu() for k, v in
                          model.state_dict().items()}},
               os.path.join(exp, "checkpoints", "ckpt.pth.tar"))
    part("setup")
    reset_launches()  # main path starts
    live = {"image": model.encode_image, "text": model.encode_text}
    inputs, _ = _tools_inputs()

    # (b) int8 live against fp32; its ms beside phase 3's fp32 towers
    out["int8"] = {}
    for kind in live:
        for b in TOOLS_INT8_BATCHES:
            x = inputs[(kind, b)]

            def live_int8(kind=kind, x=x):
                with int8_inference():
                    return live[kind](x)

            with torch.no_grad():
                fp32, int8 = live[kind](x), live_int8()
                cos = _rows_cos(int8, fp32).min().item()
                moved = ((int8 - fp32).abs().max()
                         / fp32.abs().max()).item()
                ms = {"int8": cuda_ms(live_int8, 10, 2)}
                busy = {"int8": device_ms(live_int8, 5)[0]}
            ref = slice_result["tower_ms"][b][kind]
            ms["fp32"], busy["fp32"] = ref["wall_ms"], ref["busy_ms"]
            check(cos > INT8_COSINE,
                  f"int8 {kind} B={b}: cosine {cos} (limit {INT8_COSINE})")
            check(moved > 1e-4, f"int8 {kind} B={b}: moved the output by "
                                f"{moved:.3g} of its max only")
            out["int8"][f"{kind}_b{b}"] = {"cosine": {"int8": cos},
                                           "moved": moved, "ms": ms,
                                           "device_ms": busy}
            print(f"phase 14b: {kind} B={b}: cosine {cos}, ms (CUDA "
                  f"events) {ms}, device ms {busy}", flush=True)
    part("b")

    # (d) tools/inference.py with saliency maps on phase 7's JPEGs
    img_dir = os.path.join(tmp, "inference_images")
    os.makedirs(img_dir)
    for src in sorted(glob.glob(os.path.join(corpus["root"], "train",
                                             "*.jpg")))[:INFERENCE_IMAGES]:
        shutil.copy(src, img_dir)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    t = time.perf_counter()
    jsonl = inference.main(["--config", cfg, "--image_dir", img_dir,
                            "--classes", INFERENCE_CLASSES, "--out",
                            os.path.join(tmp, "inference.jsonl"),
                            "--saliency"])
    inference_s = time.perf_counter() - t
    k1 = flash_attention.launches - before[0]
    k2 = flash_attention_bwd.launches - before[1]
    check((k1, k2) == (12 + 24 * INFERENCE_IMAGES, 12 * INFERENCE_IMAGES),
          f"inference: {k1} K1 and {k2} K2 launches (want "
          f"{12 + 24 * INFERENCE_IMAGES} and {12 * INFERENCE_IMAGES})")
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    classes = INFERENCE_CLASSES.split(",")
    class_emb = inference.class_embeddings(model, classes,
                                           torch.device("cuda"))
    crop = build_common_augmentation("ONECROP")
    prob_err, sal_max = 0.0, []
    check(len(recs) == INFERENCE_IMAGES, f"{len(recs)} inference records")
    for rec in recs:
        with open(os.path.join(img_dir, rec["filename"]), "rb") as f:
            x = torch.from_numpy(np.asarray(crop(pil_loader(f.read())),
                                            np.float32)[None]).cuda()
        with torch.no_grad():
            e = model.encode_image(x)
            e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
            want = torch.softmax(100.0 * (e @ class_emb.T)[0], -1).cpu()
        got = torch.tensor([rec["probs"][c] for c in classes])
        prob_err = max(prob_err, (got - want).abs().max().item())
        sal = np.load(rec["saliency"])
        check(sal.shape == (224, 224) and np.isfinite(sal).all()
              and sal.max() > 0, f"saliency {sal.shape} max {sal.max()}")
        sal_max.append(float(sal.max()))
    check(prob_err <= 1e-5, f"inference probabilities {prob_err:.3g} from "
                            f"the live model's zero-shot (limit 1e-5)")
    out["inference"] = {"seconds": inference_s, "k1": k1, "k2": k2,
                        "prob_max_abs_err": prob_err,
                        "saliency_max": sal_max}
    print(f"phase 14d: inference {out['inference']}", flush=True)
    del model, live, inputs
    torch.cuda.empty_cache()
    part("d")

    # (e) FLOPs a step, and the MFU of phases 4 and 6's step times
    out["flops"] = {}
    for name, res in (("clip_vitb32_bf16_b128", train_result),
                      ("declip_r50_bf16_b128", declip_result)):
        fl = res["flops"]
        out["flops"][name] = {
            "flops": fl["total"], "kernels_share": fl["kernels_share"],
            "kernels_by_op": {k: v for k, v in fl["by_operator"].items()
                              if k.startswith("declip_tpu_torch.")},
            "step_ms": res["step_ms"],
            "mfu": fl["total"] / (res["step_ms"] / 1e3)
            / H100_BF16_DENSE_FLOPS}
        print(f"phase 14e: {name}: {fl['total'] / 1e12:.3f} TFLOP a step "
              f"(K1-K5 {fl['kernels_share']:.1%}), {res['step_ms']:.2f} "
              f"ms a step, MFU {out['flops'][name]['mfu']:.1%} of the "
              f"H100 SXM5's 989 TFLOP/s dense bf16 (NVIDIA's datasheet)",
              flush=True)

    # (f) the solver's profile key
    cfg_path, sets = solver_experiment(tmp, "exp_profile", corpus,
                                       SIGLIP_RECIPE, save_freq=0)
    solver_mod.main(["--config", cfg_path, "--device", "cuda", "--set",
                     *sets, f"lr_scheduler.kwargs.max_iter="
                     f"{PROFILE_MAX_ITER}", "data.test=[]",
                     "profile=" + json.dumps(PROFILE_KEY)])
    traces = glob.glob(os.path.join(os.path.dirname(cfg_path), "events",
                                    "profile", "*.pt.trace.json"))
    check(len(traces) == 1, f"profile traces: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1_names = sorted({n for n in kernels if "flash_attn_fwd" in n})
    check(k1_names, f"the trace holds no K1 kernel among {len(kernels)} "
                    f"device kernels")
    out["profile"] = {"trace_mib": os.path.getsize(traces[0]) / 2 ** 20,
                      "device_kernels": len(kernels),
                      "k1_events": sum("flash_attn_fwd" in n
                                       for n in kernels),
                      "k1_names": k1_names}
    out["launches"] = read_launches()  # main path ends
    part("e_f")
    print(f"phase 14f: profile trace {out['profile']}; launches "
          f"{out['launches']}; seconds by part {out['part_s']}", flush=True)
    return out


def start_serving_exports(tools):
    """Phase 14's exports, started: ``python -m declip_tpu_torch.tools.
    convert --export-serving`` with a symbolic batch, fp32 and
    ``--quantize int8``, each in a process of its own as a user runs it
    (``main`` runs them beside phase 11b, whose times are no performance
    numbers) -> {name: (process, log, start)}."""
    pending = {}
    for name, extra in (("fp32", []), ("int8", ["--quantize", "int8"])):
        log = open(os.path.join(tools["exp"], f"export_{name}.log"), "w")
        argv = [sys.executable, "-m", "declip_tpu_torch.tools.convert",
                "--export-serving", "--config", tools["config"], "--out",
                os.path.join(tools["exp"], name), *extra]
        pending[name] = (subprocess.Popen(
            argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT, os.environ.get("PYTHONPATH", "")]))),
            log, time.perf_counter())
    return pending


def stop_serving_exports(pending):
    """Kills what is left of ``start_serving_exports``' processes."""
    for proc, log, _ in (pending or {}).values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def phase_serving_exports(tools, pending, slice_result):
    """Phase 14's second part, after phase 11b: (a) the two exports'
    seconds (each process's wall time, beside 11b) and MiB, each artifact
    loaded with ``torch.export.load`` at B = 1, 8, 16 against the live
    model, 12 K1 launches a tower call; (b) the int8 artifact against
    fp32 and against the live int8, and both artifacts' ms a call;
    (c) ``serve --exported`` and ``serve --int8`` hosts over HTTP."""
    import torch

    from declip_tpu_torch.ops.flash_attention import flash_attention
    from declip_tpu_torch.ops.quant import int8_inference
    from declip_tpu_torch.tools import convert
    from declip_tpu_torch.tools._common import load_eval_model
    from declip_tpu_torch.tools.serve import ServingHost

    exp, cfg = tools["exp"], tools["config"]
    out = {"export_s": {}, "artifact_mib": {}, "part_s": {}}
    t0 = time.perf_counter()
    deadline = t0 + 600
    try:
        while len(out["export_s"]) < len(pending):
            check(time.perf_counter() < deadline,
                  f"exports still running: {sorted(pending)}")
            for name, (proc, _, start) in pending.items():
                if name not in out["export_s"] and proc.poll() is not None:
                    out["export_s"][name] = time.perf_counter() - start
            time.sleep(0.1)
    finally:
        stop_serving_exports(pending)
    for name, (proc, log, _) in pending.items():
        with open(log.name) as f:
            text = f.read()
        check(proc.returncode == 0,
              f"convert --export-serving ({name}): rc {proc.returncode}, "
              f"output {text[-3000:]}")
        out["artifact_mib"][name] = {
            fname: os.path.getsize(os.path.join(exp, name, fname)) / 2 ** 20
            for fname in convert.ARTIFACTS.values()}
    print(f"phase 14a: exported in {out['export_s']} s (each process's "
          f"wall time, beside phase 11b), {out['artifact_mib']} MiB",
          flush=True)
    out["part_s"]["wait"] = time.perf_counter() - t0

    model = load_eval_model(cfg, "cuda")
    reset_launches()  # main path starts
    arts = {name: {kind: torch.export.load(os.path.join(
        exp, name, fname)).module()
        for kind, fname in convert.ARTIFACTS.items()}
        for name in pending}
    live = {"image": model.encode_image, "text": model.encode_text}
    inputs, rng = _tools_inputs()
    out["export_rel_err"] = {}
    with torch.no_grad():
        for (kind, b), x in inputs.items():
            l0 = flash_attention.launches
            got = arts["fp32"][kind](x)
            check(flash_attention.launches - l0 == 12,
                  f"{kind} artifact B={b}: "
                  f"{flash_attention.launches - l0} K1 launches (want 12)")
            want = live[kind](x)
            err = ((got - want).abs().amax(-1)
                   / torch.linalg.vector_norm(want, dim=-1)).max().item()
            out["export_rel_err"][f"{kind}_b{b}"] = err
            check(got.shape == want.shape == (b, 512) and
                  err <= EXPORT_REL_ERR,
                  f"{kind} artifact B={b}: {err:.3g} of the row norm "
                  f"(limit {EXPORT_REL_ERR})")
    print(f"phase 14a: artifacts against the live model, max abs err over "
          f"the row norm: {out['export_rel_err']}", flush=True)
    out["part_s"]["a"] = time.perf_counter() - t0

    # (b) the int8 artifact against fp32 and the live int8; ms a call
    out["int8"] = {}
    for kind in live:
        for b in TOOLS_INT8_BATCHES:
            x = inputs[(kind, b)]
            with torch.no_grad():
                fp32 = live[kind](x)
                with int8_inference():
                    int8 = live[kind](x)
                exported = arts["int8"][kind](x)
                cos = {"exported_int8": _rows_cos(exported, fp32).min()
                       .item(),
                       "exported_vs_live_int8": _rows_cos(exported, int8)
                       .min().item()}
                ms = {name: cuda_ms(lambda name=name, kind=kind, x=x:
                                    arts[name][kind](x), 10, 2)
                      for name in arts}
            check(cos["exported_int8"] > INT8_COSINE,
                  f"int8 artifact {kind} B={b}: cosine {cos} (limit "
                  f"{INT8_COSINE})")
            check(cos["exported_vs_live_int8"] >= INT8_ARTIFACT_COSINE,
                  f"int8 {kind} B={b}: artifact against live {cos}")
            out["int8"][f"{kind}_b{b}"] = {"cosine": cos, "ms": ms}
            print(f"phase 14b: artifacts, {kind} B={b}: cosine {cos}, ms "
                  f"(CUDA events) {ms}", flush=True)
    out["part_s"]["b"] = time.perf_counter() - t0

    # (c) the two new hosts over HTTP
    out["serve"] = {}
    for name, make in (
            ("exported", lambda: ServingHost.from_exported(
                os.path.join(exp, "fp32"), device="cuda", max_batch=16,
                max_wait_ms=20.0)),
            ("int8", lambda: ServingHost.from_config(
                cfg, device="cuda", int8=True, max_batch=16,
                max_wait_ms=20.0))):
        host = make()
        check(host.meta["input_resolution"] == 224, f"{host.meta}")
        out["serve"][name] = _serve_requests(host, rng)
        print(f"phase 14c: serve {name}: {out['serve'][name]}", flush=True)
    del model, arts, live, inputs
    torch.cuda.empty_cache()
    out["launches"] = read_launches()  # main path ends
    out["part_s"]["c"] = time.perf_counter() - t0
    print(f"phase 14c: launches {out['launches']}; seconds since 11b "
          f"{out['part_s']}", flush=True)
    return out


def _phase15_learnability(card):
    """15a: ``python -m declip_tpu_torch.tools.learnability``'s ``main``
    as a user runs it (DeCLIP, bf16, LEARN_STEPS at LEARN_BATCH, no pool):
    zero-shot top-1 above LEARN_TOP1, K1 and K2 launches exactly the
    towers' count, no plain-version call."""
    from declip_tpu_torch.tools import learnability

    reset_launches()  # main path starts
    with _CallCounter() as plain:
        res = learnability.main(["--steps", str(LEARN_STEPS), "--batch",
                                 str(LEARN_BATCH), "--recipe", "declip"])
    launches = read_launches()  # main path ends
    want = {k: LEARN_STEPS * n for k, n in LEARN_PER_STEP.items()}
    want["K1"] += LEARN_EVAL_K1
    check(launches == want, f"learnability launches {launches}, want {want}")
    check(plain.calls == 0 and plain.cross == 0,
          f"learnability: {plain.calls} plain-version calls")
    check(res["backend"].startswith("cuda"), f"backend {res['backend']}")
    check(res["zero_shot_top1"] > LEARN_TOP1,
          f"zero-shot top-1 {res['zero_shot_top1']} <= {LEARN_TOP1}")
    print(f"phase 15a learnability (DeCLIP, bf16, {LEARN_STEPS} steps, "
          f"B={LEARN_BATCH}) on {card}: loss {res['first_loss']} -> "
          f"{res['last_loss']}, zero-shot top-1 {res['zero_shot_top1']} "
          f"(chance 0.0625), {res['train_steps_per_s']} steps/s; "
          f"launches {launches}", flush=True)
    return {**res, "launches": launches}


def _phase15_probe_and_text(tmp, card):
    """15b and 15c on phase 3's CLIP ViT-B/32 (full width, seeded, fp32)
    from a config through ``load_eval_model``: (b) ``linear_probe.main`` on
    ``--read-from synthetic`` metas, 12 K1 an embedding batch; one batch's
    embeddings through K1 against the plain attention path within phase
    3's TOWER_TOLERANCE, and the embedding's time; (c)
    ``text_visualize.main``: the JSON written, its cosine matrix
    symmetric with a unit diagonal within 1e-5, 12 K1."""
    import numpy as np
    import torch

    from declip_tpu_torch.data.dataset import ImageNetDataset
    from declip_tpu_torch.data.transforms import build_common_augmentation
    from declip_tpu_torch.models.layers import MultiHeadAttention
    from declip_tpu_torch.tools import linear_probe, text_visualize
    from declip_tpu_torch.tools._common import load_eval_model

    exp = os.path.join(tmp, "exp_probe")
    os.makedirs(exp)
    cfg = os.path.join(exp, "config.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG)
    rng = np.random.default_rng(SEED)
    metas = {}
    for name, n in (("train", PROBE_TRAIN), ("val", PROBE_VAL)):
        metas[name] = os.path.join(exp, f"{name}.txt")
        with open(metas[name], "w") as f:
            for i in range(n):
                f.write(f"synthetic_{i}.png "
                        f"{int(rng.integers(0, PROBE_CLASSES))}\n")
    out = {}
    batches = -(-PROBE_TRAIN // 128) - (-PROBE_VAL // 128)
    reset_launches()  # main path starts
    t0 = time.perf_counter()
    res = linear_probe.main([
        "--config", cfg, "--meta", metas["train"], "--val-meta",
        metas["val"], "--read-from", "synthetic", "--epochs",
        str(PROBE_EPOCHS)])
    probe_s = time.perf_counter() - t0
    launches = read_launches()  # main path ends
    want = {"K1": 12 * batches, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    check(launches == want, f"linear probe launches {launches}, want {want}")
    check((res["n_train"], res["n_val"]) == (PROBE_TRAIN, PROBE_VAL),
          f"linear probe rows {res}")
    out["probe"] = {**res, "launches": launches, "main_s": probe_s}

    # one batch (the validation set) through K1 and through the plain path
    model = load_eval_model(cfg, "cuda")
    val = ImageNetDataset("", metas["val"], read_from="synthetic",
                          transform=build_common_augmentation("ONECROP"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, _ = linear_probe.embed_dataset(model, val)
    embed_s = time.perf_counter() - t0
    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    for m in mhas:
        m.attn_impl = "xla"
    plain, _ = linear_probe.embed_dataset(model, val)
    for m in mhas:
        m.attn_impl = "auto"
    rtol, atol = TOWER_TOLERANCE
    err = np.abs(feats - plain)
    check(feats.shape == (PROBE_VAL, 512) and np.isfinite(feats).all(),
          f"probe embeddings {feats.shape}")
    check((err <= atol + rtol * np.abs(plain)).all(),
          f"probe embeddings: K1 vs plain path max abs err {err.max():.3g} "
          f"beyond rtol {rtol} atol {atol}")
    out["probe"].update(embed_batch_s=embed_s,
                        embed_max_abs_err=float(err.max()))
    print(f"phase 15b linear probe (clip_vitb32, fp32, {PROBE_TRAIN} + "
          f"{PROBE_VAL} synthetic rows, {PROBE_EPOCHS} epochs) on {card}: "
          f"top-1 {res['linear_probe_top1']}%, main {probe_s:.2f} s, one "
          f"{PROBE_VAL}-row batch read and embedded in {embed_s:.3f} s; "
          f"K1 vs plain max abs err {err.max():.3g}; launches {launches}",
          flush=True)

    viz = os.path.join(exp, "text_viz.json")
    reset_launches()  # main path starts
    res = text_visualize.main(["--config", cfg, "--texts", PROBE_TEXTS,
                               "--out", viz])
    launches = read_launches()  # main path ends
    want = {"K1": 12, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    check(launches == want, f"text_visualize launches {launches}")
    with open(viz) as f:
        written = json.load(f)
    sim = np.asarray(written["cosine_similarity"])
    n = len(PROBE_TEXTS.split(","))
    check(written == res and sim.shape == (n, n)
          and np.asarray(written["pca_2d"]).shape == (n, 2),
          "text_visualize JSON")
    check(np.abs(sim - sim.T).max() <= 1e-5
          and np.abs(np.diag(sim) - 1).max() <= 1e-5,
          f"cosine matrix not symmetric with a unit diagonal: {sim}")
    out["text_visualize"] = {"launches": launches,
                             "cosine_similarity": written[
                                 "cosine_similarity"]}
    return out


def _phase15_hf(tmp, card):
    """15d: a BERT-base text tower (``BertConfig()``'s defaults, seeded
    weights saved under ``tmp``; nothing is downloaded) in
    ``declip_vitb32`` with the DeCLIP recipe, HF_STEPS bf16 steps at
    B=128: finite losses, K1 and K2 from the image tower only. Where
    ``transformers`` does not import, one line says so and nothing runs."""
    import importlib.util

    import numpy as np
    import torch

    if importlib.util.find_spec("transformers") is None:
        print("phase 15d: transformers is not installed on this host; the "
              "HF text tower was not run", flush=True)
        return {"transformers": None}
    import transformers
    from transformers import BertConfig, BertModel

    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models.hf_text import HFTextEncoder
    from declip_tpu_torch.optim import optim_entry, scheduler_entry
    from declip_tpu_torch.tokenizer import get_tokenizer
    from declip_tpu_torch.train import make_train_step, new_train_state

    t0 = time.perf_counter()
    bert_dir = os.path.join(tmp, "bert_base")
    torch.manual_seed(SEED)
    BertModel(BertConfig()).save_pretrained(bert_dir)
    cfg = parse_config(DECLIP_CONFIG)
    cfg.model.type = "declip_vitb32"
    cfg.model.kwargs.text_encode = {
        "text_encode_type": "Bert", "embed_dim": 1024,
        "text_model_utils": {"pretrained_path": bert_dir}}
    model = _method_build(cfg, cfg.precision.dtype)
    txt = model.encode_text
    check(isinstance(txt, HFTextEncoder) and txt.width == 768
          and txt.vocab_size == 30522
          and len(txt.backbone.encoder.layer) == 12
          and model.text_label_predictor.out_features == 30522,
          "the text tower is not BERT-base")
    build_s = time.perf_counter() - t0
    sched = scheduler_entry(cfg.lr_scheduler,
                            max_iter=int(cfg.lr_scheduler.kwargs.max_iter))
    named = dict(model.named_parameters())
    tx = optim_entry(cfg.optimizer, model, sched,
                     pconfig=cfg.optimizer.pconfig,
                     grad_clip=dict(cfg.grad_clip))
    state = new_train_state(model=model, opt_state=tx.init(named),
                            bank_text=_seeded_method_bank(model))
    step = make_train_step(model, tx, cfg, sched)
    # captions in the byte-level vocabulary (ids < 515, inside BERT's)
    batch = _declip_batch(np.random.default_rng(SEED), get_tokenizer(None))
    losses = []
    reset_launches()  # main path starts
    with _CallCounter() as plain:
        for _ in range(HF_STEPS):
            state, metrics = step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()
                           if "loss" in k})
    launches = read_launches()  # main path ends
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0 - build_s
    check(all(np.isfinite(list(m.values())).all() for m in losses),
          f"HF DeCLIP losses not finite: {losses}")
    want = {k: HF_STEPS * n for k, n in HF_PER_STEP.items()}
    check(launches == want, f"HF DeCLIP launches {launches}, want {want}")
    check(plain.calls == 0, f"HF DeCLIP: {plain.calls} plain-version calls")
    print(f"phase 15d declip_vitb32 + BERT-base text tower (transformers "
          f"{transformers.__version__}), bf16, B={TRAIN_BATCH}, on {card}: "
          f"losses {[round(m['loss'], 4) for m in losses]}; launches "
          f"{launches} (image tower only); built and saved in "
          f"{build_s:.1f} s, {HF_STEPS} steps in {steps_s:.1f} s",
          flush=True)
    return {"transformers": transformers.__version__, "losses": losses,
            "launches": launches, "build_s": build_s, "steps_s": steps_s}


def phase_last_modules(tmp, card):
    """Phase 15, the last single-card modules: (a) the learnability run,
    (b) the linear probe, (c) text visualisation, (d) the HF text tower.
    -> each part's result, with its launches and seconds."""
    t0 = time.perf_counter()
    out = {"learnability": _phase15_learnability(card)}
    part_s = {"learnability": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out.update(_phase15_probe_and_text(tmp, card))
    part_s["probe_and_text"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["hf_text"] = _phase15_hf(tmp, card)
    part_s["hf_text"] = time.perf_counter() - t0
    out["part_s"] = part_s
    print(f"phase 15 parts (s): {part_s}", flush=True)
    return out


def _moe_sets():
    """The --set arguments that make phase 16's recipe MoE on both
    towers."""
    return [f"model.kwargs.{tower}.moe={json.dumps(MOE)}"
            for tower in ("image_encode", "text_encode")]


def _moe_blocks(model):
    from declip_tpu_torch.models.layers import MoeMlpBlock

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, MoeMlpBlock)]


def _dropped_share(kept, n_tokens, k):
    """The share of a block's k * n choices that its capacity dropped."""
    return 1.0 - sum(kept) / (k * n_tokens)


class _RouterReplay:
    """``torch.argmax`` as the MoE blocks call it (models/layers.py): the
    first ``calls`` calls (one forward: k passes a block) are recorded,
    and the next ones return the recorded choices, so that a second
    forward routes every token as the first did; ``differ`` counts the
    (token, pass) choices the second forward's own router would have made
    otherwise (a near tie that the other path's rounding flips), of
    ``choices``."""

    def __init__(self, calls):
        self.calls = calls
        self.record = []
        self.differ = self.choices = 0

    def __enter__(self):
        import torch

        self.argmax = real = torch.argmax

        def argmax(input, *args, **kwargs):
            out = real(input, *args, **kwargs)
            caller = sys._getframe(1).f_globals.get("__name__")
            if caller != "declip_tpu_torch.models.layers":
                return out
            if len(self.record) < self.calls:
                self.record.append(out)
                return out
            want = self.record[self.replayed % self.calls]
            self.replayed += 1
            self.differ += int((want != out).sum())
            self.choices += out.numel()
            return want

        self.replayed = 0
        torch.argmax = argmax
        return self

    def __exit__(self, *exc):
        import torch

        torch.argmax = self.argmax


def _moe_fp32_check(cfg, batch):
    """Phase 16's fp32 step: one loss and gradient of the MoE CLIP at full
    width through K1/K2 against the plain attention path, from the same
    seeded weights and batch, the plain path routed as the kernels' path
    routed (``_RouterReplay``: the kernels are what is held, and a near
    tie in a router that the paths' rounding flips would move a token to
    another expert); the choices its own router would have made
    otherwise are counted and printed."""
    import torch

    from declip_tpu_torch.train import make_loss_fn

    model = build_clip(cfg, "float32")
    calls = MOE["top_k"] * len(_moe_blocks(model))
    with _RouterReplay(calls) as replay:
        totals, grads = step_kernels_vs_plain(model, make_loss_fn(cfg),
                                              batch)
    check(replay.replayed == calls, f"phase 16: {replay.replayed} routing "
                                    f"passes replayed, want {calls}")
    flips, total_choices = replay.differ, replay.choices
    loss_err = abs(totals["auto"] - totals["xla"]) / abs(totals["xla"])
    rel = {}
    for (name, _), a, b in zip(model.named_parameters(), grads["auto"],
                               grads["xla"]):
        norm = torch.linalg.vector_norm(b).item()
        diff = torch.linalg.vector_norm(a - b).item()
        rel[name] = diff / norm if norm > 0 else (0.0 if diff == 0
                                                   else float("inf"))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    out = {"loss": totals, "loss_rel_err": loss_err,
           "max_grad_rel_norm_err": worst[0][1], "largest": worst,
           "choices_that_differ": flips, "choices": total_choices}
    print(f"phase 16 fp32 step, kernels vs plain attention: loss "
          f"{totals['auto']:.6f} vs {totals['xla']:.6f} (rel err "
          f"{loss_err:.2e}, limit {STEP_LOSS_RTOL}); max relative gradient "
          f"norm err {worst[0][1]:.3g} (limit {STEP_GRAD_REL_NORM}; "
          f"largest {[(n, f'{r:.3g}') for n, r in worst]}; the plain "
          f"path routed as the kernels' path); routing choices (token, "
          f"pass) that differ between the two paths' own routers: "
          f"{flips} of {total_choices}"
          + (" (a near tie in a router flipped them)" if flips else ""),
          flush=True)
    check(loss_err <= STEP_LOSS_RTOL,
          f"phase 16 fp32 loss kernels {totals['auto']} vs plain "
          f"{totals['xla']}")
    check(worst[0][1] <= STEP_GRAD_REL_NORM,
          f"phase 16 fp32 gradients: ||kernels - plain|| / ||plain|| "
          f"over the limit {STEP_GRAD_REL_NORM}: {worst}")
    del model, grads
    torch.cuda.empty_cache()
    return out


def phase_moe(tmp, corpus):
    """Phase 16: CLIP ViT-B/32 at full width with both towers MoE (8
    experts, top-2, capacity 1.25, aux 0.01) through the solver's
    ``main`` on phase 7's corpus (bf16, B=128, the YFCC15M CLIP recipe as
    its file has it, the data paths and frequencies set), MOE_STEPS
    steps, saved once at the end, with its zero-shot eval: losses finite, no
    update skipped, ``moe_aux_loss`` logged and above 0, a router's and
    an expert's weights moved, the exact K1/K2 launches; the share of
    token choices the capacity dropped; steps 4-6, the device's busy
    time and idle share over repeated-batch steps, the index kernels
    that dispatch and combine, peak memory; then one fp32 step against
    the plain attention path (``_moe_fp32_check``)."""
    import numpy as np
    import torch

    from declip_tpu_torch import solver as solver_mod
    from declip_tpu_torch.config import override, parse_config

    # no periodic save: the one at the end is about 8 GiB (the weights
    # and Adam's two slots of 0.7 B parameters)
    cfg_path, sets = solver_experiment(tmp, "exp_moe", corpus, CLIP_RECIPE,
                                       save_freq=0)
    sets += _moe_sets() + [f"lr_scheduler.kwargs.max_iter={MOE_STEPS}"]
    exp = os.path.dirname(cfg_path)
    watch = ("visual.transformer.resblocks.0.moe.router",
             "visual.transformer.resblocks.0.moe.wi",
             "encode_text.transformer.resblocks.11.moe.router",
             "encode_text.transformer.resblocks.11.moe.wo")
    rec = {"kept": []}
    real_train = solver_mod.Solver.train

    def recording_train(self):
        named = dict(self.model.named_parameters())
        rec["before"] = {n: named[n].detach().clone() for n in watch}
        inner = self._train_step
        blocks = _moe_blocks(self.model)

        def step(state, batch):
            out = inner(state, batch)
            rec["kept"].append([m.kept for _, m in blocks])
            return out

        self._train_step = step
        return real_train(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver_mod.Solver.train = recording_train
    try:
        with _CallCounter() as plain:
            reset_launches()  # a main path starts
            t = time.perf_counter()
            solver = solver_mod.main(["--config", cfg_path, "--device",
                                      "cuda", "--set", *sets])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            launches = read_launches()  # ... and ends
    finally:
        solver_mod.Solver.train = real_train
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(plain.calls == 0, f"phase 16: {plain.calls} plain calls")
    model = solver.model
    vis, txt = model.visual, model.encode_text
    blocks = _moe_blocks(model)
    n_params = sum(p.numel() for p in model.parameters())
    check((solver.method, vis.width, len(vis.transformer.resblocks),
           txt.width, len(txt.transformer.resblocks), vis.dtype,
           solver.global_batch, len(blocks),
           {(m.num_experts, m.top_k, m.capacity_factor) for _, m in blocks})
          == ("clip", 768, 12, 512, 12, torch.bfloat16, TRAIN_BATCH, 24,
              {(MOE["num_experts"], MOE["top_k"],
                MOE["capacity_factor"])}),
          "phase 16: not the MoE CLIP ViT-B/32 at full width")
    eval_batches = -(-SOLVER_CLASSES * SOLVER_PER_CLASS // TRAIN_BATCH)
    scalars, top = _solver_checks("phase 16", solver, exp, MOE_STEPS,
                                  CLIP_PER_STEP, eval_batches, launches)
    aux = [v for _, v in scalars.get("moe_aux_loss", [])]
    check(len(aux) == MOE_STEPS and min(aux) > 0,
          f"phase 16: moe_aux_loss {aux}")
    named = dict(model.named_parameters())
    moved = {n: float((named[n].detach() - b).abs().max())
             for n, b in rec["before"].items()}
    check(all(v > 0 for v in moved.values()),
          f"phase 16: weights did not move: {moved}")
    tokens = {"visual": TRAIN_BATCH * 50, "encode_text": TRAIN_BATCH * 77}
    dropped = []
    for kept in rec["kept"]:
        shares = [_dropped_share([int(x) for x in k.tolist()],
                                 tokens[n.split(".")[0]], MOE["top_k"])
                  for (n, _), k in zip(blocks, kept)]
        dropped.append(shares)
    drops = np.asarray(dropped)
    window = solver_window(solver.timings, *SOLVER_TIMED, TRAIN_BATCH)
    step_ms = window["step_s_without_saves"] * 1e3

    # the device's busy time over repeated-batch steps on the solver's
    # state; the captions in the recipe's own (byte-level) vocabulary
    from declip_tpu_torch.tokenizer import get_tokenizer

    rng = np.random.default_rng(SEED)
    ids = get_tokenizer().tokenize(
        [f"a photo of shape {i} in colour {i % 7}"
         for i in range(TRAIN_BATCH)])
    check(int(np.max(ids)) < txt.vocab_size,
          f"phase 16: token ids beyond the vocab of {txt.vocab_size}")
    batch = {"images": torch.from_numpy(rng.normal(
                 size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
             "tokens": torch.from_numpy(np.asarray(ids)).long().cuda()}
    step = solver._train_step
    for _ in range(2):
        step(solver.state, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MOE_TIMED_STEPS):
        step(solver.state, batch)
    end.record()
    end.synchronize()
    repeated_ms = start.elapsed_time(end) / MOE_TIMED_STEPS
    dev = device_events(lambda: step(solver.state, batch), MOE_TIMED_STEPS)
    check(dev, "phase 16: the profiler saw no device time")
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / MOE_TIMED_STEPS
    busy = sum(by_name.values())
    index_ms = sum(v for n, v in by_name.items()
                   if any(t in n.lower() for t in ("index", "gather",
                                                    "scatter")))
    expert_gemm = {n[:90]: round(v, 3) for n, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:6]}
    del solver, step, model, named, rec, vis, txt, blocks
    torch.cuda.empty_cache()

    cfg = parse_config(cfg_path)
    for kv in _moe_sets():
        key, _, value = kv.partition("=")
        cfg = override(cfg, key, json.loads(value))
    fp32 = _moe_fp32_check(cfg, batch)
    out = {"launches": launches, "wall_s": wall_s, "params": n_params,
           "losses": [v for _, v in scalars["loss"]], "moe_aux_loss": aux,
           "top1": top["top1"], "top5": top["top5"], "moved": moved,
           "dropped_share": dropped,
           "dropped_share_mean": float(drops.mean()),
           "dropped_share_max": float(drops.max()), "window": window,
           "peak_device_mib": peak_mib, "repeated_step_ms": repeated_ms,
           "busy_ms": busy, "idle_share": 1 - busy / repeated_ms,
           "index_kernels_ms": index_ms, "top_kernels_ms": expert_gemm,
           "fp32": fp32}
    print(f"phase 16: MoE CLIP ViT-B/32 ({n_params / 1e6:.1f} M fp32 "
          f"params; {MOE}) through main: {MOE_STEPS} steps in "
          f"{wall_s:.1f} s with the eval; losses "
          f"{[round(x, 4) for x in out['losses']]}; moe_aux_loss "
          f"{[round(x, 5) for x in aux]}; zero-shot top1 {top['top1']:.2f} "
          f"top5 {top['top5']:.2f}; the capacity dropped "
          f"{drops.mean():.2%} of the token choices on average (the worst "
          f"block and step {drops.max():.2%}; by step, the mean "
          f"{[round(float(x), 4) for x in drops.mean(1)]}); steps "
          f"{SOLVER_TIMED[0]}-{SOLVER_TIMED[1]}: {step_ms:.2f} ms/step "
          f"without the save ({window['data_s'] * 1e3:.2f} waiting for "
          f"data); repeated-batch step {repeated_ms:.2f} ms (CUDA events), "
          f"device busy {busy:.2f} ms, idle share {out['idle_share']:.1%}; "
          f"index/gather/scatter kernels (MoE dispatch and combine and "
          f"their backward, with the embedding and EOT lookups) "
          f"{index_ms:.2f} ms a step; peak device memory {peak_mib:.0f} "
          f"MiB; kernel calls {launches}", flush=True)
    for n, v in expert_gemm.items():
        print(f"  {v:8.3f} ms  {n}")
    return out


def _path_sums(rows, cases, dtype_name, prefix=""):
    """Each time summed over the path's shapes in one dtype; the path is
    bound by what bounds its largest bound."""
    main = [r for r in rows if r["dtype"] == dtype_name and
            (*r["shape"], r["causal"]) in cases]
    check(len(main) == len(cases), "main-path shapes missing")
    out = {key: sum(r[prefix + key] for r in main)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = max(main, key=lambda r: r[prefix + "bound_ms"])[
        prefix + "bound_by"]
    out["max_abs_err"] = max(r[prefix + "max_abs_err"] for r in main)
    return out


def _li_entries(li_rows, li_paths, k3_eval):
    """K3, K4 and K5: launches from the paths that run them (``li_paths``:
    {path: launches by kernel}); times summed over the FILIP training
    path's two calls (image and text queries, B=128, bf16, the continuous
    unit vectors), errors the largest over every shape checked in that
    dtype. plain_ms is each kernel's own plain version (K3's makes the raw
    logits and the winner mask; K4's and K5's contract the mask).
    "k3_k4_k5" is the three together, against the sum of their bounds. K3
    also carries its times at the dense eval's shape under "eval"."""
    main = [r for r in li_rows if r["dtype"] == "bfloat16" and not r["ties"]
            and tuple(r["shape"]) in LI_MAIN_CASES]
    check(len(main) == len(LI_MAIN_CASES), "main-path shapes missing")
    entries = []
    for kname, name, line in (("K3", "late_interaction_fwd", 89),
                              ("K4", "late_interaction_bwd_d1", 107),
                              ("K5", "late_interaction_bwd_d2", 130)):
        sums = {key: sum(r[kname][key] for r in main)
                for key in ("ms", "plain_ms", "bound_ms")}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "declip_tpu_torch/csrc/filip_li.cu",
            "replaces": f"declip_tpu/ops/filip_pallas.py:{line}",
            "launches": sum(p[kname] for p in li_paths.values()),
            "launches_by_path": {path: p[kname]
                                 for path, p in li_paths.items()},
            "max_abs_err": max(r[kname]["max_abs_err"] for r in li_rows
                               if r["dtype"] == "bfloat16"),
            **sums,
            "bound_by": max(main, key=lambda r: r[kname]["bound_ms"])[
                kname]["bound_by"],
            "library_ms": None,
            "times_for": "FILIP training path: B=GB=128, N1=49 + N1=77, "
                         "N2=16, D=256, bf16",
        })
    entries[0]["eval"] = {
        **{k: k3_eval[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "matmul_ms", "timer")},
        "library_ms": None,
        "times_for": "dense zero-shot eval: B=128, N1=49 against C=1000, "
                     "N2=77, D=256, bf16; matmul_ms is its product alone"}
    total = {key: sum(e[key] for e in entries)
             for key in ("ms", "bound_ms")}
    for e in entries:
        e["k3_k4_k5"] = total
    return entries


def kernels_line(rows, bwd_rows, li_rows, k3_eval, slice_result,
                 train_result, filip_result, declip_result, solver_result,
                 fast_result, methods_result, solver_methods_result,
                 last_result, ssl_result, tools_result, modules_result,
                 moe_result):
    """One entry per kernel. K1 is on every path: its launches are the sum
    over the paths, each counted from 0 around it; its times are the
    serving path's (the sum over its two shapes, image L=50 and text L=77
    causal, at B=8 in fp32, device time per call), with the training
    path's beside them under "train" (B=128, bf16, with the log-sum-exp;
    its error is that of its output O). K2 runs on the training paths: its
    times are the sum over the same two shapes at B=128 in bf16 (the
    DeCLIP step's text passes run both at L=77 causal). K3-K5 run on the
    FILIP, DeFILIP (with and without dense_aug) and DeFILIP solver paths
    (``_li_entries``). The solver's runs (phase 7: the DeCLIP recipe
    through ``solver.main``, eval included; its resume; phase 8's fast
    input path; phase 10's DeFILIP and SLIP-R50; phase 12's SigLIP and
    DeCLIP-88M recipes, its fp32 loss-kind steps and its bf16 steps with
    and without GradCache; phase 13's MoCo, SimCLR and CLSA ViT-B/32
    steps) add to the launches, and so does phase 14's serving tools (the
    artifacts, int8, the two hosts, inference with saliency, the profiled
    solver run), phase 15's learnability run, linear probe, text
    visualisation and HF-tower DeCLIP steps, and phase 16's MoE CLIP
    through the solver, eval included."""
    serve = _path_sums(rows, MAIN_PATH_CASES, "float32")
    k1_train = _path_sums(bwd_rows, TRAIN_CASES, "bfloat16", prefix="fwd_")
    k2 = _path_sums(bwd_rows, TRAIN_CASES, "bfloat16")
    paths = {"train_filip": filip_result["launches"],
             "train_declip": declip_result["launches"],
             "solver": solver_result["launches"],
             "solver_resume": solver_result["resume_launches"],
             "solver_fast_input": fast_result["launches"],
             "train_defilip": methods_result["defilip"]["launches"],
             "train_defilip_dense_aug":
                 methods_result["defilip"]["dense_aug_launches"],
             "train_slip": methods_result["slip"]["launches"],
             "solver_defilip": solver_methods_result["defilip"]["launches"],
             "solver_slip_r50": solver_methods_result["slip_r50"]["launches"],
             "solver_siglip": last_result["siglip"]["launches"],
             "solver_siglip_resume":
                 last_result["siglip"]["resume"]["launches"],
             "solver_declip88m": last_result["declip88m"]["launches"],
             "loss_impl_fp32": last_result["loss_impl"]["launches"],
             **{f"grad_cache_bf16_{k}": v["launches"] for k, v in
                last_result["loss_impl"]["bf16"].items()
                if isinstance(v, dict)},
             **{f"train_{name}": r["launches"]
                for name, r in ssl_result["train"].items()},
             "learnability": modules_result["learnability"]["launches"],
             "linear_probe": modules_result["probe"]["launches"],
             "text_visualize":
                 modules_result["text_visualize"]["launches"],
             "solver_moe": moe_result["launches"]}
    if modules_result["hf_text"].get("launches"):
        paths["train_declip_hf_text"] = modules_result["hf_text"][
            "launches"]
    k1_paths = {"serve": slice_result["launches"],
                "train": train_result["launches"],
                **{p: n["K1"] for p, n in paths.items()},
                "serving_tools": tools_result["launches"]["K1"]}
    k2_paths = {"train": train_result["bwd_launches"],
                **{p: n["K2"] for p, n in paths.items()},
                "serving_tools": tools_result["launches"]["K2"]}
    li_paths = {p: n for p, n in paths.items()
                if any(n[k] for k in ("K3", "K4", "K5"))}
    return {"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "declip_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "declip_tpu/ops/flash_attention.py:41",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "times_for": "serving path: B=8, L=50 + L=77 causal, fp32",
        "train": {**k1_train,
                  "times_for": "training path: B=128, L=50 + L=77 causal, "
                               "bf16, with lse"},
    }, {
        "name": "flash_attn_bwd",
        "route": "cuda",
        "source": "declip_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "declip_tpu/ops/flash_attention.py:72",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "times_for": "training path: B=128, L=50 + L=77 causal, bf16",
    }, *_li_entries(li_rows, li_paths, k3_eval)]}


PHASE_S = {}  # each phase's wall seconds


def timed(name, phase, *args):
    t = time.perf_counter()
    out = phase(*args)
    PHASE_S[name] = time.perf_counter() - t
    print(f"[phase {name}: {PHASE_S[name]:.1f} s]", flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # fp32 means fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python "
          f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_solver_")
    exports = None
    try:
        card, corpus, pending = timed("build", phase_card_and_build, tmp)
        rows = timed("kernels", phase_kernel_vs_plain)
        bwd_rows = timed("backward", phase_backward)
        ptxas = finish_build(pending)
        hmma = check_tensor_cores(ptxas)
        li_rows = timed("late_interaction", phase_late_interaction)
        k3_eval = timed("k3_eval", phase_k3_eval_shape)
        slice_result = timed("serve", phase_slice)
        train_result = timed("train", phase_train)
        filip_result = timed("train_filip", phase_train_filip)
        declip_result = timed("train_declip", phase_train_declip)
        # phase 14 runs here, early: late in a full run the profiler once
        # saw no device events (PERF.md), and its trace check needs them
        tools_result = timed("serving_tools", phase_serving_tools, tmp,
                             corpus, slice_result, train_result,
                             declip_result)
        solver_result = timed("solver", phase_solver, declip_result,
                              tmp, corpus)
        fast_result = timed("fast_input", phase_fast_input,
                            solver_result, tmp, corpus)
        methods_result = timed("train_methods", phase_train_methods)
        # whether the profiler still sees the card around phase 10 (in
        # earlier full runs it saw no device events at its end)
        probe = {"before_phase_10": profiler_sees_device()}
        solver_methods_result = timed("solver_methods",
                                      phase_solver_methods, tmp, corpus)
        probe["after_phase_10"] = profiler_sees_device()
        print(f"the profiler sees device events: {probe}", flush=True)
        dp_result, exports = timed("data_parallel", phase_data_parallel,
                                   solver_result, tmp, corpus, tools_result)
        late = timed("serving_exports", phase_serving_exports,
                     tools_result, exports, slice_result)
        exports = None
        tools_result = {"first": tools_result, "exports": late,
                        "launches": {k: v + late["launches"][k] for k, v
                                     in tools_result["launches"].items()}}
        last_result = timed("last_configs", phase_last_configs, tmp, corpus,
                            train_result)
        ssl_result = timed("ssl", phase_ssl, tmp, corpus)
        modules_result = timed("last_modules", phase_last_modules, tmp,
                               card)
        moe_result = timed("moe", phase_moe, tmp, corpus)
    finally:
        stop_serving_exports(exports)
        shutil.rmtree(tmp, ignore_errors=True)
    line = kernels_line(rows, bwd_rows, li_rows, k3_eval, slice_result,
                        train_result, filip_result, declip_result,
                        solver_result, fast_result, methods_result,
                        solver_methods_result, last_result, ssl_result,
                        tools_result, modules_result, moe_result)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "hmma": hmma,
                   "attention": rows,
                   "attention_bwd": bwd_rows, "late_interaction": li_rows,
                   "k3_eval": k3_eval, "profiler_probe": probe,
                   "slice": slice_result, "train": train_result,
                   "train_filip": filip_result,
                   "train_declip": declip_result, "solver": solver_result,
                   "solver_fast_input": fast_result,
                   "train_methods": methods_result,
                   "solver_methods": solver_methods_result,
                   "data_parallel": dp_result,
                   "last_configs": last_result, "ssl": ssl_result,
                   "serving_tools": tools_result,
                   "last_modules": modules_result, "moe": moe_result,
                   "kernels": line["kernels"], "phase_s": PHASE_S,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    print(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def time_train_step(argv):
    """``python3 chip_smoke.py --time-step [--root DIR] [--tag T]``: phase
    4's training step alone (CLIP ViT-B/32, bf16, B=128; built by
    :func:`build_clip` and :func:`clip_train_step`) with the
    ``declip_tpu_torch`` of the checkout ``--root`` (default: this one),
    so that two trees are compared in turns, one process each, on one
    card. 3 warm-up steps, then 5 rounds of 20 steps: each round's ms a
    step by CUDA events, by the host's clock (the round ends in a
    synchronise) and in the process's CPU time (all its threads: less
    moved than the clock by other work on a shared host), and the time
    the host spent in Python's garbage collector, by generation; then 3 steps under ``torch.profiler`` with
    CPU activity alone, whose 25 largest operators by self CPU time are
    printed; then the host's cost of one ``flash_attention`` call without
    a gradient at [1, 1, 16, 64] bf16 (a few microseconds of kernel),
    over 2000 calls; then the serving path's one-row latency, each fp32
    tower of the same model called alone (p50 and p95 of 50 calls). In a
    tree whose K1 and K2 are registered operators (``ops/_oplib.py``), the
    step (8 rounds of 10) and the one-row image tower (8 rounds of 20) are
    also timed in this one process through the operators and through
    direct calls of their CUDA implementations, rounds alternated. The
    last line is one JSON object."""
    import argparse
    import gc

    import numpy as np

    ap = argparse.ArgumentParser(prog="chip_smoke.py --time-step")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose declip_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a label for the JSON line")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import declip_tpu_torch
    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.ops.flash_attention import flash_attention

    pkg = os.path.dirname(os.path.abspath(declip_tpu_torch.__file__))
    check(os.path.dirname(pkg) == root,
          f"declip_tpu_torch came from {pkg}, not from {root}")
    check(torch.cuda.is_available(), "--time-step times the card's step")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = parse_config(TRAIN_CONFIG)
    model = build_clip(cfg, cfg.precision.dtype)
    _, state, step, batch = clip_train_step(cfg, model)

    def run(n):
        out = [step(state, batch)[1]["loss"] for _ in range(n)]
        return float(out[-1])

    gc_ms = {0: 0.0, 1: 0.0, 2: 0.0}
    gc_n = {0: 0, 1: 0, 2: 0}
    gc_t = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t["t"] = time.perf_counter()
        elif "t" in gc_t:
            gc_ms[info["generation"]] += (time.perf_counter()
                                          - gc_t.pop("t")) * 1e3
            gc_n[info["generation"]] += 1

    run(3)
    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    rounds = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0, c0 = time.perf_counter(), time.process_time()
        start.record()
        loss = run(20)
        end.record()
        end.synchronize()
        rounds.append({"step_ms": start.elapsed_time(end) / 20,
                       "host_ms": (time.perf_counter() - t0) * 1e3 / 20,
                       "cpu_ms": (time.process_time() - c0) * 1e3 / 20,
                       "loss": loss})
        print(f"{args.tag} B={TRAIN_BATCH}: {rounds[-1]['step_ms']:.3f} "
              f"ms/step (CUDA events), host {rounds[-1]['host_ms']:.3f}, "
              f"CPU time {rounds[-1]['cpu_ms']:.3f}", flush=True)
    gc.callbacks.remove(on_gc)
    gc_info = {"ms_a_step": {g: v / 100 for g, v in gc_ms.items()},
               "collections": gc_n, "tracked_objects": len(gc.get_objects()),
               "modules": len(sys.modules),
               "torch_dynamo_imported": "torch._dynamo" in sys.modules}
    print(f"{args.tag}: garbage collection over the 100 steps {gc_info}",
          flush=True)
    fa_mod = sys.modules["declip_tpu_torch.ops.flash_attention"]
    # a tree whose K1/K2 are registered operators: each call through the
    # operator against a direct call of its CUDA implementation (the
    # launch alone, as before the registration), in this one process,
    # rounds alternated, so the host's drift between processes drops out
    registered = hasattr(fa_mod, "_fwd_cuda")
    routes = {"op": (fa_mod.flash_attn_fwd_op, fa_mod.flash_attn_bwd_op),
              "direct": (fa_mod._fwd_cuda, fa_mod._bwd_cuda)} \
        if registered else {}

    def route(name):
        fa_mod.flash_attn_fwd_op, fa_mod.flash_attn_bwd_op = routes[name]

    def alternated(fn, rounds):
        """-> {route: [fn()'s value each round]}, op/direct in ABBA order,
        the operator route restored at the end."""
        out = {"op": [], "direct": []}
        for i in range(rounds):
            order = ("op", "direct") if i % 2 == 0 else ("direct", "op")
            for name in order:
                route(name)
                out[name].append(fn())
        route("op")
        return out

    def step_round():
        run(2)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(10)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10

    step_ab = alternated(step_round, 8) if registered else None
    if step_ab:
        print(f"{args.tag}: in one process, ms a step through the "
              f"operators {[round(t, 2) for t in step_ab['op']]}, through "
              f"direct calls {[round(t, 2) for t in step_ab['direct']]}",
              flush=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(3)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:25]
    host_ops = [{"name": e.key, "calls": e.count,
                 "self_cpu_ms_a_step": e.self_cpu_time_total / 3e3,
                 "cpu_ms_a_step": e.cpu_time_total / 3e3} for e in top]
    print(f"{args.tag}: host profile, 3 steps, by self CPU time a step:")
    for op in host_ops:
        print(f"  {op['self_cpu_ms_a_step']:8.3f} ms self "
              f"{op['cpu_ms_a_step']:8.3f} total {op['calls'] // 3:5d} "
              f"calls  {op['name'][:90]}")
    q = torch.randn(1, 1, 16, 64, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        for _ in range(100):
            flash_attention(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            flash_attention(q, q, q)
        torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) * 1e6 / 2000
    print(f"{args.tag}: flash_attention without a gradient, [1, 1, 16, 64] "
          f"bf16: {call_us:.2f} us a call on the host", flush=True)
    del state, step, model
    torch.cuda.empty_cache()
    # the serving path's one-row latency: each tower of the same model in
    # fp32 (phase 3's towers), one call at a time, each synchronised
    model = build_clip(cfg, "float32").eval()
    rng = np.random.default_rng(SEED)
    one_row = {"image": (model.encode_image, torch.from_numpy(rng.normal(
                   size=(1, 224, 224, 3)).astype(np.float32)).cuda()),
               "text": (model.encode_text,
                        torch.from_numpy(_tokens(rng, 1)).cuda())}
    tower_ms = {}
    with torch.no_grad():
        for kind, (tower, x) in one_row.items():
            times = []
            for i in range(60):
                t0 = time.perf_counter()
                tower(x)
                torch.cuda.synchronize()
                if i >= 10:
                    times.append((time.perf_counter() - t0) * 1e3)
            tower_ms[kind] = {"p50_ms": float(np.percentile(times, 50)),
                              "p95_ms": float(np.percentile(times, 95))}
    print(f"{args.tag}: one-row fp32 tower call, host wall: {tower_ms}",
          flush=True)

    def one_row_round():
        tower, x = one_row["image"]
        t0 = time.perf_counter()
        for _ in range(20):
            tower(x)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 20

    with torch.no_grad():
        row_ab = alternated(one_row_round, 8) if registered else None
    if row_ab:
        print(f"{args.tag}: in one process, one-row fp32 image tower ms a "
              f"call through the operators "
              f"{[round(t, 3) for t in row_ab['op']]}, through direct "
              f"calls {[round(t, 3) for t in row_ab['direct']]}",
              flush=True)
    print(card)
    print(json.dumps({"tag": args.tag, "root": root, "card": card,
                      "batch": TRAIN_BATCH, "steps": 20, "rounds": rounds,
                      "gc": gc_info, "host_ops": host_ops,
                      "k1_call_us": call_us, "one_row_ms": tower_ms,
                      "step_ms_op_vs_direct": step_ab,
                      "one_row_image_ms_op_vs_direct": row_ab}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-step"]:
        sys.exit(time_train_step(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase-11a-rank"]:
        sys.exit(dp_launcher_rank(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--phase-11b-rank"]:
        sys.exit(dp_rank(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--ssl-loader-rates"]:
        sys.exit(ssl_loader_rates())
    sys.exit(main())
