"""Config-driven training/eval solver (port of declip_tpu/solver/__init__.py).

    python -m declip_tpu_torch.solver --config <experiment>/config.yaml \
        [--set dotted.key=value ...] [--evaluate] [--device cuda]
    python -m torch.distributed.run --nproc_per_node 8 \
        -m declip_tpu_torch.solver --config <experiment>/config.yaml
    srun --ntasks-per-node 8 python -m declip_tpu_torch.solver --config ...

One generic Solver replaces the reference's five per-method ClsSolver
classes (prototype/solver/{clip,slip,filip,declip,defilip}_solver.py); the
method is inferred from the model type. Preserved reference contracts, as
in the JAX package:

- experiment-dir layout: checkpoints/ events/ results/ log.txt next to
  config.yaml (clip_solver.py:110-117);
- saver semantics: auto_resume from the newest ckpt, save every save_freq,
  long-horizon copies every 20x save_freq (declip_solver.py:796-815);
- zero-shot protocol: per-class prompt-ensemble text embeddings, image@class
  logits, softmax x ensemble matrix, per-rank JSONL dump, top-k
  (clip_solver.py:675-737);
- loss-spike/NaN auto-rollback: reload an old checkpoint, decay warmup_lr by
  0.997, rebuild optimizer+schedule (declip_solver.py:548-619);
- EMA evaluation swap (declip_solver.py:778-787).

The port trains on one process a device. Under torchrun or SLURM each
process joins the data-parallel group (``parallel.init_distributed``) and
drives ``cuda:LOCAL_RANK`` by default: the reference's ``batch_size`` is
per rank, the sampler gives each rank its slab of the global stream, the
step runs the global-batch losses over gathered features, BatchNorm across
its rank group and the gradient mean over every rank (train/train_step.py);
rank 0 alone logs, writes scalars and checkpoints, and the eval splits its
images over the ranks and merges their scores in rank order. A checkpoint
resumes on another world size where the global batch stays the same (the
sampler re-shards the original run's stream, data/sampler.py). Without a
launcher ``device`` defaults to ``cuda`` and raises where CUDA is absent
(pass ``cpu`` to run on the CPU).
The host loader's batches are staged into pinned memory on a prefetch
thread and copied to the card on a side stream, which the step's stream
waits for. With ``data.train.device_aug`` the loader ships uint8
geometry crops (its transform is passed on to process workers too) and the
step runs the photometrics on the card. The FILIP family (FILIP, DeFILIP)
evaluates zero-shot by token-wise late interaction unless a test entry sets
``dense_eval: false`` (filip_solver.py:839-960): each image's dense tokens
against each class's prompt-averaged dense tokens, through K3 on the card.
The SSL builders (``moco_*``, ``simclr_*``, ``clsa_*``) train with their
two-view default transforms (MOCOV2, SIMCLR, CLSA; CLSA's is built once
here and handed to process workers, so that a drawn resolution is every
worker's), their key encoder and queue in the train state and the
checkpoint; they have no text tower, so a config of theirs with a
``data.test`` entry raises, as zero-shot needs one (the JAX package has no
SSL eval either).
``parallelism: {fsdp: true}`` shards every large parameter, its
optimizer slots and its EMA over the data ranks (ZeRO-3,
parallel/fsdp.py), and ``parallelism: {ep: N}`` places a MoE tower's
experts on expert groups of N adjacent ranks (parallel/mesh.py); the
checkpoints keep the world-1 format either way, so such a run resumes at
any world. Not in the port yet, each raising when the Solver is built:
the other ``parallelism`` keys (``tp``, ``sp``, ``pp``, ``slices``) and
``{ep, fsdp}`` together (ROADMAP.md item 1.10), and the orbax backend
and ``gs://`` saves (TPU/pod-only in the JAX package). The JAX package's compile cache has no counterpart here.

The ``profile`` key (``enable``, ``start_step`` 10, ``num_steps`` 5) traces
on rank 0 with ``torch.profiler`` (the CPU, and CUDA where the solver runs
on the card) into ``<event_path>/profile`` through
``tensorboard_trace_handler``, in the window of the JAX package's
``jax.profiler`` trace (declip_tpu/solver/__init__.py:618-649): from the
step that takes the step count to ``start_step`` through the one that
takes it to ``start_step + num_steps``, the card synchronised before the
trace stops. One difference: where the loop ends inside the window
(``max_iter``, a preemption, or a rollback that moves the step), the port
stops the profiler and writes what it has, where the JAX package leaves
its trace running.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import signal
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from declip_tpu_torch.checkpoint import (
    broadcast_state,
    find_last_checkpoint,
    gc_checkpoints,
    list_checkpoints,
    load_checkpoint_meta,
    load_pretrain,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending_saves,
)
from declip_tpu_torch.config import Cfg, override, parse_config
from declip_tpu_torch.data.dataloader import (
    ClipDataLoader,
    build_clip_dataloader,
    build_clip_dataset,
)
from declip_tpu_torch.data.evaluator import (
    ImageNetEvaluator,
    Metric,
    RetrievalEvaluator,
)
from declip_tpu_torch.data.sampler import compute_total_iter
from declip_tpu_torch.data.transforms import (
    build_common_augmentation,
    build_geometry_augmentation,
)
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.clip_model import l2_normalize
from declip_tpu_torch.models.layers import discard_bn_stats
from declip_tpu_torch.models.memory_bank import init_bank
from declip_tpu_torch.models.ssl_builders import init_moco_state
from declip_tpu_torch.parallel.fsdp import (
    make_plan,
    set_plan,
    shard_train_state,
)
from declip_tpu_torch.parallel.mesh import bind_experts, make_mesh
from declip_tpu_torch.ops.filip_late_interaction import (
    late_interaction_logits_kernel,
)
from declip_tpu_torch.optim import (
    fast_forward_schedule,
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
    state_bytes,
)
from declip_tpu_torch.parallel import comms, dist
from declip_tpu_torch.tokenizer import get_tokenizer
from declip_tpu_torch.tools._common import find_jax_checkpoint, resolve_device
from declip_tpu_torch.train import (
    EmaConfig,
    init_ema,
    make_train_step,
    method_of,
    new_train_state,
)
from declip_tpu_torch.utils.logging import ScalarWriter, create_logger
from declip_tpu_torch.utils.meters import AverageMeter, MeterGroup

# batch entries the model takes; the loader's labels and raw lists stay on
# the host
_HOST_ONLY = ("labels",)


def batched_class_embeddings(encode_text, ids: np.ndarray, n_class: int,
                             prompts_num: int, classes_per_call: int,
                             device) -> torch.Tensor:
    """[n_class, ...] normalized class embeddings from ``encode_text`` over
    [n_class * prompts_num, L] prompt ids ([n_class, D] pooled, [n_class,
    L, D] dense), in chunks of ``classes_per_call`` classes; the tail chunk
    is padded with copies of the last class so every call has one shape.
    Per class, as the reference (clip_solver.py:688-700,
    filip_solver.py:845-860): L2-normalize each prompt embedding (each
    token, when dense), mean over the class's prompts, L2-normalize the
    mean."""
    out = []
    for beg in range(0, n_class, classes_per_call):
        cls = min(classes_per_call, n_class - beg)
        chunk = ids[beg * prompts_num:(beg + cls) * prompts_num]
        if cls < classes_per_call:
            pad = np.tile(chunk[-prompts_num:], (classes_per_call - cls, 1))
            chunk = np.concatenate([chunk, pad])
        emb = l2_normalize(encode_text(torch.from_numpy(chunk).to(device)))
        emb = emb.reshape((classes_per_call, prompts_num) + emb.shape[1:])
        out.append(l2_normalize(emb.mean(dim=1))[:cls])
    return torch.cat(out)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item {item})")


class Solver:
    def __init__(self, config, *, device=None):
        """``device``: None for ``cuda:LOCAL_RANK`` under a launcher and
        ``cuda`` without one. A process that has joined its group already
        (``parallel.init_distributed``) keeps it."""
        if isinstance(config, str):
            config = parse_config(config)
        self.config = config
        pcfg = dict(self.config.get("parallelism") or {})
        for key in ("tp", "pp", "slices"):
            if int(pcfg.get(key, 1) or 1) > 1:
                raise _not_ported(f"parallelism {key}: {pcfg[key]}",
                                  "1.10")
        if pcfg.get("sp"):
            raise _not_ported("parallelism sp", "1.10")
        ep = int(pcfg.get("ep", 1) or 1)
        self.fsdp = bool(pcfg.get("fsdp", False))
        if ep > 1 and self.fsdp:
            raise _not_ported(
                "parallelism {ep, fsdp} together (the JAX package composes "
                "them through tp_fsdp_state_shardings)", "1.10")
        self.device = resolve_device(dist.init_distributed(device))
        self.rank, self.world = dist.rank(), dist.world()
        # the data-parallel group (None: one process without a launcher)
        self.group = dist.data_group()
        # ep's expert groups (parallel/mesh.py); the batch shards over
        # every rank, so ep does not divide the data ways
        self.mesh = make_mesh(self.group, ep)
        self.data_ways = self.world
        self.setup_env()
        self.build_model()
        self.build_data()
        self.build_optimizer()
        self.init_state()
        self.build_step()

    # ------------------------------------------------------------------ env
    def setup_env(self):
        cfg_path = self.config.get("_config_path")
        base = osp.dirname(cfg_path) if cfg_path else os.getcwd()
        save_root = self.config.get_path("saver.save_path")
        if save_root and "://" in str(save_root):
            raise NotImplementedError(
                f"saver.save_path {save_root}: object-store checkpoints are "
                f"not ported; the port saves to a local path")
        if save_root:
            ckpt_path = str(save_root)
            ckpt_k = osp.join(osp.dirname(ckpt_path.rstrip("/")),
                              "checkpoints_k_times")
        else:
            ckpt_path = osp.join(base, "checkpoints")
            ckpt_k = osp.join(base, "checkpoints_k_times")
        self.path = Cfg(
            root_path=base,
            ckpt_path=ckpt_path,
            ckpt_k_times_path=ckpt_k,
            event_path=osp.join(base, "events"),
            result_path=osp.join(base, "results"),
        )
        for p in (self.path.ckpt_path, self.path.event_path,
                  self.path.result_path):
            os.makedirs(p, exist_ok=True)
        # rank 0 alone logs and writes the scalars
        self.logger = create_logger(osp.join(base, "log.txt"),
                                    rank=self.rank)
        self.writer = ScalarWriter(self.path.event_path,
                                   enabled=self.rank == 0)
        self.meters = MeterGroup(length=int(
            self.config.get_path("saver.print_freq", 10)))
        # per print: the window's wall time, its waits for data, the
        # synchronous part of its saves, and the newest batch's
        # host-to-device copy
        self.timings: List[Dict] = []
        self.eval_seconds: List[float] = []
        self.save_seconds: List[float] = []

    # ---------------------------------------------------------------- model
    def build_model(self):
        mcfg = self.config.model
        mtype = mcfg["type"]
        kwargs = dict(mcfg.get("kwargs") or {})
        prec = self.config.get_path("precision.dtype", "bfloat16")
        kwargs["dtype"] = prec
        # weights made on the CPU from a seed, then moved: one seed gives
        # the same weights on every device
        self.model = bind_experts(
            model_entry({"type": mtype, "kwargs": kwargs},
                        data_group=self.group), self.mesh)
        self.model.init_weights(torch.Generator().manual_seed(
            int(self.config.get_path("seed", 0))))
        self.model.to(self.device)
        self.method = method_of(self.model)
        self.logger.info(
            f"model={mtype} method={self.method} dtype={prec} "
            f"device={self.device} rank={self.rank} world={self.world}")

    # ----------------------------------------------------------------- data
    @staticmethod
    def normalize_data_config(dcfg: Dict) -> Dict:
        """Accept both the reference layout (batch_size/read_from at the
        data level, test entries nesting a second ``test`` dict —
        yfcc15m_r50_declip/config.yaml:81-131) and the flat layout."""
        dcfg = dict(dcfg or {})
        train = dict(dcfg.get("train") or {})
        for key in ("batch_size", "num_workers", "read_from", "input_size"):
            if key in dcfg and key not in train:
                train[key] = dcfg[key]
        tests = dcfg.get("test") or []
        if isinstance(tests, dict):
            tests = [tests]
        norm_tests = []
        for entry in tests:
            entry = dict(entry)
            inner = dict(entry.pop("test", {}) or {})
            norm_tests.append({**entry, **inner})
        return {"train": train, "test": norm_tests}

    def build_data(self):
        dcfg = self.normalize_data_config(self.config.get("data") or {})
        train_cfg = dict(dcfg.get("train") or {})
        # the SSL methods need two views (their model refuses fewer than 6
        # channels)
        train_cfg.setdefault("transforms", {"type": {
            "moco": "MOCOV2", "simclr": "SIMCLR", "clsa": "CLSA"}.get(
                self.method, "STANDARD_CLIP")})
        self.per_chip_batch = int(train_cfg.get("batch_size", 8))
        self.host_batch = self.per_chip_batch
        self.global_batch = self.per_chip_batch * self.data_ways
        # on-device augmentation: the loader ships the preset's uint8
        # geometry crops, and the step runs the photometrics on the card
        self.device_aug = self.train_transform = None
        if train_cfg.get("device_aug", False):
            views = {"clip": 1, "filip": 2, "slip": 3}.get(self.method, 2)
            tcfg = train_cfg["transforms"]
            preset = (tcfg.get("type", "STANDARD_CLIP")
                      if isinstance(tcfg, dict) else "STANDARD_CLIP")
            self.device_aug = {"views": views, "preset": preset}
            self.train_transform = build_geometry_augmentation(preset)
        else:
            tcfg = train_cfg["transforms"]
            if isinstance(tcfg, dict) and str(
                    tcfg.get("type", "")).startswith("CLSA"):
                self.train_transform = build_common_augmentation(
                    tcfg["type"])
        ds = build_clip_dataset(
            train_cfg, world_size=self.world, rank=self.rank,
            transform=self.train_transform)
        max_iter = self.config.get_path("lr_scheduler.kwargs.max_iter")
        self.max_iter = compute_total_iter(
            {**train_cfg, **({"max_iter": max_iter} if max_iter else {})},
            len(ds), self.data_ways)
        self.train_dataset = ds
        self.train_cfg = train_cfg
        self.test_cfgs: List[Dict] = list(dcfg.get("test") or [])
        if self.test_cfgs and self.method in ("moco", "simclr", "clsa"):
            raise ValueError(
                f"{self.method}: data.test asks for a zero-shot eval, which "
                f"needs a text tower for the class embeddings; an SSL model "
                f"has none (the JAX package has no SSL eval): remove "
                f"data.test")

    def _ckpt_meta(self) -> dict:
        """Topology sidecar: what the sampler stream was laid out for when
        this checkpoint was written."""
        return {"world_size": self.world, "host_batch": self.host_batch,
                "global_batch": self.global_batch}

    def _train_loader(self, last_iter: int) -> ClipDataLoader:
        split_cfg = dict(self.train_cfg)
        split_cfg["batch_size"] = self.host_batch
        if self._elastic_orig is not None:
            scfg = dict(split_cfg.get("sampler") or {})
            kw = dict(scfg.get("kwargs") or {})
            kw["orig_world_size"], kw["orig_batch_size"] = self._elastic_orig
            scfg["kwargs"] = kw
            split_cfg["sampler"] = scfg
        split_cfg.setdefault("seed", int(self.config.get_path("seed", 0)))
        # DeCLIP extras flow from the model config (declip.py:203-212)
        split_cfg["eda"] = bool(getattr(self.model, "EDA", False)) and \
            self.method in ("declip", "defilip")
        split_cfg["text_mask_type"] = getattr(
            self.model, "text_mask_type", None)
        # the transform goes to the loader as well as the dataset, so that
        # process workers, which rebuild the dataset, crop as it does
        return build_clip_dataloader(
            split_cfg, world_size=self.world, rank=self.rank,
            last_iter=last_iter, total_iter=self.max_iter,
            dataset=self.train_dataset, transform=self.train_transform,
        )

    # ------------------------------------------------------------ optimizer
    def build_optimizer(self):
        ocfg = dict(self.config.get("optimizer") or
                    {"type": "AdamW", "kwargs": {"lr": 1e-4}})
        scfg = dict(self.config.get("lr_scheduler") or
                    {"type": "Cosine",
                     "kwargs": {"base_lr": 0.0, "warmup_lr": 1e-3,
                                "warmup_steps": 0}})
        self._sched_cfg = scfg
        self._warmup_decay = 1.0
        self._iters_per_epoch = max(
            1, len(self.train_dataset) // max(self.global_batch, 1))
        self.schedule = scheduler_entry(
            scfg, max_iter=self.max_iter,
            iters_per_epoch=self._iters_per_epoch)
        self._opt_cfg = ocfg

    def _make_tx(self):
        named = dict(self.model.named_parameters())
        frozen_paths = getattr(self.model.visual, "frozen_param_paths",
                               lambda: ())()
        return optim_entry(
            self._opt_cfg, self.model, self.schedule,
            pconfig=self._opt_cfg.get("pconfig") or {},
            grad_clip=dict(self.config.get("grad_clip") or {}),
            frozen_mask=(path_prefix_mask(named, tuple(frozen_paths))
                         if frozen_paths else None),
        )

    # ---------------------------------------------------------------- state
    def _feature_dim(self) -> int:
        dim = getattr(self.model, "feature_dim", None)
        if dim:
            return int(dim)
        return int(self.model.encode_text.text_projection.out_features)

    def init_state(self):
        named = dict(self.model.named_parameters())
        self.tx = self._make_tx()
        seed = int(self.config.get_path("seed", 0))

        ema_cfg = None
        ema_params = None
        if self.config.get_path("ema.enable", False):
            kw = dict(self.config.get_path("ema.kwargs", {}) or {})
            kw.pop("model", None)
            ema_cfg = EmaConfig(
                decay=float(kw.get("decay", 0.999)),
                warmup=int(kw.get("warmup", 1)),
                inner_T=int(kw.get("inner_T", 1)),
                copy_init=bool(kw.get("copy_init", False)),
            )
            ema_params = init_ema(named, ema_cfg)
        self.ema_cfg = ema_cfg

        bank = None
        if getattr(self.model, "return_nn_bank", False):
            bank = init_bank(
                torch.Generator().manual_seed(seed + 1),
                int(getattr(self.model, "nn_size", 2 ** 16)),
                self._feature_dim(), device=self.device)

        ssl = None
        if self.method in ("moco", "clsa"):
            ssl = init_moco_state(
                self.model, torch.Generator().manual_seed(seed + 2),
                int(self.model.K), int(self.model.dim))

        guard = dict(self.config.get("grad_clip") or {}).get(
            "type") == "logit_scale_param_ema"
        state = new_train_state(
            model=self.model, opt_state=self.tx.init(named),
            ema_params=ema_params, bank_text=bank, with_logit_guard=guard,
            ssl=ssl)
        n_params = sum(p.numel() for p in named.values())
        self.logger.info(
            f"optimizer={self._opt_cfg['type']} state "
            f"{state_bytes(state.opt_state) / 2 ** 20:.1f} MiB "
            f"({', '.join(sorted(state.opt_state.slots)) or 'no slots'}) "
            f"for {n_params} parameters")

        # auto-resume (clip_solver.py:128-139)
        self.start_step = 0
        if self.config.get_path("saver.pretrain.auto_resume", True):
            if self.config.get_path("saver.backend") == "orbax":
                raise NotImplementedError(
                    "saver.backend orbax is TPU/pod-only and not ported; "
                    "the port writes ckpt_<step>.pth.tar")
            ckpt_dir = self.path.ckpt_path
            last = find_last_checkpoint(ckpt_dir)
            jax_ckpt = find_jax_checkpoint(ckpt_dir) if last is None else None
            if jax_ckpt is not None:
                cfg_path = self.config.get("_config_path", "<config.yaml>")
                raise FileNotFoundError(
                    f"{ckpt_dir} holds the JAX package's checkpoint "
                    f"{jax_ckpt} and no ckpt*.pth.tar; the port does not "
                    f"start such an experiment from scratch. Convert it "
                    f"(model weights only) and start from it with "
                    f"saver.pretrain.path:\n  python -m "
                    f"declip_tpu.tools.convert --config {cfg_path} --to_pth "
                    f"{jax_ckpt} --out <file>.pth.tar")
            if last is not None:
                restore_checkpoint(last, state)
                self.start_step = int(state.step)
                self.logger.info(
                    f"auto-resumed from {last} at step {self.start_step}")
        # world-size-elastic resume (as the JAX solver's): a checkpoint
        # written on another topology resumes on this one where the global
        # batch stays the same; the sampler rebuilds the original run's
        # global batches and re-shards them over this world, so every
        # global batch is the uninterrupted run's
        self._elastic_orig = None
        if self.start_step > 0:
            meta = load_checkpoint_meta(self.path.ckpt_path)
            ow = int(meta.get("world_size", self.world))
            ohb = int(meta.get("host_batch", self.host_batch))
            if (ow, ohb) != (self.world, self.host_batch):
                if ow * ohb != self.world * self.host_batch:
                    raise ValueError(
                        f"resuming a {ow} x batch {ohb} checkpoint on "
                        f"{self.world} x {self.host_batch} changes the "
                        f"global batch ({ow * ohb} -> "
                        f"{self.world * self.host_batch}); an elastic "
                        "resume keeps it: set batch_size")
                stype = dict(self.train_cfg.get("sampler") or {}).get(
                    "type", "distributed_iteration")
                if stype != "distributed_iteration":
                    raise ValueError(
                        "a world-size-elastic resume takes sampler.type "
                        f"distributed_iteration only (got {stype})")
                self._elastic_orig = (ow, ohb)
                self.logger.info(
                    f"elastic resume: checkpoint topology {ow} x batch "
                    f"{ohb} -> {self.world} x {self.host_batch}; the "
                    "sampler re-shards the original stream")
        # pretrain weights (model only, fresh optimizer/step) when nothing
        # was resumed (clip_solver.py:140-163 + misc.py modify_state)
        pretrain_path = self.config.get_path("saver.pretrain.path")
        if self.start_step == 0 and pretrain_path:
            ignore = tuple(
                self.config.get_path("saver.pretrain.ignore") or ())
            state, unmatched = load_pretrain(
                pretrain_path, state, ignore=ignore)
            msg = f"loaded pretrain weights from {pretrain_path}"
            if unmatched:
                msg += (f" ({len(unmatched)} keys kept at init, e.g. "
                        f"{unmatched[:5]})")
            self.logger.info(msg)
        # every rank starts from rank 0's weights, statistics and bank
        self.state = broadcast_state(state, self.group)
        # FSDP and expert parallelism: each rank keeps its parts
        plan = make_plan(self.model, self.group, fsdp=self.fsdp,
                         mesh=self.mesh)
        shard_train_state(self.state, plan, self.tx)
        if plan:
            held = plan.resident_bytes(self.state)
            self.logger.info(
                f"sharded {len(plan.shards)} parameters "
                f"({'fsdp' if self.fsdp else 'ep'}); this rank holds "
                + ", ".join(f"{k} {v / 2 ** 20:.1f} MiB"
                            for k, v in held.items()))

    # ----------------------------------------------------------------- step
    def build_step(self):
        self._train_step = make_train_step(
            self.model, self.tx, self.config, self.schedule,
            method=self.method, ema_cfg=self.ema_cfg,
            total_steps=self.max_iter, device_aug=self.device_aug,
            seed=int(self.config.get_path("seed", 0)), axis_name=self.group)

    # ----------------------------------------------------------- preemption
    @contextlib.contextmanager
    def _preemption_guard(self):
        """Save-and-exit-clean on SIGTERM/SIGUSR1: the handler only sets an
        Event, and the loop checks it each step and cuts a final checkpoint
        before the kill (all checkpoint IO on the main thread, at a step
        boundary). Callers off the main thread skip handler installation —
        signal.signal is main-thread only."""
        self._preempt = threading.Event()
        prev = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                try:
                    prev[sig] = signal.signal(
                        sig, lambda *_: self._preempt.set())
                except (ValueError, OSError):  # pragma: no cover
                    pass
        try:
            yield self._preempt
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)

    # ---------------------------------------------------------------- train
    def train(self):
        with self._preemption_guard() as preempt:
            self._train_loop(preempt)

    def _train_loop(self, preempt):
        saver = self.config.get("saver") or {}
        print_freq = int(saver.get("print_freq", 10))
        val_freq = int(saver.get("val_freq", 0) or 0)
        save_freq = int(saver.get("save_freq", 0) or 0)
        save_many = bool(saver.get("save_many", True))

        prof = dict(self.config.get("profile") or {})
        prof_start = int(prof.get("start_step", 10))
        prof_steps = int(prof.get("num_steps", 5))
        prof_on = bool(prof.get("enable", False)) and self.rank == 0
        profiler = None

        spike_window = AverageMeter(length=100)
        it = self._device_prefetch(iter(self._train_loader(
            self.start_step - 1)))
        step = self.start_step
        t_last = time.perf_counter()
        data_time = save_time = 0.0
        window = 0
        stop = False  # the ranks' reduced preemption flag
        try:
            while step < self.max_iter:
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                data_time += time.perf_counter() - t_wait
                if prof_on and step + 1 == prof_start:
                    profiler = self._start_profiler()
                self.state, metrics = self._train_step(self.state, batch)
                # the step is host-predictable; only a rollback resyncs it
                step += 1
                window += 1
                if profiler is not None and \
                        step == prof_start + prof_steps:
                    self._stop_profiler(profiler)
                    profiler, prof_on = None, False

                if step % print_freq == 0 or step == self.max_iter:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    loss = metrics.get("loss", float("nan"))
                    # loss-spike / NaN rollback (declip_solver.py:548-619)
                    if self._spike(loss, spike_window) and \
                            self._rollback(step):
                        if profiler is not None:
                            self._stop_profiler(profiler)
                            profiler, prof_on = None, False
                        step = int(self.state.step)
                        it.close()
                        it = self._device_prefetch(iter(
                            self._train_loader(step - 1)))
                        t_last, window = time.perf_counter(), 0
                        data_time = save_time = 0.0
                        continue
                    if np.isfinite(loss):  # a NaN would poison the avg
                        spike_window.update(loss)
                    batch_time = time.perf_counter() - t_last
                    h2d_ms = self._h2d_ms()
                    self.timings.append({
                        "step": step, "steps": window,
                        "batch_time": batch_time, "data_time": data_time,
                        "save_time": save_time, "h2d_ms": h2d_ms})
                    self.meters.update(
                        {**metrics, "batch_time": batch_time,
                         "data_time": data_time})
                    for k, v in metrics.items():
                        self.writer.add_scalar(k, v, step)
                    pairs_per_sec = (
                        self.global_batch * window / max(batch_time, 1e-9)
                        if step > self.start_step + print_freq else 0.0)
                    remain = (self.max_iter - step) * self.meters[
                        "batch_time"].avg / max(print_freq, 1)
                    # MoCo's and CLSA's terms beside the loss
                    terms = "".join(f"{k} {metrics[k]:.4f} " for k in
                                    ("moco_loss", "ddm_loss")
                                    if k in metrics)
                    self.logger.info(
                        f"Iter [{step}/{self.max_iter}] "
                        f"loss {loss:.4f} ({self.meters['loss'].avg:.4f}) "
                        f"{terms}"
                        f"lr {metrics.get('lr', 0):.2e} "
                        f"top1 {metrics.get('top1', 0):.2f} "
                        f"pairs/s {pairs_per_sec:.1f} "
                        f"data {data_time / window:.3f}s/step "
                        f"h2d {h2d_ms:.2f}ms "
                        f"eta {remain / 3600:.2f}h")
                    self.writer.flush()
                    t_last, window = time.perf_counter(), 0
                    data_time = save_time = 0.0

                if val_freq and step % val_freq == 0 and step > 0:
                    self.validate(step)
                # a sharded state is gathered by every rank
                if save_freq and step % save_freq == 0 and (
                        self.rank == 0 or self.state.shards):
                    t_save = time.perf_counter()
                    keep = int(self.config.get_path("saver.keep", 10))
                    k_dir = (self.path.ckpt_k_times_path
                             if step % (save_freq * 20) == 0 else None)
                    save_checkpoint(
                        self.path.ckpt_path, self.state,
                        save_many=save_many, k_times_dir=k_dir,
                        async_write=bool(self.config.get_path(
                            "saver.async_save", True)),
                        meta=self._ckpt_meta(), write=self.rank == 0)
                    if self.rank == 0:
                        gc_checkpoints(self.path.ckpt_path, keep=keep)
                    save_time += time.perf_counter() - t_save

                stop = self._any_rank(preempt.is_set())
                if stop:
                    self.logger.info(
                        f"Preemption signal received at iter {step} — "
                        "writing final checkpoint and exiting (auto_resume "
                        "continues from here)")
                    break
        finally:
            it.close()
            if profiler is not None:  # the loop ended inside the window
                self._stop_profiler(profiler)

        if self.rank == 0 or self.state.shards:
            # drain in-flight async writes BEFORE the final synchronous
            # save (they share ckpt_meta.json; last writer must be the
            # newest)
            wait_for_pending_saves()
            t0 = time.perf_counter()
            save_checkpoint(self.path.ckpt_path, self.state, save_many=True,
                            meta=self._ckpt_meta(), write=self.rank == 0)
            self.save_seconds.append(time.perf_counter() - t0)
        # no rank reads the checkpoint back before it has landed
        comms.barrier(self.group)
        # the grace window is for IO, not eval; every rank decides on the
        # reduced flag, since the eval's merge is a collective
        if not stop:
            self.validate(step)
        self.writer.close()

    def _start_profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                osp.join(self.path.event_path, "profile")))
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler: torch.profiler.profile) -> None:
        """Stop ``profiler`` once the card has finished the traced steps;
        its trace handler writes the trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        self.logger.info(
            f"profile trace written to {self.path.event_path}/profile")

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a signal may reach some
        ranks only, and every rank must leave the loop at the same
        step)."""
        if self.group is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(comms.all_reduce_(t, self.group).item() > 0)

    def _h2d_ms(self) -> float:
        """Device time of the newest batch's host-to-device copy (0 on the
        CPU). The step's stream waited for it, so it has ended."""
        events = getattr(self, "_h2d_events", None)
        if events is None:
            return 0.0
        return float(events[0].elapsed_time(events[1]))

    def _stage(self, batch) -> Dict:
        """On the prefetch thread: the model's arrays into pinned host
        memory, then copied to the card without blocking on a side stream
        (the stream's event rides along). On the CPU: tensors over the
        arrays."""
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and k not in _HOST_ONLY}
        if self.device.type != "cuda":
            return {"tensors": {k: torch.from_numpy(v)
                                for k, v in arrays.items()}}
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in arrays.items()}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            start.record()
            tensors = {k: t.to(self.device, non_blocking=True)
                       for k, t in pinned.items()}
            done.record()
        return {"tensors": tensors, "events": (start, done)}

    def _device_prefetch(self, it, depth: int = 2):
        """Keep ``depth`` batches staged ahead on a background thread (the
        reference's DataPrefetcher role, clip_solver.py:30-61): each is read
        from the loader, pinned and copied on a side stream there; the
        consumer's stream waits on the copy's event. Closing the generator
        drains the thread and closes the loader's iterator."""
        if self.device.type == "cuda" and \
                getattr(self, "_copy_stream", None) is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pool = ThreadPoolExecutor(1, thread_name_prefix="prefetch")
        buf: deque = deque()

        def fetch():
            try:
                return self._stage(next(it))
            except StopIteration:
                return None

        def fill():
            while len(buf) < depth:
                buf.append(pool.submit(fetch))

        try:
            fill()
            while buf:
                staged = buf.popleft().result()
                if staged is None:
                    break
                fill()
                tensors = staged["tensors"]
                if "events" in staged:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(staged["events"][1])
                    for t in tensors.values():
                        # the step's stream uses memory the copy stream
                        # allocated
                        t.record_stream(stream)
                    self._h2d_events = staged["events"]
                yield tensors
        finally:
            for f in buf:
                with contextlib.suppress(Exception):
                    f.result()
            pool.shutdown(wait=True)
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _spike(self, loss: float, window: AverageMeter) -> bool:
        if not np.isfinite(loss):
            return True
        thr = float(self.config.get_path("saver.spike_threshold", 10.0))
        return window.count > 20 and loss > window.avg + thr

    def _rollback(self, step: int) -> bool:
        """Reload an old checkpoint, decay warmup lr, rebuild optimizer
        (declip_solver.py:548-619). Returns True if a rollback happened."""
        if not bool(self.config.get_path("saver.rollback", False)):
            self.logger.warning(
                f"loss spike/NaN at step {step} (rollback disabled)")
            return False
        # in-flight async writes must land first, on rank 0, and no rank
        # reads a checkpoint before then
        if self.rank == 0:
            wait_for_pending_saves()
        comms.barrier(self.group)
        # every rank restores rank 0's choice (the spike decision read the
        # loss averaged over the ranks, so all of them are here)
        ckpts = comms.broadcast_object(
            list_checkpoints(self.path.ckpt_path), 0, self.group)
        if not ckpts:
            self.logger.warning("spike but no checkpoint to roll back to")
            return False
        # >= 3 save-points back from the newest (declip_solver.py:590-594);
        # clamp to the oldest when fewer exist
        target = ckpts[max(0, len(ckpts) - 4)]
        self.logger.warning(
            f"loss spike at {step}: rolling back to step {target[0]}, "
            f"warmup_lr x= 0.997")
        self._warmup_decay *= 0.997
        scfg = dict(self._sched_cfg)
        kwargs = dict(scfg.get("kwargs") or {})
        kwargs["warmup_lr"] = float(kwargs.get("warmup_lr", 1e-3)) * \
            self._warmup_decay
        scfg["kwargs"] = kwargs
        self.schedule = scheduler_entry(
            scfg, max_iter=self.max_iter,
            iters_per_epoch=self._iters_per_epoch)
        # model, optimizer state, EMA, guard, bank and SSL state, in
        # place. Default:
        # keep the restored optimizer state — it belongs to the good
        # checkpoint and carries the schedule count for that step (a delta
        # from the reference, which reloads only the model and rebuilds its
        # optimizer, kept from the JAX package)
        restore_checkpoint(target[1], self.state)
        # the update rule binds the schedule: rebuild it
        self.tx = self._make_tx()
        set_plan(self.tx, self.state.shards)
        if bool(self.config.get_path("saver.rollback_reset_opt", False)):
            # reference-exact mode (declip_solver.py:600-607): a fresh
            # optimizer, with the rebuilt schedule still evaluated at the
            # restored step
            self.state.opt_state = fast_forward_schedule(
                self.tx.init(dict(self.model.named_parameters())),
                int(self.state.step))
        self.build_step()
        return True

    # ----------------------------------------------------------------- eval
    @contextlib.contextmanager
    def _eval_mode(self, use_ema: bool = False):
        """The model in eval mode (running BatchNorm statistics), with the
        EMA weights swapped in under ``use_ema`` and the shards of FSDP or
        expert parallelism gathered whole; afterwards the weights are
        put back bit for bit, no BatchNorm statistic is left pending, and
        the mode is what it was."""
        model = self.model
        was_training = model.training
        saved = None
        if use_ema:
            params = dict(model.named_parameters())
            saved = {n: params[n].detach().clone()
                     for n in self.state.ema_params}
            with torch.no_grad():
                for n, t in self.state.ema_params.items():
                    params[n].copy_(t)
        model.eval()
        plan = self.state.shards
        try:
            with torch.no_grad(), (
                    plan.gathered(("fsdp", "expert"), differentiable=False)
                    if plan else contextlib.nullcontext()):
                yield model
        finally:
            if saved is not None:
                with torch.no_grad():
                    for n, t in saved.items():
                        params[n].copy_(t)
            discard_bn_stats(model)
            model.train(was_training)

    def _eval_loader(self, tcfg: Dict):
        split_cfg = dict(tcfg)
        split_cfg.setdefault("meta_file", "256")
        split_cfg.setdefault("label_texts_ensemble", "prompt80")
        ds = build_clip_dataset(split_cfg)
        return ds, int(tcfg.get("batch_size", self.host_batch))

    def validate(self, step: int):
        for i, tcfg in enumerate(self.test_cfgs):
            t0 = time.perf_counter()
            metrics = self.evaluate(tcfg)
            self.eval_seconds.append(time.perf_counter() - t0)
            self.logger.info(
                f"eval[{i}] @ {step}: " + json.dumps(dict(metrics)))
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(f"eval{i}/{k}", v, step)
            if self.state.ema_params is not None:
                ema_metrics = self.evaluate(tcfg, use_ema=True)
                self.logger.info(
                    f"eval[{i}] EMA @ {step}: "
                    + json.dumps(dict(ema_metrics)))
                for k, v in ema_metrics.items():
                    if isinstance(v, (int, float)):
                        self.writer.add_scalar(f"eval{i}/ema_{k}", v, step)

    def class_embeddings(self, model, label_texts: List[str],
                         n_class: int) -> torch.Tensor:
        """Prompt-ensemble class embeddings (clip_solver.py:688-700), the
        classes packed into [cpc*P, 77] chunks as in the JAX package."""
        if n_class == 0:
            raise ValueError(
                "zero-shot eval needs class names: the test metafile has no "
                "'label_name' fields (use a JSONL metafile with label/"
                "label_name like the reference's val_official.json, or pass "
                "class_names).")
        prompts_num = len(label_texts) // n_class
        ids = np.asarray(get_tokenizer().tokenize(label_texts))
        cpc = min(max(1, 2048 // prompts_num), n_class)
        return batched_class_embeddings(
            model.encode_text, ids, n_class, prompts_num, cpc, self.device)

    def dense_class_embeddings(self, model, label_texts: List[str],
                               n_class: int) -> torch.Tensor:
        """Token-wise class embeddings [n_class, 77, D] for the FILIP
        family's dense eval (filip_solver.py:839-960): as
        ``class_embeddings`` over ``encode_text_dense``, 512 // prompts
        classes to a chunk."""
        prompts_num = len(label_texts) // n_class
        ids = np.asarray(get_tokenizer().tokenize(label_texts))
        cpc = min(max(1, 512 // prompts_num), n_class)
        return batched_class_embeddings(
            model.encode_text_dense, ids, n_class, prompts_num, cpc,
            self.device)

    def dense_eval(self, tcfg: Dict) -> bool:
        """Whether ``tcfg`` evaluates by late interaction: ``dense_eval``,
        true by default for FILIP and DeFILIP, and a model with dense heads
        (solver/__init__.py:933-944 of the JAX package)."""
        has_dense_head = bool(getattr(self.model, "return_dense", False)
                              or getattr(self.model, "return_filip", False))
        return (bool(tcfg.get("dense_eval",
                              self.method in ("filip", "defilip")))
                and hasattr(self.model, "encode_image_dense")
                and has_dense_head)

    def _idx_batches(self, n: int, batch_size: int):
        # hosts split the val set by interleaved batches; results merge
        # via the per-rank dumps (base_dataset.py:122-139)
        return [range(beg, min(beg + batch_size, n))
                for beg in range(self.rank * batch_size, n,
                                 batch_size * self.world)]

    def _padded(self, arr: np.ndarray, batch_size: int) -> torch.Tensor:
        """A batch padded to ``batch_size`` rows with copies of the last
        (every call has one shape), on the device."""
        if arr.shape[0] < batch_size:
            arr = np.concatenate(
                [arr, np.repeat(arr[-1:], batch_size - arr.shape[0], 0)])
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def evaluate(self, tcfg: Dict, *, use_ema: bool = False) -> Metric:
        if (tcfg.get("evaluation") or {}).get("type") == "retrieval":
            return self.evaluate_retrieval(tcfg, use_ema=use_ema)
        dense = self.dense_eval(tcfg)
        dataset, batch_size = self._eval_loader(tcfg)
        label_texts, ensemble = dataset.get_label_texts()
        n_class = ensemble.shape[0]
        res_path = osp.join(
            self.path.result_path, f"results.txt.rank{self.rank}")
        all_scores, all_labels = [], []
        idx_batches = self._idx_batches(len(dataset), batch_size)
        workers = max(1, int(tcfg.get("num_workers", 4)))
        ens = torch.from_numpy(ensemble).to(self.device)

        def _fetch(idxs):
            return [dataset[i] for i in idxs]

        # decode/transform runs on worker threads a few batches ahead
        with self._eval_mode(use_ema) as model, \
                open(res_path, "w") as writer, \
                ThreadPoolExecutor(workers) as pool:
            class_emb = (self.dense_class_embeddings if dense else
                         self.class_embeddings)(model, label_texts, n_class)
            inflight: deque = deque()
            queued = 0
            while queued < len(idx_batches) and len(inflight) < workers + 2:
                inflight.append(pool.submit(_fetch, idx_batches[queued]))
                queued += 1
            while inflight:
                items = inflight.popleft().result()
                if queued < len(idx_batches):
                    inflight.append(pool.submit(_fetch, idx_batches[queued]))
                    queued += 1
                valid = len(items)
                imgs = self._padded(
                    np.stack([it["image"] for it in items]), batch_size)
                if dense:
                    # K3 on the card (no fallback), its plain version here
                    logits = late_interaction_logits_kernel(
                        l2_normalize(model.encode_image_dense(imgs)),
                        class_emb, torch.ones((), device=self.device))
                else:
                    emb = model.encode_image(imgs)
                    emb = emb / torch.linalg.vector_norm(emb, dim=-1,
                                                         keepdim=True)
                    logits = emb.float() @ class_emb.float().t()
                scores = torch.softmax(logits, dim=-1) @ ens
                scores = scores[:valid].cpu().numpy()
                preds = scores.argmax(-1)
                for j, it in enumerate(items):
                    writer.write(json.dumps({
                        "image_id": it["image_id"],
                        "filename": it["filename"],
                        "label": it["label"],
                        "label_name": it["label_name"],
                        "caption": it["caption"],
                        "tag": it["tag"],
                        "prediction": int(preds[j]),
                        "score": [round(float(s), 8) for s in scores[j]],
                    }, ensure_ascii=False) + "\n")
                all_scores.append(scores)
                all_labels.append(np.asarray([it["label"] for it in items]))
        scores = (np.concatenate(all_scores) if all_scores
                  else np.zeros((0, n_class), np.float32))
        labels = (np.concatenate(all_labels) if all_labels
                  else np.zeros((0,), np.int64))
        if self.group is not None:
            # every rank's share, in rank order, without a shared
            # filesystem (the JAX solver's merge; the per-rank
            # results.txt.rank<i> dumps stay as they are)
            shards = comms.gather_object((scores, labels), self.group)
            scores = np.concatenate([sc for sc, _ in shards])
            labels = np.concatenate([lb for _, lb in shards])
        if not len(scores):
            return Metric({"top1": 0.0, "top5": 0.0, "n": 0})
        return ImageNetEvaluator().eval_arrays(scores, labels)

    def evaluate_retrieval(self, tcfg: Dict, *, use_ema: bool = False
                           ) -> Metric:
        """Image<->text retrieval eval (beyond-reference, as in the JAX
        package): a data.test entry with ``evaluation: {type: retrieval,
        kwargs: {topk: [1, 5, 10]}}``; every sample's own caption is its
        positive, metrics come from RetrievalEvaluator on the host."""
        dataset, batch_size = self._eval_loader(tcfg)
        tok = get_tokenizer()
        idx_all, img_all, txt_all = [], [], []
        with self._eval_mode(use_ema) as model:
            for idxs in self._idx_batches(len(dataset), batch_size):
                items = [dataset[i] for i in idxs]
                valid = len(items)
                imgs = self._padded(
                    np.stack([it["image"] for it in items]), batch_size)
                toks = self._padded(np.asarray(tok.tokenize(
                    [it["caption"] for it in items])), batch_size)
                img_all.append(model.encode_image(imgs).float()[:valid]
                               .cpu().numpy())
                txt_all.append(model.encode_text(toks).float()[:valid]
                               .cpu().numpy())
                idx_all.append(np.asarray(idxs, np.int64))
        kwargs = dict((tcfg.get("evaluation") or {}).get("kwargs") or {})
        evaluator = RetrievalEvaluator(**kwargs)
        idx = (np.concatenate(idx_all) if idx_all
               else np.zeros((0,), np.int64))
        img = (np.concatenate(img_all) if img_all
               else np.zeros((0, 1), np.float32))
        txt = (np.concatenate(txt_all) if txt_all
               else np.zeros((0, 1), np.float32))
        if self.group is not None:
            parts = comms.gather_object((idx, img, txt), self.group)
            idx = np.concatenate([p[0] for p in parts])
            img = np.concatenate([p[1] for p in parts])
            txt = np.concatenate([p[2] for p in parts])
        order = np.argsort(idx)
        return evaluator.eval_arrays(img[order], txt[order])


def main(argv: Optional[List[str]] = None) -> Solver:
    """The CLI: train, or with ``--evaluate`` run the config's test sets.
    Returns the Solver (for callers that drive it in-process)."""
    parser = argparse.ArgumentParser(description="declip_tpu_torch solver")
    parser.add_argument("--config", required=True)
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--set", nargs="*", default=[],
                        help="dotted.key=value config overrides")
    parser.add_argument("--device", default=None,
                        help="cuda:LOCAL_RANK under torchrun or SLURM, "
                             "else cuda (the default; raises where CUDA "
                             "is absent), or cpu")
    args = parser.parse_args(argv)

    cfg = parse_config(args.config)
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        cfg = override(cfg, key, value)
    cfg["_config_path"] = osp.abspath(args.config)

    solver = Solver(cfg, device=args.device)
    if args.evaluate:
        for tcfg in solver.test_cfgs:
            metrics = solver.evaluate(tcfg)
            solver.logger.critical(json.dumps(dict(metrics), indent=2))
    else:
        solver.train()
    return solver


if __name__ == "__main__":
    main()
