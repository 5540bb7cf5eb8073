"""The port's SSL builders (declip_tpu_torch.models.ssl_builders: MoCo,
SimCLR, CLSA), their losses and training step, AutoAugment and CLSA's
views, against the JAX package's.

Both packages start from the port's seeded init (the JAX package's own
``torch_state_to_variables`` makes the JAX variables) and the JAX
``init_moco_state``'s queue, which ``convert.ssl_from_jax`` carries across
with the key encoder. tests/test_ssl_training.py's tiny widths: ResNet-50
at 32 px, layers (1, 1, 1, 1), width 8, embed 32; dim 16, K 64, m 0.9; a
2-layer 32-wide ViT-B/32 at 32 px with 16 px patches; CLSA's strong views
off the weak views' resolution, one on the ResNet (64 px, a 2 x 2 grid
into attnpool) and two on the ViT (48 and 64 px, L = 10 and 17; one
strong view less on the ResNet spares this file 4 s of JAX compile). SGD with momentum, three steps on three batches
(each image noise around a colour of its own).

- ``moco_res50``, ``simclr_res50``, ``clsa_res50`` and ``clsa_vitb32``:
  the feature dict and the first step's loss and metrics within 1e-5
  relative; each parameter's first gradient (what the step gave its
  optimizer) within 1e-4 of its norm, those that are 0 in exact arithmetic
  (attnpool's key bias, the key rows of a ViT's ``in_proj_bias``) within
  1e-4 of the whole gradient's norm; the three-step trajectory (metrics,
  parameters, BatchNorm statistics, key parameters, key statistics, the
  queue and its pointer) within 1e-4 (see PARAM_ATOL).
- The enqueue's clamp (K 64, batches of 24), a planted NaN leaving the
  SSL state bit for bit, the GradCache and two-view refusals.
- ``ImageNetPolicy``, ``CLSAAug`` and ``CLSA2-16-32`` bit for bit for one
  seed; a CLSA loader batch with JAX's keys, shapes and values.
- A tiny ``moco_res50`` through the port's solver on the CPU: a save, and
  a resume that restores the SSL state bit for bit.

One JAX compile a method: the train step, which also returns the feature
dict its loss took, called once a step; the four compile side by side.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import pickle
import random
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_defilip import _capturing, _seeded_variables

from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.ssl_builders import (
    init_moco_state as jax_init_moco_state,
)
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.train import make_train_step as jax_make_train_step
from declip_tpu.train import new_train_state as jax_new_train_state

from declip_tpu_torch.convert import ssl_from_jax, state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.ssl_builders import (
    SSLModel,
    enqueue_keys,
    init_moco_state,
)
from declip_tpu_torch.optim import optim_entry, scheduler_entry
from declip_tpu_torch.train import (
    make_train_step,
    method_of,
    new_train_state,
)

RES, B, DIM, K, STEPS = 32, 8, 16, 64, 3
RTOL_OUT = 1e-5  # outputs, the first step's loss and metrics
RTOL = 1e-4  # gradients (of their norm) and the trajectory
RESNET = {"embed_dim": 32, "input_resolution": RES, "layers": (1, 1, 1, 1),
          "width": 8, "heads": 4}
VIT = {"embed_dim": 32, "input_resolution": RES, "patch_size": 16,
       "width": 32, "layers": 2, "heads": 2}
# name: (image_encode, the strong views' resolutions)
MODELS = {"moco_res50": (RESNET, ()), "simclr_res50": (RESNET, ()),
          "clsa_res50": (RESNET, (64,)), "clsa_vitb32": (VIT, (48, 64))}
OPT = {"type": "SGD", "kwargs": {"lr": 1e-2, "momentum": 0.9}}
SCHED = {"type": "Cosine", "kwargs": {"base_lr": 0.0, "warmup_lr": 1e-2,
                                      "warmup_steps": 2}}
MAX_ITER = 10
# a gradient of 0 in exact arithmetic (the softmax removes a key bias)
ZERO_GRAD = ("attnpool.k_proj.bias",)
# the trajectory's parameters: rtol RTOL and this atol. A parameter whose
# gradient is rounding noise (attnpool's key bias) or near it (a block's
# BatchNorm biases: 0 while the block's last BatchNorm scale is at its init
# of 0, tiny after) moves by less than 1e-8 a step, and those moves differ
# by their whole size: up to 1.5e-9 (0.1% of the move) on clsa_res50
PARAM_ATOL = 1e-6


def _cfg(name):
    return {"type": name, "kwargs": {"image_encode": dict(MODELS[name][0]),
                                     "dim": DIM, "K": K, "m": 0.9,
                                     "dtype": "float32"}}


def _batch(name, seed):
    rng = np.random.default_rng(seed)

    def views(res, c):
        x = rng.normal(size=(B, res, res, c)) + rng.normal(size=(B, 1, 1, c))
        return x.astype(np.float32)

    b = {"images": views(RES, 6)}
    for i, r in enumerate(MODELS[name][1]):
        b[f"images_strong_{i}"] = views(r, 3)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# held while a step is set up and traced (the trace swaps
# jax.value_and_grad); the compiles run outside it, side by side
_TRACING = threading.Lock()


def _jax_run(name):
    """JAX's STEPS train steps from the port's seeded init: {"variables",
    "ssl" (the initial MoCoState), "out" (the first step's feature dict),
    "grads" (the first step's), "hist", "state" (the last)}."""
    with _TRACING:
        args = _jax_setup(name)
    return _jax_steps(name, *args)


def _jax_setup(name):
    cfg = _cfg(name)
    jmodel = jax_model_entry(cfg)
    variables = _seeded_variables(cfg)
    params, stats = variables["params"], variables.get("batch_stats", {})
    sched = jax_scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = _capturing(jax_optim_entry(OPT, params, sched))
    ssl = None
    if jmodel.ssl_method != "simclr":  # one compile, not one a leaf
        ssl = jax.jit(lambda p, s: jax_init_moco_state(
            p, jax.random.PRNGKey(1), K, DIM, s))(params, stats)
    jstate = jax_new_train_state(params=params, batch_stats=stats,
                                 opt_state=jax.jit(tx.init)(params), ssl=ssl)
    step = jax_make_train_step(jmodel, tx, {}, sched)

    def step_and_out(state, batch):
        """The step, and the feature dict its loss took (the auxiliary
        output of its ``value_and_grad``, read while it is traced)."""
        seen = {}
        value_and_grad = jax.value_and_grad

        def spying(fn, **kwargs):
            inner = value_and_grad(fn, **kwargs)

            def call(*args):
                (total, aux), grads = inner(*args)
                seen["out"] = aux[2]
                return (total, aux), grads
            return call

        jax.value_and_grad = spying
        try:
            new_state, metrics = step(state, batch)
        finally:
            jax.value_and_grad = value_and_grad
        return seen["out"], new_state, metrics

    return (jax.jit(step_and_out).lower(jstate, _batch(name, 0)), jstate,
            variables, ssl)


def _jax_steps(name, lowered, jstate, variables, ssl):
    # XLA's LLVM passes at their lowest level: a quicker compile of the
    # same operations
    run = lowered.compile({"xla_backend_optimization_level": 0,
                           "xla_llvm_disable_expensive_passes": True})
    res = {"variables": variables, "ssl": jax.device_get(ssl), "hist": []}
    for i in range(STEPS):
        out, jstate, metrics = run(jstate, _batch(name, i))
        if i == 0:
            res["out"] = jax.device_get(out)
            res["grads"] = jax.device_get(jstate.opt_state[1])
        res["hist"].append({k: float(v) for k, v in metrics.items()})
    res["state"] = jax.device_get(jstate)
    return res


def _port_run(name, jax_res):
    """The port's forward and STEPS steps from the same weights and
    MoCoState: (model, state, first forward, first gradients, metrics)."""
    port = model_entry(_cfg(name))
    port.load_state_dict(state_from_jax_variables(jax_res["variables"]),
                         strict=True)
    port.train()
    named = dict(port.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, port, sched)
    grads = []
    update = tx.update_

    def capturing(g, *args, **kwargs):
        grads.append({n: t.detach().clone() for n, t in g.items()})
        return update(g, *args, **kwargs)

    tx.update_ = capturing
    ssl = None if jax_res["ssl"] is None else ssl_from_jax(
        port, jax_res["ssl"])
    state = new_train_state(model=port, opt_state=tx.init(named), ssl=ssl)
    step = make_train_step(port, tx, {}, sched)
    out = port(_torch(_batch(name, 0)))
    hist = []
    for i in range(STEPS):
        state, metrics = step(state, _torch(_batch(name, i)))
        hist.append({k: float(v) for k, v in metrics.items()})
    return port, state, out, grads[0], hist


@pytest.fixture(scope="module")
def jax_runs():
    """Every method's ``_jax_run``, started together on threads: each
    traces in turn and compiles beside the others."""
    with ThreadPoolExecutor(len(MODELS)) as pool:
        yield {name: pool.submit(_jax_run, name) for name in MODELS}


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request, jax_runs):
    name = request.param
    jax_res = jax_runs[name].result()
    return name, jax_res, _port_run(name, jax_res)


def _rel_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(np.abs(want).max(initial=0), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _param_close(got, want, name):
    """rtol RTOL, atol PARAM_ATOL."""
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=PARAM_ATOL,
                               err_msg=name)


def test_forward_loss_and_gradients_match_jax(runs):
    name, jres, (port, _, out, grads, hist) = runs
    assert isinstance(port, SSLModel) and method_of(port) == name.split(
        "_")[0]
    want = jres["out"]
    assert sorted(out) == sorted(want)
    for key, w in want.items():
        if key == "q_strong":
            assert len(out[key]) == len(w) == len(MODELS[name][1])
            for i, (g, ww) in enumerate(zip(out[key], w)):
                _rel_close(g.detach().numpy(), ww, RTOL_OUT, f"{key}[{i}]")
        else:
            _rel_close(out[key].detach().numpy(), w, RTOL_OUT, key)
    first = jres["hist"][0]
    assert sorted(hist[0]) == sorted(first)
    for key, w in first.items():
        _rel_close(hist[0][key], w, RTOL_OUT, key)
    if name.startswith("clsa"):
        assert first["ddm_loss"] > 0

    jgrads = state_from_jax_variables({"params": jres["grads"]})
    assert sorted(grads) == sorted(jgrads)
    whole = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in jgrads.values()))
    for n, g in grads.items():
        w = jgrads[n].numpy().astype(np.float64)
        d = g.numpy().astype(np.float64) - w
        rows = slice(None)
        if n.endswith("attn.in_proj_bias"):
            width = w.shape[0] // 3
            rows = np.r_[0:width, 2 * width:3 * width]
            assert np.linalg.norm(d[width:2 * width]) <= RTOL * whole, n
        elif n.endswith(ZERO_GRAD):
            assert np.linalg.norm(d) <= RTOL * whole, n
            continue
        assert np.linalg.norm(d[rows]) <= RTOL * np.linalg.norm(w[rows]), n


def test_trajectory_matches_jax(runs):
    """Three steps: every metric, the parameters and BatchNorm statistics,
    and MoCo's and CLSA's key parameters, key statistics, queue and
    pointer."""
    name, jres, (port, state, _, _, hist) = runs
    for got, want in zip(hist, jres["hist"]):
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            _rel_close(got[key], w, RTOL, key)
    jstate = jres["state"]
    want = state_from_jax_variables({"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        _param_close(got[n].numpy(), w.numpy(), n)
    if jstate.ssl is None:
        assert state.ssl is None
        return
    jssl = jstate.ssl
    want = state_from_jax_variables({"params": jssl.key_params,
                                     "batch_stats": jssl.key_batch_stats})
    got = state.ssl.key_model.state_dict()
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        _param_close(got[n].numpy(), w.numpy(), f"key {n}")
    _rel_close(state.ssl.queue.numpy(), jssl.queue, RTOL, "queue")
    assert state.ssl.queue_ptr == int(jssl.queue_ptr) == STEPS * B
    if "visual.bn1.running_var" in got:
        # the key statistics moved apart from the query's
        assert not np.array_equal(
            got["visual.bn1.running_var"].numpy(),
            port.state_dict()["visual.bn1.running_var"].numpy())


def _moco(name="moco_res50", seed=0):
    model = model_entry(_cfg(name))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.train()


def test_enqueue_clamps_as_jax():
    """K 64, batches of 24: writes at 0, 24, then 40 (clamped to K - 24)
    with the pointer back to 0, then at 0; JAX's enqueue_keys alike."""
    from declip_tpu.models.ssl_builders import MoCoState as JaxMoCoState
    from declip_tpu.models.ssl_builders import enqueue_keys as jax_enqueue

    state = init_moco_state(_moco(), torch.Generator().manual_seed(1), K,
                            DIM)
    jstate = JaxMoCoState(None, jnp.asarray(state.queue.numpy()),
                          jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(3)
    for want_ptr in (24, 48, 0, 24):
        keys = rng.normal(size=(24, DIM)).astype(np.float32)
        enqueue_keys(state, torch.from_numpy(keys))
        jstate = jax_enqueue(jstate, jnp.asarray(keys))
        assert state.queue_ptr == int(jstate.queue_ptr) == want_ptr
        np.testing.assert_array_equal(state.queue.numpy(),
                                      np.asarray(jstate.queue))
        if want_ptr == 0:  # the third batch, at K - 24 = 40
            np.testing.assert_array_equal(state.queue[40:].numpy(), keys)


def test_nonfinite_step_keeps_the_ssl_state():
    """A NaN in the images: the step is skipped and the key parameters
    (momentum-updated inside the step), the key statistics, the queue and
    its pointer are left bit for bit; a finite step after it moves them."""
    model = _moco("clsa_res50")
    ssl = init_moco_state(model, torch.Generator().manual_seed(1), K, DIM)
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, model, sched)
    state = new_train_state(model=model, opt_state=tx.init(
        dict(model.named_parameters())), ssl=ssl)
    step = make_train_step(model, tx, {}, sched)
    state, _ = step(state, _torch(_batch("clsa_res50", 0)))

    def snapshot():
        return ({k: v.clone() for k, v in ssl.key_model.state_dict().items()},
                ssl.queue.clone(), ssl.queue_ptr)

    before = snapshot()
    bad = _batch("clsa_res50", 1)
    bad["images"][0, 0, 0, 3] = np.nan  # view 2: the keys' view
    state, metrics = step(state, _torch(bad))
    assert float(metrics["update_skipped"]) == 1.0
    after = snapshot()
    assert after[2] == before[2] == B
    assert torch.equal(after[1], before[1])
    for k, v in before[0].items():
        assert torch.equal(after[0][k], v), k
    state, metrics = step(state, _torch(_batch("clsa_res50", 2)))
    assert float(metrics["update_skipped"]) == 0.0 and ssl.queue_ptr == 2 * B
    assert not torch.equal(ssl.key_model.visual.conv1.weight,
                           before[0]["visual.conv1.weight"])


def test_refusals_match_jax():
    model = _moco()
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, model, sched)
    with pytest.raises(NotImplementedError, match="SSL methods"):
        make_train_step(model, tx, {"grad_cache": {"chunks": 2}}, sched)
    with pytest.raises(ValueError, match="two-view"):
        model(torch.zeros(2, RES, RES, 3))


@pytest.mark.parametrize("preset", ["MOCOV2", "SIMCLR"])
def test_check_grad_and_device_aug(preset):
    """``check_grad`` names the modules as the JAX step does (the top-level
    entries of its parameter tree); ``device_aug`` with MOCOV2's and
    SIMCLR's geometry takes the loader's uint8 crops, as for CLIP."""
    name = "moco_res50" if preset == "MOCOV2" else "simclr_res50"
    model = _moco(name)
    ssl = None if name.startswith("simclr") else init_moco_state(
        model, torch.Generator().manual_seed(1), K, DIM)
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, model, sched)
    state = new_train_state(model=model, opt_state=tx.init(
        dict(model.named_parameters())), ssl=ssl)
    step = make_train_step(model, tx, {"check_grad": True}, sched,
                           device_aug={"views": 2, "preset": preset})
    crops = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (B, RES, RES, 6), np.uint8))
    state, metrics = step(state, {"images": crops})
    heads = ({"head"} if name.startswith("simclr")
             else {"head_fc1", "head_fc2"})
    assert {k for k in metrics if k.startswith("grad_norm/")} == {
        f"grad_norm/{m}" for m in {"visual"} | heads}
    assert float(metrics["update_skipped"]) == 0.0
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(TypeError, match="uint8"):
        step(state, {"images": crops.float()})


def test_registry_builds_every_ssl_name():
    """The 12 names on the meta device: the defaults (embed_dim 2048,
    attnpool_all_res on the ResNets, SimCLR's T 0.5, the head's layout)
    and flat kwargs merged into ``ssl``."""
    for method in ("moco", "simclr", "clsa"):
        for arch in ("res50", "res101", "vitb32", "vitb16"):
            m = model_entry({"type": f"{method}_{arch}",
                             "kwargs": {"mlp": method != "clsa",
                                        "ssl": {"dim": 64}}},
                            device="meta")
            assert method_of(m) == method and m.dim == 64
            assert m.visual.embed_dim == m.hidden_dim == 2048
            assert getattr(m.visual, "attnpool_all_res",
                           True) is True
            heads = sorted({n.rsplit(".", 1)[0] for n, _ in
                            m.named_parameters()
                            if not n.startswith("visual.")})
            assert heads == {"simclr": ["head.fc1", "head.fc2"],
                             "moco": ["head_fc1", "head_fc2"],
                             "clsa": ["head_fc2"]}[method]
            assert m.T == (0.5 if method == "simclr" else 0.07)


@pytest.fixture(scope="module")
def photo():
    rng = np.random.default_rng(5)
    return Image.fromarray(rng.integers(0, 256, (60, 80, 3), np.uint8))


def test_autoaugment_and_clsa_views_match_jax(photo):
    """The same ops drawing from the same ``random.Random``: the same
    images bit for bit, every op of the table taken."""
    from declip_tpu.data import transforms as jt
    from declip_tpu.data import transforms_extra as jte
    from declip_tpu_torch.data import transforms as pt
    from declip_tpu_torch.data import transforms_extra as pte

    assert list(pte.OPS) == list(jte.OPS)
    assert pte.IMAGENET_POLICY == list(jte.IMAGENET_POLICY)
    for name in pte.OPS:
        for mag in (0, 5, 9):
            got = pte._apply(photo, name, 1.0, mag, random.Random(mag))
            want = jte._apply(photo, name, 1.0, mag, random.Random(mag))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f"{name} {mag}")
    for cls in ("ImageNetPolicy", "CLSAAug"):
        port = getattr(pte, cls)(rng=random.Random(4))
        jax_t = getattr(jte, cls)(rng=random.Random(4))
        for _ in range(4):
            np.testing.assert_array_equal(np.asarray(port(photo)),
                                          np.asarray(jax_t(photo)))
    for aug in ("AUTOAUG", "CLSA2-16-32", "CLSA3-40_48"):
        port = pt.build_common_augmentation(aug, random.Random(8))
        jax_t = jt.build_common_augmentation(aug, random.Random(8))
        for _ in range(1):
            got, want = port(photo), jax_t(photo)
            if aug == "AUTOAUG":
                got, want = [got], [want]
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
    views = pt.build_common_augmentation("CLSA2-16-32")(photo)
    assert [v.shape for v in views] == [(224, 224, 3)] * 2 + [
        (16, 16, 3), (32, 32, 3)]


def test_clsa_loader_batch_matches_jax():
    """The loader's collation of CLSA's views: the two weak views on the
    channel axis of ``images``, each strong resolution its own
    ``images_strong_{i}``, float32, the JAX loader's arrays."""
    from declip_tpu.data.dataloader import build_clip_dataloader as jax_build
    from declip_tpu.data.transforms import build_common_augmentation as jt
    from declip_tpu_torch.data.dataloader import build_clip_dataloader
    from declip_tpu_torch.data.transforms import build_common_augmentation

    cfg = {"read_from": "synthetic", "meta_file": "8", "batch_size": 4,
           "num_workers": 1, "max_iter": 1, "seed": 2,
           "sampler": {"type": "distributed_iteration"}}
    transform = build_common_augmentation("CLSA2-48-64", random.Random(3))
    # process workers receive it pickled, as the solver hands it on
    transform = pickle.loads(pickle.dumps(transform))
    got = next(iter(build_clip_dataloader(cfg, transform=transform)))
    want = next(iter(jax_build(cfg, transform=jt("CLSA2-48-64",
                                                 random.Random(3)))))
    assert set(got) == set(want) == {"images", "images_strong_0",
                                     "images_strong_1", "tokens", "labels"}
    shapes = {"images": (4, 224, 224, 6), "images_strong_0": (4, 48, 48, 3),
              "images_strong_1": (4, 64, 64, 3)}
    for k, shape in shapes.items():
        assert got[k].shape == shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


MOCO_CONFIG = """
model:
    type: moco_res50
    kwargs:
        image_encode: {embed_dim: 32, layers: [1, 1, 1, 1], width: 8,
                       heads: 4, input_resolution: 64}
        dim: 16
        K: 48
precision: {dtype: float32}
optimizer:
    type: SGD
    kwargs: {lr: 0.03, momentum: 0.9, weight_decay: 0.0001}
lr_scheduler:
    type: Cosine
    kwargs: {base_lr: 0.0, warmup_lr: 0.03, warmup_steps: 1, max_iter: 2}
data:
    train:
        batch_size: 4
        read_from: synthetic
        meta_file: "16"
        transforms: {type: MOCOV2}
        num_workers: 1
saver: {print_freq: 1, save_freq: 0, pretrain: {auto_resume: True}}
"""


def test_moco_solver_saves_and_resumes(tmp_path):
    """``moco_res50`` through the port's ``main`` on the CPU for 2 steps
    (saved at the end), then resumed to 3: the resumed Solver starts from
    the saved key encoder (parameters and statistics), queue and pointer,
    bit for bit."""
    from declip_tpu_torch import solver as solver_mod

    (tmp_path / "config.yaml").write_text(MOCO_CONFIG)
    args = ["--config", str(tmp_path / "config.yaml"), "--device", "cpu"]
    first = solver_mod.main(args)
    ssl = first.state.ssl
    assert first.method == "moco" and ssl.queue_ptr == 8
    saved = {k: v.clone() for k, v in ssl.key_model.state_dict().items()}
    cfg = solver_mod.override(solver_mod.parse_config(
        str(tmp_path / "config.yaml")), "lr_scheduler.kwargs.max_iter", 3)
    again = solver_mod.Solver(cfg, device="cpu")
    assert again.start_step == 2
    got = again.state.ssl
    assert got.queue_ptr == 8 and torch.equal(got.queue, ssl.queue)
    for k, v in got.key_model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert not torch.equal(saved["visual.bn1.running_var"],
                           again.model.visual.bn1.running_var)
    again.train()
    assert again.state.step == 3 and again.state.ssl.queue_ptr == 12
    shutil.rmtree(tmp_path / "checkpoints")
