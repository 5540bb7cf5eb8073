"""The port's serving host against the JAX package's, over real HTTP.

One tiny CLIP experiment directory serves both: the JAX host reads
``checkpoints/ckpt.msgpack``, the port's host (``--device cpu``) reads
``checkpoints/ckpt.pth.tar``, written from that msgpack by
``python -m declip_tpu.tools.convert --to_pth``. Both compute in fp32;
embeddings agree at rtol 1e-4 / atol 1e-5 (summation order only, as in
tests/test_torch_clip.py).

The serving tools on the same directory (each tolerance stated in its
test): the int8 towers against the JAX package's ``int8_jit``, the
``torch.export`` artifacts (fp32, int8, a pinned batch) and their hosts
(``from_exported``, ``from_config(int8=True)``), ``tools.inference``
against the JAX package's with saliency maps, and the parameter census
against ``declip_tpu.utils.flops``.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import contextlib
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

RES = 32
RTOL, ATOL = 1e-4, 1e-5

CONFIG = """
model:
    type: clip_vitb32
    kwargs:
        image_encode: {embed_dim: 32, input_resolution: 32, patch_size: 8,
                       width: 64, layers: 2, heads: 2}
        text_encode: {embed_dim: 32, transformer_width: 64,
                      transformer_heads: 2, transformer_layers: 2}
        clip: {use_allgather: False}
"""


def _start(host):
    stop = threading.Event()
    t = threading.Thread(target=host.batcher.run_forever, args=(stop,),
                         daemon=True)
    t.start()
    port = host.start_http("127.0.0.1", 0)
    return f"http://127.0.0.1:{port}", stop, t


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """(jax_url, port_url, jax_host, port_host) over one experiment dir."""
    from flax import serialization

    from declip_tpu.models import model_entry
    from declip_tpu.tools.convert import main as convert_main
    from declip_tpu.tools.serve import ServingHost as JaxHost
    from declip_tpu_torch.tools.serve import ServingHost

    exp = tmp_path_factory.mktemp("tiny_clip")
    cfg = exp / "config.yaml"
    cfg.write_text(CONFIG)
    ckpts = exp / "checkpoints"
    ckpts.mkdir()
    import yaml
    model = model_entry(yaml.safe_load(CONFIG)["model"])
    batch = {"images": jnp.zeros((1, RES, RES, 3), jnp.float32),
             "tokens": jnp.ones((1, 77), jnp.int32)}
    variables = jax.jit(
        lambda: model.init(jax.random.PRNGKey(0), batch, train=True))()
    msgpack = ckpts / "ckpt.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize(
        {"params": jax.device_get(variables["params"]), "step": 0}))
    convert_main(["--to_pth", str(msgpack), "--config", str(cfg),
                  "--out", str(ckpts / "ckpt.pth.tar")])

    kw = {"max_batch": 8, "max_wait_ms": 30.0}
    jhost = JaxHost.from_config(str(cfg), **kw)
    thost = ServingHost.from_config(str(cfg), device="cpu", **kw)
    jurl, jstop, jt = _start(jhost)
    turl, tstop, tt = _start(thost)
    yield jurl, turl, jhost, thost
    for stop, host, t in ((jstop, jhost, jt), (tstop, thost, tt)):
        stop.set()
        host.shutdown()
        t.join(timeout=10)
        assert not t.is_alive()


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _both(hosts, path, payload):
    jurl, turl, *_ = hosts
    return _post(jurl, path, payload), _post(turl, path, payload)


@pytest.mark.parametrize("payload", [
    {"texts": ["a red square", "a photo of a blue circle", "hello"]},
    {"tokens": np.random.default_rng(0).integers(
        0, 514, size=(2, 77)).tolist()},
    {"texts": ["a dog"], "normalize": True},
], ids=["texts", "tokens", "normalized"])
def test_encode_text_matches_jax_host(hosts, payload):
    (js, jout), (ts, tout) = _both(hosts, "/v1/encode_text", payload)
    assert js == ts == 200
    np.testing.assert_allclose(np.asarray(tout["embeddings"]),
                               np.asarray(jout["embeddings"]),
                               rtol=RTOL, atol=ATOL)
    assert (tout["dim"], tout["batch"]) == (jout["dim"], jout["batch"])


def test_encode_image_bucketing_matches_jax_host(hosts):
    """3 rows pad to the 4-bucket on both hosts; padding is invisible."""
    *_, jhost, thost = hosts
    pads = (jhost.batcher.stats["padded_rows"],
            thost.batcher.stats["padded_rows"])
    imgs = np.random.default_rng(1).normal(size=(3, RES, RES, 3))
    (js, jout), (ts, tout) = _both(
        hosts, "/v1/encode_image",
        {"arrays": imgs.astype(np.float32).tolist(), "normalize": True})
    assert js == ts == 200
    got = np.asarray(tout["embeddings"])
    np.testing.assert_allclose(got, np.asarray(jout["embeddings"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert jhost.batcher.stats["padded_rows"] - pads[0] == 1
    assert thost.batcher.stats["padded_rows"] - pads[1] == 1
    # a lone row gives the same values as inside the padded batch
    _, one = _post(hosts[1], "/v1/encode_image",
                   {"arrays": imgs[:1].astype(np.float32).tolist(),
                    "normalize": True})
    np.testing.assert_allclose(one["embeddings"][0], got[0], rtol=1e-5,
                               atol=1e-6)


def test_concurrent_requests_coalesced(hosts):
    _, turl, _, thost = hosts
    texts = [f"prompt number {i}" for i in range(6)]
    results, errs = {}, []

    def one(i):
        try:
            status, out = _post(turl, "/v1/encode_text", {"texts": [texts[i]]})
            assert status == 200, out
            results[i] = np.asarray(out["embeddings"][0], np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    b0 = thost.batcher.stats["batches"]
    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs and len(results) == 6
    # 6 one-row requests must not have taken 6 batches (30 ms window)
    assert thost.batcher.stats["batches"] - b0 < 6
    _, want = _post(hosts[0], "/v1/encode_text", {"texts": texts})
    for i in range(6):
        np.testing.assert_allclose(results[i], want["embeddings"][i],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path,payload,code,needle", [
    ("/v1/encode_text", {}, 400, "need 'texts' or 'tokens'"),
    ("/v1/encode_text", {"texts": [f"t{i}" for i in range(9)]}, 400,
     "max_batch"),
    ("/v1/encode_text", {"tokens": [1, 2, 3]}, 400, "[n, context]"),
    ("/v1/encode_image", {"arrays": [[1.0, 2.0]]}, 400, "[n, H, W, 3]"),
    ("/v1/encode_image", {"images_b64": ["AAAA"]}, 400, "no preprocess"),
    ("/v1/nope", {}, 404, "no route"),
], ids=["empty", "over-max-batch", "tokens-1d", "arrays-2d", "no-preprocess",
        "no-route"])
def test_errors_match_jax_host(hosts, path, payload, code, needle):
    (js, jout), (ts, tout) = _both(hosts, path, payload)
    assert js == ts == code
    assert needle in tout["error"] and tout["error"] == jout["error"]


def test_health_and_stats(hosts):
    jurl, turl, _, thost = hosts
    _post(turl, "/v1/encode_text", {"texts": ["warm"]})
    h = _get(turl, "/healthz")
    assert h == {"ok": True, "device": "cpu", "kinds": ["image", "text"]}
    s, js = _get(turl, "/stats"), _get(jurl, "/stats")
    assert set(js) - {"int8"} <= set(s)
    assert s["device"] == "cpu" and s["input_resolution"] == RES
    assert s["requests"] >= 1 and s["latency_ms"]["p95"] >= \
        s["latency_ms"]["p50"] > 0
    assert thost.model is not None and not thost.model.training


def test_load_eval_model_reads_converted_pth(hosts):
    """The port's load_eval_model found ckpt.pth.tar (not the random init):
    its weights equal the JAX msgpack's, converted."""
    import torch
    from flax import serialization

    from declip_tpu.tools.convert import variables_to_torch_state

    *_, thost = hosts
    src = thost.meta["source"]
    blob = open(os.path.join(os.path.dirname(src), "checkpoints",
                             "ckpt.msgpack"), "rb").read()
    want = variables_to_torch_state(
        {"params": serialization.msgpack_restore(blob)["params"]})
    got = thost.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------ serving tools
# int8, the torch.export artifacts, tools/inference.py and the parameter
# census, on the same experiment directory (no new JAX model is built: the
# JAX side loads the fixture's msgpack)

def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, RES, RES, 3)).astype(np.float32),
            "text": rng.integers(0, 514, size=(n, 77)).astype(np.int64)}


def _live(model, kind, rows):
    import torch

    tower = model.encode_image if kind == "image" else model.encode_text
    with torch.no_grad():
        return tower(torch.from_numpy(rows)).numpy()


@pytest.fixture(scope="module")
def jax_eval(hosts):
    """The JAX package's ``(model, variables)`` from the fixture's msgpack."""
    from declip_tpu.tools._common import load_eval_model

    return load_eval_model(hosts[3].meta["source"])


@pytest.fixture(scope="module")
def exported(hosts, tmp_path_factory):
    """``convert --export-serving`` on the CPU with a symbolic batch, fp32
    and int8 -> {"fp32": dir, "int8": dir}."""
    from declip_tpu_torch.tools import convert

    root = tmp_path_factory.mktemp("exported")
    cfg = hosts[3].meta["source"]
    for name, extra in (("fp32", []), ("int8", ["--quantize", "int8"])):
        written = convert.main(["--export-serving", "--config", cfg, "--out",
                                str(root / name), "--device", "cpu",
                                *extra])
        assert sorted(map(os.path.basename, written)) == [
            "encode_image.pt2", "encode_text.pt2"]
    return {name: str(root / name) for name in ("fp32", "int8")}


@pytest.mark.parametrize("kind", ["image", "text"])
def test_int8_towers_match_jax_int8_jit(hosts, jax_eval, kind):
    """Under ``int8_inference(min_dim=32)`` (every Dense of the 64-wide
    towers) the port's towers agree with JAX's ``int8_jit`` per row with a
    cosine >= 0.9999 (the two quantize activations that differ by fp32
    rounding, so a code may flip), and with their own fp32 forward above
    0.995 (the JAX test's bound) without equalling it."""
    import jax.numpy as jnp

    from declip_tpu.ops.quant import int8_jit
    from declip_tpu_torch.ops.quant import int8_inference

    model, variables = jax_eval
    rows = _inputs(4)[kind]
    method = "encode_image" if kind == "image" else "encode_text"
    kw = {"train": False} if kind == "image" else {}
    want = np.asarray(int8_jit(
        lambda v, x: model.apply(v, x, method=method, **kw),
        min_dim=32)(variables, jnp.asarray(rows)))
    with int8_inference(min_dim=32):
        got = _live(hosts[3].model, kind, rows)
    fp32 = _live(hosts[3].model, kind, rows)
    assert _cos(got, want).min() >= 0.9999
    assert _cos(got, fp32).min() > 0.995
    assert not np.allclose(got, fp32, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["image", "text"])
def test_int8_min_dim_above_every_width_changes_nothing(hosts, kind):
    from declip_tpu_torch.ops.quant import int8_inference

    rows = _inputs(2)[kind]
    with int8_inference(min_dim=10_000):
        gated = _live(hosts[3].model, kind, rows)
    np.testing.assert_array_equal(gated, _live(hosts[3].model, kind, rows))


@pytest.mark.parametrize("kind", ["image", "text"])
def test_exported_artifacts_match_live_model(hosts, exported, kind):
    """One artifact with a symbolic batch serves B = 1 and B = 3 within
    1e-6 of each row's norm. On the CPU it agrees bit for bit: the graph
    runs the live model's own kernels in the same order."""
    import torch

    from declip_tpu_torch.tools.convert import ARTIFACTS

    module = torch.export.load(
        os.path.join(exported["fp32"], ARTIFACTS[kind])).module()
    rows = _inputs(3)[kind]
    for b in (1, 3):
        with torch.no_grad():
            got = module(torch.from_numpy(rows[:b])).numpy()
        want = _live(hosts[3].model, kind, rows[:b])
        assert got.shape == want.shape == (b, 32)
        err = np.abs(got - want).max(-1)
        assert (err <= 1e-6 * np.linalg.norm(want, axis=-1)).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["image", "text"])
def test_int8_artifact_is_quantized(hosts, exported, kind):
    import torch

    from declip_tpu_torch.ops.quant import int8_inference
    from declip_tpu_torch.tools.convert import ARTIFACTS

    program = torch.export.load(os.path.join(exported["int8"],
                                             ARTIFACTS[kind]))
    assert any(n.target == torch.ops.aten._int_mm.default
               for n in program.graph.nodes)
    rows = _inputs(3)[kind]
    with torch.no_grad():
        got = program.module()(torch.from_numpy(rows)).numpy()
    fp32 = _live(hosts[3].model, kind, rows)
    assert _cos(got, fp32).min() > 0.995
    assert not np.allclose(got, fp32, rtol=1e-5, atol=1e-6)
    with int8_inference():  # the export's min_dim, 64
        np.testing.assert_array_equal(got, _live(hosts[3].model, kind, rows))


def test_serving_batch_pins_the_batch(hosts, tmp_path):
    """``--serving-batch 2`` exports a fixed batch of 2: the artifacts take
    2 rows and no other count."""
    import torch

    from declip_tpu_torch.tools import convert

    written = convert.main(["--export-serving", "--config",
                            hosts[3].meta["source"], "--out", str(tmp_path),
                            "--serving-batch", "2", "--device", "cpu"])
    rows = _inputs(3)
    for path, kind in zip(written, ("image", "text")):
        module = torch.export.load(path).module()
        with torch.no_grad():
            got = module(torch.from_numpy(rows[kind][:2])).numpy()
            np.testing.assert_array_equal(
                got, _live(hosts[3].model, kind, rows[kind][:2]))
            with pytest.raises(AssertionError, match=r"size\(\)\[0\] == 2"):
                module(torch.from_numpy(rows[kind]))


def test_from_exported_refuses_an_empty_dir(tmp_path):
    from declip_tpu_torch.tools.serve import ServingHost

    with pytest.raises(FileNotFoundError, match="encode_image.pt2"):
        ServingHost.from_exported(str(tmp_path), device="cpu")


@pytest.mark.parametrize("source", ["exported", "int8"])
def test_exported_and_int8_hosts_serve(hosts, exported, source):
    """``serve --exported`` and ``serve --int8`` hosts answer a one-row
    and a batched request over HTTP with what their models compute."""
    from declip_tpu_torch.ops.quant import int8_inference
    from declip_tpu_torch.tools.serve import ServingHost

    cfg = hosts[3].meta["source"]
    kw = {"device": "cpu", "max_batch": 8, "max_wait_ms": 30.0}
    host = (ServingHost.from_exported(exported["fp32"], **kw)
            if source == "exported" else
            ServingHost.from_config(cfg, int8=True, **kw))
    assert host.meta["input_resolution"] == RES
    url, stop, t = _start(host)
    try:
        rows = _inputs(3)
        for n in (1, 3):
            status, out = _post(url, "/v1/encode_image",
                                {"arrays": rows["image"][:n].tolist()})
            assert status == 200, out
            status, txt = _post(url, "/v1/encode_text",
                                {"tokens": rows["text"][:n].tolist()})
            assert status == 200, txt
            with (int8_inference() if source == "int8"
                  else contextlib.nullcontext()):
                want_img = _live(hosts[3].model, "image", rows["image"][:n])
                want_txt = _live(hosts[3].model, "text", rows["text"][:n])
            np.testing.assert_allclose(out["embeddings"], want_img,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(txt["embeddings"], want_txt,
                                       rtol=1e-5, atol=1e-6)
    finally:
        stop.set()
        host.shutdown()
        t.join(timeout=10)
        assert not t.is_alive()


def test_inference_matches_jax(hosts, tmp_path):
    """JAX's ``inference.main`` and the port's (``--device cpu``) on one
    checkpoint and three seeded PNGs write the same predictions, the
    probabilities within 1e-5 and the saliency maps within 1e-4 of their
    max (the 224-pixel ONECROP crops run the 32-pixel ViT on a resized
    positional grid, 785 tokens, on both sides)."""
    from PIL import Image

    from declip_tpu.tools import inference as jax_inference
    from declip_tpu_torch.tools import inference

    cfg = hosts[3].meta["source"]
    rng = np.random.default_rng(6)
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    for i, size in enumerate([(48, 40), (64, 64), (30, 90)]):
        img = Image.fromarray(rng.integers(0, 256, size=(*size, 3),
                                           dtype=np.uint8))
        for d in dirs.values():
            d.mkdir(exist_ok=True)
            img.save(d / f"img{i}.png")
    classes = "cat,dog,red square"
    outs = {side: str(tmp_path / f"{side}.jsonl") for side in dirs}
    jax_inference.main(["--config", cfg, "--image_dir", str(dirs["jax"]),
                        "--classes", classes, "--out", outs["jax"],
                        "--saliency"])
    inference.main(["--config", cfg, "--image_dir", str(dirs["port"]),
                    "--classes", classes, "--out", outs["port"],
                    "--saliency", "--device", "cpu"])
    recs = {side: [json.loads(line) for line in open(path)]
            for side, path in outs.items()}
    assert len(recs["port"]) == len(recs["jax"]) == 3
    for got, want in zip(recs["port"], recs["jax"]):
        assert set(got) == set(want)
        assert got["filename"] == want["filename"]
        assert got["prediction"] == want["prediction"]
        assert list(got["probs"]) == list(want["probs"])
        np.testing.assert_allclose(list(got["probs"].values()),
                                   list(want["probs"].values()), atol=1e-5)
        sal, ref = np.load(got["saliency"]), np.load(want["saliency"])
        assert sal.shape == ref.shape == (224, 224)
        assert sal.dtype == np.float32 and ref.max() > 0
        assert np.abs(sal - ref).max() <= 1e-4 * ref.max()


def test_count_params_match_jax(hosts, jax_eval):
    """The census of the converted tiny CLIP equals JAX's over ``params``;
    by top module through the name map (the port's ``encode_text`` is
    JAX's ``text``). ``tensors`` differs by design: JAX stacks each
    tower's residual blocks into one leaf a kind."""
    from declip_tpu.utils import flops as jax_flops
    from declip_tpu_torch.utils import flops

    names = {"encode_text": "text", "visual": "visual",
             "logit_scale": "logit_scale"}
    params = jax_eval[1]["params"]
    got, want = (flops.count_params(hosts[3].model),
                 jax_flops.count_params(params))
    assert (got["total"], got["total_M"]) == (want["total"], want["total_M"])
    by_top = flops.count_params_by_top_module(hosts[3].model)
    assert {names[k]: v for k, v in by_top.items()} == \
        jax_flops.count_params_by_top_module(params)
