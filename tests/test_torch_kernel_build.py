"""What the kernel build and the card checks do that runs without a card:
the build cache key, and chip_smoke.py's readers of nvcc's and cuobjdump's
output and its tolerance rule. The kernels themselves are held to their
plain versions on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py)."""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import importlib.util
import pathlib

import pytest
import torch

from declip_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "blocks.cuh").write_text("// shared blocks\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edit,rebuilds", [
    ("k.cu", True),          # the source itself
    ("blocks.cuh", True),    # a header every attention source includes
    ("notes.txt", False),    # anything else in csrc/
])
def test_library_path_follows_sources_and_headers(csrc, edit, rebuilds):
    before = _build.library_path("k")
    with open(csrc / edit, "a") as f:
        f.write("// edited\n")
    assert (_build.library_path("k") != before) == rebuilds


def test_every_header_is_packaged():
    """pyproject ships the headers the sources include."""
    text = (REPO / "pyproject.toml").read_text()
    assert '"csrc/*.cuh"' in text
    assert list(pathlib.Path(_build.CSRC_DIR).glob("*.cuh"))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z10a_bf16_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z10a_bf16_kernelPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8b_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z8b_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 372 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z10a_bf16_kernelPf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
\t\tFunction : _Z8b_kernelPf
        /*0100*/                   FFMA R1, R2, R3, R1 ;
"""


# the attention libraries' kernels as nvcc names them (mangled, cut short)
FWD_BF16 = "_Z26flash_attn_fwd_bf16_kernelILi64EEvPK13__nv_bfloat16"
FWD_TF32 = "_Z26flash_attn_fwd_tf32_kernelILi64EEvPKfS1_S1_PfS2_iif"
FWD_SASS = f"""\
\t\tFunction : {FWD_TF32}
        /*0100*/                   HMMA.1688.F32.TF32 R8, R4, R12, R8 ;
        /*0110*/                   HMMA.1688.F32.TF32 R8, R6, R14, R8 ;
        /*0120*/                   HMMA.1688.F32.TF32 R8, R4, R14, R8 ;
\t\tFunction : {FWD_BF16}
        /*0100*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""
NO_SPILL = {"spill_stores": 0, "spill_loads": 0, "registers": 168}


def test_hmma_counts_tf32_kernel(smoke):
    assert smoke.hmma_counts(FWD_SASS) == {FWD_TF32: 3, FWD_BF16: 1}


def test_tensor_core_check_passes_both_forward_routes(smoke):
    faults, found = smoke.tensor_core_faults(
        "flash_attn_fwd", smoke.hmma_counts(FWD_SASS),
        {FWD_TF32: NO_SPILL, FWD_BF16: NO_SPILL})
    assert faults == [] and found == {FWD_TF32: 3, FWD_BF16: 1}


@pytest.mark.parametrize("fault", ["cuda-cores", "missing", "spill"])
def test_tensor_core_check_fails_the_fp32_forward(smoke, fault):
    """Phase 1 fails K1's fp32 kernel when it runs on the CUDA cores (no
    HMMA), is missing, or spilled."""
    sass, ptxas = FWD_SASS, {FWD_TF32: dict(NO_SPILL), FWD_BF16: NO_SPILL}
    if fault == "cuda-cores":
        sass = sass.replace("HMMA.1688.F32.TF32", "FFMA")
    elif fault == "missing":
        sass = sass.replace("tf32_kernel", "kernel")
    else:
        ptxas[FWD_TF32]["spill_stores"] = 4
    faults, _ = smoke.tensor_core_faults("flash_attn_fwd",
                                         smoke.hmma_counts(sass), ptxas)
    want = {"cuda-cores": "has no HMMA",
            "missing": "no tensor-core kernel *_tf32_kernel",
            "spill": "ptxas spilled"}[fault]
    assert len(faults) == 1 and want in faults[0], faults


def test_round_tf32_rounds_to_nearest_ties_away(smoke):
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3.14159265, 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 ** -10, 3.140625, 0.0])
    assert torch.equal(smoke.round_tf32(x), want)


@pytest.mark.parametrize("heads,length,causal", [(12, 50, False),
                                                 (8, 77, True)],
                         ids=["image", "text"])
def test_fp32_limit_fails_plain_tf32_on_cpu(smoke, heads, length, causal):
    """The plain version on TF32-rounded inputs misses the fp32 limit at the
    serving shapes (the card test repeats this on the card)."""
    g = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn(2, heads, length, 64, generator=g)
               for _ in range(3))
    _, share = smoke.tf32_plain_check(q, k, v, causal, 64 ** -0.5)
    assert share > 1


def test_ptxas_report_reads_registers_and_spills(smoke):
    rep = smoke.ptxas_report(PTXAS_LOG)
    assert rep == {
        "_Z10a_bf16_kernelPf": {"spill_stores": 8, "spill_loads": 4,
                                "registers": 255},
        "_Z8b_kernelPf": {"spill_stores": 0, "spill_loads": 0,
                          "registers": 40}}


def test_hmma_counts_per_function(smoke):
    assert smoke.hmma_counts(SASS) == {"_Z10a_bf16_kernelPf": 2,
                                       "_Z8b_kernelPf": 0}


@pytest.mark.parametrize("err,ok", [
    (0.9e-2, True),   # inside 1% of the largest magnitude
    (1.1e-2, False),  # outside it (the element itself is 0)
])
def test_bf16_tolerance_scales_with_the_largest_magnitude(smoke, err, ok):
    want = torch.tensor([1.0, 0.0, -0.5])
    got = want + torch.tensor([0.0, err, 0.0])
    assert smoke._within(got, want, *smoke.TOLERANCE["bfloat16"])[0] is ok


@pytest.mark.parametrize("err,ok", [(5e-7, True), (2e-6, False)])
def test_bf16_tolerance_floor_for_a_zero_tensor(smoke, err, ok):
    """A gradient that is exactly zero (dq, dk at L=1) is held to 1e-6."""
    want = torch.zeros(4)
    got = torch.full((4,), err)
    assert smoke._within(got, want,
                         *smoke.BWD_TOLERANCE["bfloat16"])[0] is ok


def test_fp32_tolerance_is_absolute(smoke):
    want = torch.tensor([100.0, 0.0])
    got = want + torch.tensor([0.0, 3e-5])  # beyond atol 2e-5 at the zero
    assert not smoke._within(got, want, *smoke.TOLERANCE["float32"])[0]


@pytest.mark.parametrize("which", ["fwd", "d1", "d2"])
def test_late_interaction_bound_counts_the_winner_mask(smoke, which):
    """K3 writes the winner mask; K4 and K5 read it, with g and their one
    feature tensor, and write their gradient: each bound counts those bytes
    and, for K4 and K5, 2*D FLOPs per winner only."""
    b, n1, gb, n2, d = 128, 49, 128, 16, 256
    winners = b * n1 * gb  # one winner per (row, item)
    mask = b * n1 * gb * 4
    feats = (b * n1 + gb * n2) * d * 2
    want_bytes = {"fwd": feats + b * gb * 4 + mask,
                  "d1": mask + b * gb * 4 + feats,
                  "d2": mask + b * gb * 4 + feats}[which]
    ms, by = smoke.late_interaction_bound(b, n1, gb, n2, d, "bfloat16",
                                          which, winners)
    want_flops = (2 * b * n1 * gb * n2 * d if which == "fwd"
                  else 2 * winners * d)
    want = max(want_bytes / smoke.HBM_BYTES_PER_S,
               want_flops / smoke.PEAK_FLOPS["bfloat16"]) * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == ("operations" if which == "fwd" else "bytes")
    # two words of mask a pair at N2 = 33
    ms33, _ = smoke.late_interaction_bound(b, n1, gb, 33, d, "bfloat16",
                                           which, winners)
    assert ms33 > ms


# the late-interaction library's kernels as nvcc names them (cut short)
LI_BF16 = ("_ZN12_GLOBAL__N_118li_fwd_bf16_kernelILb1ELi16EEEvPK13__nv_"
           "bfloat16S3_PfPjNS_5ShapeEiiiib")
LI_FP32 = "_ZN12_GLOBAL__N_113li_fwd_kernelIfEEvPKT_S3_PfPjNS_5ShapeEi"
LI_K4 = ("_ZN12_GLOBAL__N_116li_bwd_d1_kernelI13__nv_bfloat16Li3EEEvPKjPKT_"
         "PKfPfPS4_NS_5ShapeEiib")
LI_SASS = f"""\
\t\tFunction : {LI_BF16}
        /*0100*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
\t\tFunction : {LI_FP32}
        /*0100*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : {LI_K4}
        /*0100*/                   FFMA R1, R2, R3, R1 ;
"""


@pytest.mark.parametrize("fault", [None, "cuda-cores", "missing", "spill"])
def test_tensor_core_check_holds_k3_bf16(smoke, fault):
    """Phase 1 passes K3's bf16 kernel with HMMA and no spill, whatever the
    fp32 K3 and K4 (CUDA cores) hold, and fails it on the CUDA cores,
    missing or spilled."""
    sass = LI_SASS
    ptxas = {fn: dict(NO_SPILL) for fn in (LI_BF16, LI_FP32, LI_K4)}
    if fault == "cuda-cores":
        sass = sass.replace("HMMA.16816.F32.BF16", "FFMA")
    elif fault == "missing":
        sass = sass.replace("li_fwd_bf16_kernel", "li_fwd_x_kernel")
    elif fault == "spill":
        ptxas[LI_BF16]["spill_loads"] = 8
    faults, found = smoke.tensor_core_faults("filip_li",
                                             smoke.hmma_counts(sass), ptxas)
    if fault is None:
        assert faults == [] and found == {LI_BF16: 2}
    else:
        want = {"cuda-cores": "has no HMMA",
                "missing": "no tensor-core kernel *li_fwd_bf16_kernel",
                "spill": "ptxas spilled"}[fault]
        assert len(faults) == 1 and want in faults[0], faults


@pytest.mark.parametrize("name,kind", [
    (LI_BF16, "K3"),
    (LI_FP32, "K3"),
    ("_ZN12_GLOBAL__N_114li_mean_kernelEPKfPfiii", "K3"),
    (LI_K4, "K4"),
    ("void (anonymous namespace)::li_fwd_bf16_kernel<true, 16>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float*, unsigned int*, "
     "(anonymous namespace)::Shape, int, int, int, int, bool)", "K3"),
])
def test_kernel_kind_counts_k3_by_either_route(smoke, name, kind):
    """The profiler's names of K3's kernels, mangled or demangled, count as
    K3, so the FILIP step's K3 time and the timing tool keep them."""
    assert smoke.kernel_kind(name) == kind


@pytest.mark.parametrize("name,kind", [
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel"
     "<at::native::Var, c10::BFloat16, float, 4>(...)", "BatchNorm"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, "
     "1, true>(...)", "BatchNorm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1", "conv (cuDNN)"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv (cuDNN)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM"),
])
def test_kernel_kind_parts_convs_and_batchnorm(smoke, name, kind):
    """The DeCLIP-R50 step's cuDNN convs and BatchNorm kernels get kinds of
    their own; a plain GEMM stays a GEMM."""
    assert smoke.kernel_kind(name) == kind


def test_call_counter_keeps_the_pooled_query_apart(smoke):
    """Plain self-attention counts as a plain-path call; a query of another
    length than its keys (AttentionPool2d's pooled query) counts apart."""
    from declip_tpu_torch.ops.attention import dot_product_attention

    q = torch.randn(2, 2, 5, 8)
    with smoke._CallCounter() as plain:
        dot_product_attention(q[:, :, :1], q, q)
        dot_product_attention(q[:, :, :1], q, q)
        dot_product_attention(q, q, q, impl="xla")
    assert (plain.calls, plain.cross) == (1, 2)


def test_solver_window_reads_steps_of_one(smoke):
    """Phase 7's reader of the solver's per-print timings: means over the
    asked steps, pairs/s from the batch, the data wait's share."""
    timings = [{"step": s, "steps": 1, "batch_time": 0.1 * s,
                "data_time": 0.05 * s, "save_time": 0.3 if s == 4 else 0.0,
                "h2d_ms": float(s)} for s in range(1, 7)]
    w = smoke.solver_window(timings, 4, 6, 128)
    assert w["step_s"] == pytest.approx(0.5)
    assert w["pairs_per_s"] == pytest.approx(256.0)
    assert w["save_s"] == pytest.approx(0.1)
    assert w["pairs_per_s_without_saves"] == pytest.approx(320.0)
    assert w["data_s"] == pytest.approx(0.25)
    assert w["data_share"] == pytest.approx(0.5)
    assert (w["h2d_ms_median"], w["h2d_ms_max"]) == (4.0, 6.0)
    with pytest.raises(AssertionError, match="missing"):
        smoke.solver_window(timings[:5], 4, 6, 128)
    windowed = [dict(t, steps=2) for t in timings]
    with pytest.raises(AssertionError, match="missing"):
        smoke.solver_window(windowed, 4, 6, 128)


def test_loader_rate_skips_the_first_round(smoke):
    """A loader of 3 workers whose batches land in rounds of 3, the rounds
    ending at 2, 3.5 and 5 s: 6 batches past the first round in 3 s, 2
    batches/s, however its arrivals spread inside a round. A span that is
    not whole rounds, or only one round, is refused."""
    arrivals = [1.9, 2.0, 2.0, 3.0, 3.5, 3.5, 4.4, 4.5, 5.0]
    r = smoke.loader_rate(arrivals, 3, 128)
    assert r["batches_per_s"] == pytest.approx(2.0)
    assert r["pairs_per_s"] == pytest.approx(256.0)
    assert (r["first_batch_s"], r["first_round_s"], r["batches"]) == (
        1.9, 2.0, 9)
    for cut in (arrivals[:4], arrivals[:3]):
        with pytest.raises(AssertionError):
            smoke.loader_rate(cut, 3, 128)


def test_scalars_by_tag_and_corpus(smoke, tmp_path):
    """Phase 7's reader of events/scalars.jsonl, and its corpus writer:
    JPEGs of the stated sizes, captions of 5-20 words, a labelled val
    set."""
    import json

    from PIL import Image

    path = tmp_path / "scalars.jsonl"
    path.write_text("".join(json.dumps({"t": 0, "step": s, "tag": tag,
                                        "value": v}) + "\n"
                            for s, tag, v in [(1, "loss", 2.0),
                                              (1, "lr", 1e-4),
                                              (2, "loss", 1.5)]))
    assert smoke.scalars_by_tag(str(path)) == {
        "loss": [(1, 2.0), (2, 1.5)], "lr": [(1, 1e-4)]}
    train, val = smoke.write_corpus(str(tmp_path / "c"), 6, 3, 2, seed=0)
    rows = [json.loads(x) for x in open(train)]
    assert len(rows) == 6
    for r in rows:
        assert 5 <= len(r["caption"].split()) <= 20
        img = Image.open(tmp_path / "c" / r["filename"])
        assert img.format == "JPEG" and 256 <= max(img.size) <= 640
        assert 0.74 <= img.size[0] / img.size[1] <= 1.34
    labels = [json.loads(x) for x in open(val)]
    assert sorted({(r["label"], r["label_name"]) for r in labels}) == \
        sorted({(r["label"], r["label_name"]) for r in labels[::2]})
    assert len(labels) == 6 and {r["label"] for r in labels} == {0, 1, 2}


def test_solver_kernel_calls_counts_the_solvers_prompt_chunks(smoke):
    """Phase 7's exact launch count: 24 K1 and K2 a step, and K1 once a text
    layer for each chunk the solver's zero-shot eval encodes (its own
    chunking, over the recipe's 80 prompts and the phase's classes)."""
    from types import SimpleNamespace

    from declip_tpu_torch.solver import Solver

    calls = []

    def encode_text(ids):
        calls.append(ids.shape[0])
        return torch.ones(ids.shape[0], 4)

    names = [f"class {i}" for i in range(smoke.SOLVER_CLASSES)]
    texts = [f"a photo of a {n} {p}." for n in names
             for p in range(smoke.SOLVER_PROMPTS)]
    emb = Solver.class_embeddings(SimpleNamespace(device="cpu"),
                                  SimpleNamespace(encode_text=encode_text),
                                  texts, smoke.SOLVER_CLASSES)
    assert emb.shape == (smoke.SOLVER_CLASSES, 4)
    blocks = SimpleNamespace(resblocks=[None] * 12)
    fake = SimpleNamespace(
        model=SimpleNamespace(encode_text=SimpleNamespace(transformer=blocks)),
        eval_seconds=[1.0, 2.0])
    assert smoke.solver_kernel_calls(fake, 6) == {
        "K1": 24 * 6 + 2 * len(calls) * 12, "K2": 24 * 6,
        "K3": 0, "K4": 0, "K5": 0}


def test_solver_method_calls_match_the_solvers_chunking(smoke):
    """Phase 10's expected launches follow the solver's own chunking: the
    dense class embeddings in chunks of 512 // prompts classes (so K1 once
    a text layer a chunk), a ViT's eval batches 12 K1 each, K3 once an eval
    batch when dense; a ResNet tower adds no K1, and the pooled eval no
    K3."""
    from types import SimpleNamespace

    import numpy as np

    from declip_tpu_torch.solver import Solver

    calls = []

    def encode_text_dense(ids):
        calls.append(ids.shape[0])
        return torch.ones(ids.shape[0], 77, 4)

    names = [f"class {i}" for i in range(smoke.SOLVER_CLASSES)]
    texts = [f"a photo of a {n} {p}." for n in names
             for p in range(smoke.SOLVER_PROMPTS)]
    emb = Solver.dense_class_embeddings(
        SimpleNamespace(device="cpu"),
        SimpleNamespace(encode_text_dense=encode_text_dense), texts,
        smoke.SOLVER_CLASSES)
    assert emb.shape == (smoke.SOLVER_CLASSES, 77, 4)
    assert np.isclose(float(emb[0, 0].norm()), 1.0)
    blocks = SimpleNamespace(resblocks=[None] * 12)
    vit = SimpleNamespace(model=SimpleNamespace(
        encode_text=SimpleNamespace(transformer=blocks),
        visual=SimpleNamespace(transformer=blocks)))
    per_step = smoke.DEFILIP_PER_STEP
    assert smoke.solver_method_calls(vit, 4, per_step, True, 2) == {
        "K1": 48 * 4 + len(calls) * 12 + 2 * 12, "K2": 48 * 4,
        "K3": 2 * 4 + 2, "K4": 2 * 4, "K5": 2 * 4}
    assert len(calls) == 2
    resnet = SimpleNamespace(model=SimpleNamespace(
        encode_text=SimpleNamespace(transformer=blocks),
        visual=SimpleNamespace()))
    text_only = {"K1": 12, "K2": 12, "K3": 0, "K4": 0, "K5": 0}
    assert smoke.solver_method_calls(resnet, 2, text_only, False, 2) == {
        "K1": 12 * 2 + 12, "K2": 12 * 2, "K3": 0, "K4": 0, "K5": 0}


def test_loader_configs_of_the_fast_input_path(smoke, tmp_path):
    """Phase 8's three loaders from the solver's train split (as --set
    leaves it, shards and process workers): each ships device_aug's crops
    and decodes with PIL; (a) and (b) read the JSONL metafile with threads
    and processes, (c) the shards with processes, and each builds."""
    from declip_tpu_torch.data.dataloader import build_clip_dataset
    from declip_tpu_torch.data.transforms import build_geometry_augmentation
    from declip_tpu_torch.data.wds import WdsClipDataset
    from declip_tpu_torch.tools import make_wds

    train, _ = smoke.write_corpus(str(tmp_path / "c"), 6, 3, 2, seed=0)
    make_wds.pack(train, str(tmp_path / "c"), str(tmp_path / "s-%05d.tar"),
                  3)
    shards = str(tmp_path / "s-{00000..00001}.tar")
    solver_cfg = {"root_dir": [str(tmp_path / "c")], "meta_file": [train],
                  "fseek": True, "read_from": "fs", "batch_size": 2,
                  "transforms": {"type": "MOCOV2"}, "device_aug": True,
                  "type": "clip_wds", "tar_files": shards,
                  "worker_type": "process", "image_reader": {"type": "pil"}}
    cfgs = smoke.loader_configs(solver_cfg, shards)
    assert [cfgs[k]["worker_type"] for k in "abc"] == \
        ["thread", "process", "process"]
    geometry = build_geometry_augmentation("MOCOV2")
    for name, cfg in cfgs.items():
        assert cfg["device_aug"] and cfg["image_reader"] == {"type": "pil"}
        ds = build_clip_dataset(cfg, transform=geometry)
        assert isinstance(ds, WdsClipDataset) == (name == "c")
        assert len(ds) == 6
        item = ds[0]["image"]
        assert item.dtype == "uint8" and item.shape == (224, 224, 6)
    assert "type" not in cfgs["a"] and "root_dir" not in cfgs["c"]


@pytest.mark.parametrize("kind", ["ring", "sigmoid_ring", "chunked",
                                  "sigmoid_chunked"])
def test_phase_12_configs_name_their_loss_kind(smoke, kind):
    """Phase 12's CLIP ViT-B/32 configurations: the ViT-CLIP recipe under
    the kind (chunk 32), with a SigLIP bias of -10 for the sigmoid kinds
    only, at full width (built on the meta device)."""
    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry

    cfg = parse_config(smoke.clip_loss_config(kind))
    assert dict(cfg.loss_impl) == {"type": kind,
                                   "chunk_size": smoke.LOSS_IMPL_CHUNK}
    model = model_entry({"type": cfg.model.type,
                         "kwargs": dict(cfg.model.kwargs)}, device="meta")
    assert model.visual.width == 768
    assert (model.logit_bias is not None) == kind.startswith("sigmoid")
    if kind.startswith("sigmoid"):
        assert cfg.model.kwargs.clip.logit_bias_init == -10.0


@pytest.mark.parametrize("scale,ok", [(1 + 5e-5, True), (1 + 2e-4, False)])
def test_phase_12_gradient_check_reads_relative_norms(smoke, scale, ok):
    """Phase 12c's gradient check: ||g - g_ref|| <= 1e-4 ||g_ref|| for
    every parameter; a parameter whose reference is zero must be zero."""
    ref = [torch.ones(4), torch.zeros(3)]
    grads = [ref[0] * scale, torch.zeros(3)]
    if ok:
        worst = smoke._grads_rel("t", ["a", "b"], grads, ref)
        assert worst[0][0] == "a"
    else:
        with pytest.raises(AssertionError, match="beyond"):
            smoke._grads_rel("t", ["a", "b"], grads, ref)
    with pytest.raises(AssertionError, match="beyond"):
        smoke._grads_rel("t", ["a", "b"], [ref[0], torch.ones(3)], ref)
