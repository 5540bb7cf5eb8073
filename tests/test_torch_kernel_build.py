"""What the kernel build and the card checks do that runs without a card:
the build cache key, and chip_smoke.py's readers of nvcc's and cuobjdump's
output and its tolerance rule. The kernels themselves are held to their
plain versions on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py)."""

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
