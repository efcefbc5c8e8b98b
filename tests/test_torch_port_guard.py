"""Guards of the PyTorch/CUDA port that need no card.

* The port and ``chip_smoke.py`` import neither JAX, flax nor the JAX package.
* Kernel wrappers take their plain versions only on CPU tensors (counters
  untouched); on any other device they launch or raise, with no fallback.
* A failed kernel build raises.
* ``chip_smoke.py`` fails without a GPU and prints no result, and its K1
  limits refuse a kernel that leaves the last key tile unmasked.
"""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import fused_mlp as fm

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lam_slide_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lam_slide_tpu"}


def _port_sources():
    sources = [p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts]
    return sorted(sources) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_no_sdpa_in_port():
    for path in _port_sources():
        assert "scaled_dot_product_attention" not in path.read_text(), path


@pytest.mark.parametrize("module", [fa, fm], ids=["flash_attention", "fused_mlp"])
def test_wrappers_have_no_try(module):
    tree = ast.parse(Path(module.__file__).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _attn_inputs(device):
    return [torch.zeros(1, 2, 130, 24, dtype=torch.bfloat16, device=device) for _ in range(3)]


def _mlp_inputs(device):
    x = torch.zeros(8, 32, dtype=torch.bfloat16, device=device)
    w1 = torch.zeros(64, 32, dtype=torch.bfloat16, device=device).t()
    b1 = torch.zeros(64, dtype=torch.bfloat16, device=device)
    w2 = torch.zeros(32, 64, dtype=torch.bfloat16, device=device).t()
    return x, w1, b1, w2


def test_cpu_tensors_take_plain_versions_without_counting(monkeypatch):
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fm, "launches", 0)
    q, k, v = _attn_inputs("cpu")
    torch.testing.assert_close(fa.flash_attention(q, k, v), fa.reference_attention(q, k, v))
    args = _mlp_inputs("cpu")
    torch.testing.assert_close(fm.fused_mlp(*args), fm.reference_mlp(*args))
    assert fa.launches == 0 and fm.launches == 0


def test_non_cpu_tensors_raise_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU never reaches a plain version: here
    (meta tensors, no card) the wrappers raise and count nothing."""
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fm, "launches", 0)

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(fa, "reference_attention", no_plain)
    monkeypatch.setattr(fm, "reference_mlp", no_plain)
    with pytest.raises(ValueError):
        fa.flash_attention(*_attn_inputs("meta"))
    with pytest.raises(ValueError):
        fm.fused_mlp(*_mlp_inputs("meta"))
    assert fa.launches == 0 and fm.launches == 0


def test_masks_are_refused():
    q, k, v = _attn_inputs("cpu")
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, mask=torch.ones(1, 130, dtype=torch.bool))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_build_key_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"flash_attention.cu", "fused_mlp.cu", "common.cu", "common.cuh"} <= names
    assert _build.source_hash() == _build.source_hash()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-GPU behaviour")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("variant", ["rounded_from_fp32", "unmasked_last_tile"])
def test_chip_smoke_k1_limits(variant):
    """chip_smoke's K1 limits accept an output rounded differently and refuse
    one whose last key tile is left unmasked, at the 4AA temporal shape."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 1000, 24, generator=g).to(torch.bfloat16) for _ in range(3))
    want = fa.reference_attention(q, k, v)

    def check(got):
        abs_err, _, atol, k1_gain = smoke.k1_errors(got, want)
        smoke.check_k1(abs_err, atol, k1_gain)

    if variant == "rounded_from_fp32":
        # P kept in fp32 through AV: a correct kernel whose roundings differ
        p = torch.softmax(q.float() @ k.float().transpose(-1, -2) * 24 ** -0.5, -1)
        check((p @ v.float()).to(torch.bfloat16))
    else:
        # a kernel without the key mask: 24 zero-filled keys pad 1000 to 1024
        pad = torch.zeros(1, 16, 24, 24, dtype=torch.bfloat16)
        got = fa.reference_attention(q, torch.cat([k, pad], 2), torch.cat([v, pad], 2),
                                     scale=24 ** -0.5)
        with pytest.raises(RuntimeError, match="K1"):
            check(got)

