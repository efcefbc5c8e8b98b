"""Guards of the PyTorch/CUDA port that need no card.

* The port and ``chip_smoke.py`` import neither JAX, flax nor the JAX package,
  and only ``chip_smoke.library_times`` calls PyTorch's own attention.
* Kernel wrappers take their plain versions only on CPU tensors (counters
  untouched); on any other device they launch or raise, with no fallback.
* A failed kernel build raises.
* The DiT is built on the card unless the CPU is asked for, and the ODE
  sampler defaults to dopri5, as the JAX package's does.
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

from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr
from lam_slide_tpu_torch.ops import fused_adaln as fad
from lam_slide_tpu_torch.ops import fused_mlp as fm
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.transport import Sampler, create_transport

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
    """PyTorch's attention is a yardstick only: no port module names it, and
    chip_smoke.py names it inside ``library_times`` alone."""
    for path in _port_sources()[:-1]:
        assert "scaled_dot_product_attention" not in path.read_text(), path
    text = (ROOT / "chip_smoke.py").read_text()
    (timer,) = [n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == "library_times"]
    inside = ast.get_source_segment(text, timer).count("scaled_dot_product_attention")
    assert inside >= 1 and text.count("scaled_dot_product_attention") == inside


WRAPPER_MODULES = [fa, fnr, fad, fm, fsb]


@pytest.mark.parametrize("module", WRAPPER_MODULES, ids=lambda m: m.__name__.split(".")[-1])
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


def _normrope_inputs(device):
    q, k, v = _attn_inputs(device)
    cos, sin = rope_cos_sin(130, 24, device=device)
    return q, k, v, torch.ones(24, device=device), torch.ones(24, device=device), cos, sin


def _adaln_inputs(device):
    x = torch.zeros(2, 5, 2, 32, dtype=torch.bfloat16, device=device)
    mods = torch.zeros(2, 1, 1, 96, dtype=torch.bfloat16, device=device).chunk(3, dim=-1)
    return (x, torch.zeros_like(x), *mods)


def _spatial_inputs(device):
    d, m, heads = 32, 64, 4
    bf = dict(dtype=torch.bfloat16, device=device)
    cos, sin = rope_cos_sin(2, d // heads, device=device)
    return (torch.zeros(3, 2, d, **bf), torch.zeros(3 * d + m, d, **bf),
            torch.zeros(3 * d + m, **bf), torch.ones(d // heads, device=device),
            torch.ones(d // heads, device=device), torch.zeros(d, d + m, **bf),
            torch.zeros(d, **bf), cos, sin, heads, 0.3)


# (name, wrapper, its plain version's name in the module, inputs)
WRAPPERS = [
    ("K1", fa.flash_attention, fa, "reference_attention", _attn_inputs),
    ("K3", lambda *a: fa.flash_attention_packed(*(t.transpose(1, 2).flatten(2) for t in a), 2),
     fa, "reference_attention_packed", _attn_inputs),
    ("K5", fnr.flash_attention_normrope, fnr, "reference_attention_normrope", _normrope_inputs),
    ("K2", fm.fused_mlp, fm, "reference_mlp", _mlp_inputs),
    ("K7", fad.residual_adaln_modulate, fad, "reference_residual_adaln_modulate", _adaln_inputs),
    ("K7 no residual", lambda x, h, g, s, c: fad.adaln_modulate(x, s, c), fad,
     "reference_adaln_modulate", _adaln_inputs),
    ("K8", fsb.fused_spatial_block, fsb, "reference_spatial_block", _spatial_inputs),
]


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_cpu_tensors_take_plain_versions_without_counting(monkeypatch, name, wrapper, module,
                                                          plain, inputs):
    for mod in WRAPPER_MODULES:
        monkeypatch.setattr(mod, "launches", 0)
    calls = []
    real = getattr(module, plain)
    monkeypatch.setattr(module, plain, lambda *a, **k: calls.append(1) or real(*a, **k))
    wrapper(*inputs("cpu"))
    assert calls, f"{name}: the CPU call did not take {plain}"
    assert all(mod.launches == 0 for mod in WRAPPER_MODULES)


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_non_cpu_tensors_raise_instead_of_falling_back(monkeypatch, name, wrapper, module,
                                                       plain, inputs):
    """A tensor that is not on the CPU never reaches a plain version: here
    (meta tensors, no card) the wrappers raise and count nothing."""
    for mod in WRAPPER_MODULES:
        monkeypatch.setattr(mod, "launches", 0)

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(module, plain, no_plain)
    with pytest.raises(ValueError):
        wrapper(*inputs("meta"))
    assert all(mod.launches == 0 for mod in WRAPPER_MODULES)


def test_dit_is_built_on_the_card_unless_the_cpu_is_asked_for():
    """Fault repaired: ``LatentDiT(device=None)`` used to build on the CPU, so
    a missing card ran the whole model there without a word."""
    kw = dict(depth=1, in_dim=4, hidden_size=32, num_heads=2)
    assert next(LatentDiT(**kw, device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert next(LatentDiT(**kw).parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            LatentDiT(**kw)


def test_sample_ode_defaults_to_dopri5():
    """Fault repaired: the port's ``sample_ode`` defaulted to euler where the
    JAX package's defaults to dopri5 (transport.py:273)."""
    sampler = Sampler(create_transport(path_type="GVP", prediction="data"))
    x0 = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))

    def model(x, t):
        return 0.5 * x

    default = sampler.sample_ode()(x0, model)
    torch.testing.assert_close(default, sampler.sample_ode(sampling_method="dopri5")(x0, model),
                               atol=0, rtol=0)
    assert not torch.allclose(default, sampler.sample_ode(sampling_method="euler")(x0, model))


def test_masks_are_refused():
    q, k, v = _attn_inputs("cpu")
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, mask=torch.ones(1, 130, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        fnr.flash_attention_normrope(*_normrope_inputs("cpu"),
                                     mask=torch.ones(1, 130, dtype=torch.bool))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_build_key_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"flash_attention.cu", "fused_mlp.cu", "fused_adaln.cu", "fused_spatial_block.cu",
            "common.cu", "common.cuh"} <= names
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

