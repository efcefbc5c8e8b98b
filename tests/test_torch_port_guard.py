"""Guards of the PyTorch/CUDA port that need no card.

* The port (every package of it, parallel/ included) and ``chip_smoke.py``
  import neither JAX, flax nor the JAX package, and only
  ``chip_smoke.library_times`` calls PyTorch's own attention.
* Kernel wrappers take their plain versions only on CPU tensors (counters
  untouched); on any other device they launch or raise, with no fallback,
  and inputs that need a gradient go through a ``torch.autograd.Function``
  (the kernels write through raw pointers, which autograd cannot see).
* A masked or fp32 flash call (K1) that needs a gradient reaches the
  autograd Function whose backward is K4 with the bias and fp32 operands,
  and so do fp32 calls at dh 128 (K1, K3, K5), of K8 and of K9; fp32
  operands wider than K4-fp32 takes (dh > 128) raise with a gradient before
  anything launches.
* K10 (fused temporal attention) and K11 (the short grouped backward) are
  wrappers like the others.
* A failed kernel build raises.
* The DiT, both MD17 stages and the registry's MD17 runs are built on the
  card unless the CPU is asked for, and the ODE sampler defaults to dopri5,
  as the JAX package's does.
* ``chip_smoke.py`` fails without a GPU and prints no result, and its K1
  limits refuse a kernel that leaves the last key tile unmasked.
"""

import ast
import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lam_slide_tpu_torch.composites import md17 as tmd17
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr
from lam_slide_tpu_torch.ops import fused_adaln as fad
from lam_slide_tpu_torch.ops import fused_mlp as fm
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft
from lam_slide_tpu_torch.ops.ablations import short_backward as tsb
from lam_slide_tpu_torch.transport import Sampler, create_transport

# the module (the package's ``ring_attention`` name is its function)
tring = importlib.import_module("lam_slide_tpu_torch.parallel.ring_attention")

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


def test_guard_covers_every_port_package():
    """The import guard walks every module of the port, parallel/ included."""
    covered = {p.relative_to(PORT).parts[0] for p in _port_sources()[:-1]}
    packages = {p.name for p in PORT.iterdir() if (p / "__init__.py").exists()}
    assert "parallel" in packages and packages <= covered


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


WRAPPER_MODULES = [fa, fnr, fad, fm, fsb, tsa, tft, tsb]
COUNTERS = ("launches", "bias_launches", "fp32_launches", "bwd_kv_launches", "bwd_q_launches",
            "bwd_bias_launches", "bwd_fp32_launches", "bwd_launches", "transform_launches",
            "sm90_launches", "sm90_cp_async_launches", "bwd_sm90_launches",
            "bwd_sm90_cp_async_launches", "fp32_wide_launches", "bwd_fp32_wide_launches",
            "f32_launches", "fp32_narrow_launches", "f32_tiled_launches", "f32_dot_launches",
            "tp_partial_launches")


def _zero_counters(monkeypatch):
    for mod in WRAPPER_MODULES:
        for name in COUNTERS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, 0)


def _counts():
    return [getattr(mod, name) for mod in WRAPPER_MODULES for name in COUNTERS
            if hasattr(mod, name)]


@pytest.mark.parametrize("module", WRAPPER_MODULES, ids=lambda m: m.__name__.split(".")[-1])
def test_wrappers_have_no_try(module):
    tree = ast.parse(Path(module.__file__).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _attn_inputs(device):
    return [torch.zeros(1, 2, 130, 24, dtype=torch.bfloat16, device=device) for _ in range(3)]


def _masked_attn_inputs(device):
    mask = torch.ones(1, 130, dtype=torch.bool, device=device)
    mask[:, 100:] = False
    return (*_attn_inputs(device), mask)


def _fp32_attn_inputs(device):
    return [t.float() for t in _attn_inputs(device)]


def _fp32_wide_attn_inputs(device, dh=128):
    return [torch.zeros(1, 2, 130, dh, device=device) for _ in range(3)]


def _fp32_normrope_inputs(device, dh=128):
    q, k, v = _fp32_wide_attn_inputs(device, dh)
    cos, sin = rope_cos_sin(130, dh, device=device)
    return q, k, v, torch.ones(dh, device=device), torch.ones(dh, device=device), cos, sin


def _fp32_wide_backward_inputs(device, dh=128):
    q, k, v = _fp32_wide_attn_inputs(device, dh)
    return q, k, v, torch.zeros_like(q), torch.zeros(1, 2, 130, device=device), \
        torch.zeros_like(q), 0.2


TOO_WIDE = 136  # past every kernel's dh <= 128


def _short_inputs(device):
    return [torch.zeros(1, 30, 48, dtype=torch.bfloat16, device=device) for _ in range(3)]


def _short_backward_inputs(device):
    return (*_short_inputs(device), torch.zeros(1, 30, 48, dtype=torch.bfloat16, device=device),
            2, 0.2)


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


def _backward_inputs(device):
    q, k, v = _attn_inputs(device)
    lse = torch.zeros(1, 2, 130, device=device)
    return q, k, v, torch.zeros_like(q), lse, torch.zeros_like(q), 0.2


def _masked_backward_inputs(device):
    return (*_backward_inputs(device), _masked_attn_inputs(device)[-1])


def _fp32_backward_inputs(device):
    return [t.float() if isinstance(t, torch.Tensor) else t for t in _backward_inputs(device)]


def _normrope_backward_inputs(device):
    q, k, v, out, lse, g, scale = _backward_inputs(device)
    return (q, k, v, *_normrope_inputs(device)[3:], out, lse, g, scale)


def _fused_temporal_inputs(device):
    q, k, v = (t.transpose(1, 2).flatten(2) for t in _attn_inputs(device))  # [1, 130, 48]
    cos, sin = rope_cos_sin(130, 24, device=device)
    cos_l, sin_l = (t.repeat_interleave(2, -1).repeat(1, 2) for t in (cos, sin))
    return (q, k, v, cos_l, sin_l, torch.ones(1, 48, device=device),
            torch.ones(1, 48, device=device), 2, 0.2)


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
    ("K9", lambda q, k, v: tsa.short_attention(q, k, v, 2), tsa, "reference_short_attention",
     _short_inputs),
    ("K1 masked", lambda q, k, v, m: fa.flash_attention(q, k, v, mask=m), fa,
     "reference_attention", _masked_attn_inputs),
    ("K1 fp32", fa.flash_attention, fa, "reference_attention", _fp32_attn_inputs),
    ("K10", tft.fused_temporal_attention, tft, "reference_fused_temporal",
     _fused_temporal_inputs),
]
BACKWARD_WRAPPERS = [
    ("K4", fa.flash_attention_backward, fa, "reference_flash_backward", _backward_inputs),
    ("K4 masked", lambda *a: fa.flash_attention_backward(*a[:-1], mask=a[-1]), fa,
     "reference_flash_backward", _masked_backward_inputs),
    ("K4 fp32", fa.flash_attention_backward, fa, "reference_flash_backward",
     _fp32_backward_inputs),
    ("K6", fnr.flash_attention_normrope_backward, fnr, "reference_normrope_backward",
     _normrope_backward_inputs),
    ("K5 transform", lambda q, k, v, qs, ks, cos, sin: fnr.qk_normrope(q, k, qs, ks, cos, sin),
     fnr, "pre_transform", _normrope_inputs),
    ("K9 backward", tsa.short_attention_backward, tsa, "reference_short_backward",
     _short_backward_inputs),
    ("K11", tsb.flash_backward_short, tsb, "reference_flash_backward_short", _backward_inputs),
    ("K11 fp32", tsb.flash_backward_short, tsb, "reference_flash_backward_short",
     _fp32_backward_inputs),
]
# fp32 at dh 128 (K4's register-tiled pair, K6 in fp32) and the fp32 K8 and
# K9: with a gradient, through their autograd Functions
# (test_fp32_calls_that_need_a_grad_reach_an_autograd_function)
FP32_WITH_GRAD = [
    ("K1 fp32 dh128", fa.flash_attention, fa, "reference_attention", _fp32_wide_attn_inputs),
    ("K3 fp32 dh128",
     lambda *a: fa.flash_attention_packed(*(t.transpose(1, 2).flatten(2) for t in a), 2),
     fa, "reference_attention_packed", _fp32_wide_attn_inputs),
    ("K5 fp32", fnr.flash_attention_normrope, fnr, "reference_attention_normrope",
     _fp32_normrope_inputs),
    ("K8 fp32", fsb.fused_spatial_block, fsb, "reference_spatial_block",
     lambda device: [t.float() if isinstance(t, torch.Tensor) else t
                     for t in _spatial_inputs(device)]),
    ("K9 fp32", lambda q, k, v: tsa.short_attention(q, k, v, 2), tsa,
     "reference_short_attention", lambda device: [t.float() for t in _short_inputs(device)]),
]
# fp32 wider than every kernel takes: with a gradient they raise
# (test_fp32_calls_that_need_a_grad_raise_before_any_launch)
FP32_TOO_WIDE = [
    ("K1 fp32 dh136", fa.flash_attention, fa, "reference_attention",
     lambda device: _fp32_wide_attn_inputs(device, TOO_WIDE)),
    ("K3 fp32 dh136",
     lambda *a: fa.flash_attention_packed(*(t.transpose(1, 2).flatten(2) for t in a), 2),
     fa, "reference_attention_packed", lambda device: _fp32_wide_attn_inputs(device, TOO_WIDE)),
    ("K5 fp32 dh136", fnr.flash_attention_normrope, fnr, "reference_attention_normrope",
     lambda device: _fp32_normrope_inputs(device, TOO_WIDE)),
]
ALL_WRAPPERS = WRAPPERS + BACKWARD_WRAPPERS + FP32_WITH_GRAD + [
    ("K5 transform fp32",
     lambda q, k, v, qs, ks, cos, sin: fnr.qk_normrope(q, k, qs, ks, cos, sin),
     fnr, "pre_transform", _fp32_normrope_inputs),
    ("K4 fp32 dh128", fa.flash_attention_backward, fa, "reference_flash_backward",
     _fp32_wide_backward_inputs),
    ("K1 lse", fa.flash_attention_with_lse, fa, "reference_attention", _attn_inputs),
    ("ring", lambda q, k, v: tring.ring_attention_chunks(q.chunk(2, 2), k.chunk(2, 2),
                                                         v.chunk(2, 2)),
     tring, "_chunk_stats", _attn_inputs),
]


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", ALL_WRAPPERS,
                         ids=[w[0] for w in ALL_WRAPPERS])
def test_cpu_tensors_take_plain_versions_without_counting(monkeypatch, name, wrapper, module,
                                                          plain, inputs):
    _zero_counters(monkeypatch)
    calls = []
    real = getattr(module, plain)
    monkeypatch.setattr(module, plain, lambda *a, **k: calls.append(1) or real(*a, **k))
    wrapper(*inputs("cpu"))
    assert calls, f"{name}: the CPU call did not take {plain}"
    assert not any(_counts())


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", ALL_WRAPPERS,
                         ids=[w[0] for w in ALL_WRAPPERS])
def test_non_cpu_tensors_raise_instead_of_falling_back(monkeypatch, name, wrapper, module,
                                                       plain, inputs):
    """A tensor that is not on the CPU never reaches a plain version: here
    (meta tensors, no card) the wrappers raise and count nothing."""
    _zero_counters(monkeypatch)

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(module, plain, no_plain)
    with pytest.raises(ValueError):
        wrapper(*inputs("meta"))
    assert not any(_counts())


class _ReachedFunction(Exception):
    pass


@pytest.mark.parametrize("grad", [True, False], ids=["needs_grad", "no_grad"])
@pytest.mark.parametrize("name,wrapper,module,plain,inputs", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_non_cpu_tensors_that_need_a_grad_reach_an_autograd_function(
        monkeypatch, name, wrapper, module, plain, inputs, grad):
    """Fault repaired: every CUDA wrapper wrote its output through ctypes into
    a fresh tensor with no ``grad_fn``, so a DiT on the card under autograd
    trained silently wrong (no grad reached linear1's q/k/v columns, the
    QK-norm scales, the MLP weights, the spatial blocks or the residual
    stream through the kernels). Now a non-CPU input that needs a gradient
    reaches a ``torch.autograd.Function`` of the wrapper's module; without a
    gradient (the sampler, under no_grad) the wrapper launches directly."""
    reached = []

    def apply(cls, *args, **kwargs):
        reached.append(cls)
        raise _ReachedFunction

    monkeypatch.setattr(torch.autograd.Function, "apply", classmethod(apply))
    args = [t.requires_grad_() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
            for t in inputs("meta")]
    with torch.set_grad_enabled(grad), pytest.raises(_ReachedFunction if grad else ValueError):
        wrapper(*args)
    if grad:
        (cls,) = reached
        assert issubclass(cls, torch.autograd.Function) and cls.__module__ == module.__name__
    else:
        assert not reached


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", FP32_WITH_GRAD,
                         ids=[w[0] for w in FP32_WITH_GRAD])
def test_fp32_calls_that_need_a_grad_reach_an_autograd_function(monkeypatch, name, wrapper,
                                                                module, plain, inputs):
    """fp32 training on the card: K4's fp32 pair takes dh up to 128 (its
    register-tiled pair above 64), K6 runs on it in fp32, K8-fp32 runs under
    ``_SpatialBlock`` and K9 has an fp32 backward. A non-CPU fp32 call that
    needs a gradient reaches its module's autograd Function, launching
    nothing before it."""
    _zero_counters(monkeypatch)
    reached = []

    def apply(cls, *args, **kwargs):
        reached.append(cls)
        raise _ReachedFunction

    monkeypatch.setattr(torch.autograd.Function, "apply", classmethod(apply))
    args = [t.requires_grad_() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
            for t in inputs("meta")]
    with pytest.raises(_ReachedFunction):
        wrapper(*args)
    (cls,) = reached
    assert cls.__module__ == module.__name__ and not any(_counts())


@pytest.mark.parametrize("name,wrapper,module,plain,inputs", FP32_TOO_WIDE,
                         ids=[w[0] for w in FP32_TOO_WIDE])
def test_fp32_calls_that_need_a_grad_raise_before_any_launch(monkeypatch, name, wrapper, module,
                                                             plain, inputs):
    """fp32 above dh 128 has no kernel, forward or backward (K4-fp32 stops
    at dh 128). A non-CPU fp32 call that needs a gradient raises, naming the
    missing backward, before its forward launches and without reaching an
    autograd Function; so does K4-fp32 itself at that width."""
    _zero_counters(monkeypatch)
    reached = []
    monkeypatch.setattr(torch.autograd.Function, "apply",
                        classmethod(lambda cls, *a, **k: reached.append(cls)))
    args = [t.requires_grad_() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
            for t in inputs("meta")]
    with pytest.raises(ValueError, match="backward"):
        wrapper(*args)
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention_backward(*_fp32_wide_backward_inputs("meta", TOO_WIDE))
    assert not reached and not any(_counts())


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


def test_md17_stages_are_built_on_the_card_unless_the_cpu_is_asked_for():
    cfg1 = tmd17.MD17FirstStageConfig(num_entities=6, dim_input=8, dim_latent=4, dim_entity=8,
                                      num_latents=3, dim_head_cross=2, dim_head_latent=2)
    cfg2 = tmd17.MD17SecondStageConfig(depth=1, in_dim=4, hidden_size=8, num_heads=2,
                                       class_conditional=True, vec_in_dim=8)
    fs = tmd17.build_md17_first_stage(cfg1, device="cpu")
    assert {p.device.type for p in [*fs.parameters(), *fs.buffers()]} == {"cpu"}
    ss = tmd17.build_md17_second_stage(cfg2, fs, device="cpu")
    assert {p.device.type for p in ss.backbone.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        assert next(tmd17.build_md17_first_stage(cfg1).parameters()).is_cuda
        assert next(tmd17.build_md17_second_stage(cfg2, fs).backbone.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tmd17.build_md17_first_stage(cfg1)
        with pytest.raises((AssertionError, RuntimeError)):
            tmd17.build_md17_second_stage(cfg2, fs)


def test_md17_runs_are_built_on_the_card_unless_the_cpu_is_asked_for():
    run = treg.md17_first_stage(smoke=True, device="cpu")
    assert {p.device.type for p in run.model.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        assert next(treg.md17_first_stage(smoke=True).model.parameters()).is_cuda
        assert next(treg.md17_second_stage(first_stage=run, smoke=True)
                    .model.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            treg.md17_first_stage(smoke=True)
        with pytest.raises((AssertionError, RuntimeError)):
            treg.md17_second_stage(first_stage=run, smoke=True)


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


@pytest.mark.parametrize("method", ["dopri5", "euler", "heun"])
def test_sampling_records_no_autograd_graph(method):
    """A solve outside ``torch.no_grad()`` builds no graph through a model
    whose parameters need grads: the eval protocol never differentiates a
    solve, so on the card the kernels launch without their autograd
    Functions (no lse, no saved inputs per drift evaluation)."""
    w = torch.nn.Parameter(torch.tensor(0.5))
    sampler = Sampler(create_transport(path_type="GVP", prediction="data"))
    x0 = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    out = sampler.sample_ode(sampling_method=method, num_steps=5)(x0, lambda x, t: w * x)
    assert out.grad_fn is None and not out.requires_grad


def test_masks_are_refused(monkeypatch):
    """K1 takes a key-padding mask; K5 with one takes JAX's fallback
    (flash_normrope.py:496-498), the plain pre-transform then K1's entry
    with the mask, counting no K5 launch; the packed entries (K3, K9) take
    none, as in JAX."""
    _zero_counters(monkeypatch)
    q, k, v, qs, ks, cos, sin = (t.normal_() if t.dim() == 4 else t
                                 for t in _normrope_inputs("cpu"))
    mask = torch.arange(130)[None] < 97
    calls = []
    real = fnr.flash_attention
    monkeypatch.setattr(fnr, "flash_attention",
                        lambda *a, **kw: calls.append(kw["mask"]) or real(*a, **kw))
    got = fnr.flash_attention_normrope(q, k, v, qs, ks, cos, sin, mask=mask)
    assert len(calls) == 1 and calls[0] is mask and not any(_counts())
    want = fa.reference_attention(*fnr.pre_transform(q, k, qs, ks, cos, sin), v, mask=mask)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for entry in (fa.flash_attention_packed, tsa.short_attention):
        assert "mask" not in inspect.signature(entry).parameters


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_build_key_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"flash_attention.cu", "flash_attention_bwd.cu", "flash_tiles.cuh", "fused_mlp.cu",
            "fused_adaln.cu", "fused_spatial_block.cu", "short_attention.cu", "common.cu",
            "common.cuh", "short_backward.cu"} <= names
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

