"""Import hygiene and dispatch rules of the PyTorch port: no JAX, Triton,
YAML or image libraries at import, kernels built only on request with no
fallback, and no silent route from a kernel request to the twin."""

import ast
import contextlib
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from pctrans_torch.ops import _build
from pctrans_torch.ops.mask_stats import packed_mask_stats
from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
from pctrans_torch.ops.render import dynamic_mask_render
from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize
from pctrans_torch.ops.window_attn import window_attention

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "triton", "yaml")
# the dataset readers import these at their first read and the submission
# writer h5py when it writes, never at import
LAZY = ("PIL", "cv2", "h5py")
# the legacy zoo and the volume data: cv2, PIL and h5py inside functions only
ZOO_AND_VOLUME = tuple(f"pctrans_torch.{m}" for m in (
    "models.legacy.resnet_legacy", "models.legacy.repvgg", "models.legacy.botnet",
    "models.legacy.efficientnet", "models.legacy.fpn3d", "models.legacy.deeplab",
    "models.legacy.resunet", "models.legacy.discriminator", "data.seg_targets",
    "data.diffusion", "data.volume_io", "data.volume_augment", "data.volume_dataset"))
SCRIPTS = [REPO / "scripts" / "main_torch.py", REPO / "scripts" / "eval_torch.py",
           REPO / "scripts" / "scan_dataset_torch.py",
           REPO / "scripts" / "tools" / "compare_config_torch.py"]

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
before = set(sys.modules)
import pctrans_torch
for m in pkgutil.walk_packages(pctrans_torch.__path__, "pctrans_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, {str(REPO / "scripts")!r})
sys.path.insert(0, {str(REPO / "scripts" / "tools")!r})
import main_torch, eval_torch, scan_dataset_torch, compare_config_torch
added = set(sys.modules) - before
print(sum(m.startswith("pctrans_torch") for m in added),
      *sorted(m for m in added if m.split(".")[0] in {FORBIDDEN + LAZY!r}),
      *sorted(m for m in {ZOO_AND_VOLUME!r} if m not in added))
"""


def test_importing_every_module_loads_no_jax_triton_yaml_or_image_library():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    count, *forbidden = out.stdout.split()
    assert forbidden == []
    assert int(count) >= 53


def test_port_and_smoke_import_nothing_of_the_jax_package():
    """Neither chip_smoke.py, the port's scripts nor any port module
    names JAX, Triton, YAML or the JAX package ``pctrans_tpu`` in an import,
    at module level or inside a function (the card's machine has no JAX and
    no PyYAML), nor PIL, cv2 or h5py at module level."""
    files = [REPO / "chip_smoke.py", *SCRIPTS,
             *sorted((REPO / "pctrans_torch").rglob("*.py"))]
    banned = set(FORBIDDEN) | {"pctrans_tpu"}
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(f.name, n) for n in names if n.split(".")[0] in banned]
        for node in ast.parse(f.read_text()).body:      # module level
            if isinstance(node, ast.Import):
                found += [(f.name, a.name) for a in node.names
                          if a.name.split(".")[0] in LAZY]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[0] in LAZY:
                found.append((f.name, node.module))
    names = {".".join(f.relative_to(REPO).with_suffix("").parts) for f in files}
    assert set(ZOO_AND_VOLUME) <= names
    assert len(files) >= 59 and found == []


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_kernel_turns_without_cuda_fail_and_print_no_time():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "pctrans_torch.ops.time_kernels", str(REPO)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "ms device" not in out.stdout and "card:" not in out.stdout


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "lib.so")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    so = tmp_path / "out" / "lib.so"
    with pytest.raises(RuntimeError, match="no such target"):
        _build.build(so)
    assert not so.exists()


def test_library_name_follows_the_sources():
    name = _build.library_path().name
    assert name.startswith("libpctrans_kernels_") and name.endswith(".so")
    assert _build.library_path().parent == REPO / "build" / "pctrans_torch_kernels"


def _meta_calls():
    m = "meta"
    yield "ms_deform_attn", lambda impl: ms_deform_attn(
        torch.empty(1, 6, 2, 4, device=m), [(2, 3)],
        torch.empty(1, 5, 2, 1, 2, 2, device=m),
        torch.empty(1, 5, 2, 1, 2, device=m), impl=impl)
    yield "ms_deform_attn_backward", lambda impl: ms_deform_attn_backward(
        torch.empty(1, 6, 2, 4, device=m), [(2, 3)],
        torch.empty(1, 5, 2, 1, 2, 2, device=m),
        torch.empty(1, 5, 2, 1, 2, device=m), torch.empty(1, 5, 8, device=m),
        impl=impl)
    yield "dynamic_mask_render", lambda impl: dynamic_mask_render(
        torch.empty(1, 6, 4, device=m), torch.empty(1, 3, 2, device=m),
        torch.empty(1, 3, 8, 6, device=m), torch.empty(1, 3, 8, 8, device=m),
        torch.empty(1, 3, 1, 8, device=m), torch.empty(1, 3, 8, device=m),
        torch.empty(1, 3, 8, device=m), torch.empty(1, 3, 1, device=m),
        (2, 3), 4, True, impl=impl)
    yield "resize_bilinear_binarize", lambda impl: resize_bilinear_binarize(
        torch.empty(1, 2, 3, 3, device=m), (6, 6), 0.8, impl=impl)
    yield "window_attention", lambda impl: window_attention(
        torch.empty(4, 4, 96, dtype=torch.bfloat16, device=m), torch.empty(9, 1, device=m),
        1, 2, 2, 0, (2, 2), 0.1, impl=impl)
    yield "packed_mask_stats", lambda impl: packed_mask_stats(
        torch.empty(1, 2, 4, 4, dtype=torch.uint8, device=m), impl=impl)


@pytest.mark.parametrize("name,call", [pytest.param(n, c, id=n)
                                       for n, c in _meta_calls()])
def test_wrapper_on_a_non_cpu_device_raises_without_fallback(name, call):
    """A tensor that is not on the CPU asks for the kernel; with no CUDA
    device behind it the wrapper raises instead of running the twin (for
    ms-deform's backward too, which autograd reaches through K2's
    wrapper)."""
    with pytest.raises(RuntimeError, match=name):
        call(None)
    with pytest.raises(ValueError, match="impl"):
        call("kernel")


@pytest.mark.parametrize("name,call", [pytest.param(n, c, id=n)
                                       for n, c in _meta_calls()])
def test_wrapper_refuses_the_tpu_formulation_names(name, call):
    """``pallas`` (the JAX package's name for K5) selects nothing in a
    wrapper: K5 is reached only by calling ``ms_deform_attn_separable``."""
    with pytest.raises(ValueError, match=f"{name}: impl must be None or 'twin'"):
        call("pallas")


def _on(device: str):
    """A stand-in for a tensor on ``device``: the rule reads only its device,
    so a CUDA one needs no card."""
    return types.SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("device,impl,scope,expect", [
    ("cpu", None, False, "twin"),
    ("cpu", "twin", False, "twin"),
    ("cpu", None, True, "twin"),
    ("cpu", "twin", True, "twin"),
    ("meta", None, False, "raises"),
    ("meta", "twin", False, "twin"),
    ("meta", None, True, "twin"),
    ("meta", "twin", True, "twin"),
    ("cuda", None, False, "kernel"),
    ("cuda", "twin", False, "twin"),
    ("cuda", None, True, "twin"),
    ("cuda", "twin", True, "twin"),
])
def test_one_rule_picks_the_kernel_or_the_twin(device, impl, scope, expect):
    with _build.twins() if scope else contextlib.nullcontext():
        if expect == "raises":
            with pytest.raises(RuntimeError, match="op: no kernel for device meta"):
                _build.use_kernel(_on(device), impl, "op")
        else:
            assert _build.use_kernel(_on(device), impl, "op") == (expect == "kernel")


def test_twins_scope_ends_on_an_exception():
    with pytest.raises(KeyError):
        with _build.twins():
            assert _build.in_twins() and not _build.use_kernel(_on("cuda"), None, "op")
            raise KeyError("inside the scope")
    assert not _build.in_twins() and _build.use_kernel(_on("cuda"), None, "op")


def test_twins_scopes_nest():
    with _build.twins():
        with _build.twins():
            assert not _build.use_kernel(_on("cuda"), None, "op")
        assert _build.in_twins() and not _build.use_kernel(_on("cuda"), None, "op")
    assert not _build.in_twins() and _build.use_kernel(_on("cuda"), None, "op")


def test_twins_scope_reaches_only_its_own_thread():
    seen = []
    with _build.twins():
        other = threading.Thread(
            target=lambda: seen.append((_build.in_twins(),
                                        _build.use_kernel(_on("cuda"), None, "op"))))
        other.start()
        other.join()
        assert _build.in_twins()
    assert seen == [(False, True)]


def test_kernel_path_rejects_grad_and_foreign_devices():
    a = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        _build.check_inputs("op", a)
    with pytest.raises(RuntimeError, match="contiguous"):
        _build.check_inputs("op", torch.zeros(4, 4).t())
    with pytest.raises(RuntimeError, match="meta"):
        _build.check_inputs("op", torch.zeros(2), torch.zeros(2, device="meta"))
