"""Build and load the port's CUDA kernels (``pctrans_torch/csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together, and
one more ``nvcc`` call links the objects into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use,
never at import, into ``build/pctrans_torch_kernels/`` at the repository
root; the library's name carries a hash of the sources and flags, so an
edited source rebuilds.  A missing ``nvcc`` or a failed build raises
``RuntimeError``: there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pctrans_torch_kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_RESTYPES = {"pctrans_render_records_floats": ctypes.c_longlong}
_SIGNATURES = {
    # value, loc, weights, out, B, S, M, D, Lq, L, P, shapes (host int[2L]),
    # is_bf16, stream
    "pctrans_msdeform_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                             _I, _P],
    # K5, the separable form: value, loc, weights, out, part (f32 scratch or
    # NULL), B, S, M, D, Lq, L, P, shapes, plan (host int[]), smem bytes,
    # is_bf16, stream
    "pctrans_msdeform_sep_fwd": [_P] * 5 + [_I] * 7 + [_P, _P, _I, _I, _P],
    # value, loc, weights, grad, d_value, d_loc, d_weights, B, S, M, D, Lq,
    # L, P, shapes (host int[2L]), agg_mask, is_bf16, stream
    "pctrans_msdeform_bwd": [_P] * 7 + [_I] * 7 + [_P, _I, _I, _P],
    # feats, inst_xy, w1, w2, w3, b1, b2, b3, records (scratch), out, B, Q,
    # Hm, Wm, Cm, rel_coord, stride, stream
    "pctrans_render_fwd": [_P] * 10 + [_I] * 7 + [_P],
    # B, Q, Cm -> floats of K3's records scratch (long long)
    "pctrans_render_records_floats": [_I] * 3,
    # x, row_idx, row_w, col_idx, col_w, out, N, h, w, H, W, rows_per_tile,
    # logit_t, stream
    "pctrans_resize_binarize": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P],
}


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpctrans_kernels_{h.hexdigest()[:16]}.so"


def build(so: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "pctrans_torch kernels: nvcc not found (PATH, $CUDA_HOME, "
            "/usr/local/cuda); the CUDA kernels cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.name}.{os.getpid()}"
    tmp = so.with_name(f"{tag}.tmp")
    sources = _sources()
    objs = [so.with_name(f"{tag}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    outputs = [p.communicate() for p in procs]     # all compiles run at once
    results = [(p.returncode, out, err) for p, (out, err) in zip(procs, outputs)]
    log = "".join(f"== {src.name}\n{out}{err}" for src, (_, out, err)
                  in zip(sources, results))
    failed = [(rc, err) for rc, _, err in results if rc != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed = [(link.returncode, link.stderr)]
    so.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        rc, err = failed[0]
        raise RuntimeError(f"pctrans_torch kernels: nvcc failed ({rc}):\n"
                           f"{err[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial .so


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    so = library_path()
    if not so.exists():
        build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.pctrans_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pctrans_cuda_error_string.restype = ctypes.c_char_p
    return lib


def use_kernel(t: torch.Tensor, impl: Optional[str], op: str) -> bool:
    """Dispatch rule shared by the kernel wrappers.

    ``impl=None``: a CPU tensor takes the plain twin, a CUDA tensor the
    kernel; any other device raises.  ``impl="twin"`` runs the twin on any
    device (the kernel-vs-twin comparisons on the card).
    """
    if impl == "twin":
        return False
    if impl is not None:
        raise ValueError(f"{op}: impl must be None or 'twin', got {impl!r}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{op}: no kernel for device {t.device}")
    return True


def check_inputs(op: str, *tensors: torch.Tensor) -> None:
    """A raw launch takes contiguous CUDA tensors on one device, none of
    which needs grad: autograd reaches the kernels only through
    ``msdeform.MSDeformAttnFunction``, which passes detached tensors."""
    dev = tensors[0].device
    for t in tensors:
        if t.requires_grad:
            raise RuntimeError(f"{op}: a raw kernel launch is forward-only "
                               "for autograd; an input requires grad")
        if t.device != dev:
            raise RuntimeError(f"{op}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise RuntimeError(f"{op}: inputs must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, op: str) -> None:
    if rc != 0:
        msg = lib.pctrans_cuda_error_string(rc).decode()
        raise RuntimeError(f"{op}: CUDA error {rc} at launch: {msg}")


def compare_build_times() -> None:
    """Time :func:`build` from nothing beside one ``nvcc`` call that
    compiles and links every source in turn, twice each (parallel, single,
    single, parallel), into a temporary directory."""
    import tempfile
    import time

    BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in _sources()]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent) as tmp:
        for i, form in enumerate(("parallel", "single", "single", "parallel")):
            so = Path(tmp) / f"{form}{i}.so"
            t0 = time.perf_counter()
            if form == "parallel":
                build(so)
            else:
                subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                                *sources], check=True, capture_output=True)
            print(f"{form:8s} build of {len(sources)} sources: "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)


if __name__ == "__main__":
    compare_build_times()       # python -m pctrans_torch.ops._build
