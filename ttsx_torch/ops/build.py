"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points (device
pointers, sizes, the stream; they return ``cudaGetLastError()``) and is
compiled on its own into ``_build/<hash>/lib<name>.so``, keyed by the
hash of all sources (``*.cu`` and the ``*.cuh`` they include) and
flags, so a fresh checkout builds at first use and a second call in the
same tree reuses the libraries. All sources compile
in parallel, one nvcc process each. No PyTorch header is included, which
keeps a build to seconds. A failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of every entry point, by source file
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "upsample": {"ttsx_upsample_f32": [_P] * 4 + [_I] * 5 + [_P]},
    "resblock_stack": {
        "ttsx_resblock_stack_f32": [_P] * 7 + [_I] * 10 + [_P]},
    "mel_frontend": {"ttsx_mel_frontend_f32": [_P] * 7 + [_I] * 5 + [_P]},
    "s4_scan": {"ttsx_s4_scan_f32": [_P] * 5 + [_I] * 6 + [_P]},
    "resblock": {"ttsx_resblock_f32": [_P] * 8 + [_I] * 4 + [_P]},
    "conv1d_same": {"ttsx_conv1d_same_f32": [_P] * 4 + [_I] * 5 + [_P]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc_candidates():
    return [os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
            shutil.which("nvcc")]


def _nvcc() -> str:
    for cand in _nvcc_candidates():
        if cand and Path(cand).is_file():
            return cand
    raise KernelCompileError(
        "nvcc not found (looked at $NVCC, /usr/local/cuda/bin/nvcc, PATH): "
        "the CUDA kernels cannot be built on this machine")


def build_dir() -> Path:
    """``_build/<hash>`` beside the package, or under the temp directory
    when the checkout is not writable."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = BUILD_ROOT
    try:
        root.mkdir(parents=True, exist_ok=True)
    except OSError:
        root = Path(tempfile.gettempdir()) / "ttsx_torch_build"
    if not os.access(root, os.W_OK):
        root = Path(tempfile.gettempdir()) / "ttsx_torch_build"
    return root / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns name -> .so path.

    The ptxas report (registers, shared memory, spills) of each source is
    kept beside its library as ``<name>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    names = sorted(SIGNATURES)
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = out / f"lib{n}.so.tmp{os.getpid()}"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for n, (tmp, p) in procs.items():
            stdout, stderr = p.communicate()
            (out / f"{n}.log").write_text(stdout + stderr)
            if p.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu (rc {p.returncode}):\n"
                              f"{stderr}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out / f"lib{n}.so")
        if errors:
            raise KernelCompileError("\n".join(errors))
    return {n: out / f"lib{n}.so" for n in names}


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, smem, spills) of a built source."""
    log = build_dir() / f"{name}.log"
    if not log.exists():
        return ""
    return "\n".join(l for l in log.read_text().splitlines()
                     if "ptxas" in l or "spill" in l or "registers" in l)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def as_f32(*ts):
    """The kernels' operands in float32, as the reference kernels cast
    theirs: a bfloat16 or float16 tensor becomes its float32 copy (exact),
    any other passes as it is, for ``check_tensor`` to take or refuse
    (float64 is refused, never narrowed)."""
    return [t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
            for t in ts]


def check_tensor(t, ndim: int, name: str):
    """Shape of ``t`` after checking it is a contiguous f32 tensor of
    ``ndim`` dims, as the kernels take it."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return tuple(t.shape)
