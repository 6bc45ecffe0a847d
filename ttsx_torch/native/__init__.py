"""Native (C) host loaders, the port's own copy of ``ttsx/native``.

* ``_ttsx_wavio``: ``read_wav(path, target_sr=0) -> (float32 [T], sr)``,
  a single-pass RIFF/WAVE decoder (parse, mono mix, normalize, linear
  resample straight into the output array; ``wavio.c``);
* ``_ttsx_prefetch``: ``Prefetcher(paths, labels, crop, batch,
  target_sr=0, workers=2, depth=4, seed=0)`` with ``next(timeout_ms)``,
  ``stats()`` and ``close()``, a pthreads pool that decodes, crops and
  batches wavs outside the GIL into a bounded ring (``prefetch.c``).

Both share the decode core ``wav_core.h``. Each builds at its first use,
never at import, with ``gcc -O3 -shared -fPIC -std=c11 -pthread``
(``$CC`` where set) against Python's and numpy's headers, into
``ttsx_torch/_build/native-<hash>/`` (the hash of the sources, the flags,
the interpreter's extension suffix, numpy's headers and version), and is
loaded from there by path; nothing is written beside the sources. ``load``
raises ``NativeBuildError`` with the compiler's error where the build
fails; ``try_load`` returns None there (the failure is kept, so a
process tries each build once).

    python -m ttsx_torch.native.build
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional, Union

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parent / "_build"
SOURCES = {"_ttsx_wavio": "wavio.c", "_ttsx_prefetch": "prefetch.c"}
HEADERS = ("wav_core.h",)
CFLAGS = ["-O3", "-shared", "-fPIC", "-std=c11", "-pthread"]

_lock = threading.Lock()
_loaded: Dict[str, Union[ModuleType, "NativeBuildError"]] = {}


class NativeBuildError(RuntimeError):
    """A native extension did not build or load; the message holds the
    compiler's error."""


def _includes():
    return [sysconfig.get_paths()["include"], np.get_include()]


def build_dir() -> Path:
    """``_build/native-<hash>``: the directory this tree's sources, flags,
    interpreter and numpy build into."""
    h = hashlib.sha256()
    for name in sorted(SOURCES.values()) + sorted(HEADERS):
        h.update(name.encode() + b"\0" + (HERE / name).read_bytes())
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h.update("\0".join(CFLAGS + _includes() + [ext, np.__version__])
             .encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def _library(name: str) -> Path:
    return build_dir() / (name + (sysconfig.get_config_var("EXT_SUFFIX")
                                  or ".so"))


def build(name: str) -> Path:
    """Compile extension ``name`` unless built; its path. Raises
    ``NativeBuildError`` with the compiler's stderr."""
    out = _library(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "gcc"), *CFLAGS,
           *(f"-I{d}" for d in _includes()), str(HERE / SOURCES[name]),
           "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{name}: {' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{name}: {' '.join(cmd)} exited "
                               f"{r.returncode}:\n{r.stderr}")
    os.replace(tmp, out)    # atomic: concurrent builders write the same file
    return out


def load(name: str) -> ModuleType:
    """Extension ``name``, built at its first use and loaded by path;
    raises ``NativeBuildError`` where it does not build or load."""
    with _lock:
        got = _loaded.get(name)
        if got is None:
            try:
                path = build(name)
                full = f"{__name__}.{name}"
                spec = importlib.util.spec_from_file_location(full, path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                sys.modules[full] = mod
                got = mod
            except NativeBuildError as e:
                got = e
            except ImportError as e:
                got = NativeBuildError(f"{name}: loading {path}: {e}")
            _loaded[name] = got
    if isinstance(got, NativeBuildError):
        raise got
    return got


def try_load(name: str) -> Optional[ModuleType]:
    """``load(name)``, or None where it does not build."""
    try:
        return load(name)
    except NativeBuildError:
        return None


def build_all() -> Dict[str, Path]:
    """Build every extension; their paths."""
    return {name: build(name) for name in SOURCES}
