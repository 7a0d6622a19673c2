"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded through :mod:`ctypes` with
explicit ``argtypes``.  The libraries land in ``build/repro_torch/<key>/``
at the root of the checkout, where ``<key>`` hashes the sources, the shared
headers and the flags, so an edited source rebuilds and an unchanged one
loads at once.  All sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import: the first kernel launch (or
:func:`build_all`) builds.  A failed build raises with the compiler's
output; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "KERNELS", "BuildError", "build_all", "build_dir", "library", "ptxas_entries", "source_key",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C entry point and argtypes of each kernel library (see csrc/<name>.cu).
KERNELS: dict[str, tuple[str, list]] = {
    "gram": ("repro_gram", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "fused_apply_gram": (
        "repro_fused_apply_gram", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "apply_right": ("repro_apply_right", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "trailing_update": (
        "repro_trailing_update",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _P],
    ),
    "panel_cross": ("repro_panel_cross", [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I, _P]),
    "pad_cross": (
        "repro_pad_cross", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    ),
    "combine_gram": ("repro_combine_gram", [_P, _P, _P, _I, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes._CFuncPtr] = {}


class BuildError(RuntimeError):
    """A kernel library could not be compiled or loaded."""


def source_key() -> str:
    """Hash of every kernel source, shared header and compiler flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _ROOT / "build" / "repro_torch" / source_key()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise BuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the Hopper kernels "
        "are built from src/repro_torch/csrc at first use and need the CUDA "
        "toolkit; CPU tensors take the plain PyTorch versions instead"
    )


def _compile(names: list[str], out: Path) -> None:
    """Run one nvcc per source, all at once; raise on the first failure."""
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"lib{name}.so")
        else:
            failed.append(f"{name}.cu (exit {rc}):\n{(out / f'{name}.log').read_text()}")
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))


def build_all() -> dict[str, ctypes._CFuncPtr]:
    """Build (if needed) and load every kernel library; returns the C entry
    points by kernel name."""
    with _LOCK:
        missing = [n for n in KERNELS if n not in _LOADED]
        if not missing:
            return dict(_LOADED)
        out = build_dir()
        to_build = [n for n in missing if not (out / f"lib{n}.so").is_file()]
        if to_build:
            _compile(to_build, out)
        for name in missing:
            symbol, argtypes = KERNELS[name]
            try:
                fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
            except OSError as exc:
                raise BuildError(f"cannot load lib{name}.so from {out}: {exc}") from exc
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LOADED[name] = fn
        return dict(_LOADED)


def library(name: str) -> ctypes._CFuncPtr:
    """The C entry point of one kernel, building every kernel at first use."""
    fn = _LOADED.get(name)
    return fn if fn is not None else build_all()[name]


def ptxas_entries(name: str) -> dict[str, str]:
    """``ptxas -v``'s report of each kernel entry of one built library:
    the mangled entry name -> its spill line and its register line."""
    log = build_dir() / f"{name}.log"
    entries: dict[str, list[str]] = {}
    entry = None
    for line in log.read_text().splitlines() if log.is_file() else ():
        if "Compiling entry function '" in line:
            entry = line.split("'")[1]
            entries[entry] = []
        elif entry and ("spill" in line or "Used " in line):
            entries[entry].append(line.split(":")[-1].strip())
    return {k: "; ".join(v) for k, v in entries.items()}
