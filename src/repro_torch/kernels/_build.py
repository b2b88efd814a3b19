"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
its own into ``build/repro_torch/<name>-<hash>.so`` for ``sm_90a``.  The
hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so a changed source or header rebuilds and an unchanged one is
reused.  The build runs at first use: the first
kernel launch (or ``build_all()``, which ``chip_smoke.py`` times) starts
one ``nvcc`` per source, all at once, and waits for them.  Nothing is
downloaded; the sources are the ones in this checkout.

The wrappers pass pointers (``tensor.data_ptr()``) and PyTorch's current
stream (``torch.cuda.current_stream().cuda_stream``) as ``c_void_p``.
Each C entry point returns the ``cudaError_t`` of its launch, and the
wrapper raises if it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

SOURCES = ("aes_ecb", "crc32", "dpi_mlp", "preproc", "reduce", "fused_chain",
           "fused_epoch")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def target(name: str) -> Path:
    """The shared library ``name`` builds into (content-addressed: the
    source, the headers it may include, the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    ``<lib>.log`` beside each library keeps ptxas's register and
    shared-memory report.  Raises with nvcc's output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: target(name) for name in SOURCES}
    procs = {}
    for name, so in out.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building everything first
    if it is not built yet."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        lib = ctypes.CDLL(str(paths[name]))
        lib.balboa_error_string.argtypes = [ctypes.c_int]
        lib.balboa_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.balboa_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} "
                           f"({msg})")
