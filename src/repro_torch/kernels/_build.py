"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds rather than minutes. Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is compiled at import time: the first launch builds, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together).

A lock serializes builds and loads within the process (the serving worker
thread and the main thread may both reach a first launch); the library is
written under a temporary name and moved into place, so concurrent processes
never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "repro_torch_kernels"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "flash_attention_short", "flash_attention_tc",
           "psgf_mix", "ssm_scan")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc") or (CUDA_NVCC if os.path.exists(CUDA_NVCC)
                                    else None)
    if path is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
            "the port's CUDA kernels are compiled at first use and need the "
            "CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by source and flags)."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) from the build of ``name``'s current library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """``-Xptxas -v`` output -> ``{entry function: {"registers", "stack_bytes",
    "spill_stores", "spill_loads"}}``, each line read for the entry function
    whose compilation it follows."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[entry].update(stack_bytes=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def _build_locked(names: Sequence[str]) -> Dict[str, str]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(logs[n])
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` whose library is missing, all at
    once. Returns ``{name: compiler output}`` for the sources it compiled."""
    with _LOCK:
        return _build_locked(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _build_locked((name,))
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
