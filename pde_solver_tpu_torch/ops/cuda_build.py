"""Build the port's CUDA sources into shared libraries, bound with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at first use.  The
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source or header builds anew.
:func:`build` starts one ``nvcc`` per source that still needs it, all at
once, and waits for them together; each build goes to a temporary name and
is renamed into place, so concurrent builders never load a half-written
file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per source name: {"path": .so, "seconds": build wall time (0 when the .so
# already existed), "log": nvcc's output, ptxas report included}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _so_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> None:
    """Compile every named source whose library is missing, in parallel."""
    running = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            BUILD_INFO.setdefault(name, {"path": str(so), "seconds": 0.0,
                                         "log": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = {"path": str(so),
                            "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def defined_list(name: str, macro: str) -> Tuple[int, ...]:
    """The integers of a ``#define <macro> 1, 2, 3`` line of
    ``csrc/<name>.cu``: what that source is built for, listed once."""
    src = (CSRC / f"{name}.cu").read_text()
    m = re.search(rf"^#define {macro} ([0-9, ]+)$", src, re.M)
    return tuple(int(v) for v in m.group(1).split(","))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(BUILD_INFO[name]["path"])
        _LIBS[name] = lib
    return lib
