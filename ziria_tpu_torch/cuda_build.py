"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ctypes. The
library's file name carries a hash of its source, so an edited source
is rebuilt and an unchanged one is reused. Builds happen at first use
(or all at once, in parallel, through :func:`build_all`) into
``csrc/build/``, which git ignores. There is no fallback: without
``nvcc`` the build raises. Each nvcc run is the port's only compile: it
reports itself to ``utils/telemetry`` as a ``compile`` event named
``nvcc:<source>`` with its seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

from ziria_tpu_torch.utils import telemetry

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = {"viterbi": "viterbi.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=None) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns {name: {"path", "seconds", "log"}};
    raises RuntimeError naming the source if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = None
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            jobs[name] = (out, None, None)
            continue
        exe = exe or nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (out, tmp, proc)
    info = {}
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        if proc is None:
            info[name] = {"path": out, "seconds": 0.0, "log": "cached"}
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"path": out, "seconds": time.perf_counter() - t0,
                      "log": log}
        telemetry.record_compile(
            f"nvcc:{SOURCES[name]}", seconds=info[name]["seconds"],
            args={"library": os.path.basename(out)})
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
