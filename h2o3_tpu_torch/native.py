"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes its kernels through a plain C interface.
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so`` and loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds.  The hash of the source,
of every header it includes with ``#include "..."`` (the kernels share
``csrc/hist_common.cuh``) and of the flags names the library, so an
edited source or header rebuilds and a stale library is never loaded.
A failed build raises: there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# no --use_fast_math: the kernels compare floats and route NaNs exactly
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(source: str) -> List[str]:
    """``source`` and every header it includes with ``#include "..."``,
    transitively (resolved beside the including file), in include order;
    the files whose bytes decide the built library."""
    files: List[str] = []

    def visit(path: str) -> None:
        path = os.path.normpath(path)
        if path in files:
            return
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _LOCAL_INCLUDE.findall(text):
            visit(os.path.join(os.path.dirname(path), name.decode()))

    visit(source)
    return files


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "CUDA kernels of h2o3_tpu_torch cannot be built")
    return path


class Kernel:
    """One CUDA source: its built library and a count of launches.

    ``signatures`` maps each exported C function to ``(argtypes,
    restype)``.  The wrapper that launches a kernel calls ``count()``
    once per launch, so a run can show that its path went through it.
    """

    def __init__(self, name: str,
                 signatures: Dict[str, Tuple[Sequence, object]]):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def count(self) -> None:
        with self._lock:
            self.launches += 1

    def _lib_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in source_files(self.source):
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _start_build(self):
        """Start nvcc unless the library is built; returns the pending
        ``(process, tmp_path, lib_path)`` or None."""
        path = self._lib_path()
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path

    def _finish_build(self, pending) -> None:
        proc, tmp, path = pending
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, path)          # atomic against a concurrent build

    def _load(self) -> ctypes.CDLL:
        lib = ctypes.CDLL(self._lib_path())
        for fn, (argtypes, restype) in self.signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = restype
        return lib

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built at first use."""
        with self._lock:
            if self._lib is None:
                pending = self._start_build()
                if pending is not None:
                    self._finish_build(pending)
                self._lib = self._load()
            return self._lib


def build_all(kernels: Iterable[Kernel]) -> None:
    """Build every kernel's library at once: one nvcc per source, all
    started together, then load each.  A failed build stops the others
    and raises."""
    kernels = list(kernels)
    with contextlib.ExitStack() as stack:
        for k in kernels:
            stack.enter_context(k._lock)
        todo = [k for k in kernels if k._lib is None]
        pending = []
        try:
            for k in todo:
                pending.append((k, k._start_build()))
            for k, p in pending:
                if p is not None:
                    k._finish_build(p)
        finally:
            for _, p in pending:
                if p is not None and p[0].poll() is None:
                    p[0].kill()
                    p[0].wait()
        for k in todo:
            k._lib = k._load()
