"""Build and load the port's CUDA libraries: one ``nvcc`` call per library,
at first use, into ``tpufwi_torch/_build`` (git-ignored), keyed by a hash of
the sources, the headers and the flags. The libraries have a plain C
interface and are called through ctypes, so neither this module's import
nor the kernels' plain versions need CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


class Library:
    """One shared library built from ``sources`` (which include
    ``headers``); ``declare(lib)`` sets the ctypes signatures.
    ``build_seconds`` is the wall time of this process's nvcc call (None if
    the library was already built); ``log`` the path of its nvcc output,
    ``path`` that of the library once loaded."""

    def __init__(self, stem: str, sources: Sequence[Path], headers: Sequence[Path],
                 declare: Callable[[ctypes.CDLL], None]):
        self.stem = stem
        self.sources = tuple(sources)
        self.headers = tuple(headers)
        self.declare = declare
        self.build_seconds = None
        self.log = None
        self.path = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
            for path in self.sources + self.headers:
                digest.update(path.read_bytes())
            tag = digest.hexdigest()[:12]
            so = BUILD_DIR / f"lib{self.stem}_{tag}.so"
            self.log = BUILD_DIR / f"build_{self.stem}_{tag}.log"
            self.path = so
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                res = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, self.sources)],
                    capture_output=True, text=True,
                )
                self.build_seconds = time.perf_counter() - t0
                self.log.write_text(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self.declare(lib)
            self._lib = lib
            return lib


def declare_all(lib, sigs):
    """Set ``argtypes`` (pointers..., ints..., host taps, stream) and an int
    return code for each ``name: (n_ptr, n_int)``, and the error string."""
    P, I = ctypes.c_void_p, ctypes.c_int
    F = ctypes.POINTER(ctypes.c_float)
    for name, (n_ptr, n_int) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = [P] * n_ptr + [I] * n_int + [F, P]
        fn.restype = I
    lib.tpufwi_error_string.argtypes = [I]
    lib.tpufwi_error_string.restype = ctypes.c_char_p


def raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.tpufwi_error_string(err).decode()}")
