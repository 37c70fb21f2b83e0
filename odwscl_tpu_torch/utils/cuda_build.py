"""Build a CUDA source of ``odwscl_tpu_torch/csrc`` into a shared library.

Plain ``nvcc`` for ``sm_90a`` into a library with a C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library is
built at first use into ``build/odwscl_tpu_torch/`` at the root of the
checkout, named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so a changed source is rebuilt and an unchanged one is
reused. A failed build raises: there is no fallback to the plain version.
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
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "odwscl_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "",
                   os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "odwscl_tpu_torch are built from source at first use")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source built and loaded on first ``get()``.

    ``bind`` declares the ctypes signatures once the library is loaded.
    ``compile_log`` holds the ptxas register/spill report of a build made
    in this process, if any.
    """

    def __init__(self, name: str, bind):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.compile_log = ""

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared includes
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {self.source.name} failed "
                               f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        self.compile_log = proc.stdout + proc.stderr
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
