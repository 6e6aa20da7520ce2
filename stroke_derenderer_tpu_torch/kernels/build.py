"""Build a CUDA source of ``csrc/`` into a shared library and load it.

One ``nvcc`` call per source into a library with a plain C interface,
loaded with ``ctypes``: it builds in seconds, where a source that includes
PyTorch's headers takes minutes, and it needs neither ``ninja`` nor
PyTorch's extension builder. The library goes to ``_build/`` beside the
package on first use and is rebuilt when the source, or a header it names
as a dependency, is newer. A file lock
taken with ``fcntl`` (released by the kernel when its holder dies, so a
stale lock file cannot block) keeps concurrent processes from building the
same library at once; waiting for it times out and raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "ptxas": str} for builds made by this process;
# "ptxas" is the compiler's -Xptxas -v report.
BUILD_LOG: dict[str, dict] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin)")


@contextlib.contextmanager
def _file_lock(path: Path, timeout: float):
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not lock {path} within {timeout:.0f} s")
                time.sleep(0.2)
        yield
    finally:
        os.close(fd)  # releases the lock


def _compile(src: Path, lib: Path, timeout: float) -> None:
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    # -Xptxas -v: registers, shared memory and spills of each kernel.
    ptxas = (proc.stdout + proc.stderr).strip()
    BUILD_LOG[src.stem] = {"seconds": seconds, "ptxas": ptxas}


def load_library(name: str, force: bool = False, timeout: float = 600.0,
                 deps: tuple = ()) -> ctypes.CDLL:
    """``csrc/<name>.cu`` -> loaded ``_build/lib<name>.so``. ``deps`` names
    headers in ``csrc/`` that the source includes: an edit to one rebuilds
    the library too. ``force`` rebuilds even when the library is up to
    date."""
    if name in _LIBS and not force:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{name}.so"
    BUILD.mkdir(exist_ok=True)
    deadline = time.monotonic() + timeout
    with _file_lock(BUILD / f"{name}.lock", timeout):
        newest = max((CSRC / n).stat().st_mtime for n in (src.name, *deps))
        if force or not lib.exists() or lib.stat().st_mtime < newest:
            _compile(src, lib, max(1.0, deadline - time.monotonic()))
    _LIBS[name] = ctypes.CDLL(str(lib))
    return _LIBS[name]
