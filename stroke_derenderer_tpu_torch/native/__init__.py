"""Host C++ of the port, copies of the JAX package's ``native/``: the
union-find connected components (``cc.cpp``, :mod:`.cc_native`) and the
uint8 bilinear resize (``resize.cpp``, :mod:`.resize_native`), called
through ``ctypes``, which releases the GIL for the call.

Each source is built with ``g++`` at first use into the package's
``_build/`` (beside the CUDA kernels' libraries) and rebuilt when the
source is newer; a file lock keeps concurrent processes from building one
library at once. A failed build raises with the compiler's output: nothing
falls back to scipy or numpy unless the caller asks for them
(``backend=`` of ``ops.connected`` and ``ops.resize``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

from stroke_derenderer_tpu_torch.kernels.build import BUILD, _file_lock

SRC = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def load(name: str, extra_flags: tuple = (), timeout: float = 300.0
         ) -> ctypes.CDLL:
    """``native/<name>.cpp`` -> the loaded ``_build/libsd_<name>.so``,
    built with ``g++`` ``GXX_FLAGS`` + ``extra_flags`` when missing or
    older than the source. Raises ``RuntimeError`` when the build fails."""
    with _lock:
        if name in _LIBS:
            return _LIBS[name]
        src = SRC / f"{name}.cpp"
        lib = BUILD / f"libsd_{name}.so"
        BUILD.mkdir(exist_ok=True)
        with _file_lock(BUILD / f"sd_{name}.lock", timeout):
            if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
                _compile(src, lib, extra_flags, timeout)
        _LIBS[name] = ctypes.CDLL(str(lib))
        return _LIBS[name]


def _compile(src: Path, lib: Path, extra_flags: tuple,
             timeout: float) -> None:
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found, needed to build {src.name}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
