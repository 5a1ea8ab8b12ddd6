"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Each source is compiled to an object by its own ``nvcc``, all started
together, and the objects are linked into one library.  The library is
built at first use into ``build/repro_torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), under a name keyed by a hash of
the sources, the headers they include and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  Nothing is
built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = tuple(_CSRC / f for f in ("fused_search.cu", "window_verify.cu", "dist.cu",
                                      "pairwise_l2.cu", "select.cu", "merge.cu"))
_HEADERS = (_CSRC / "search_common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # name: (argtypes, restype)
    "fused_search_smem_bytes": ((_I,) * 7, ctypes.c_size_t),
    "fused_search_error_string": ((_I,), ctypes.c_char_p),
    "fused_window_search_launch": ((_P,) * 14 + (_I,) * 12 + (_P,), _I),
    "fused_cand_search_launch": ((_P,) * 13 + (_I,) * 9 + (_P,), _I),
    "verify_smem_bytes": ((_I,) * 5, ctypes.c_size_t),
    "window_verify_launch": ((_P,) * 6 + (_F,) + (_P,) * 2 + (_I,) * 8 + (_P,), _I),
    "candidate_verify_launch": ((_P,) * 5 + (_F,) + (_P,) * 2 + (_I,) * 6 + (_P,), _I),
    "dist_smem_bytes": ((_I, _I), ctypes.c_size_t),
    "window_dist_launch": ((_P,) * 9 + (_I,) * 9 + (_P,), _I),
    "candidate_dist_launch": ((_P,) * 8 + (_I,) * 6 + (_P,), _I),
    "pairwise_l2_launch": ((_P,) * 3 + (_I,) * 4 + (_P,), _I),
    "select_scratch_keys": ((_I,) * 5, ctypes.c_size_t),
    "select_blocks_launch": ((_P,) * 3 + (_F,) + (_P,) * 3 + (_I,) * 5 + (_P,), _I),
    "merge_smem_bytes": ((_I, _I), ctypes.c_size_t),
    "merge_schedule_launch": ((_P,) * 12 + (_LL,) + (_I,) * 8 + (_P,), _I),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    return _BUILD_DIR / f"search_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
        for cmd in ([nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(_SOURCES, objs))
    ]
    log, failed = [], []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
