"""Build and load the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, bound with ``ctypes``.

The sources under ``kernels/csrc/`` are compiled at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``): one
``nvcc`` per source, all started together, then one link into a single
library. The library's file name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale build is never loaded. Nothing
is compiled at import time: the CPU tests import every module without
``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` and no
``-ftz=true`` — denormal results must stay visible so the Viterbi combine's
explicit flush matches the reference — and ``--fmad=false`` so no multiply
and add are contracted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("relax.cu", "segment_reduce.cu", "embedding_bag.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
SIGNATURES = {
    # name: argtypes (restype is c_int: cudaGetLastError() for the runs, a
    # count for segment_reduce_scratch, segment_reduce_max_width and
    # relax_multi_max_lanes; the error-string lookup is apart)
    "relax_multi_max_lanes": (),
    "relax_multi_run": (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P),
    "edge_relax_run": (_I, _I, _P, _P, _P, _P, _LL, _P, _P),
    "segment_reduce_max_width": (),
    "segment_reduce_scratch": (_I, _I, _I),
    "segment_reduce_tiles": (_I, _I, _I, _P, _P, _P),
    "segment_reduce_run": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "embedding_bag_run": (_I, _I, _LL, _P, _P, _P, _P, _P, _P, _P),
}

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch can only be built on a machine with the "
            "CUDA toolkit")
    return found


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every ``(cmd, Popen)``; raise with the compiler's output if
    any failed."""
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> pathlib.Path:
    """Compile the sources if this exact build is missing; returns its path.

    One ``nvcc -c`` per source runs in parallel, then one link. Everything
    is written under a temporary directory and the library renamed into
    place, so concurrent builders never load a half-written file.
    """
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, pathlib.Path(s).stem + ".o")
                for s in SOURCES]
        _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / s)])
              for s, obj in zip(SOURCES, objs)])
        lib = os.path.join(tmp, out.name)
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])])
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def void_ptrs(ptrs) -> ctypes.Array:
    """A C array of device pointers (Python ints) for a ``void* const*``."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def longlongs(values) -> ctypes.Array:
    """A C array of 64-bit ints."""
    return (ctypes.c_longlong * len(values))(*values)
