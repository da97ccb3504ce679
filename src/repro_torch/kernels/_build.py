"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one shared
library, ``build/lib<name>-<hash>.so`` inside the package.  The hash covers
the source text and the compiler flags, so an edited source is rebuilt and
a stale library is never loaded.  The build runs at first use (or ahead of
it through :func:`build`, which starts one ``nvcc`` per source, all at
once).  There is no fallback: a CUDA caller on a host without ``nvcc``
gets an error.

Plain C plus ``ctypes`` keeps a build to seconds; a source that includes
PyTorch's headers takes minutes.  Wrappers pass pointers from
``tensor.data_ptr()`` and PyTorch's current stream, declare ``argtypes``
with ``c_void_p`` for each pointer and the stream, and raise when the C
entry returns a non-zero ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    """Names of every CUDA source in ``csrc`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at "
                       "first use and have no fallback")


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (all of ``csrc`` by default) that has no
    up-to-date library, one ``nvcc`` per source, all started together.
    Returns ``nvcc``'s output (``-Xptxas -v``: registers, shared memory,
    spills) for each source it compiled; raises if any compile failed."""
    names = sources() if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        final = library_path(name)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, final)
    logs, failed = {}, []
    for name, (proc, tmp, final) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, final)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
