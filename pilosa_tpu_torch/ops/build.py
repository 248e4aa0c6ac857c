"""Build and load the port's CUDA kernels.

The sources in ``pilosa_tpu_torch/csrc/`` compile with ``nvcc``, one
process per source, all started together, and link into one shared
library with a plain C interface, which ``ctypes`` loads. The library
lands under ``build/kernels/<hash>/`` at the repository root, keyed on a
hash of the sources and flags, at first use; a later call in the same
process reuses the loaded handle. Nothing here runs at import.
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
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = ("bank_counts.cu", "mega_interpret.cu", "pbank_membership.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# source name -> what nvcc printed for it in the last verbose build
# (``-Xptxas -v``: each kernel's registers, shared memory and spills).
BUILD_LOG: Dict[str, str] = {}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# name -> argtypes of each C entry point (all return cudaError_t as int).
SIGNATURES = {
    "bank_row_counts": (_P, _P, _LL, _LL, _P),
    "bank_row_counts_masked": (_P, _P, _P, _P, _LL, _LL, _P),
    "bsi_plane_counts": (_P, _P, _P, _LL, _LL, _P),
    "mega_interpret": (_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _LL, _LL,
                       _P, _P, _P, _P),
    "pbank_membership_counts": (_P, _P, _P, _P, _LL, _LL, _LL, _P),
}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / "libpilosa_kernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless this source hash is already built;
    returns its path. Each source compiles to an object in its own nvcc
    process (all in parallel), then one link writes the library under a
    temporary name that is renamed, so a concurrent build never loads a
    half-written file."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        procs = []
        for name in SOURCES:
            obj = str(Path(tmpdir) / (Path(name).stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-c", "-o", obj, str(CSRC_DIR / name)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, _, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name} failed ({proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
            elif verbose and (stdout or stderr):
                BUILD_LOG[name] = stdout + stderr
                print(f"nvcc {name}:\n{stdout}{stderr}", flush=True)
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = str(Path(tmpdir) / out.name)
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
             *(obj for _, obj, _ in procs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
