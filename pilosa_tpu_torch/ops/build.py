"""Build and load the port's native libraries.

The CUDA sources in ``pilosa_tpu_torch/csrc/`` compile with ``nvcc``,
one process per source, all started together, and link into one shared
library with a plain C interface, which ``ctypes`` loads. The library
lands under ``build/kernels/<hash>/`` at the repository root, keyed on a
hash of the sources and flags, at first use; a later call in the same
process reuses the loaded handle.

The host file codec (``csrc/roaring_codec.cpp``) compiles the same way
with ``g++`` into ``build/native/<hash>/`` (``build_host``,
``load_host``); it needs no card, so the CPU builds and uses it too. A
failed build raises. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = ("bank_counts.cu", "mega_interpret.cu", "pbank_membership.cu",
           "sparse_expand.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

HOST_SOURCES = ("roaring_codec.cpp",)
HOST_BUILD_DIR = PKG_DIR.parent / "build" / "native"
# The codec popcounts every container it reads or writes: on x86-64 the
# popcnt instruction, not libgcc's bit loop.
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall",
              "-Wextra", "-Werror") + (("-mpopcnt",) if platform.machine().lower() in (
                  "x86_64", "amd64") else ())

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None
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
    "expand_positions": (_P, _P, _P, _P, _LL, _P, _LL, _LL, _LL, _LL, _LL,
                         _LL, _P),
    "launch_floor": (_P,),
}


_U64 = ctypes.c_uint64
# name -> (argtypes, restype) of the host codec's C entry points.
HOST_SIGNATURES = {
    "rc_load": ((_P, _U64), _P),
    "rc_error": ((_P,), ctypes.c_char_p),
    "rc_container_count": ((_P,), _U64),
    "rc_op_n": ((_P,), _U64),
    "rc_op_n_small": ((_P,), _U64),
    "rc_ops_bytes": ((_P,), _U64),
    "rc_snapshot_bytes": ((_P,), _U64),
    "rc_tail_dropped": ((_P,), _U64),
    "rc_free": ((_P,), None),
    "rc_keys": ((_P, _P), None),
    "rc_counts": ((_P, _P), None),
    "rc_export_split": ((_P, _U64, _P, _P), None),
    "rc_serialize_size": ((_P, _P, _P, _P, _U64), _U64),
    "rc_serialize": ((_P, _P, _P, _P, _P, _U64, _P), _U64),
    "rc_fnv1a32": ((_P, _U64, ctypes.c_uint32), ctypes.c_uint32),
    "rc_popcount_ptrs": ((_P, _U64), _U64),
    "rc_dense_positions_ptrs": ((_P, _U64, _P, _P), _U64),
    "rc_import_build": ((_P, _P, _U64, ctypes.c_uint32, ctypes.c_int), _P),
    "rc_ib_error": ((_P,), ctypes.c_char_p),
    "rc_ib_count": ((_P,), _U64),
    "rc_ib_nbits": ((_P,), _U64),
    "rc_ib_payload_size": ((_P,), _U64),
    "rc_ib_keys_counts": ((_P, _P, _P), None),
    "rc_ib_words": ((_P, _P), None),
    "rc_ib_payload": ((_P, _P), None),
    "rc_ib_free": ((_P,), None),
    "rc_serialize_groups_cap": ((_U64, _U64), _U64),
    "rc_serialize_groups": ((_P, _P, _P, _U64, _P), _U64),
    "rc_serialize_import_size": ((_P, _U64), _U64),
    "rc_serialize_import": ((_P, _P, _P, _U64, _P), _U64),
    "rc_build_masks": ((_P, _U64, _U64, _P, _P), _U64),
    "rc_scatter_rows": ((_P, _P, _U64, _P, _U64, _P), None),
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


def loaded() -> bool:
    """Whether this process has loaded the kernel library yet (the
    profiler's jit hit: a launch before it builds or loads it)."""
    return _LIB is not None


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


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, then g++, then c++."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand:
            found = shutil.which(cand)
            if found is not None:
                return found
    raise RuntimeError("no C++ compiler (g++) found: the host codec needs "
                       "one to build")


def host_source_hash() -> str:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for name in HOST_SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def host_library_path() -> Path:
    return HOST_BUILD_DIR / host_source_hash() / "libpilosa_codec.so"


def build_host() -> Path:
    """Compile the host codec unless this source hash is already built;
    returns its path. The library is written under a temporary name and
    renamed, so a concurrent build never loads a half-written file."""
    out = host_library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        tmp = str(Path(tmpdir) / out.name)
        proc = subprocess.run(
            [find_cxx(), *HOST_FLAGS, "-o", tmp,
             *(str(CSRC_DIR / name) for name in HOST_SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host codec build failed ({proc.returncode})"
                               f":\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The loaded host codec library (built on first call)."""
    global _HOST_LIB
    with _LOCK:
        if _HOST_LIB is None:
            lib = ctypes.CDLL(str(build_host()))
            for name, (argtypes, restype) in HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _HOST_LIB = lib
        return _HOST_LIB
