"""Build and load the port's host libraries (csrc/host/*.cpp) with g++.

The verifier's pairing check and G1 MSM (pairing.cpp) and the Keccak of
the EVM transcript and the in-repo EVM (hashing.cpp) run on the host in
C++. Each source is compiled at first use with the host compiler and the
flags below into `build/host/` at the repository root. A library's file
name carries a digest of its source, the flags, the compiler's version and
the target flags that -march=native resolves to on this host, so a library
built by another compiler or for another CPU is never loaded. Processes
that build at once (test workers) take a file lock a library and write a
temporary file that they rename. A failed build raises RuntimeError with
the compiler's output: nothing falls back to the Python versions, which
stay as the tests' oracle. Nothing is built or loaded at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
SOURCES = ("pairing", "hashing")

_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "wh2_g1_msm": ([_U64P, _U64P, ctypes.c_uint64, _U64P], ctypes.c_int),
    "wh2_pairing_check": ([_U64P, _U64P, ctypes.c_uint64], ctypes.c_int),
    "wh2_keccak256": ([ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p], None),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> bytes:
    """The compiler's version and the target flags of -march=native here."""
    out = []
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        try:
            r = subprocess.run([cxx, *args], capture_output=True, timeout=120)
        except OSError as e:
            raise RuntimeError(f"the host compiler {cxx!r} cannot run: {e}") from e
        if r.returncode:
            raise RuntimeError(f"{cxx} {' '.join(args)} exited {r.returncode}:\n"
                               + r.stderr.decode(errors="replace")[-4000:])
        out.append(r.stdout)
    return b"\0".join(out)


def so_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_compiler_id(CXX))
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_paths() -> dict[str, Path]:
    """Each source's library as today's sources, flags and compiler name it,
    built or not: the compiler is asked for its version, nothing is built
    or loaded."""
    return {name: so_path(name) for name in SOURCES}


def _build(name: str) -> Path:
    """The library of `name`, compiled first if no process has yet."""
    so = so_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():
            return so
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host library {name} failed to build "
                               f"({' '.join(cmd)} exited {r.returncode}):\n"
                               + (r.stdout + r.stderr)[-4000:])
        os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` ("pairing" or "hashing"), built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(_build(name)))
    for fn, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    with _LIBS_LOCK:
        return _LIBS.setdefault(name, lib)


def build_all() -> None:
    """Build and load every host library, each in a thread of its own."""
    errors = []

    def one(name):
        try:
            load(name)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=one, args=(name,)) for name in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))


@contextlib.contextmanager
def python_oracles():
    """While the block runs, the verifier's and the EVM's pairing check, the
    verifier's host MSM and the Keccak of the transcript and the EVM are
    their pure-Python oracles instead of the native libraries (a check that
    both host paths give the same verdicts)."""
    from ..evm import machine
    from ..fields import pairing as P
    from ..plonk import transcript as T
    from ..plonk import verifier as V
    from . import keccak as KC

    swaps = [(V, "pairing_check", P.pairing_check_py), (V, "_host_msm", V._host_msm_py),
             (T, "keccak256", KC.keccak256_py), (machine, "pairing_check", P.pairing_check_py),
             (machine, "keccak256", KC.keccak256_py)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
