"""Build and bind the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`), all
sources at once in parallel, into `build/kernels/` at the repository root.
A library's file name carries a digest of its source, of every shared
header (csrc/*.cuh) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. Nothing is built or
loaded when this module is imported: the first launch builds, under a
lock, so that threads of one process (a server's requests, the workers
of a proof batch) compile each source once and load only finished files;
a file lock a library (`fcntl.flock`) does the same across processes
(the ranks of a sharded prover, test workers): one nvcc a source.

Every C entry returns `cudaGetLastError()`; `check` raises on anything but 0.
The C entries set kernel attributes, read device properties and launch on
the CUDA runtime's current device, so every wrapper launches inside
`on_card(card_of(...))`: the card that holds its tensors is made current
for the length of the call, whatever the calling thread's current device
(torch keeps one a thread, and a new thread starts on card 0). Tensors on
two cards, or not on a card, raise before anything is launched.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("montmul", "ntt", "msm", "combine", "ec", "mxu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U32 = ctypes.c_uint32
_U64 = ctypes.c_ulonglong
_SIGNATURES = {
    "wh2_montmul": [_P, _LL, _I, _P, _LL, _I, _P, _LL, _U32P, _U32, _P],
    "wh2_ntt_stage_a": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _U32P, _U32, _P],
    "wh2_ntt_stage_b": [_P, _P, _P, _LL, _LL, _LL, _I, _U32P, _U32, _P],
    "wh2_msm_interior": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                         _P, _U32P, _U32, _U32P, _P],
    "wh2_msm_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U32P,
                     _U32, _U32P, _P],
    "wh2_msm_combine_chunks": [_P, _P, _P, _P, _I, _I, _I, _U32P, _U32, _U32P,
                               _P],
    "wh2_msm_combine_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _U32P, _U32,
                             _U32P, _P],
    "wh2_ec_add_unsafe": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _U32P,
                          _U32, _P],
    "wh2_mxu_montmul": [_P, _P, _P, _LL, _P, _U32P, _U32P, _P],
    "wh2_mma_tile": [_P, _P, _P, _P],
}


class _Libraries:
    """The loaded libraries of one process (built on first use)."""

    def __init__(self):
        self.libs: dict[str, ctypes.CDLL] = {}


_STATE = _Libraries()
_BUILD_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_paths() -> dict[str, Path]:
    """Each source's library as today's sources, headers and flags name it,
    built or not: nothing is built or loaded."""
    return {name: _so_path(name) for name in SOURCES}


def build_all() -> float:
    """Compile every missing library (one nvcc per source, all started
    together) and load them all. Returns the seconds spent; `BUILD_SECONDS`
    keeps each library's time from the start to its nvcc's exit."""
    with _BUILD_LOCK:
        return _build_all_locked()


def _build_all_locked() -> float:
    if len(_STATE.libs) == len(SOURCES):
        return 0.0
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        # each missing library under its own file lock, taken in SOURCES
        # order and held until its nvcc has finished: a process that finds
        # the lock taken waits, then loads the other's file
        for name in SOURCES:
            so = _so_path(name)
            if so.exists():
                continue
            lock = open(BUILD_DIR / f".{name}.lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if so.exists():
                lock.close()
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            log = open(so.with_suffix(".log"), "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (so, tmp, log, lock,
                           subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
        errors = []
        while procs:
            for name, (so, tmp, log, lock, proc) in list(procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                BUILD_SECONDS[name] = time.time() - t0
                del procs[name]
                log.close()
                if rc != 0:
                    errors.append(f"{name}: nvcc exit {rc}\n"
                                  + so.with_suffix(".log").read_text()[-4000:])
                else:
                    os.replace(tmp, so)
                lock.close()
            time.sleep(0.05)
    finally:
        for so, tmp, log, lock, proc in procs.values():  # only after an exception
            proc.kill()
            log.close()
            lock.close()
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    for name in SOURCES:
        lib = ctypes.CDLL(str(_so_path(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _STATE.libs[name] = lib
    return time.time() - t0


def lib(name: str) -> ctypes.CDLL:
    if name not in _STATE.libs:
        build_all()
    return _STATE.libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def card_of(what: str, *tensors):
    """The one CUDA device that holds every tensor of a launch; raises
    ValueError when one lies on the CPU or on another card."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors on one card, got "
                         f"{sorted(str(d) for d in devices)}")
    return devices.pop()


@contextlib.contextmanager
def on_card(device):
    """Make `device` (a CUDA device with its index, as `card_of` gives it)
    the calling thread's current device for the length of a C entry's call,
    and yield the handle of the thread's current stream on it; the thread's
    own current device is restored after."""
    import torch

    if device.type != "cuda" or device.index is None:
        raise ValueError(f"a kernel launches on a CUDA device with an index, not {device}")
    previous = torch.cuda.current_device()
    if previous != device.index:
        torch.cuda.set_device(device.index)
    try:
        yield stream_ptr(device)
    finally:
        if previous != device.index:
            torch.cuda.set_device(previous)


def _words(arr) -> ctypes.Array:
    return (ctypes.c_uint32 * 8)(*[int(v) & 0xFFFFFFFF for v in arr])


def modulus_words(spec) -> ctypes.Array:
    """The modulus of a FieldSpec as a host uint32[8] for a C entry."""
    return _words(spec.p_words)


def one_words(spec) -> ctypes.Array:
    """R mod p (Montgomery one) of a FieldSpec as a host uint32[8]."""
    return _words(spec.one_mont)
