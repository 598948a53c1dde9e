"""Native (C++) host components, loaded with ctypes (the port's counterpart
of ``opsagent_tpu/native``).

The constrained-decoding FSM matcher (``fsm_matcher.cc``): the full
``[states x vocab]`` token admissibility and destination tables of a byte
DFA, precomputed eagerly over worker threads, so that a host mask is a row
copy and an advance a lookup (``serving.constrained.TokenFSM`` takes them
within ``NATIVE_TABLE_BUDGET``).

The source is compiled at first use with ``g++ -O2 -shared -fPIC
-std=c++17 -pthread`` into the kernel build directory
(``ops.cuda_build.BUILD_DIR``, ``build/opsagent_tpu_torch/`` in the
checkout), under a name that carries a hash of the source, as the CUDA
kernels' libraries are kept: an edited source never loads a stale build.
Nothing is compiled when the module is imported. Unlike the JAX package's
loader there is no fallback and no switch: a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops import cuda_build

SOURCE = Path(__file__).resolve().parent / "fsm_matcher.cc"
BUILD_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of this version of ``fsm_matcher.cc`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return cuda_build.BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


def build() -> Path:
    """Compile the matcher if this version of it is not built yet. Returns
    the library's path; raises with the compiler's output on a failure."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ {SOURCE.name} could not run: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ {SOURCE.name} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded matcher library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32, ptr = ctypes.c_int32, ctypes.c_void_p
        lib.opsagent_fsm_build.restype = ptr
        lib.opsagent_fsm_build.argtypes = [ptr, ptr, i32, ptr, ptr, i32, i32, i32]
        lib.opsagent_fsm_num_states.restype = i32
        lib.opsagent_fsm_num_states.argtypes = [ptr]
        for name in ("opsagent_fsm_mask", "opsagent_fsm_dest"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ptr, i32, ptr]
        lib.opsagent_fsm_advance.restype = i32
        lib.opsagent_fsm_advance.argtypes = [ptr, i32, i32]
        lib.opsagent_fsm_free.restype = None
        lib.opsagent_fsm_free.argtypes = [ptr]
        _lib = lib
        return lib


class NativeFSMTables:
    """The precomputed token tables of a byte DFA (owned by the library):
    ``mask_for_state`` and ``advance`` as ``TokenFSM``'s numpy walk gives
    them, and ``dest_row``, a state's DFA destination of every token (-1
    dead)."""

    def __init__(self, dfa_next: np.ndarray, dfa_accept: np.ndarray,
                 token_bytes: list[bytes], eos_id: int):
        lib = get_lib()
        self._lib = lib
        self.vocab = len(token_bytes)
        self.num_states = len(dfa_accept)
        self._next = np.ascontiguousarray(dfa_next, np.int32)
        self._accept = np.ascontiguousarray(np.asarray(dfa_accept), np.uint8)
        blob = b"".join(token_bytes)
        offsets = np.zeros((self.vocab + 1,), np.int32)
        offsets[1:] = np.cumsum([len(tb) for tb in token_bytes])
        self._blob = (np.frombuffer(blob, np.uint8) if blob
                      else np.zeros((1,), np.uint8))
        self._offsets = np.ascontiguousarray(offsets)
        self._handle = lib.opsagent_fsm_build(
            self._next.ctypes.data, self._accept.ctypes.data,
            ctypes.c_int32(self.num_states), self._blob.ctypes.data,
            self._offsets.ctypes.data, ctypes.c_int32(self.vocab),
            ctypes.c_int32(eos_id), ctypes.c_int32(0),
        )
        if not self._handle:
            raise RuntimeError("the native FSM build returned null")

    def mask_for_state(self, state: int) -> np.ndarray:
        out = np.empty((self.vocab,), np.uint8)
        self._lib.opsagent_fsm_mask(self._handle, ctypes.c_int32(state), out.ctypes.data)
        return out.astype(bool)

    def dest_row(self, state: int) -> np.ndarray:
        out = np.empty((self.vocab,), np.int32)
        self._lib.opsagent_fsm_dest(self._handle, ctypes.c_int32(state), out.ctypes.data)
        return out

    def advance(self, state: int, token_id: int) -> int:
        return int(self._lib.opsagent_fsm_advance(
            self._handle, ctypes.c_int32(state), ctypes.c_int32(token_id)))

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.opsagent_fsm_free(handle)
            self._handle = None
