"""ctypes binding of the port's host data plane, ``csrc/host/miner_data.cpp``.

The C++ library draws an epoch of training samples (``sample_epoch``) and
packs UnBERT's rows (``pack_unbert``) with the JAX package's native code:
the same C ABI and the same draws, so that the two packages sample the same
epochs from the same flags and seed. The numpy paths in ``samplers.py`` and
``unbert_packing.py`` stay as the behavioral reference and the fallback.

The library is host code and needs no card: ``g++ -O3 -shared -fPIC
-std=c++17`` builds it at first use into ``miner_tpu_torch/build/`` (listed
in ``.gitignore``), apart from the CUDA kernels' ``nvcc`` build
(``ops/common.py``). Its file name carries the ABI version and a hash of the
source, so an edited source is rebuilt and a stale library never loaded; the
build writes a name unique to the process and moves it into place, so
processes that build at the same time never see half a file. Setting
``MINER_TPU_NO_NATIVE`` (to any value) switches the library off, as in the
JAX package.

Each entry point counts its calls (``sample_epoch.calls``,
``pack_unbert.calls``; :func:`call_counts`), as the kernel wrappers count
their launches, so a run can show which path it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)

ABI_VERSION = 2  # must match miner_data_abi_version() in miner_data.cpp
PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "host" / "miner_data.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAX_CANDIDATES = 512  # the C side's per-event row buffer
MAX_VARIANTS = 64  # the C side's hard-mode variant buffer

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be had, once known


def library_path() -> Path:
    """Where the library lives once built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libminer_data.v{ABI_VERSION}.{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _bind(lib: ctypes.CDLL) -> None:
    lib.miner_data_abi_version.argtypes = []
    lib.miner_data_abi_version.restype = ctypes.c_int32
    if lib.miner_data_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native library ABI {lib.miner_data_abi_version()}, "
                           f"want {ABI_VERSION}")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.miner_sample_epoch.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        i32p, i32p, i32p, i32p, f32p,
    ]
    lib.miner_sample_epoch.restype = None
    lib.miner_pack_unbert.argtypes = [
        ctypes.c_int64, ctypes.c_int,
        i32p, i32p, ctypes.c_int64,
        i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.miner_pack_unbert.restype = None


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises ``RuntimeError``
    (with the compiler's output where the build failed) when it cannot be
    had or ``MINER_TPU_NO_NATIVE`` is set."""
    global _lib, _error
    if os.environ.get("MINER_TPU_NO_NATIVE"):
        raise RuntimeError("native data plane switched off by MINER_TPU_NO_NATIVE")
    with _lock:
        if _lib is None and _error is None:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = str(e)
                log.warning("native data plane unavailable: %s", _error)
        if _lib is None:
            raise RuntimeError(f"native data plane unavailable: {_error}")
        return _lib


def native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def sample_epoch(seed: int, epoch: int, mode: str, num_events: int, C: int,
                 V: int, N: int, pos_row: np.ndarray, neg_flat: np.ndarray,
                 neg_offsets: np.ndarray):
    """One epoch's (cand, label) of ``num_events`` events, (E, C) int32
    global indices and float32 one-hot labels, drawn per event from
    (seed, epoch, event): the JAX package's ``native.sample_epoch``."""
    if mode not in ("base", "hard"):
        raise ValueError(f"unknown sampler mode {mode!r}")
    if not 0 < C <= MAX_CANDIDATES:
        raise ValueError(f"{C} candidates an event; the native sampler takes 1 to "
                         f"{MAX_CANDIDATES}")
    if mode == "hard" and V > MAX_VARIANTS:
        raise ValueError(f"{V} variants; the native hard mode takes at most {MAX_VARIANTS}")
    if V * N >= 2 ** 31:
        raise ValueError(f"{V} x {N} global news indices overflow int32")
    if len(pos_row) < num_events or len(neg_offsets) < num_events + 1:
        raise ValueError("pos_row / neg_offsets shorter than the events")
    lib = load()
    cand = np.zeros((num_events, C), dtype=np.int32)
    label = np.zeros((num_events, C), dtype=np.float32)
    lib.miner_sample_epoch(
        seed & 0xFFFFFFFFFFFFFFFF, epoch, 1 if mode == "hard" else 0,
        num_events, C, V, N, _i32(pos_row), _i32(neg_flat), _i32(neg_offsets),
        cand, label,
    )
    sample_epoch.calls += 1
    return cand, label


def pack_unbert(tokens: np.ndarray, lens: np.ndarray, cand_rows: np.ndarray,
                hist_rows: np.ndarray, seq_max_len: int, news_max_len: int,
                hist_max_len: int, cls_id: int, sep_id: int, pad_id: int,
                legacy_layout: bool = False) -> Dict[str, np.ndarray]:
    """UnBERT's packed features of (B,) candidate rows x (B, H) history rows
    over the title table ``tokens`` (R, Lt) and its lengths: the JAX
    package's ``native.pack_unbert``."""
    tokens, lens = _i32(tokens), _i32(lens)
    cand_rows, hist_rows = _i32(cand_rows), _i32(hist_rows)
    if hist_rows.ndim != 2 or len(hist_rows) != len(cand_rows):
        raise ValueError(f"history rows {hist_rows.shape} for {len(cand_rows)} candidates")
    if lens.shape != (len(tokens),) or (len(lens) and int(lens.max()) > min(
            tokens.shape[1], news_max_len, seq_max_len - 3)):
        raise ValueError("title lengths must fit the token table, news_max_len "
                         "and seq_max_len - 3")
    rows = np.concatenate([cand_rows, hist_rows.reshape(-1)])
    if len(rows) and (int(rows.min()) < 0 or int(rows.max()) >= len(tokens)):
        raise ValueError("a candidate or history row is outside the token table")
    lib = load()
    B, H = len(cand_rows), hist_rows.shape[1]
    S = 3 + hist_max_len
    out = {
        "input_ids": np.zeros((B, seq_max_len), np.int32),
        "input_mask": np.zeros((B, seq_max_len), np.int32),
        "segment_ids": np.zeros((B, seq_max_len), np.int32),
        "news_segment_ids": np.zeros((B, seq_max_len), np.int32),
        "sentence_ids": np.zeros((B, S), np.int32),
        "sentence_mask": np.zeros((B, S), np.int32),
        "sentence_segment_ids": np.zeros((B, S), np.int32),
    }
    lib.miner_pack_unbert(
        B, H, tokens, lens, tokens.shape[1], cand_rows, hist_rows,
        seq_max_len, news_max_len, hist_max_len, cls_id, sep_id, pad_id,
        1 if legacy_layout else 0,
        out["input_ids"], out["input_mask"], out["segment_ids"],
        out["news_segment_ids"], out["sentence_ids"], out["sentence_mask"],
        out["sentence_segment_ids"],
    )
    pack_unbert.calls += 1
    return out


sample_epoch.calls = 0
pack_unbert.calls = 0


def call_counts() -> Dict[str, int]:
    return {"sample_epoch": sample_epoch.calls, "pack_unbert": pack_unbert.calls}


def reset_call_counts() -> None:
    sample_epoch.calls = 0
    pack_unbert.calls = 0
