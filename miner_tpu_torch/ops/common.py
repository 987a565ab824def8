"""Building, loading and launching the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. Nothing
here includes PyTorch's headers, so a build takes seconds. A library is built
at first use into ``miner_tpu_torch/build/`` (listed in ``.gitignore``); its
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. :func:`build` starts one
``nvcc`` per source, all together.

Every C entry point takes the device index and the CUDA stream as arguments,
launches on that stream, allocates nothing, and returns ``cudaGetLastError()``
right after its launch; :func:`launch` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
CUDA_SOURCES = ("mha_fwd", "mha_bwd", "add_ln_bwd", "poly_attention_fwd",
                "lookup_score_fwd", "fastformer_attn_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh; INT8_CODE names lookup+score's
# int8 cache rows, the only kernel input of that type
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8_CODE = 2

_load_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the port's CUDA kernels are built from source")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256()
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = CUDA_SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns each name's ``ptxas`` report
    (registers, shared memory, spills), empty for a library already built.
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``. The first load builds every
    library not built yet (:func:`build`: one ``nvcc`` each, all started
    together), so that an entry point does not wait for them one by one at
    their first launches."""
    with _load_lock:
        if name not in _libraries:
            build(CUDA_SOURCES if name in CUDA_SOURCES else [name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return _libraries[name]


@functools.lru_cache(maxsize=None)
def kernel_function(name: str, symbol: str, argtypes: Tuple, restype=ctypes.c_int):
    """``symbol`` of library ``name`` with its ctypes signature set. Every
    pointer and the stream are ``c_void_p``: a bare Python int would be
    passed as a 32-bit int and cut."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def launch(name: str, fn, *args) -> None:
    """Call a C entry point and raise if its launch was refused (too many
    threads, too much shared memory, no image for this card...): such a
    launch never runs, and a later synchronize would not report it."""
    rc = fn(*args)
    if rc != 0:
        msg = load(name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(what: str, t: torch.Tensor, device: torch.device,
                 dtypes: Sequence[torch.dtype],
                 shape: Optional[Tuple[int, ...]] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` on
    ``device`` with ``shape`` (when given): what every kernel takes."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of {list(dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_aligned(what: str, t: torch.Tensor, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary: kernels
    that copy rows with 16-byte loads take no other."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{what} must start on a {nbytes}-byte boundary")


def require_cuda(t: torch.Tensor, op: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{op}: tensors on {t.device} are not supported "
                         "(cpu runs the plain version, cuda the kernel)")

