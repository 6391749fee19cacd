"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Route (b) of a plain-C build: every ``csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.

The library is built at first use into ``build/repro_torch/`` at the
repository root (``.gitignore`` lists ``build/``), under a name that
hashes the sources and flags, so an edited source is never served from a
stale library.  Import this module freely: nothing is compiled or loaded
until :func:`library` is called, which only a CUDA tensor's kernel launch
does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",             # no contracted multiply-adds: the f32 CC
                                # update stays bit-equal to the plain version
    "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of repro_torch need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build(verbose: bool = False, force: bool = False) -> dict:
    """Compile every ``csrc/*.cu`` in parallel and link the library.

    Returns ``{"path", "seconds", "built", "log"}``; ``built`` is False when
    a library of the same sources already existed (``force`` rebuilds it
    anyway).  ``verbose`` adds ``-Xptxas -v`` (registers, shared memory
    and spills per kernel) to the compiler log."""
    out = library_path()
    if out.is_file() and not force:
        return {"path": out, "seconds": 0.0, "built": False, "log": ""}
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, out)             # atomic: concurrent builds agree
    return {"path": out, "seconds": time.perf_counter() - t0, "built": True,
            "log": "\n".join(log)}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()["path"]))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")


def use_kernel(backend: str, x) -> bool:
    """The dispatch rule of every ops layer: the CUDA kernel for the
    ``"kernel"`` backend on a CUDA tensor; the plain version otherwise —
    a ``"kernel"`` backend takes it only because the tensor is on the CPU."""
    return backend == "kernel" and x.device.type == "cuda"


def on_card(device, what: str) -> None:
    """Raise unless ``device`` is a CUDA device.  Wrappers call it after
    checking every operand, so a CPU rehearsal exercises those checks."""
    if device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {device}")


def require(x, name: str, dtype, shape, device, *, last_dim_only: bool = False):
    """Validate one kernel operand and return its data pointer.

    Checks device, dtype, shape and contiguity (``last_dim_only``: only
    the innermost stride must be 1; the kernel takes the row stride)."""
    import torch

    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    ok = (x.stride(-1) == 1 if x.dim() else True) if last_dim_only \
        else x.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: not contiguous (strides {x.stride()})")
    return ctypes.c_void_p(x.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launcher."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
