"""Build and bind the port's CUDA kernels (``diral_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch header is
included, so a build takes seconds.  Libraries go to
``build/diral_tpu_torch/`` at the repository root, named by the source's
content hash, so an edited source is rebuilt and an unchanged one is
reused.  ``build_all`` starts one ``nvcc`` per missing library, all at
once.

``launch`` is the one path from a wrapper to its C entry: each entry is
bound once (``entry``), tensors go as their data pointers, the stream is
read as a raw handle, and the device is switched only where the tensors'
device is not the current one.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: the channel
walk and the histogram are meant to match their plain PyTorch versions
bit for bit, and eager PyTorch rounds ``a*b + c`` as two operations.
Never ``--use_fast_math`` (it would also swap ``sqrtf``/``expf``/division
for approximations).  Kernels that want a fused multiply-add ask for it
with ``__fmaf_rn`` where the product is exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from diral_tpu_torch.utils import spans

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "diral_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of diral_tpu_torch build only "
        "where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Returns {name: ptxas report} for the sources compiled in this call."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    with spans.once("setup.kernels", sources=len(todo)):
        return _compile(todo)


def _compile(todo: list) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    reports, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        reports[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


_ENTRIES: dict = {}


def entry(lib, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry ``symbol`` of ``lib``, bound once: it returns an int
    (a ``cudaError_t``) and takes ``argtypes`` and then the stream."""
    key = (lib, symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        _ENTRIES[key] = fn
    return fn


def _stream(device) -> tuple[int, bool]:
    """(the current stream of ``device`` as a raw handle, whether
    ``device`` is not the current device).  The raw handle is PyTorch's
    own ``_cuda_getCurrentRawStream``; ``torch.cuda.current_stream``
    would build a Stream object inside a device switch on every call."""
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(idx), idx != cur


def launch(lib, symbol: str, argtypes, device, *args) -> None:
    """Call the C entry ``symbol`` of ``lib`` on ``device``'s current
    stream.  Tensors in ``args`` are passed as their data pointers;
    ``argtypes`` declares every argument but the stream, which each entry
    takes last.  Each entry returns the ``cudaError_t`` of its launch; a
    non-zero one raises (the library's ``dtt_error_string`` names it).
    The device is switched to only where it is not the current one."""
    fn = entry(lib, symbol, argtypes)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream, switch = _stream(device)
    if switch:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    else:
        err = fn(*args, stream)
    if err != 0:
        msg = lib.dtt_error_string
        msg.restype, msg.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{symbol}: CUDA error {err}: "
                           f"{msg(err).decode(errors='replace')}")


def check_tensor(name, t, dtype, shape, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape,
    contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
