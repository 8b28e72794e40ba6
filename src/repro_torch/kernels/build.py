"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` at the repo root, keyed on a hash
of the sources and flags, at first use.  ``build()`` starts one ``nvcc``
per missing library, all at once.  Nothing here runs at import: this
module is imported on machines without ``nvcc`` or a card, where only the
plain PyTorch versions run.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("motion_sad", "blockdct", "qtransfer", "roi_gather",
           "flash_attention", "seq_sum")
# no --use_fast_math: blockdct divides y / qtab and rounds exactly as the
# reference does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that it went through the kernels
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_functions: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through kernel
    ``name``: grad mode is on and a tensor argument requires grad.

    No kernel has a backward, as no Pallas kernel of the reference has
    one (``jax.grad`` through them fails).  The CUDA branch writes into a
    fresh tensor through ctypes, so its result would carry no
    ``grad_fn`` and the gradient would vanish silently; the CPU branch
    would keep it.  Every wrapper calls this before choosing its branch,
    so the CPU tests see what the card does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (neither has the reference's Pallas "
            "kernel): call it on tensors that need no grad, or under "
            "torch.no_grad()")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile each named source that has no library for its current
    hash, one ``nvcc`` per source, all started together.  Returns the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    for each source it built; raises if any build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        report, _ = proc.communicate()
        reports[name] = report
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu:\n{report}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def kernel_function(source: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built on first use,
    with its argument types declared.  Every entry returns a
    ``cudaError_t`` as an int."""
    key = (source, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            path = _library_path(source)
            if not path.exists():
                build((source,))
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, "biswift_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            fn.error_string = err
            _functions[key] = fn
    return fn


def launch(name: str, fn, device, *args) -> None:
    """Call a C entry with ``args`` and the current stream of ``device``,
    the device of the tensors the wrapper checked, and count one launch
    of kernel ``name``; raise if the launch was refused.

    The C side launches on the CUDA runtime's current device, which is
    set per thread and need not be the tensors' (a worker thread starts
    on device 0, and a stream mesh spans cards), so the call runs under
    ``torch.cuda.device(device)``."""
    with torch.cuda.device(device):
        code = fn(*args, stream_ptr(device))
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({fn.error_string(code).decode()})")
    with _lock:
        LAUNCHES[name] += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def storage_dtype(dtype) -> torch.dtype:
    """The storage dtype a kernel form runs in: torch.float32 for None or
    torch.float32, or torch.bfloat16 (every sum still taken in f32)."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype must be None (f32) or "
                         f"torch.bfloat16, got {dtype}")
    return dtype or torch.float32


def check_cuda_tensor(name: str, t, dtype, device) -> None:
    """What every kernel wrapper requires of a tensor it passes by
    pointer: the launch device, the kernel's dtype, contiguous memory."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
