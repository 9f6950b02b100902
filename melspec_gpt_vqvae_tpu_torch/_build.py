"""Build the port's CUDA kernels and call them through ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) and linked into one shared library under
``build/torch_kernels/`` of the checkout, at the first kernel call of the
process.  The sources use a plain C interface and no PyTorch headers, so a
build takes seconds; the library is named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.  A
failed build raises: nothing falls back to the plain PyTorch versions.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0, because a
launch the CUDA runtime refuses (too much shared memory, a bad grid) never
runs and ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes.  Every pointer and the stream are c_void_p:
# an undeclared pointer would be passed as a 32-bit int and cut.
SIGNATURES = {
    "msgv_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "msgv_decode_attention": [_P] * 9 + [_I] * 13 + [_P],
    "msgv_flash_attention_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    "msgv_flash_attention_bwd": [_P] * 11 + [_I] * 4 + [_F, _P],
    "msgv_resblock_stack": [_P] * 3 + [_I] * 8 + [_P],
    "msgv_resblock_stack_bf16": [_P] * 4 + [_I] * 8 + [_P],
    "msgv_vq_nearest": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "msgv_mel": [_P] * 7 + [_I] * 7 + [_F] * 8 + [_P],
    "msgv_quantize_rows": [_P] * 3 + [_I] * 5 + [_P],
    "msgv_rescale_bias": [_P] * 5 + [_I] * 3 + [_P],
    "msgv_int8_linear_splitk": [_P] * 5 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall seconds of this process's build (None: reused)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME to the "
                           "CUDA toolkit that builds the port's kernels")
    return str(path)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmsgv_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = so.with_name(f"{so.stem}_{src.stem}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            so = _library_path()
            if not so.exists():
                # the processes of one launch (torchrun) share the checkout:
                # one builds, the others wait for its library
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / "build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not so.exists():
                        _build(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.msgv_error_string.argtypes = [ctypes.c_int]
            lib.msgv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes the
    plain PyTorch version); False when all are CUDA tensors of one device.
    Anything else raises: a kernel wrapper never silently falls back."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel inputs must all be on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    return False


_KERNELS: contextvars.ContextVar = contextvars.ContextVar(
    "msgv_kernels", default=None)


@contextlib.contextmanager
def kernels(enabled: Optional[bool]):
    """Scope of the kernel switch that every wrapper reads
    (``use_kernel``): None takes each kernel for CUDA tensors and the
    plain version for CPU tensors, False the plain version on either
    device, True the kernel (CPU tensors then raise).  A context variable,
    so a scope entered in one thread is not seen by another (the HTTP
    server's handler threads each call a pipeline)."""
    if enabled not in (None, False, True):
        raise ValueError(f"kernels(enabled={enabled!r}): expected None, "
                         "False or True")
    token = _KERNELS.set(enabled)
    try:
        yield
    finally:
        _KERNELS.reset(token)


def kernel_setting() -> Optional[bool]:
    """The switch of the scope the caller is in (None outside any): what a
    captured program bakes in, so it is part of every capture's key."""
    return _KERNELS.get()


def use_kernel(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel on ``tensors``, by the
    switch of the enclosing ``kernels`` scope: None takes the kernel for
    CUDA tensors and the plain PyTorch version for CPU tensors
    (``on_cpu``); False takes the plain version on either device; True
    takes the kernel, and raises for CPU tensors, where there is none.
    Only the caller turns a kernel off: a kernel that fails to build or
    launch raises."""
    cpu = on_cpu(*tensors)
    setting = _KERNELS.get()
    if setting is False:
        return False
    if cpu and setting:
        raise ValueError("use_kernels=True: the port's kernels run on the "
                         "card only, and these tensors lie on the CPU")
    return not cpu


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (appended
    as the last argument) and raise if the launch failed."""
    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.msgv_error_string(err).decode()}")
