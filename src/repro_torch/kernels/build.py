"""Build, load and count the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``; a
library holds the launch functions of one or more kernels. The
library's file name carries a hash of its source and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Libraries go to
``build/repro_torch/`` at the root of the checkout (``build/`` is
git-ignored), or to ``$REPRO_TORCH_BUILD_DIR`` when that is set.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
calls into a library's launch function, and nowhere else, so a run can
show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Launch function of each kernel: (library, C symbol, argtypes). The
#: library is the stem of its source in ``csrc/``.
_SYMBOLS = {
    "descriptor_copy": ("descriptor_copy", "descriptor_copy_launch",
                        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                        + [ctypes.c_char_p] * 2 + [ctypes.c_longlong] * 2
                        + [ctypes.c_void_p]),
    "quantize_copy": ("quantize_copy", "quantize_copy_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.c_void_p]),
    "prefetch_pipeline": ("prefetch_pipeline", "prefetch_pipeline_launch",
                          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                          + [ctypes.c_char_p] * 2 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int, ctypes.c_void_p]),
    "paged_attention": ("paged_attention", "paged_attention_launch",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p]),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_launch",
                            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                            + [ctypes.c_float, ctypes.c_void_p]),
    "moe_gather": ("moe_dispatch", "moe_gather_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p]),
    "moe_combine": ("moe_dispatch", "moe_combine_launch",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_void_p]),
    "moe_gather_bwd": ("moe_dispatch", "moe_gather_bwd_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p]),
    "moe_combine_bwd": ("moe_dispatch", "moe_combine_bwd_launch",
                        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4
                        + [ctypes.c_int, ctypes.c_void_p]),
    "adamw_update": ("adamw", "adamw_update_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                     + [ctypes.c_double] * 4 + [ctypes.c_void_p]),
    "sum_squares": ("adamw", "sum_squares_launch",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p]),
}
#: The libraries, one per source.
LIBRARIES = sorted({lib for lib, _, _ in _SYMBOLS.values()})

LAUNCHES: Dict[str, int] = {name: 0 for name in _SYMBOLS}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the GPU")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{key}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = None) -> None:
    """Compile every library (source stem) in ``names``, default all, that
    is not built yet, one nvcc each, in parallel; raises if any fails."""
    names = LIBRARIES if names is None else names
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            _finish(n, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use, with the
    argument types of every launch function it holds."""
    lib_name = _SYMBOLS[name][0]
    lib = _LIBS.get(lib_name)
    if lib is not None:
        return lib
    build_all([lib_name])
    with _LOCK:
        lib = ctypes.CDLL(str(_target(lib_name)))
        for owner, sym, argtypes in _SYMBOLS.values():
            if owner == lib_name:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[lib_name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s launch function, count it, raise on error."""
    _, sym, _ = _SYMBOLS[name]
    err = getattr(library(name), sym)(*args)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


#: Device types whose tensors take a wrapper's plain version: the CPU, and
#: the meta device (shapes only: the dry run counts the plain version's
#: operations there, and nothing runs or launches).
PLAIN_DEVICES = ("cpu", "meta")
#: Device types a wrapper takes at all.
DEVICES = PLAIN_DEVICES + ("cuda",)


def plain_device(t) -> bool:
    """Whether tensor ``t`` takes its wrapper's plain version (it lies on
    the CPU or the meta device) rather than the kernel (on the card)."""
    return t.device.type in PLAIN_DEVICES


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward that kernel ``name``
    does not have: grad is enabled and an input requires grad. The kernel
    writes its output through a raw pointer, so that output would carry no
    ``grad_fn`` and every gradient below it would be lost without a word.
    The wrappers call this on their CUDA route only; the plain versions
    on the CPU are differentiable."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            "requires grad; run it under torch.no_grad() or on the CPU")


#: Return code of a table launch function when an index is out of range
#: (``csrc/desc_table.cuh``).
OUT_OF_RANGE = -1


def launch_table(name: str, *args) -> None:
    """Call kernel ``name``'s launch function that takes its descriptors by
    value (``csrc/desc_table.cuh``): it returns the number of launches it
    made, which are counted, :data:`OUT_OF_RANGE` when it launched nothing
    because an index is out of range (raises ``IndexError``), or
    ``-1 - error`` after a failed launch (raises ``RuntimeError``)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(library(name), _SYMBOLS[name][1])
    r = fn(*args)
    if r >= 0:
        LAUNCHES[name] += r
    elif r == OUT_OF_RANGE:
        raise IndexError(f"{name}: row index out of range")
    else:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{-1 - r}")
