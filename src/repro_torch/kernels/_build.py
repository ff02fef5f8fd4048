"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface, so it compiles in
seconds to its own shared library under ``build/kernels/`` at the root
of the checkout (git-ignored), named after a hash of its source and of
the shared ``csrc/*.cuh`` headers, and is loaded with :mod:`ctypes`.  All sources are compiled at once, one
``nvcc`` process each, on the first call that needs a kernel; later
calls and later processes reuse the libraries.  Nothing is built when
this module is imported.

The tensor-core kernels (``hopper.cuh``) encode their TMA tensor maps
with the driver's ``cuTensorMapEncodeTiled``, which they fetch at run
time through ``cudaGetDriverEntryPoint``; the libraries link against
the CUDA runtime only, so the build needs no ``-lcuda``.

:func:`launch` is the one place a kernel is launched, so it also keeps
each kernel's launch count: a plain int that goes up by one when the C
entry point reports a successful launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each library's entry point: (name, argtypes)
SIGNATURES = {
    "paged_decode_attention": (
        "paged_decode_attention_launch",
        [_VOID_P] * 7 + [_INT] * 9 + [_VOID_P],
    ),
    "page_gather": (
        "page_gather_launch",
        [_VOID_P] * 3 + [_INT] * 4 + [ctypes.c_longlong, _VOID_P],
    ),
    "flash_attention": (
        "flash_attention_launch",
        [_VOID_P] * 4 + [_INT] * 8 + [_VOID_P],
    ),
    "decode_attention": (
        "decode_attention_launch",
        [_VOID_P] * 6 + [_INT] * 7 + [_VOID_P],
    ),
    "ssd": (
        "ssd_launch",
        [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    ),
    "rmsnorm": (
        "rmsnorm_launch",
        [_VOID_P] * 3 + [_INT] * 3 + [ctypes.c_float, _VOID_P],
    ),
}
# further C entry points of a library: name -> (library, argtypes)
ENTRIES = {
    # the CUDA-core flash instance for either dtype (a yardstick)
    "flash_attention_fma_launch": ("flash_attention",
                                   SIGNATURES["flash_attention"][1]),
    # the tensor-core SSD (bf16), with its C B^T workspace
    "ssd_tc_launch": ("ssd", [_VOID_P] * 8 + [_INT] * 5 + [_VOID_P]),
}
# dtype code the entry points take
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what the last build printed per kernel (ptxas register/spill report)
build_log: dict[str, str] = {}
_launches = {name: 0 for name in SIGNATURES}


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def cuda_tool(tool: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else under $CUDA_HOME or /usr/local/cuda; raises if it is missing."""
    found = shutil.which(tool)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", tool).exists():
            return str(Path(root, "bin", tool))
    raise RuntimeError(
        f"{tool} not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)"
    )


def library_path(name: str) -> Path:
    """The built shared library of kernel ``name``."""
    return _target(name)


def _target(name: str) -> Path:
    # the key covers the shared headers too, which every source may include
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel.
    Returns the seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SIGNATURES if not _target(n).exists()]
    if todo:
        nvcc = cuda_tool("nvcc")
        procs = {}
        for name in todo:
            tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(name))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            entries = [SIGNATURES[name]] + [
                (fn_name, argtypes)
                for fn_name, (owner, argtypes) in ENTRIES.items()
                if owner == name]
            for fn_name, argtypes in entries:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_operands(floats: dict, ints: dict,
                   f32s: Optional[dict] = None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device, the float operands share one dtype of ``DTYPE_CODE`` and are
    16-byte aligned (the kernels read 16-byte words), the integer
    operands are int32 (torch's default integer is int64) and the
    ``f32s`` operands are float32 whatever the others' dtype."""
    f32s = f32s or {}
    tensors = {**floats, **ints, **f32s}
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or not dtypes <= DTYPE_CODE.keys():
        raise TypeError(f"{', '.join(floats)} must share one dtype of "
                        f"float32 / bfloat16, got {sorted(map(str, dtypes))}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in f32s.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {**floats, **f32s}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch(name: str, *args, entry: Optional[str] = None) -> None:
    """Call kernel ``name``'s C entry point (or its further ``entry`` of
    ``ENTRIES``), raise if the launch reported an error (cudaGetLastError
    right after the launch), else count it: one count per call, whatever
    number of CUDA kernels the entry point runs."""
    if entry is not None and ENTRIES[entry][0] != name:
        raise ValueError(f"{entry} is not an entry point of {name}")
    fn = getattr(library(name), entry or SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {err}"
        )
    _launches[name] += 1
