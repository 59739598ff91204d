"""Builds the hand-written CUDA kernels and binds them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/repro_torch/<hash of sources and flags>/`` at the repo root (listed
in ``.gitignore``) on first use and is reused while the sources are
unchanged. Nothing is built or imported when this module is imported, and
a failed build raises: there is no fallback. The library is not linked
against the CUDA driver library (``libcuda``): the one function of it
that it calls, ``cuTensorMapEncodeTiled`` (the flash attention's wgmma
route encodes its TMA tensor maps per call), is taken through the
runtime's ``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``).

Each kernel wrapper counts its launches here (``LAUNCHES``), where it
launches, and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Iterator, NamedTuple, Optional

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
REPO_DIR = PKG_DIR.parents[1]
BUILD_ROOT = REPO_DIR / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counters: one per kernel, the gated routes (skip="gated" and
# "two_level") of the fused PE, spike matmul and dw kernels counted apart
# from their dense-skip route
KERNELS = ("lif_update", "fused_pe", "spike_matmul", "w2ttfs_pool",
           "pack_spikes", "unpack_spikes", "spike_matmul_dx",
           "spike_matmul_dw", "qk_attention", "fused_pe_gated",
           "spike_matmul_gated", "spike_matmul_dw_gated", "flash_attention")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_VOID_P = ctypes.c_void_p
_I, _LL, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "repro_lif_update": [_VOID_P] * 5 + [_LL, _F, _F, _I, _VOID_P],
    "repro_fused_pe": [_VOID_P] * 9 + [_I] + [_VOID_P] * 6
    + [_I] * 7 + [_F, _F, _F, _I, _I, _I, _I, _VOID_P, _VOID_P],
    "repro_spike_matmul": [_VOID_P] * 7 + [_I] * 8 + [_VOID_P],
    "repro_w2ttfs_pool": [_VOID_P] * 4 + [_I] * 6 + [_F, _VOID_P],
    "repro_pack_spikes": [_VOID_P] * 4 + [_I] * 5 + [_VOID_P],
    "repro_unpack_spikes": [_VOID_P] * 2 + [_LL, _VOID_P],
    "repro_spike_matmul_dx": [_VOID_P] * 5 + [_I] * 5 + [_F] * 5 + [_VOID_P],
    "repro_spike_matmul_dw": [_VOID_P] * 7 + [_I] * 7 + [_VOID_P],
    "repro_qk_attention": [_VOID_P] * 3 + [_LL, _I, _F, _I, _VOID_P],
    "repro_flash_attention": [_VOID_P] * 4 + [_I] * 5 + [_F, _I, _I, _VOID_P],
    "repro_flash_attention_wgmma": [_VOID_P] * 4 + [_I] * 5
    + [_F, _I, _VOID_P],
    "repro_wgmma_probe": [_VOID_P] * 4 + [_I, _I, _VOID_P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: pathlib.Path       # the shared library
    seconds: float           # wall time of this build (0.0 when reused)
    ptxas_log: str           # nvcc's -Xptxas -v report for every kernel


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None
_CAPTURE: Optional[list] = None


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit (``CUDA_HOME``, or the
    toolkit's default install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"nvcc not found on PATH or in {home / 'bin'}; the "
                       f"CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile and link the library if this source tree has none yet."""
    global _INFO
    if _INFO is not None:
        return _INFO
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib.exists() and log_path.exists():
        _INFO = BuildInfo(lib, 0.0, log_path.read_text())
        return _INFO
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                           str(tmp / LIB_NAME), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}"
                           f"{link.stderr}")
    seconds = time.perf_counter() - t0
    (tmp / "ptxas.log").write_text(log)
    out_dir.mkdir(parents=True, exist_ok=True)
    os.replace(tmp / "ptxas.log", log_path)
    os.replace(tmp / LIB_NAME, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    _INFO = BuildInfo(lib, seconds, log)
    return _INFO


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, entry: str) -> None:
    """Raise if a C entry's ``cudaGetLastError()`` is not success."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device, align: int = 16) -> None:
    """The checks every C entry relies on: device, dtype, exact shape,
    contiguity and alignment (the tiled kernels load 16 bytes at a time)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


class Launch(NamedTuple):
    """One captured launch: kernel ``name``, the operands the wrapper
    handed it (``args``), the tensors its caller gave the wrapper before
    padding and casts (``inputs``), and the route it took (``"tile"`` or,
    for the fused PE and the spike matmul, ``"decode"``; for the flash
    attention ``"wgmma"`` or ``"scalar"``)."""
    name: str
    args: tuple
    inputs: tuple
    route: str = "tile"


def count_launch(name: str, args: tuple, inputs: tuple,
                 route: str = "tile") -> None:
    """Called by a wrapper right where it launches kernel ``name``, with
    the operands it hands the kernel (``args``), the tensors its caller
    gave it before padding and casts (``inputs``) and the route it
    launches. Inside ``capture_launches()`` they are kept as a ``Launch``,
    so a measurement can replay the exact launch the main path made and
    size its work at the caller's extent and dtypes."""
    LAUNCHES[name] += 1
    if _CAPTURE is not None:
        _CAPTURE.append(Launch(name, args, inputs, route))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def capture_launches() -> Iterator[list]:
    """Record a ``Launch`` for every launch inside the block."""
    global _CAPTURE
    prev, _CAPTURE = _CAPTURE, []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = prev
