"""Build, bind and count the port's CUDA kernels.

The three kernels of the sketched round live in one source,
``csrc/sketch_kernels.cu``, with a plain ``extern "C"`` interface. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` beside this
file (keyed on a hash of the source and the flags, so an edited source
rebuilds) and loaded with ``ctypes``. Nothing is compiled or loaded at
import: the CPU tests import every module.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises if the C function reports a CUDA error, and adds one to its
kernel's ``launches`` count. The plain PyTorch versions live beside the
public dispatch functions in ``ops/sketch.py`` and ``ops/topk.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "sketch_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclass
class Kernel:
    """One kernel of the library and its launch count."""

    name: str
    source: str    # path in the repo
    replaces: str  # the TPU kernel it ports, file:line
    launches: int = 0


SKETCH_ACCUMULATE = Kernel(
    "sketch_accumulate", "commefficient_torch/csrc/sketch_kernels.cu",
    "commefficient_tpu/ops/sketch.py:274 (_sketch_vec_pallas)")
SKETCH_ESTIMATES = Kernel(
    "sketch_estimates", "commefficient_torch/csrc/sketch_kernels.cu",
    "commefficient_tpu/ops/sketch.py:889 (_estimates_pallas)")
TOPK_COUNT_GE = Kernel(
    "topk_count_ge", "commefficient_torch/csrc/sketch_kernels.cu",
    "commefficient_tpu/ops/topk.py:95 (_count_ge_pallas)")
KERNELS: Tuple[Kernel, ...] = (SKETCH_ACCUMULATE, SKETCH_ESTIMATES,
                               TOPK_COUNT_GE)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source has no build yet.
    Returns ``(library path, compiler output)``; the output holds
    ``ptxas``'s register, shared-memory and spill summary."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsketch_kernels_{key}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / lib.name
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(out, lib)
    return lib, (log.read_text() if log.exists() else "")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sketch_accumulate.argtypes = [p, p, p, p, p, i32, i32, i32, i32, p]
    lib.sketch_accumulate.restype = i32
    lib.sketch_estimates.argtypes = [p, p, p, p, p, i32, i32, i32, i32, p]
    lib.sketch_estimates.restype = i32
    lib.sketch_estimates_max_rows.argtypes = []
    lib.sketch_estimates_max_rows.restype = i32
    lib.topk_count_ge.argtypes = [p, i64, p, p, i32, p]
    lib.topk_count_ge.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, kernel: Kernel) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _shift_args(v_dev, shift_q, shift_w, sign_keys, r, Tn):
    _check("shift_q", shift_q, torch.int32, (r, Tn), v_dev)
    _check("shift_w", shift_w, torch.int32, (r, Tn), v_dev)
    _check("sign_keys", sign_keys, torch.int32, (r,), v_dev)


def sketch_accumulate(v3: torch.Tensor, shift_q: torch.Tensor,
                      shift_w: torch.Tensor, sign_keys: torch.Tensor,
                      t0: int = 0) -> torch.Tensor:
    """``(Tn, S, 128)`` f32 chunks -> ``(r, S, 128)`` f32 table on the
    card (see ``ops/sketch.sketch_accumulate``)."""
    if v3.device.type != "cuda" or v3.ndim != 3:
        raise ValueError("sketch_accumulate: expected a (Tn, S, 128) CUDA "
                         f"tensor, got {tuple(v3.shape)} on {v3.device}")
    Tn, S, lanes = v3.shape
    r = shift_q.shape[0]
    _check("v3", v3, torch.float32, (Tn, S, 128), v3.device)
    _shift_args(v3.device, shift_q, shift_w, sign_keys, r, Tn)
    lib = library()
    with torch.cuda.device(v3.device):
        out = torch.empty((r, S, lanes), dtype=torch.float32,
                          device=v3.device)
        err = lib.sketch_accumulate(
            v3.data_ptr(), shift_q.data_ptr(), shift_w.data_ptr(),
            sign_keys.data_ptr(), out.data_ptr(), r, Tn, S * lanes, int(t0),
            torch.cuda.current_stream(v3.device).cuda_stream)
    _raise_on(err, SKETCH_ACCUMULATE)
    SKETCH_ACCUMULATE.launches += 1
    return out


def sketch_estimates(table3: torch.Tensor, shift_q: torch.Tensor,
                     shift_w: torch.Tensor, sign_keys: torch.Tensor,
                     t0: int = 0) -> torch.Tensor:
    """``(r, S, 128)`` f32 table -> ``(Tn, S, 128)`` f32 median-of-rows
    estimates on the card, ``Tn = shift_q.shape[1]``, with the FORWARD
    shift columns (see ``ops/sketch.sketch_estimates``)."""
    if table3.device.type != "cuda" or table3.ndim != 3:
        raise ValueError("sketch_estimates: expected an (r, S, 128) CUDA "
                         f"tensor, got {tuple(table3.shape)} on "
                         f"{table3.device}")
    r, S, lanes = table3.shape
    Tn = shift_q.shape[1]
    _check("table3", table3, torch.float32, (r, S, 128), table3.device)
    _shift_args(table3.device, shift_q, shift_w, sign_keys, r, Tn)
    lib = library()
    if not 1 <= r <= lib.sketch_estimates_max_rows():
        raise ValueError(f"sketch_estimates: r={r} rows not supported "
                         f"(1..{lib.sketch_estimates_max_rows()})")
    with torch.cuda.device(table3.device):
        out = torch.empty((Tn, S, lanes), dtype=torch.float32,
                          device=table3.device)
        err = lib.sketch_estimates(
            table3.data_ptr(), shift_q.data_ptr(), shift_w.data_ptr(),
            sign_keys.data_ptr(), out.data_ptr(), r, Tn, S * lanes, int(t0),
            torch.cuda.current_stream(table3.device).cuda_stream)
    _raise_on(err, SKETCH_ESTIMATES)
    SKETCH_ESTIMATES.launches += 1
    return out


def topk_count_ge(bits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """``counts[j] = #{i : mag(bits_i) >= ts[j]}`` for 16 int32 thresholds
    over flat int32 bit patterns, on the card (see ``ops/topk``)."""
    if bits.device.type != "cuda" or bits.ndim != 1:
        raise ValueError("topk_count_ge: expected a flat CUDA tensor, got "
                         f"{tuple(bits.shape)} on {bits.device}")
    _check("bits", bits, torch.int32, bits.shape, bits.device)
    _check("ts", ts, torch.int32, (16,), bits.device)
    lib = library()
    with torch.cuda.device(bits.device):
        out = torch.empty(16, dtype=torch.int32, device=bits.device)
        err = lib.topk_count_ge(
            bits.data_ptr(), bits.numel(), ts.data_ptr(), out.data_ptr(),
            _num_sms(bits.device.index if bits.device.index is not None
                     else torch.cuda.current_device()),
            torch.cuda.current_stream(bits.device).cuda_stream)
    _raise_on(err, TOPK_COUNT_GE)
    TOPK_COUNT_GE.launches += 1
    return out
