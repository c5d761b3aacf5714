"""Build, bind and count the port's CUDA kernels.

The six kernels of the sketched round live in two sources under ``csrc/``
(``sketch_kernels.cu``: the accumulate from a zero or an incoming table and
the fused server epilogue, three instantiations of one loop body, the
median query with the tail mask and the top-k count pass;
``topk_descent.cu``), each with a plain ``extern "C"`` interface and the
helpers of ``csrc/sketch_common.cuh``. At first use each source is
compiled by its own ``nvcc`` for ``sm_90a`` (all started together), the
objects are linked into one shared library in ``_build/`` beside this file
(keyed on a hash of the sources and the flags, so an edited source
rebuilds), and the library is loaded with ``ctypes``. Nothing is compiled
or loaded at import: the CPU tests import every module.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
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
from typing import Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "sketch_kernels.cu", CSRC / "topk_descent.cu")
HEADERS = (CSRC / "sketch_common.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Kernel:
    """One kernel of the library and its launch count."""

    name: str
    source: str    # path in the repo
    replaces: str  # the TPU kernel it ports, file:line of its def
    launches: int = 0


_SKETCH_CU = "commefficient_torch/csrc/sketch_kernels.cu"
SKETCH_ACCUMULATE = Kernel(
    "sketch_accumulate", _SKETCH_CU,
    "commefficient_tpu/ops/sketch.py:275 (_sketch_vec_pallas)")
SKETCH_ACCUMULATE_INTO = Kernel(
    "sketch_accumulate_into", _SKETCH_CU,
    "commefficient_tpu/ops/sketch.py:563 (_accum_pallas_call)")
SKETCH_ESTIMATES = Kernel(
    "sketch_estimates", _SKETCH_CU,
    "commefficient_tpu/ops/sketch.py:891 (_estimates_pallas)")
FUSED_EPILOGUE = Kernel(
    "fused_epilogue", _SKETCH_CU,
    "commefficient_tpu/ops/sketch.py:1118 (_fused_epilogue_pallas)")
TOPK_COUNT_GE = Kernel(
    "topk_count_ge", _SKETCH_CU,
    "commefficient_tpu/ops/topk.py:96 (_count_ge_pallas)")
TOPK_DESCENT = Kernel(
    "topk_descent", "commefficient_torch/csrc/topk_descent.cu",
    "commefficient_tpu/ops/topk.py:136 (_descent_pallas)")
# in the order of the TPU kernels they replace
KERNELS: Tuple[Kernel, ...] = (SKETCH_ACCUMULATE, SKETCH_ACCUMULATE_INTO,
                               SKETCH_ESTIMATES, FUSED_EPILOGUE,
                               TOPK_COUNT_GE, TOPK_DESCENT)


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
    """Compile the kernel library if these sources have no build yet: one
    ``nvcc -c`` per source, all running at once, then one link. Returns
    ``(library path, compiler output)``; the output holds ``ptxas``'s
    register, shared-memory and spill summary of every kernel."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    lib = BUILD_DIR / f"libsketch_kernels_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / (src.stem + ".o")) for src in SOURCES]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(SOURCES, objs)]
            text = "".join(f"== {src.name}\n{proc.communicate()[0]}"
                           for src, proc in zip(SOURCES, procs))
            tmp_lib = Path(tmp) / lib.name
            failed = any(proc.returncode for proc in procs)
            if not failed:
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp_lib), *objs],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                text += link.stdout
                failed = link.returncode != 0
            if failed:
                raise RuntimeError(f"nvcc failed:\n{text}")
            log.write_text(text)
            os.replace(tmp_lib, lib)
    return lib, (log.read_text() if log.exists() else "")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sketch_accumulate.argtypes = [p, p, p, p, p, i32, i32, i32, i32, p]
    lib.sketch_accumulate.restype = i32
    lib.sketch_estimates.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i64,
                                     p]
    lib.sketch_estimates.restype = i32
    lib.sketch_estimates_max_rows.argtypes = []
    lib.sketch_estimates_max_rows.restype = i32
    lib.topk_count_ge.argtypes = [p, i64, p, p, p, i32, p]
    lib.topk_count_ge.restype = i32
    lib.sketch_accumulate_into.argtypes = [p, p, i32, i32, p, p, p, p, i32,
                                           i32, i32, i32, p]
    lib.sketch_accumulate_into.restype = i32
    lib.fused_epilogue.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32,
                                   p]
    lib.fused_epilogue.restype = i32
    lib.topk_descent.argtypes = [p, i64, i32, p, p, i32, p]
    lib.topk_descent.restype = i32
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
                     t0: int = 0, n_valid: Optional[int] = None
                     ) -> torch.Tensor:
    """``(r, S, 128)`` f32 table -> ``(Tn, S, 128)`` f32 median-of-rows
    estimates on the card, ``Tn = shift_q.shape[1]``, with the FORWARD
    shift columns (see ``ops/sketch.sketch_estimates``). Positions whose
    global coordinate ``(t0 + t) * S * 128 + p`` is ``>= n_valid`` are
    written as +0.0 (``None``: none are)."""
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
    if n_valid is None:
        n_valid = (t0 + Tn) * S * lanes
    if n_valid < 0:
        raise ValueError(f"sketch_estimates: n_valid={n_valid} < 0")
    with torch.cuda.device(table3.device):
        out = torch.empty((Tn, S, lanes), dtype=torch.float32,
                          device=table3.device)
        err = lib.sketch_estimates(
            table3.data_ptr(), shift_q.data_ptr(), shift_w.data_ptr(),
            sign_keys.data_ptr(), out.data_ptr(), r, Tn, S * lanes, int(t0),
            int(n_valid), torch.cuda.current_stream(table3.device).cuda_stream)
    _raise_on(err, SKETCH_ESTIMATES)
    SKETCH_ESTIMATES.launches += 1
    return out


# The count pass's scratch on each (device, stream): 16 running totals and
# the last block's ticket, zeroed once here; every launch leaves it zero.
_COUNT_SCRATCH: dict = {}


def _count_scratch(index: int, stream) -> torch.Tensor:
    key = (index, stream.cuda_stream)
    buf = _COUNT_SCRATCH.get(key)
    if buf is None:
        buf = _COUNT_SCRATCH[key] = torch.zeros(17, dtype=torch.int32,
                                                device=f"cuda:{index}")
    return buf


def topk_count_ge(bits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """``counts[j] = #{i : mag(bits_i) >= ts[j]}`` for any 16 int32
    thresholds over fewer than 2**31 flat int32 bit patterns, on the card,
    in one launch (see ``ops/topk``). ``bits`` may be a view at any 4-byte
    offset."""
    if bits.device.type != "cuda" or bits.ndim != 1:
        raise ValueError("topk_count_ge: expected a flat CUDA tensor, got "
                         f"{tuple(bits.shape)} on {bits.device}")
    _check("bits", bits, torch.int32, bits.shape, bits.device)
    _check("ts", ts, torch.int32, (16,), bits.device)
    if bits.numel() >= 2**31:
        raise ValueError(f"topk_count_ge: {bits.numel()} patterns, at most "
                         "2**31 - 1")
    lib = library()
    index = (bits.device.index if bits.device.index is not None
             else torch.cuda.current_device())
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        out = torch.empty(16, dtype=torch.int32, device=bits.device)
        err = lib.topk_count_ge(
            bits.data_ptr(), bits.numel(), ts.data_ptr(), out.data_ptr(),
            _count_scratch(index, stream).data_ptr(), _num_sms(index),
            stream.cuda_stream)
    _raise_on(err, TOPK_COUNT_GE)
    TOPK_COUNT_GE.launches += 1
    return out


def _launch_into(tbl3: torch.Tensor, v: torch.Tensor, lpad: int,
                 shift_q: torch.Tensor, shift_w: torch.Tensor,
                 sign_keys: torch.Tensor, t0: int) -> torch.Tensor:
    """One launch of the running accumulate: a new ``(r, S, 128)`` table,
    ``tbl3`` plus the sketch of the flat ``v`` read in place as the
    coordinates from position ``lpad`` of chunk ``t0`` on."""
    r, S, lanes = tbl3.shape
    Tn = shift_q.shape[1]
    _shift_args(tbl3.device, shift_q, shift_w, sign_keys, r, Tn)
    c_pad = S * lanes
    n = v.numel()
    if not (0 <= lpad < c_pad and lpad + n <= Tn * c_pad
            and Tn * c_pad < 2**31):
        raise ValueError(f"sketch_accumulate_into: {n} coordinates from "
                         f"position {lpad} do not fit {Tn} chunks of {c_pad}")
    lib = library()
    with torch.cuda.device(tbl3.device):
        out = torch.empty_like(tbl3)
        err = lib.sketch_accumulate_into(
            tbl3.data_ptr(), v.data_ptr(), int(lpad), n, shift_q.data_ptr(),
            shift_w.data_ptr(), sign_keys.data_ptr(), out.data_ptr(), r, Tn,
            c_pad, int(t0),
            torch.cuda.current_stream(tbl3.device).cuda_stream)
    _raise_on(err, SKETCH_ACCUMULATE_INTO)
    SKETCH_ACCUMULATE_INTO.launches += 1
    return out


def sketch_accumulate_into(tbl3: torch.Tensor, v3: torch.Tensor,
                           shift_q: torch.Tensor, shift_w: torch.Tensor,
                           sign_keys: torch.Tensor,
                           t0: int = 0) -> torch.Tensor:
    """``(r, S, 128)`` f32 table plus the sketch of ``(Tn, S, 128)`` f32
    chunks, each cell's adds continuing the table's fold, on the card (see
    ``ops/sketch.sketch_accumulate_into``). Returns a new table."""
    if tbl3.device.type != "cuda" or tbl3.ndim != 3 or v3.ndim != 3:
        raise ValueError("sketch_accumulate_into: expected an (r, S, 128) "
                         "CUDA table and (Tn, S, 128) chunks, got "
                         f"{tuple(tbl3.shape)} on {tbl3.device} and "
                         f"{tuple(v3.shape)}")
    r, S, _ = tbl3.shape
    _check("tbl3", tbl3, torch.float32, (r, S, 128), tbl3.device)
    _check("v3", v3, torch.float32, (shift_q.shape[1], S, 128), tbl3.device)
    return _launch_into(tbl3, v3, 0, shift_q, shift_w, sign_keys, t0)


def sketch_segment_into(tbl3: torch.Tensor, seg: torch.Tensor, lpad: int,
                        shift_q: torch.Tensor, shift_w: torch.Tensor,
                        sign_keys: torch.Tensor,
                        t0: int = 0) -> torch.Tensor:
    """The running accumulate of a segment read in place: ``(r, S, 128)``
    f32 table plus the sketch of the flat f32 ``seg``, whose first
    coordinate is position ``lpad`` of chunk ``t0``; the ``Tn`` chunks of
    the shift columns cover it and their positions outside it add ``sign *
    0.0`` (see ``ops/sketch.sketch_segment_into``). The same kernel as
    ``sketch_accumulate_into``, counted as its launch. Returns a new
    table."""
    if tbl3.device.type != "cuda" or tbl3.ndim != 3 or seg.ndim != 1:
        raise ValueError("sketch_segment_into: expected an (r, S, 128) CUDA "
                         "table and a flat segment, got "
                         f"{tuple(tbl3.shape)} on {tbl3.device} and "
                         f"{tuple(seg.shape)}")
    r, S, _ = tbl3.shape
    _check("tbl3", tbl3, torch.float32, (r, S, 128), tbl3.device)
    _check("seg", seg, torch.float32, seg.shape, tbl3.device)
    return _launch_into(tbl3, seg, lpad, shift_q, shift_w, sign_keys, t0)


def fused_epilogue(est3: torch.Tensor, p: torch.Tensor,
                   shift_q: torch.Tensor, shift_w: torch.Tensor,
                   sign_keys: torch.Tensor, t0: int = 0):
    """``(Tn, S, 128)`` f32 estimates and the int32 threshold pattern ``p``
    (one element, on the card) -> ``(update (Tn, S, 128), table (r, S,
    128))`` (see ``ops/sketch.fused_epilogue``)."""
    if est3.device.type != "cuda" or est3.ndim != 3:
        raise ValueError("fused_epilogue: expected a (Tn, S, 128) CUDA "
                         f"tensor, got {tuple(est3.shape)} on {est3.device}")
    Tn, S, lanes = est3.shape
    r = shift_q.shape[0]
    _check("est3", est3, torch.float32, (Tn, S, 128), est3.device)
    _check("p", p.reshape(1), torch.int32, (1,), est3.device)
    _shift_args(est3.device, shift_q, shift_w, sign_keys, r, Tn)
    lib = library()
    with torch.cuda.device(est3.device):
        update = torch.empty_like(est3)
        table = torch.empty((r, S, lanes), dtype=torch.float32,
                            device=est3.device)
        err = lib.fused_epilogue(
            est3.data_ptr(), p.reshape(1).data_ptr(), shift_q.data_ptr(),
            shift_w.data_ptr(), sign_keys.data_ptr(), update.data_ptr(),
            table.data_ptr(), r, Tn, S * lanes, int(t0),
            torch.cuda.current_stream(est3.device).cuda_stream)
    _raise_on(err, FUSED_EPILOGUE)
    FUSED_EPILOGUE.launches += 1
    return update, table


def topk_descent(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest magnitude's int32 bit pattern of flat int32 bit
    patterns (0 when there are fewer than k), a 3-pass histogram radix
    select in one cooperative launch, as a 0-d int32 tensor on the card
    (see ``ops/topk.topk_descent``). ``bits`` may be a view at any 4-byte
    offset."""
    if bits.device.type != "cuda" or bits.ndim != 1:
        raise ValueError("topk_descent: expected a flat CUDA tensor, got "
                         f"{tuple(bits.shape)} on {bits.device}")
    _check("bits", bits, torch.int32, bits.shape, bits.device)
    if not 1 <= int(k) < 2**31:
        raise ValueError(f"topk_descent: k={k} out of range")
    lib = library()
    with torch.cuda.device(bits.device):
        hist = torch.empty(4096, dtype=torch.int32, device=bits.device)
        out = torch.empty(1, dtype=torch.int32, device=bits.device)
        err = lib.topk_descent(
            bits.data_ptr(), bits.numel(), int(k), hist.data_ptr(),
            out.data_ptr(),
            _num_sms(bits.device.index if bits.device.index is not None
                     else torch.cuda.current_device()),
            torch.cuda.current_stream(bits.device).cuda_stream)
    _raise_on(err, TOPK_DESCENT)
    TOPK_DESCENT.launches += 1
    return out.reshape(())
