"""ctypes bindings of the port's host data plane (``csrc/feddata.cpp``),
modelled on ``commefficient_tpu/native/__init__.py``.

``image_batch`` (the loader's fused pad/crop/flip/normalize of a round's
images from a contiguous store), ``resized_crop`` (the fused ImageNet
crop, bilinear resize, flip and normalize of one image) and
``leaf_parse`` (a LEAF FEMNIST shard). The library is compiled with
``g++`` at first use into ``_build/`` beside this file (keyed on a hash of
the source and the flags; nothing is built at import) and loaded with
``ctypes``, which releases the GIL for each call, so ``PrefetchLoader``'s
thread overlaps batch assembly with device work.

There is no quiet fallback: a failed build raises. ``_image_batch_np``
and ``_resized_crop_np`` are the plain numpy versions, which the tests
hold the library against (the JAX package's tolerances). ``leaf_parse``
returns None for a file its restricted-schema parser rejects; the caller
then reads that file with ``json`` (a data-format path, not a build
failure).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["image_batch", "leaf_parse", "library", "resized_crop"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "feddata.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build() -> Path:
    """Compile the library if this source has no build yet (an atomic
    rename, so concurrent builds agree). Raises on a failed build."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    lib = BUILD_DIR / f"libfeddata_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = Path(tmp) / lib.name
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp_lib)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded data-plane library (built at first call)."""
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ll, i, f, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, \
        ctypes.c_void_p
    lib.fd_image_batch.restype = None
    lib.fd_image_batch.argtypes = [
        vp, i, ll, i, i, i, i64p, vp, vp, vp, ll, i, i, f32p, f32p, f32p, i]
    lib.fd_resized_crop.restype = None
    lib.fd_resized_crop.argtypes = [
        vp, i, i, i, i, f, f, f, f, i, i, i, i, f32p, f32p, f32p, i]
    lib.fd_leaf_open.restype = ll
    lib.fd_leaf_open.argtypes = [ctypes.c_char_p]
    lib.fd_leaf_counts.restype = None
    lib.fd_leaf_counts.argtypes = [ll] + [ctypes.POINTER(ll)] * 4
    lib.fd_leaf_names.restype = None
    lib.fd_leaf_names.argtypes = [ll, ctypes.c_char_p]
    lib.fd_leaf_fill.restype = None
    lib.fd_leaf_fill.argtypes = [ll, f32p, i64p, i64p]
    lib.fd_leaf_close.restype = None
    lib.fd_leaf_close.argtypes = [ll]
    return lib


def _nthreads() -> int:
    return int(os.environ.get("COMMEFFICIENT_NATIVE_THREADS", 0))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def image_batch(src, indices, crop_h, crop_w, flip, pad, size, mean, std):
    """Fused pad/crop/flip/normalize batch assembly.

    src: (N, H, W, C) uint8 or float32. indices: (M,) int64, -1 -> an
    all-zero slot. crop_h/crop_w: (M,) top-left of each crop in the
    reflect-padded image (None: 0); flip: (M,) nonzero -> horizontal flip
    (None: none). Returns (M, size, size, C) float32."""
    src = np.ascontiguousarray(src)
    if src.ndim == 3:
        src = src[..., None]
    if src.dtype not in (np.uint8, np.float32):
        raise TypeError(f"image_batch takes uint8 or float32, not "
                        f"{src.dtype}")
    N, H, W, C = src.shape
    indices = np.ascontiguousarray(indices, np.int64)
    M = indices.shape[0]
    mean = np.ascontiguousarray(np.broadcast_to(mean, (C,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (C,)), np.float32)
    ch = None if crop_h is None else np.ascontiguousarray(crop_h, np.int32)
    cw = None if crop_w is None else np.ascontiguousarray(crop_w, np.int32)
    fl = None if flip is None else np.ascontiguousarray(flip, np.uint8)
    out = np.empty((M, size, size, C), np.float32)
    library().fd_image_batch(
        _ptr(src), int(src.dtype == np.uint8), N, H, W, C, indices,
        _ptr(ch), _ptr(cw), _ptr(fl), M, int(pad), int(size), mean, std,
        out, _nthreads())
    return out


def resized_crop(img, box, out_h, out_w, flip, mean, std, clip_mode=0):
    """Fused crop/bilinear-resize/flip/normalize of one HWC image.

    box: (by, bx, bh, bw) in source coordinates. clip_mode 0:
    crop-then-resize of an integral box (train); 1: the resize-then-crop
    affine sampling (val). Returns (out_h, out_w, C) float32."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resized_crop takes uint8 or float32, not "
                        f"{img.dtype}")
    H, W, C = img.shape
    by, bx, bh, bw = (float(v) for v in box)
    if clip_mode == 0 and not (0 <= by and 0 <= bx and by + bh <= H
                               and bx + bw <= W and bh >= 1 and bw >= 1):
        # the window-clip path offsets by the box origin with no image
        # bounds check: an out-of-range box would read out of bounds
        raise ValueError(f"crop box {box} outside image ({H}, {W})")
    mean = np.ascontiguousarray(np.broadcast_to(mean, (C,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (C,)), np.float32)
    out = np.empty((out_h, out_w, C), np.float32)
    library().fd_resized_crop(
        _ptr(img), int(img.dtype == np.uint8), H, W, C, by, bx, bh, bw,
        int(clip_mode), int(out_h), int(out_w), int(bool(flip)), mean, std,
        out, _nthreads())
    return out


def _resized_crop_np(img, box, out_h, out_w, flip, mean, std, clip_mode):
    """The plain numpy version of ``resized_crop``."""
    from commefficient_torch.data_utils.transforms import _resize_bilinear

    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    by, bx, bh, bw = box
    f = img.astype(np.float32)
    if img.dtype == np.uint8:
        f = f / 255.0
    if clip_mode == 0:
        crop = f[int(by):int(by) + int(bh), int(bx):int(bx) + int(bw)]
        out = _resize_bilinear(crop, out_h, out_w)
    else:
        H, W = f.shape[:2]
        ys = (np.arange(out_h) + 0.5) * bh / out_h - 0.5 + by
        xs = (np.arange(out_w) + 0.5) * bw / out_w - 0.5 + bx
        y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
        y1 = np.clip(y0 + 1, 0, H - 1)
        x1 = np.clip(x0 + 1, 0, W - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        out = (f[y0][:, x0] * (1 - wy) * (1 - wx)
               + f[y0][:, x1] * (1 - wy) * wx
               + f[y1][:, x0] * wy * (1 - wx)
               + f[y1][:, x1] * wy * wx)
    if flip:
        out = out[:, ::-1]
    return ((out - mean) / std).astype(np.float32)


def _image_batch_np(src, indices, crop_h, crop_w, flip, pad, size, mean,
                    std):
    """The plain numpy version of ``image_batch``."""
    src = np.asarray(src)
    if src.ndim == 3:
        src = src[..., None]
    M = indices.shape[0]
    C = src.shape[-1]
    out = np.zeros((M, size, size, C), np.float32)
    for m in range(M):
        idx = int(indices[m])
        if idx < 0:
            continue
        img = src[idx]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        else:
            img = img.astype(np.float32)
        if pad:
            img = np.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                         mode="reflect")
        h = int(crop_h[m]) if crop_h is not None else 0
        w = int(crop_w[m]) if crop_w is not None else 0
        img = img[h:h + size, w:w + size]
        if flip is not None and flip[m]:
            img = img[:, ::-1]
        out[m] = (img - mean) / std
    return out


def leaf_parse(path):
    """Parse one LEAF shard json: ``(users, x, y, offsets)`` with users in
    file order, x (total, feat) float32, y (total,) int64, offsets
    (n_users + 1,) int64; None when the restricted-schema parser rejects
    the file (the caller reads it with ``json``)."""
    lib = library()
    h = lib.fd_leaf_open(str(path).encode())
    if h < 0:
        return None
    try:
        n_users, total, feat, name_bytes = (ctypes.c_longlong()
                                            for _ in range(4))
        lib.fd_leaf_counts(h, ctypes.byref(n_users), ctypes.byref(total),
                           ctypes.byref(feat), ctypes.byref(name_bytes))
        if n_users.value <= 0:
            return None
        namebuf = ctypes.create_string_buffer(max(1, name_bytes.value))
        lib.fd_leaf_names(h, namebuf)
        users = namebuf.raw[:name_bytes.value].decode(
            "utf-8", "replace").split("\n")
        if len(users) != n_users.value:
            return None
        x = np.empty((total.value, feat.value), np.float32)
        y = np.empty((total.value,), np.int64)
        offsets = np.empty((n_users.value + 1,), np.int64)
        lib.fd_leaf_fill(h, x.reshape(-1), y, offsets)
        return users, x, y, offsets
    finally:
        lib.fd_leaf_close(h)
