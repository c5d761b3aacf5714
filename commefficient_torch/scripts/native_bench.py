"""The host data plane's fused C++ batch assembly against the numpy
loader: the port's copy of the JAX package's ``scripts/native_bench.py``.

Two timings on the host (the data plane never touches the card):

- the port's ``FedLoader`` with ``use_native`` off against on, on
  synthetic CIFAR10 (500 images a class, 50 IID clients, 8 workers x 8
  images, the train transforms), the best of ``--epochs`` timed epochs
  after a warm one;
- the per-image ImageNet train and val transforms, the fused native call
  (``transforms.imagenet_*_transforms``) against the per-op numpy stacks
  (``imagenet_*_transforms_py``), on 32 images of 375 x 500 with the
  native call pinned to one thread (``COMMEFFICIENT_NATIVE_THREADS=1``).

Before it times anything it builds and loads ``csrc/feddata.cpp``
(``native.library()``, which raises on a failed build: there is no
numpy fallback), and it holds the two loaders' first epoch against each
other from the same seed (``atol=1e-5``, the tolerance of
``tests/test_torch_cv_data.py``).

    python -m commefficient_torch.scripts.native_bench [--epochs N]

The dataset is written to ``--data_dir`` (default: a temporary directory
removed at the end). Prints the JAX script's lines and returns its
results.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from commefficient_torch import native
from commefficient_torch.data_utils import FedCIFAR10, FedLoader
from commefficient_torch.data_utils.transforms import (
    cifar10_train_transforms,
    imagenet_train_transforms,
    imagenet_train_transforms_py,
    imagenet_val_transforms,
    imagenet_val_transforms_py,
)

PER_CLASS = 500
NUM_CLIENTS = 50
WORKERS, BATCH = 8, 8
BATCH_ATOL = 1e-5


def time_epochs(loader, n_epochs=3):
    """One warm epoch, then the best of ``n_epochs``: ``(seconds, images
    an epoch)``."""
    for _ in loader:
        pass
    times = []
    n = 0
    for _ in range(n_epochs):
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += batch["inputs"].shape[0] * batch["inputs"].shape[1]
        times.append(time.perf_counter() - t0)
    return min(times), n


def check_batches_equal(ds) -> int:
    """The numpy and native loaders' first epoch from seed 0: the same
    batches (inputs to ``BATCH_ATOL``, the rest exactly). Returns the
    number of batches compared."""
    epochs = []
    for use_native in (False, True):
        np.random.seed(0)
        loader = FedLoader(ds, num_workers=WORKERS, local_batch_size=BATCH,
                           use_native=use_native)
        assert loader.use_native == use_native
        epochs.append(list(loader))
    py, nat = epochs
    assert len(py) == len(nat) > 0
    for a, b in zip(py, nat):
        assert set(a) == set(b)
        for key in a:
            if key == "inputs":
                np.testing.assert_allclose(b[key], a[key], atol=BATCH_ATOL)
            else:
                np.testing.assert_array_equal(b[key], a[key])
    return len(py)


def bench_imagenet_transform():
    """Per-image ImageNet transforms, fused native against per-op numpy,
    at a decoded JPEG's size, the native call on one thread."""
    old = os.environ.get("COMMEFFICIENT_NATIVE_THREADS")
    os.environ["COMMEFFICIENT_NATIVE_THREADS"] = "1"
    try:
        rng = np.random.RandomState(0)
        imgs = [rng.randint(0, 256, (375, 500, 3)).astype(np.uint8)
                for _ in range(32)]
        out = {}
        for tag, fn in (("train_py", imagenet_train_transforms_py),
                        ("train_native", imagenet_train_transforms),
                        ("val_py", imagenet_val_transforms_py),
                        ("val_native", imagenet_val_transforms)):
            np.random.seed(0)
            for im in imgs[:4]:
                fn(im)  # warm
            np.random.seed(0)
            t0 = time.perf_counter()
            for im in imgs:
                fn(im)
            dt = (time.perf_counter() - t0) / len(imgs)
            out[tag] = dt
            print(f"imagenet {tag:13s}: {dt * 1e3:7.2f} ms/image "
                  f"({1 / dt:,.0f} images/sec)")
    finally:
        if old is None:
            os.environ.pop("COMMEFFICIENT_NATIVE_THREADS", None)
        else:
            os.environ["COMMEFFICIENT_NATIVE_THREADS"] = old
    tr = out["train_py"] / out["train_native"]
    va = out["val_py"] / out["val_native"]
    print(f"imagenet speedup: train {tr:.1f}x, val {va:.1f}x")
    # the imagenet.sh round: 7 workers x 64 images = 448 images a round
    rps = 1.0 / (448 * out["train_native"])
    print(f"imagenet.sh round shape (7x64): native host assembly supports "
          f"{rps:.1f} rounds/sec/thread")
    return out


def run(data_dir: str, epochs: int):
    """The JAX script's ``main``: ``(results, speedup, imagenet)``;
    ``results[key] = (seconds an epoch, images/sec)``."""
    lib = native.library()  # raises on a failed build: no numpy fallback
    print(f"native library: {lib._name}")
    old = os.environ.get("COMMEFFICIENT_SYNTHETIC_PER_CLASS")
    os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = str(PER_CLASS)
    try:
        ds = FedCIFAR10(data_dir, "CIFAR10",
                        transform=cifar10_train_transforms, train=True,
                        do_iid=True, num_clients=NUM_CLIENTS)
    finally:
        if old is None:
            os.environ.pop("COMMEFFICIENT_SYNTHETIC_PER_CLASS", None)
        else:
            os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = old
    n_checked = check_batches_equal(ds)
    print(f"native == numpy: {n_checked} batches of the first epoch "
          f"(atol {BATCH_ATOL})")
    results = {}
    for use_native in (False, True):
        np.random.seed(0)
        loader = FedLoader(ds, num_workers=WORKERS, local_batch_size=BATCH,
                           use_native=use_native)
        dt, n = time_epochs(loader, epochs)
        key = "native" if use_native else "python"
        results[key] = (dt, n / dt)
        print(f"{key:8s}: {dt:.3f}s/epoch, {n / dt:,.0f} images/sec")
    speedup = results["python"][0] / results["native"][0]
    print(f"speedup: {speedup:.1f}x")
    imagenet = bench_imagenet_transform()
    return results, speedup, imagenet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3,
                    help="timed epochs a loader, after a warm one "
                         "(default 3)")
    ap.add_argument("--data_dir", default="",
                    help="the synthetic CIFAR10 directory (default: a "
                         "temporary one)")
    args = ap.parse_args(argv)
    if args.data_dir:
        return run(args.data_dir, args.epochs)
    with tempfile.TemporaryDirectory(prefix="native_bench_") as d:
        return run(d, args.epochs)


if __name__ == "__main__":
    main()
