"""The port's ``commefficient_torch.scripts.native_bench`` on the CPU: its
``main`` at one timed epoch builds and loads the data plane's library,
holds the native and numpy loaders' first epoch equal (inside ``main``,
``check_batches_equal``), and returns both loader timings and the four
ImageNet transform timings, as the JAX script's ``main`` does."""

import numpy as np
import pytest

pytest.importorskip("torch")

from commefficient_torch.data_utils import FedCIFAR10  # noqa: E402
from commefficient_torch.data_utils.transforms import (  # noqa: E402
    cifar10_train_transforms,
)
from commefficient_torch.scripts import native_bench as nb  # noqa: E402


def test_main_returns_both_timings(tmp_path, capsys):
    results, speedup, imagenet = nb.main(
        ["--epochs", "1", "--data_dir", str(tmp_path / "cifar")])
    assert set(results) == {"python", "native"}
    for secs, rate in results.values():
        assert secs > 0 and rate > 0
    assert speedup == pytest.approx(results["python"][0]
                                    / results["native"][0])
    assert set(imagenet) == {"train_py", "train_native", "val_py",
                             "val_native"}
    assert all(v > 0 for v in imagenet.values())
    out = capsys.readouterr().out
    # the JAX script's lines, and the equality check before the timings
    for line in ("native == numpy:", "python  :", "native  :", "speedup:",
                 "imagenet speedup:", "imagenet.sh round shape (7x64)"):
        assert line in out, line
    assert out.index("native == numpy:") < out.index("python  :")


def test_native_and_numpy_batches_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "16")
    ds = FedCIFAR10(str(tmp_path), "CIFAR10",
                    transform=cifar10_train_transforms, train=True,
                    do_iid=True, num_clients=10)
    assert nb.check_batches_equal(ds) > 0
    # the check catches a wrong batch
    state = np.random.get_state()
    real = nb.FedLoader

    class Shifted(real):
        def __iter__(self):
            for b in super().__iter__():
                if self.use_native:
                    b = dict(b, inputs=b["inputs"] + 1e-3)
                yield b

    monkeypatch.setattr(nb, "FedLoader", Shifted)
    with pytest.raises(AssertionError):
        nb.check_batches_equal(ds)
    np.random.set_state(state)
