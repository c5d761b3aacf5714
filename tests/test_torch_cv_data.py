"""The port's FEMNIST and ImageNet data, its native batch plane and its
loaders against the JAX package on the CPU.

- The per-op FEMNIST and ImageNet stacks are the same numpy code drawing
  ``np.random`` in the same order: bit-equal to the JAX package's under
  one seed. The fused ImageNet stacks are held to the per-op stacks at the
  JAX package's atol 2e-4 (``tests/test_native.py``).
- ``_synthetic_leaf`` and ``_make_synthetic_tree`` write the same data.
- The native ``image_batch``, ``resized_crop`` and ``leaf_parse`` (built
  with ``g++`` into ``commefficient_torch/_build/``) against their numpy
  versions and ``json``, at ``tests/test_native.py``'s tolerances (1e-5
  and 2e-4: the library multiplies by 1/255 and 1/std where numpy
  divides), and bit-equal to the JAX package's own library, which is the
  same C++.
- The loader's native and numpy batches at atol 1e-5, with the same
  targets, masks and client ids exactly; the port's native batches equal
  the JAX package's native batches.
- ``PrefetchLoader``: the same batches, early exit, errors.
"""

import json
import os
import threading

import numpy as np
import pytest

from commefficient_tpu import native as jnative
from commefficient_tpu.data_utils import FedCIFAR10 as JCIFAR10
from commefficient_tpu.data_utils import FedEMNIST as JEMNIST
from commefficient_tpu.data_utils import FedImageNet as JImageNet
from commefficient_tpu.data_utils import FedLoader as JLoader
from commefficient_tpu.data_utils import fed_emnist as jfe
from commefficient_tpu.data_utils import fed_imagenet as jfi
from commefficient_tpu.data_utils import transforms as jtr
from commefficient_torch import native
from commefficient_torch.data_utils import (
    FedCIFAR10,
    FedEMNIST,
    FedImageNet,
    FedLoader,
    PrefetchLoader,
    fed_datasets,
)
from commefficient_torch.data_utils import fed_emnist as tfe
from commefficient_torch.data_utils import fed_imagenet as tfi
from commefficient_torch.data_utils import transforms as ttr

MEAN3 = np.array([0.49, 0.48, 0.44], np.float32)
STD3 = np.array([0.24, 0.24, 0.26], np.float32)


def test_dataset_registry():
    assert fed_datasets["EMNIST"] == 62 and fed_datasets["ImageNet"] == 1000


# -- transforms ---------------------------------------------------------


def _stack_pair(name):
    return getattr(jtr, name), getattr(ttr, name)


@pytest.mark.parametrize("name,shape,dtype", [
    ("femnist_train_transforms", (28, 28), np.float32),
    ("femnist_test_transforms", (28, 28), np.float32),
    ("imagenet_train_transforms_py", (90, 70, 3), np.uint8),
    ("imagenet_val_transforms_py", (300, 260, 3), np.uint8),
    ("cifar10_train_transforms", (32, 32, 3), np.uint8),
])
def test_per_op_stacks_bit_equal(name, shape, dtype):
    """The per-op stacks give the JAX package's images bit for bit under
    one ``np.random`` seed, and leave the generator in the same state."""
    jt, tt = _stack_pair(name)
    rng = np.random.RandomState(0)
    imgs = [(rng.rand(*shape) if dtype == np.float32 else
             rng.randint(0, 256, shape)).astype(dtype) for _ in range(4)]
    outs = []
    for stack in (jt, tt):
        np.random.seed(17)
        outs.append(np.stack([stack(im) for im in imgs]))
        outs.append(np.random.rand())
    assert outs[0].dtype == outs[2].dtype == np.float32
    np.testing.assert_array_equal(outs[2], outs[0])
    assert outs[3] == outs[1]


def test_femnist_rotation_fills_white():
    """The rotation's fill is 1.0 (white), before normalization."""
    rot = ttr.RandomRotation(5, fill=1.0)
    img = np.zeros((28, 28, 1), np.float32)
    np.random.seed(3)
    while True:  # an angle large enough to expose a corner
        out = rot(img)
        if (out == 1.0).any():
            break
    assert set(np.unique(out)) == {0.0, 1.0}


@pytest.mark.parametrize("shape", [(200, 150, 3), (64, 64, 3), (40, 90, 3)])
def test_fused_train_stack_matches_per_op(shape):
    """``FusedResizedCropFlip`` draws the per-op stack's ``np.random``
    sequence: the same crops and flips, pixels within 2e-4."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    for seed in range(4):
        np.random.seed(seed)
        fused = ttr.imagenet_train_transforms(img)
        after_fused = np.random.rand()
        np.random.seed(seed)
        ref = ttr.imagenet_train_transforms_py(img)
        assert np.random.rand() == after_fused
        assert fused.shape == (224, 224, 3)
        np.testing.assert_allclose(fused, ref, atol=2e-4)


@pytest.mark.parametrize("shape", [(300, 500, 3), (500, 300, 3),
                                   (256, 256, 3), (64, 64, 3)])
def test_fused_val_stack_matches_per_op(shape):
    rng = np.random.RandomState(10)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    fused = ttr.imagenet_val_transforms(img)
    ref = ttr.imagenet_val_transforms_py(img)
    assert fused.shape == (224, 224, 3)
    np.testing.assert_allclose(fused, ref, atol=2e-4)


def test_fused_stacks_equal_the_jax_package():
    """The fused stacks call the same C++ as the JAX package's: equal."""
    rng = np.random.RandomState(11)
    img = rng.randint(0, 256, (120, 90, 3)).astype(np.uint8)
    np.random.seed(5)
    j = jtr.imagenet_train_transforms(img)
    np.random.seed(5)
    t = ttr.imagenet_train_transforms(img)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(ttr.imagenet_val_transforms(img),
                                  jtr.imagenet_val_transforms(img))


# -- synthetic data ------------------------------------------------------


@pytest.mark.parametrize("clients,samples", [("6", "10"), ("3", "40")])
def test_synthetic_leaf_equal(monkeypatch, clients, samples):
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", clients)
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_SAMPLES", samples)
    assert tfe.SYNTHETIC_GEN_VERSION == jfe.SYNTHETIC_GEN_VERSION == 2
    jtrain, jtest = jfe._synthetic_leaf()
    ttrain, ttest = tfe._synthetic_leaf()
    assert jtrain == ttrain and jtest == ttest
    assert len(ttrain) == int(clients)


def test_synthetic_imagenet_tree_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "3")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "4")
    jfi._make_synthetic_tree(str(tmp_path / "j"))
    tfi._make_synthetic_tree(str(tmp_path / "t"))
    js = jfi._list_tree(str(tmp_path / "j" / "train"))
    ts = tfi._list_tree(str(tmp_path / "t" / "train"))
    assert len(ts) == 12
    assert [t for _, t in js] == [t for _, t in ts]
    for (jp, _), (tp, _) in zip(js, ts):
        assert os.path.relpath(jp, tmp_path / "j") == \
            os.path.relpath(tp, tmp_path / "t")
        np.testing.assert_array_equal(tfi._load_image(tp), np.load(jp))
    assert len(tfi._list_tree(str(tmp_path / "t" / "val"))) == 3


def test_load_image_names_pil_for_a_jpeg(tmp_path, monkeypatch):
    """A JPEG needs PIL; where PIL is missing the error says so."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        tfi._load_image(str(tmp_path / "x.JPEG"))


@pytest.fixture(scope="module")
def emnist_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("emnist")
    os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"] = "6"
    os.environ["COMMEFFICIENT_SYNTHETIC_SAMPLES"] = "10"
    try:
        JEMNIST(str(root / "j"), "EMNIST", train=True)
        FedEMNIST(str(root / "t"), "EMNIST", train=True)
    finally:
        del os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"]
        del os.environ["COMMEFFICIENT_SYNTHETIC_SAMPLES"]
    return str(root / "j"), str(root / "t")


def test_fed_emnist_store_equal(emnist_dirs):
    jd, td = emnist_dirs
    j = JEMNIST(jd, "EMNIST", train=True)
    t = FedEMNIST(td, "EMNIST", train=True)
    np.testing.assert_array_equal(t.client_images, j.client_images)
    np.testing.assert_array_equal(t.client_targets, j.client_targets)
    np.testing.assert_array_equal(t.client_offsets, j.client_offsets)
    assert t.num_clients == j.num_clients == 6
    jv = JEMNIST(jd, "EMNIST", train=False)
    tv = FedEMNIST(td, "EMNIST", train=False)
    np.testing.assert_array_equal(tv.native_val_access()["store"],
                                  jv.native_val_access()["store"])
    for i in (0, len(t) - 1):
        np.testing.assert_array_equal(t[i][1], j[i][1])
        assert t[i][0] == j[i][0] and t[i][2] == j[i][2]


def test_fed_emnist_reads_leaf_json(tmp_path):
    """A LEAF tree (one shard the native parser reads, one it rejects and
    ``json`` reads) gives the same store in both packages."""
    rng = np.random.RandomState(0)
    for root in ("j", "t"):
        for split in ("train", "test"):
            os.makedirs(tmp_path / root / split)

    def shard(users, n):
        data = {u: {"x": rng.rand(n, 784).round(4).tolist(),
                    "y": rng.randint(0, 62, n).tolist()} for u in users}
        return {"users": users, "num_samples": [n] * len(users),
                "user_data": data}

    files = {"train/a.json": json.dumps(shard(["u0", "u1"], 3)),
             # a non-ASCII escape: the native parser rejects the file
             "train/b.json": json.dumps(shard(["été"], 2)),
             "test/t.json": json.dumps(shard(["v0"], 4))}
    for root in ("j", "t"):
        for name, text in files.items():
            (tmp_path / root / name).write_text(text)
    assert native.leaf_parse(str(tmp_path / "t" / "train" / "b.json")) \
        is None
    j = JEMNIST(str(tmp_path / "j"), "EMNIST", train=True)
    t = FedEMNIST(str(tmp_path / "t"), "EMNIST", train=True)
    assert t.num_clients == 3
    np.testing.assert_array_equal(t.client_images, j.client_images)
    np.testing.assert_array_equal(t.client_targets, j.client_targets)
    tv = FedEMNIST(str(tmp_path / "t"), "EMNIST", train=False)
    assert len(tv) == 4


def test_fed_imagenet_items_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "3")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "4")
    j = JImageNet(str(tmp_path / "j"), "ImageNet",
                  jtr.imagenet_train_transforms, train=True)
    t = FedImageNet(str(tmp_path / "t"), "ImageNet",
                    ttr.imagenet_train_transforms, train=True)
    assert t.num_clients == j.num_clients == 3
    for i in range(len(t)):
        np.random.seed(i)
        ji = j[i]
        np.random.seed(i)
        ti = t[i]
        assert (ti[0], ti[2]) == (ji[0], ji[2])
        np.testing.assert_array_equal(ti[1], ji[1])
    v = FedImageNet(str(tmp_path / "t"), "ImageNet",
                    ttr.imagenet_val_transforms, train=False)
    assert len(v) == 3 and v[0][1].shape == (224, 224, 3)


# -- the native library ----------------------------------------------------


def test_native_builds_into_the_package():
    lib = native.build()
    assert lib.parent.name == "_build"
    assert lib.parent.parent.name == "commefficient_torch"


@pytest.mark.parametrize("src_kind", ["u8", "f32"])
def test_image_batch_matches_numpy(src_kind):
    rng = np.random.RandomState(0)
    if src_kind == "u8":
        src = rng.randint(0, 256, (20, 32, 32, 3)).astype(np.uint8)
    else:
        src = rng.rand(20, 32, 32, 3).astype(np.float32)
    idx = np.array([3, 5, -1, 7, 19], np.int64)
    ch = np.array([0, 4, 2, 8, 1], np.int32)
    cw = np.array([8, 0, 3, 4, 6], np.int32)
    fl = np.array([1, 0, 1, 0, 1], np.uint8)
    out = native.image_batch(src, idx, ch, cw, fl, 4, 32, MEAN3, STD3)
    ref = native._image_batch_np(src, idx, ch, cw, fl, 4, 32, MEAN3, STD3)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert np.all(out[2] == 0)
    jout = jnative.image_batch(src, idx, ch, cw, fl, 4, 32, MEAN3, STD3)
    np.testing.assert_array_equal(out, jout)


def test_image_batch_float_single_channel():
    """FEMNIST's val store: float32 (N, 28, 28), no pad or crop."""
    rng = np.random.RandomState(2)
    src = rng.rand(6, 28, 28).astype(np.float32)
    m, s = ttr.femnist_mean, ttr.femnist_std
    out = native.image_batch(src, np.array([1, 4], np.int64), None, None,
                             None, 0, 28, m, s)
    np.testing.assert_allclose(out, (src[[1, 4]][..., None] - m) / s,
                               atol=1e-5)


@pytest.mark.parametrize("box,flip,mode", [
    ((11, 23, 71, 93), False, 0), ((4, 4, 48, 60), True, 0),
    ((0, 0, 113, 157), False, 0), ((10.5, 3.25, 90.0, 120.0), False, 1)])
def test_resized_crop_matches_numpy(box, flip, mode):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (113, 157, 3)).astype(np.uint8)
    m, s = ttr.imagenet_mean, ttr.imagenet_std
    got = native.resized_crop(img, box, 224, 224, flip, m, s, clip_mode=mode)
    ref = native._resized_crop_np(img, box, 224, 224, flip, m, s, mode)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_array_equal(
        got, jnative.resized_crop(img, box, 224, 224, flip, m, s,
                                  clip_mode=mode))


def test_resized_crop_rejects_a_box_outside():
    img = np.zeros((10, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.resized_crop(img, (5, 5, 8, 8), 4, 4, False, MEAN3, STD3)


def test_leaf_parse_matches_json(tmp_path):
    leaf = {"users": ["u0", "u1"], "num_samples": [2, 3],
            "user_data": {
                "u0": {"x": [[0.1] * 4, [0.2] * 4], "y": [1, 5]},
                "u1": {"x": [[0.3] * 4, [0.4] * 4, [0.5] * 4],
                       "y": [2, 0, 61]}}}
    p = tmp_path / "shard.json"
    p.write_text(json.dumps(leaf))
    users, x, y, offsets = native.leaf_parse(str(p))
    assert users == ["u0", "u1"]
    assert offsets.tolist() == [0, 2, 5]
    assert y.tolist() == [1, 5, 2, 0, 61]
    want = np.asarray(leaf["user_data"]["u0"]["x"]
                      + leaf["user_data"]["u1"]["x"], np.float32)
    np.testing.assert_array_equal(x, want)
    (tmp_path / "bad.json").write_text("{not json at all")
    assert native.leaf_parse(str(tmp_path / "bad.json")) is None


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises."""
    bad = tmp_path / "feddata.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# -- loaders ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cifar_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = "20"
    try:
        JCIFAR10(str(root / "j"), "CIFAR10", train=True)
        FedCIFAR10(str(root / "t"), "CIFAR10", train=True)
    finally:
        del os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"]
    return str(root / "j"), str(root / "t")


def _cifar_batches(cls, loader_cls, tr, d, use_native, train, n=3):
    np.random.seed(7)
    if train:
        ds = cls(d, "CIFAR10", tr.cifar10_train_transforms, True, 4,
                 train=True, seed=3)
        loader = loader_cls(ds, num_workers=3, local_batch_size=5,
                            use_native=use_native)
    else:
        ds = cls(d, "CIFAR10", tr.cifar10_test_transforms, train=False)
        loader = loader_cls(ds, val_batch_size=7, use_native=use_native)
    np.random.seed(11)
    out = [b for _, b in zip(range(n), loader)]
    return out, np.random.rand()


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_loader_native_matches_numpy(cifar_dirs, train):
    """The native path draws the per-item path's ``np.random`` sequence:
    the same batches to atol 1e-5, targets, masks and client ids exactly,
    and the generator left in the same state."""
    _, td = cifar_dirs
    a, ra = _cifar_batches(FedCIFAR10, FedLoader, ttr, td, False, train)
    b, rb = _cifar_batches(FedCIFAR10, FedLoader, ttr, td, True, train)
    assert ra == rb
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if k == "inputs":
                np.testing.assert_allclose(y[k], x[k], atol=1e-5)
            else:
                assert y[k].dtype == x[k].dtype, k
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_loader_native_equals_jax_native(cifar_dirs, train):
    jd, td = cifar_dirs
    a, _ = _cifar_batches(JCIFAR10, JLoader, jtr, jd, True, train)
    b, _ = _cifar_batches(FedCIFAR10, FedLoader, ttr, td, True, train)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)


def test_loader_takes_native_where_it_can(cifar_dirs, emnist_dirs):
    _, td = cifar_dirs
    train = FedCIFAR10(td, "CIFAR10", ttr.cifar10_train_transforms, True, 4,
                       train=True)
    assert FedLoader(train, 2, 4).use_native
    _, ed = emnist_dirs
    etrain = FedEMNIST(ed, "EMNIST", ttr.femnist_train_transforms)
    # FEMNIST's train stack (crops, resized crops, rotations) is per item
    assert not FedLoader(etrain, 2, 4).use_native
    with pytest.raises(ValueError, match="use_native"):
        FedLoader(etrain, 2, 4, use_native=True)
    etest = FedEMNIST(ed, "EMNIST", ttr.femnist_test_transforms,
                      train=False)
    assert FedLoader(etest, val_batch_size=8).use_native


def test_femnist_loaders_equal_jax(emnist_dirs):
    """FEMNIST's train (per item) and val (native) batches equal the JAX
    package's under one seed."""
    jd, td = emnist_dirs
    got = []
    for cls, loader_cls, tr, d in ((JEMNIST, JLoader, jtr, jd),
                                   (FedEMNIST, FedLoader, ttr, td)):
        np.random.seed(2)
        train = cls(d, "EMNIST", tr.femnist_train_transforms, False, None,
                    train=True)
        test = cls(d, "EMNIST", tr.femnist_test_transforms, train=False)
        tl = loader_cls(train, 3, 4)
        vl = loader_cls(test, val_batch_size=5)
        got.append([b for _, b in zip(range(3), tl)] + list(vl))
    assert len(got[0]) == len(got[1])
    for x, y in zip(*got):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)


def test_prefetch_same_batches(cifar_dirs):
    _, td = cifar_dirs
    ds = FedCIFAR10(td, "CIFAR10", ttr.cifar10_test_transforms, train=False)
    loader = FedLoader(ds, val_batch_size=16)
    direct = list(loader)
    pre = PrefetchLoader(loader, depth=2)
    assert len(pre) == len(loader)
    assert pre.val_batch_size == 16  # attributes pass through
    fetched = list(pre)
    assert len(direct) == len(fetched)
    for a, b in zip(direct, fetched):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_train_batches_in_order(emnist_dirs):
    """The producer thread draws ``np.random`` in the loader's order: the
    train batches equal the direct loader's under one seed."""
    _, td = emnist_dirs
    out = []
    for wrap in (lambda x: x, PrefetchLoader):
        np.random.seed(4)
        ds = FedEMNIST(td, "EMNIST", ttr.femnist_train_transforms)
        out.append(list(wrap(FedLoader(ds, 2, 4))))
    assert len(out[0]) == len(out[1]) > 1
    for a, b in zip(*out):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_early_exit_reaps_producer(cifar_dirs):
    _, td = cifar_dirs
    ds = FedCIFAR10(td, "CIFAR10", ttr.cifar10_test_transforms, train=False)
    loader = FedLoader(ds, val_batch_size=4)
    before = threading.active_count()
    for _ in PrefetchLoader(loader, depth=1):
        break
    assert threading.active_count() <= before


def test_prefetch_propagates_errors():
    class Boom:
        def __iter__(self):
            yield {"x": 1}
            raise RuntimeError("boom")

        def __len__(self):
            return 2

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in PrefetchLoader(Boom()):
            got.append(b)
    assert got == [{"x": 1}]
