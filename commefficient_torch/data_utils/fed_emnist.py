"""FedEMNIST: LEAF FEMNIST, natural clients (3,500 in the full split). The
port's own copy of ``commefficient_tpu/data_utils/fed_emnist.py``: the
same files on disk and the same synthetic data for the same settings.

``prepare_datasets`` parses LEAF json shards (``train/*.json`` /
``test/*.json`` with ``users`` / ``user_data`` keys) into per-client
``.npz`` files; training concatenates all clients into single arrays plus
offsets. Images are float32 28 x 28 in [0, 1] as LEAF emits them.

Zero-egress fallback: when no LEAF json is present, a deterministic
synthetic FEMNIST-like dataset is generated
(``COMMEFFICIENT_SYNTHETIC_CLIENTS`` clients, default 100;
``COMMEFFICIENT_SYNTHETIC_SAMPLES`` mean samples a client, default 40;
class-conditional smooth strokes, 62 classes), read at prepare time.
"""

from __future__ import annotations

import json
import os

import numpy as np

from commefficient_torch.data_utils.fed_dataset import FedDataset

__all__ = ["FedEMNIST"]


def _read_leaf_dir(data_dir):
    """Parse all LEAF shard jsons in ``data_dir`` -> {user: {"x": (n, feat)
    float32, "y": (n,) int64}}: the native parser
    (``commefficient_torch.native.leaf_parse``), and the stdlib ``json``
    for a file it rejects."""
    from commefficient_torch import native

    data = {}
    if not os.path.isdir(data_dir):
        return data
    for f in sorted(os.listdir(data_dir)):
        if not f.endswith(".json"):
            continue
        path = os.path.join(data_dir, f)
        parsed = native.leaf_parse(path)
        if parsed is not None:
            users, x, y, offsets = parsed
            # keyed by username, last-wins — same merge semantics as the
            # json fallback's dict.update
            for u, name in enumerate(users):
                lo, hi = int(offsets[u]), int(offsets[u + 1])
                data[name] = {"x": x[lo:hi], "y": y[lo:hi]}
        else:
            with open(path, "rb") as inf:
                cdata = json.loads(inf.read())
            data.update(cdata["user_data"])
    return data


# bump when _synthetic_leaf / _smooth_protos change what they generate:
# consumers (commefficient_torch/scripts/femnist_ablation.py) fingerprint
# their prepared-data cache dirs with it, since FedDataset.prepare keeps
# existing client files
SYNTHETIC_GEN_VERSION = 2


def _bilinear_upsample(p, size):
    """(n, h, h) -> (n, size, size) bilinear resize, pure numpy."""
    n, h, w = p.shape
    assert h == w, f"square inputs only (the sample grid is shared): {p.shape}"
    xs = np.linspace(0, h - 1, size)
    i0 = np.floor(xs).astype(np.int64)
    i1 = np.minimum(i0 + 1, h - 1)
    f = (xs - i0).astype(np.float32)
    rows = p[:, i0, :] * (1 - f)[None, :, None] \
        + p[:, i1, :] * f[None, :, None]
    out = rows[:, :, i0] * (1 - f)[None, None, :] \
        + rows[:, :, i1] * f[None, None, :]
    return out


def _smooth_protos(rng, n_classes=62, size=28, lo_res=7):
    """Class prototypes that behave like handwriting under the reference's
    FEMNIST augmentation recipe (RandomCrop/RandomResizedCrop/rotation with
    white fill, transforms.py): spatially SMOOTH dark strokes on a white
    background, fading to white at the borders. The original fallback used
    per-pixel uniform noise as the prototype — resampling augmentation
    DECORRELATES white noise, so augmented train images carried almost none
    of the class signal the un-augmented test images carry, and every
    trained model looked like it memorized (measured: the same sketched run
    goes from test acc ~0.05 with noise protos to 1.00 with the
    augmentation stack disabled). Smooth protos preserve class evidence
    under small shifts/zooms/rotations exactly like real strokes do."""
    blobs = _bilinear_upsample(
        rng.rand(n_classes, lo_res, lo_res).astype(np.float32), size)
    # fade to white background over the outer ~5 px, matching the
    # augmentation ops' fill=1.0
    edge = np.minimum(np.arange(size), np.arange(size)[::-1])
    taper = np.clip(edge / 5.0, 0, 1).astype(np.float32)
    window = taper[:, None] * taper[None, :]
    return 1.0 - 0.85 * blobs * window[None]


def _synthetic_leaf(seed=0):
    n_clients = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_CLIENTS", 100))
    # COMMEFFICIENT_SYNTHETIC_SAMPLES: mean samples/client (default 40 →
    # the historical randint(20, 60)). Real FEMNIST averages ~230
    # samples/writer over 800k images; scaling this up is how the
    # sample-count ablation (commefficient_torch/scripts/femnist_ablation.py)
    # probes the small-data regime of the fallback.
    base = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_SAMPLES", 40))
    lo, hi = max(1, base // 2), max(2, base * 3 // 2)
    rng = np.random.RandomState(seed)
    protos = _smooth_protos(rng)

    def batch(n):
        ys = rng.randint(0, 62, size=n)
        xs = np.clip(protos[ys] * 0.8
                     + rng.rand(n, 28, 28).astype(np.float32) * 0.2, 0, 1)
        return xs, ys

    train, test = {}, {}
    for c in range(n_clients):
        xs, ys = batch(rng.randint(lo, hi))
        train[f"synth_{c}"] = {"x": xs.reshape(len(ys), -1).tolist(),
                               "y": ys.tolist()}
    for c in range(max(1, n_clients // 10)):
        xs, ys = batch(rng.randint(lo, hi))
        test[f"synth_t{c}"] = {"x": xs.reshape(len(ys), -1).tolist(),
                               "y": ys.tolist()}
    return train, test


class FedEMNIST(FedDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.type == "train":
            images, targets, offsets = [], [], [0]
            for cid in range(len(self.images_per_client)):
                with np.load(self.client_fn(cid)) as d:
                    images.append(d["x"])
                    targets.append(d["y"])
                offsets.append(offsets[-1] + len(targets[-1]))
            self.client_images = np.concatenate(images, axis=0)
            self.client_targets = np.concatenate(targets, axis=0)
            self.client_offsets = np.asarray(offsets)
        else:
            with np.load(self.test_fn()) as d:
                self.test_images = d["x"]
                self.test_targets = d["y"]

    def native_val_access(self):
        # float32 (N, 28, 28) store → the loader's fused normalize path
        return {"store": self.test_images,
                "targets": np.asarray(self.test_targets, np.int64)}

    def prepare_datasets(self, download=False):
        train_data = _read_leaf_dir(os.path.join(self.dataset_dir, "train"))
        if train_data:
            test_data = _read_leaf_dir(os.path.join(self.dataset_dir, "test"))
        else:
            train_data, test_data = _synthetic_leaf()

        os.makedirs(os.path.join(self.dataset_dir, "train"), exist_ok=True)
        os.makedirs(os.path.join(self.dataset_dir, "test"), exist_ok=True)

        images_per_client = []
        for cid, cdata in enumerate(train_data.values()):
            x = np.asarray(cdata["x"], np.float32).reshape(-1, 28, 28)
            y = np.asarray(cdata["y"], np.int64)
            images_per_client.append(int(y.size))
            fn = self.client_fn(cid)
            if not os.path.exists(fn):
                np.savez(fn, x=x, y=y)

        all_x, all_y = [], []
        for cdata in test_data.values():
            all_x.append(np.asarray(cdata["x"], np.float32).reshape(-1, 28, 28))
            all_y.append(np.asarray(cdata["y"], np.int64))
        all_x = np.concatenate(all_x, axis=0)
        all_y = np.concatenate(all_y, axis=0)
        np.savez(self.test_fn(), x=all_x, y=all_y)

        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": int(all_y.size)}, f)

    def _get_train_item(self, client_id, idx_within_client):
        i = int(self.client_offsets[client_id]) + idx_within_client
        return self.client_images[i], int(self.client_targets[i])

    def _get_val_item(self, idx):
        return self.test_images[idx], int(self.test_targets[idx])

    def client_fn(self, client_id):
        return os.path.join(self.dataset_dir, "train", f"client{client_id}.npz")

    def test_fn(self):
        return os.path.join(self.dataset_dir, "test", "test.npz")
