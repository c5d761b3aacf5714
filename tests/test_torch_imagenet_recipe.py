"""The port's ImageNet recipe (``commefficient_torch/scripts/imagenet.sh``)
against the JAX package's (``scripts/imagenet.sh``): the same flags, and
the same config from each package's parser."""

import shlex
from pathlib import Path

import pytest

pytest.importorskip("torch")

from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DATASET = "/data/imagenet"


def recipe(path: Path):
    """The entry point a recipe runs and its flags, with the dataset
    directory's argument filled in and the caller's ``"$@"`` dropped."""
    text = path.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.lstrip().startswith("exec "))
    toks = shlex.split(line)[1:]
    assert toks[-1] == "$@", toks
    entry, flags = (toks[1:3], toks[3:-1]) if toks[1] == "-m" else (
        toks[1:2], toks[2:-1])
    return entry, [t.replace("$DATASET_DIR", DATASET) for t in flags]


def test_recipes_parse_to_the_same_config():
    j_entry, j_flags = recipe(ROOT / "scripts" / "imagenet.sh")
    t_entry, t_flags = recipe(ROOT / "commefficient_torch" / "scripts"
                              / "imagenet.sh")
    assert j_entry == ["cv_train.py"]
    assert t_entry == ["-m", "commefficient_torch.cv_train"]
    assert t_flags == j_flags
    j_args, t_args = vars(j_parse(argv=j_flags)), vars(t_parse(argv=t_flags))
    shared = sorted(set(j_args) & set(t_args))
    assert len(shared) >= 100
    # ``--device`` is the one field the packages default differently: the
    # JAX package's None picks its backend, the port's recipe runs on the
    # card
    assert j_args["device"] is None and t_args["device"] == "cuda"
    diff = {k: (j_args[k], t_args[k]) for k in shared
            if k != "device" and j_args[k] != t_args[k]}
    assert not diff, diff
    assert t_args["dataset_dir"] == DATASET
    assert (t_args["model"], t_args["mode"], t_args["num_clients"],
            t_args["num_workers"], t_args["num_epochs"]) == (
        "FixupResNet50", "uncompressed", 7, 7, 24)
