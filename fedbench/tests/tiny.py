"""A checkout root of tiny cells for the CPU tests: the repo's
``BENCHMARK.json`` metrics, copies of ``fedbench/{reference,program,
metrics}``, and the three cells' configurations and mixes at a small
width (ResNet9 at 8/16/16/32 channels and a 3 x 2,048 sketch; GPT-2 of 2
layers of width 32 over 512 tokens and a 3 x 4,096 sketch)."""

import json
import shutil
from pathlib import Path

from fedbench import spec

REPO = Path(__file__).resolve().parents[2]
CELLS = ("t-resnet9", "t-gpt2", "t-gpt2-dense")
# on the CPU the port and the reference compute the same float32 sums in
# nearly the same order: gaps of 0 to 1e-7
LIMITS = {"first_loss_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-5,
          "zeroed_differ": 0, "change_gap": 1e-4}


def _load(rel):
    with open(REPO / rel) as f:
        return json.load(f)


def _dump(obj, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make(root: Path) -> Path:
    root = Path(root)
    for d in ("reference", "program", "metrics"):
        shutil.copytree(REPO / "fedbench" / d, root / "fedbench" / d,
                        dirs_exist_ok=True)
    r9 = _load("fedbench/configs/resnet9-cifar10.json")
    r9.update(channels={"prep": 8, "layer1": 16, "layer2": 16,
                        "layer3": 32}, d=31640)
    r9["recipe"].update(num_rows=3, num_cols=2048, k=500)
    g2 = _load("fedbench/configs/gpt2-small-persona.json")
    g2.update(vocab_size=512, n_positions=64, n_ctx=64, n_embd=32,
              n_layer=2, n_head=2, d=43937)
    g2["recipe"].update(num_rows=3, num_cols=4096, k=500)
    _dump(r9, root / "fedbench/configs/t-resnet9.json")
    _dump(g2, root / "fedbench/configs/t-gpt2.json")
    mix = spec.mix("cifar-c100x5-sketch", REPO)
    mix.update(clients_per_round=4, examples_per_client=2, population=20,
               pool=4)
    mix["fields"]["inputs"]["shape"] = [2, 32, 32, 3]
    mix["fields"]["targets"]["shape"] = [2]
    _dump(mix, root / "fedbench/traffic/t-cifar.json")
    for mode in ("sketch", "uncompressed"):
        mix = spec.mix(f"persona-w4-{mode}", REPO)
        mix.update(clients_per_round=3, population=10, pool=4)
        f = mix["fields"]
        for k in ("input_ids", "token_type_ids", "lm_labels"):
            f[k]["shape"] = [2, 2, 32]
        f["input_ids"]["high"] = f["lm_labels"]["high"] = 507
        f["token_type_ids"].update(low=510, high=512)
        f["mc_token_ids"].update(low=16, high=32)
        mix["flags"]["max_seq_len"] = 32
        _dump(mix, root / f"fedbench/traffic/t-persona-{mode}.json")
    bench = _load("BENCHMARK.json")
    bench["configs"] = [
        {"name": n, "source": "test", "file": f"fedbench/configs/{n}.json",
         "reduced": [], "why": "test"} for n in ("t-resnet9", "t-gpt2")]
    bench["workloads"] = [
        {"name": "t-resnet9", "config": "t-resnet9", "traffic": "t-cifar",
         "chips": 1, "why": "test"},
        {"name": "t-gpt2", "config": "t-gpt2",
         "traffic": "t-persona-sketch", "chips": 1, "why": "test"},
        {"name": "t-gpt2-dense", "config": "t-gpt2",
         "traffic": "t-persona-uncompressed", "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    _dump(bench, root / "BENCHMARK.json")
    for name in CELLS:
        limits = dict(LIMITS)
        if name == "t-gpt2-dense":  # no top-k cut: no cells it zeroes
            del limits["zeroed_differ"]
        _dump(limits, root / f"fedbench/limits/{name}.json")
    return root
