"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy only: nothing here imports the program
(``commefficient_torch``), JAX or the JAX package, and nothing takes a
value the program made. The benchmark hands both sides the same initial
weights (``flat.initial_weights``, from the seed) and the same batches; the
reference then works out the rounds again on its own:

- ``flat``: the flat parameter vector in JAX ravel order (every leaf in
  its flax layout, leaves sorted by path) and the seeded initial weights;
- ``resnet9`` and ``gpt2_double_heads``: the two models' leaves, forward
  passes and per-example losses;
- ``sketch``: the count sketch, its hash and sign formulas re-derived from
  the seed, the median-of-rows query and the tie-inclusive top-k;
- ``fetchsgd``: the federated round (client sum, weight decay, the
  data-weighted mean, the server rule, the weight update).

Each model module exposes ``leaves(cfg)``, ``init_rule(path, shape,
cfg)``, ``example_losses(params, batch, keep, cfg)`` and
``keep_numel(cfg, batch)``; the harness finds a model's module by the
``model`` key of its configuration file.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products and convolutions with TF32 on or off,
    restored on exit. The configurations state float32 with TF32 off; the
    control (the reference in the program's place one precision below)
    runs with it on."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
