"""fedtpu on PyTorch and CUDA: the port of ``commefficient_tpu`` to an
NVIDIA H100 (sm_90a).

This package imports ``torch`` and numpy, never JAX and nothing of
``commefficient_tpu``. Its entry points (``federated.FedModel`` /
``FedOptimizer`` / ``LambdaLR`` and ``python -m
commefficient_torch.cv_train``) run on ``cuda`` unless the caller asks for
the CPU. The hot path's kernels are hand-written CUDA C++ (``csrc/``),
built with ``nvcc`` at first use (``kernels.py``). The observability
plane (``telemetry.py``: the metric vector, the run event log, the watch
rules) and the health guards (``federated.round_health``) are on the
round's path as in the JAX package.
"""

__version__ = "0.1.0"
