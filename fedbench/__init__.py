"""The benchmark of the PyTorch/CUDA port (``commefficient_torch``) on
NVIDIA cards: ``python3 -m fedbench.run`` (see ``run.py``), the cells in
``BENCHMARK.json`` at the checkout's root. Imports neither JAX nor the JAX
package."""
