"""psalm_tpu_torch: PSALM in PyTorch, with hand-written CUDA kernels for
Hopper (H100): the eval tasks, chat serving and training.

The JAX package ``psalm_tpu`` is the reference the port is held against in
the tests. The port imports nothing of it: it keeps its own copies of the
JAX-free modules it needs (``config.py``, ``data/constants.py``,
``data/splicer.py``), which the tests hold equal to the originals.
"""

from psalm_tpu_torch.config import PSALMConfig, SegTask, tiny_test_config  # noqa: F401

__version__ = "0.2.0"
