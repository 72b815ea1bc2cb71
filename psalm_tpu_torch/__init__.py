"""psalm_tpu_torch: the PSALM COCO-panoptic eval path in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The JAX package ``psalm_tpu`` is the reference the port is held against.
The port shares its JAX-free modules instead of copying them: the config
tree (re-exported here), the numpy splicer and the checkpoint converter.
"""

from psalm_tpu.config import PSALMConfig, SegTask, tiny_test_config  # noqa: F401

__version__ = "0.1.0"
