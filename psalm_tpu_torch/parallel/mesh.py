"""Process groups and sharding rules for data and tensor parallelism.

Counterpart of ``psalm_tpu/parallel/mesh.py`` on ``torch.distributed``. The
reference trained with DeepSpeed ZeRO-2 over NCCL; JAX replaces it with a
('data', 'model') device mesh, and the port with process groups: one process
per card (NCCL), or per CPU worker (gloo, for the tests).

  * ``init_distributed`` is ``jax.distributed.initialize``: the default
    group from torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``;
  * ``make_mesh(data, model)`` splits the world as JAX reshapes its devices
    to (data, model): rank = d * model + m. The data group of a rank holds
    the ranks of its model rank m; its model group those of its data rank d;
  * ``_TP_RULES`` are JAX's rules on the port's names (the torch state-dict
    keys, ``checkpoint/from_jax.py::_phi``): Phi's q/k/v and fc1 are
    column-parallel (a torch weight [out, in] split on out, its bias too),
    dense and fc2 row-parallel (split on in; the bias stays whole and is
    added after the reduction), ``lm_head`` column-parallel (its bias, like
    JAX's, whole). A spec names the mesh axis of each tensor axis.
    ``param_spec(name, cfg)`` places a parameter as JAX places the matching
    leaf of the same config. JAX's rules match only ``.../kernel`` of a
    float ``nn.Dense``; a LoRA layer's ``base/kernel``, an int8
    ``kernel_q`` and an int4 ``kernel_q4`` / ``kernel_q4n`` fall through to
    replicated. So with ``lora_rank`` or ``quant_bits`` set
    (``phi_layers_split`` false) every decoder-layer tensor stays whole
    (the int8 ``weight``, whose torch name the float rule would match,
    among them) and only ``lm_head.weight`` splits. One placement differs
    from JAX's: without LoRA, JAX's ``.../bias`` rule also splits a
    quantized q/k/v/fc1 layer's bias. That is placement only (its kernel
    is whole, so GSPMD gathers the bias back before the add and the numbers
    are the replicated ones); the port keeps such a bias whole;
  * ``shard_state_dict`` gives a model rank its slices of a full state dict
    and ``unshard`` puts a tensor back together over the model group; both
    pass a whole tensor through (every LoRA and int8 / int4 layer's);
  * ``host_shard_info`` is the sampler's shard: the DATA rank, since the
    model ranks of one data group read the same samples;
  * ``local_rows`` is the counterpart of ``make_global_batch``: a process
    holds only its data rank's rows of the global batch, on its device;
  * ``shard_draws`` makes random draws of a global batch: every rank draws
    the global [B * data, ...] numbers from the shared seeded generator and
    keeps its own rows, so that the data-parallel step equals the one-process
    step on the concatenated batch.
"""

from __future__ import annotations

import dataclasses
import os
import re
import socket
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') split of the default process group, as this rank
    sees it."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    device: torch.device

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(device="cuda") -> torch.device:
    """Initializes the default process group and returns this process's
    device: NCCL and card ``LOCAL_RANK`` for ``"cuda"``, gloo for
    ``"cpu"``. The rank, world size and rendezvous come from torchrun's
    environment; a process started without ``WORLD_SIZE`` is a group of one
    on a free localhost port."""
    dev = _device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)
    return dev


def make_mesh(data: int = -1, model: int = 1, device="cuda") -> Mesh:
    """The ('data', 'model') mesh over the initialized default group;
    ``data=-1`` takes every rank the model axis leaves."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if data == -1:
        if n % model:
            raise ValueError(f"world size {n} is not a multiple of model "
                             f"{model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data {data} x model {model} != world size {n}")
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    d, m = divmod(rank, model)
    return Mesh(data, model, d, m, data_groups[m], model_groups[d],
                _device(device))


# ---------------------------------------------------------------------------
# tensor-parallel rules over 'model' (psalm_tpu/parallel/mesh.py:47-53), on
# the torch names and layout: a Linear weight is [out, in], so JAX's kernel
# spec (in, out) is reversed here

_TP_RULES = [
    (r"^model\.layers\.\d+\.(self_attn\.[qkv]_proj|mlp\.fc1)\.weight$",
     ("model", None)),
    (r"^model\.layers\.\d+\.(self_attn\.[qkv]_proj|mlp\.fc1)\.bias$",
     ("model",)),
    (r"^model\.layers\.\d+\.(self_attn\.dense|mlp\.fc2)\.weight$",
     (None, "model")),
    (r"^model\.embed_tokens\.weight$", (None, None)),
    (r"^lm_head\.weight$", ("model", None)),
]


def phi_layers_split(cfg) -> bool:
    """Whether Phi's decoder layers split over 'model' under ``cfg`` (a
    ``PSALMConfig`` or its ``PhiConfig``): only when every linear is a float
    ``Dense``, the only layer whose leaves JAX's rules match."""
    phi = getattr(cfg, "phi", cfg)
    return not (phi.lora_rank or phi.quant_bits)


def param_spec(name: str, cfg) -> Spec:
    """The mesh axis of each axis of parameter ``name`` of a model of
    ``cfg`` (() = replicated)."""
    if name.startswith("model.layers.") and not phi_layers_split(cfg):
        return ()
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name):
            return spec
    return ()


def tp_axis(name: str, cfg) -> Optional[int]:
    """The axis that ``name`` is split on over 'model', or None."""
    spec = param_spec(name, cfg)
    return spec.index("model") if "model" in spec else None


def _chunk(t: torch.Tensor, axis: int, index: int, parts: int) -> torch.Tensor:
    size = t.shape[axis]
    if size % parts:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"into {parts}")
    return t.narrow(axis, index * (size // parts), size // parts)


def shard_tensor(t: torch.Tensor, name: str, mesh: Mesh, cfg) -> torch.Tensor:
    """This model rank's slice of the full parameter ``name`` of a model of
    ``cfg`` (a view)."""
    axis = tp_axis(name, cfg)
    if axis is None or mesh.model == 1:
        return t
    return _chunk(t, axis, mesh.model_rank, mesh.model)


def shard_state_dict(sd: Dict[str, Any], mesh: Mesh, cfg) -> Dict[str, Any]:
    """A full state dict (tensors or numpy arrays) of a model of ``cfg`` ->
    this model rank's slices, contiguous, for a model built with
    ``PSALM(cfg, ..., mesh=mesh)``."""
    return {k: shard_tensor(torch.as_tensor(v), k, mesh, cfg).contiguous()
            for k, v in sd.items()}


def gather_axis(t: torch.Tensor, axis: int, group, parts: int
                ) -> torch.Tensor:
    """The ``parts`` slices of ``group``'s ranks, joined in rank order along
    ``axis`` (collective)."""
    out = torch.empty((parts * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1), group=group)
    out = out.view(parts, *t.shape).movedim(0, axis)
    shape = list(t.shape)
    shape[axis] *= parts
    return out.reshape(shape)


def unshard(t: torch.Tensor, name: str, mesh: Mesh, cfg) -> torch.Tensor:
    """The full parameter ``name`` of a model of ``cfg`` from this rank's
    slice (collective over the model group for a split parameter)."""
    axis = tp_axis(name, cfg)
    if axis is None or mesh.model == 1:
        return t
    return gather_axis(t, axis, mesh.model_group, mesh.model)


def host_shard_info(mesh: Mesh) -> Tuple[int, int]:
    """(shard_index, num_shards) for ``UnifiedTaskSampler``."""
    return mesh.data_rank, mesh.data


def local_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This data rank's rows of a global batch: every array whose leading
    axis is the batch's is cut to rows [r b, (r + 1) b); strings and other
    values pass through."""
    B = len(batch["images"])
    if B % mesh.data:
        raise ValueError(f"batch of {B} does not split over {mesh.data} "
                         "data ranks")
    b = B // mesh.data
    lo = mesh.data_rank * b

    def rows(v):
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim and \
                len(v) == B:
            return v[lo:lo + b]
        return v

    return {k: rows(v) for k, v in batch.items()}


def shard_draws(uniform_fn: Callable, mesh: Mesh) -> Callable:
    """``uniform_fn(generator, shape)`` of a local batch from the global
    draws: shape [B, ...] draws [B * data, ...] and keeps this data rank's
    B rows."""
    def draw(generator, shape):
        B = shape[0]
        full = uniform_fn(generator, (B * mesh.data, *shape[1:]))
        return full[mesh.data_rank * B:(mesh.data_rank + 1) * B]
    return draw


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, as a new tensor outside the graph."""
    t = t.detach().clone()
    dist.all_reduce(t, op=op, group=group)
    return t
