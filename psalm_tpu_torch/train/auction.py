"""Assignment by the auction algorithm on the device: kernel K7 and its plain
version.

Counterpart of ``psalm_tpu/train/auction.py`` (``auction_assign``, :24):
persons (targets) bid for objects (queries) in an eps-scaled price war of at
most ``num_iters`` rounds, eps = spread x (eps_scale / (N + 1)) per image
(spread over the whole [N, Q] value matrix, padding rows included); each
object goes to its highest bid, ties to the lower person id; persons still
unassigned at the end take, in order, their best free query. It is
approximate (JAX measured 0.08% above the optimum on random costs); the
exact matcher is ``train/lap.py``.

``auction_assign`` launches K7 (``csrc/auction.cu``: a block per image, a
warp a person, values, prices and owners in shared memory; a round is two
barriers: the bids, each one packed 64-bit atomic max of (bid, N - 1 -
person) on its object, then each object's update; rounds until the image
is done or ``num_iters``, the greedy finish in the same launch) for a CUDA
tensor; a CPU tensor takes ``auction_assign_plain``, JAX's batched
arithmetic in torch with the loop's stop condition on the host. JAX stops the whole batch
at once; a finished image's rounds change nothing, so K7's blocks stop on
their own.

One difference from JAX: non-finite costs are read as ``lap_assign`` and the
scipy route read them (NaN and +inf as 1e8, -inf as -1e8). JAX's auction
lets them into its bids, where a NaN or an infinite eps decides the
matching arbitrarily; on finite costs the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from psalm_tpu_torch.ops import _build
from psalm_tpu_torch.train.lap import guarded_cost, launch_buffers

#: Launches of K7 since the last reset (the plain version does not count).
LAUNCHES = 0

NEG = -1e9


def eps_coefficient(eps_scale: float, N: int) -> float:
    """eps / spread: JAX writes eps_scale * spread / (N + 1), which XLA
    compiles to spread * (eps_scale / (N + 1)) with the constant folded in
    f32; both versions here round as that does."""
    return float(np.float32(eps_scale) / np.float32(N + 1))


def auction_assign_plain(cost: torch.Tensor, n_valid: torch.Tensor,
                         num_iters: int = 300, eps_scale: float = 1e-3,
                         steps: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on any device, JAX's ops in JAX's order. ``steps``
    ([B] int32), when given, receives each image's count of bidding rounds,
    as K7 reports them."""
    value = -guarded_cost(cost)  # persons (N) x objects (Q): [B, N, Q]
    B, N, Q = value.shape
    dev = value.device
    nv = n_valid.to(dev, torch.long)
    ids = torch.arange(N, device=dev)
    person_valid = ids[None, :] < nv[:, None]  # [B, N]
    value = torch.where(person_valid[:, :, None], value, NEG)
    rounds = torch.zeros(B, dtype=torch.long, device=dev)
    if N == 0:
        if steps is not None:
            steps.zero_()
        empty = torch.zeros(B, 0, dtype=torch.long, device=dev)
        return empty, empty.bool()
    spread = torch.clamp(value.amax((1, 2))
                         - torch.clamp(value.amin((1, 2)), min=NEG / 2),
                         min=1.0)
    eps = (spread * eps_coefficient(eps_scale, N))[:, None]
    prices = torch.zeros(B, Q, device=dev)
    owner = torch.full((B, Q), -1, dtype=torch.long, device=dev)

    def assigned_of(owner):
        return torch.zeros(B, N, dtype=torch.long, device=dev).scatter_reduce(
            1, owner.clamp(0, N - 1), (owner >= 0).long(), "amax")

    for _ in range(num_iters):
        assigned = assigned_of(owner)
        unassigned = person_valid & (assigned == 0)
        if not bool(unassigned.any()):
            break
        rounds += unassigned.any(1).long()
        net = value - prices[:, None, :]  # [B, N, Q]
        best = net.amax(2)
        best_j = net.argmax(2)  # the lowest index on ties
        second = net.scatter(2, best_j[..., None], NEG).amax(2)
        bid = prices.gather(1, best_j) + (best - second) + eps
        # the highest bidder per object wins; ties -> the lower person id
        bid_masked = torch.where(unassigned, bid, NEG)
        obj_bid = torch.full((B, Q), NEG, device=dev).scatter_reduce(
            1, best_j, bid_masked, "amax")
        has_bid = obj_bid > NEG
        is_winner = (unassigned & (bid_masked >= obj_bid.gather(1, best_j))
                     & has_bid.gather(1, best_j))
        winner = torch.full((B, Q), N, dtype=torch.long, device=dev
                            ).scatter_reduce(
            1, best_j, torch.where(is_winner, ids[None, :], N), "amin")
        won = winner < N
        owner = torch.where(won, winner, owner)
        prices = torch.where(won, obj_bid, prices)

    # invert owner -> src: src[i] = j with owner[j] == i
    qs = torch.arange(Q, device=dev)
    src = torch.full((B, N), -1, dtype=torch.long, device=dev).scatter_reduce(
        1, owner.clamp(0, N - 1), torch.where(owner >= 0, qs[None, :], -1),
        "amax")
    taken = torch.zeros(B, Q, dtype=torch.long, device=dev).scatter_reduce(
        1, src.clamp(0, Q - 1), (src >= 0).long(), "amax").bool()
    ar = torch.arange(B, device=dev)
    # greedy cleanup: persons in order take their best still-free query
    for i in range(N):
        need = (src[:, i] < 0) & (nv > i)
        j = torch.where(taken, NEG, value[:, i]).argmax(1)
        src[:, i] = torch.where(need, j, src[:, i])
        taken[ar, j] = taken[ar, j] | need
    if steps is not None:
        steps.copy_(rounds.to(steps.dtype))
    valid = person_valid & (src >= 0)
    return torch.where(valid, src, 0), valid


def smem_bytes(N: int, Q: int) -> int:
    """Shared memory of one K7 block: the round's 64-bit bid keys, the value
    matrix, prices, owners, ``assigned`` and ``src``
    (csrc/auction.cu::smem_layout)."""
    return 8 * Q + 4 * (N * Q + 2 * Q + 2 * N)


def auction_assign(cost: torch.Tensor, n_valid: torch.Tensor,
                   num_iters: int = 300, eps_scale: float = 1e-3,
                   steps: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src [B, N] long, valid [B, N] bool), the ``hungarian_assign``
    contract. A CPU tensor goes to the plain version; a CUDA tensor
    launches K7, one launch for the batch, or raises. ``steps`` ([B] int32
    on the card), when given, receives each image's count of rounds."""
    global LAUNCHES
    if cost.device.type == "cpu":
        return auction_assign_plain(cost, n_valid, num_iters, eps_scale,
                                    steps)
    lib = _build.library()
    c, nv, src, valid = launch_buffers("auction_assign", cost, n_valid,
                                       steps, smem_bytes)
    B, Q, N = c.shape
    with torch.cuda.device(cost.device):
        rc = lib.psalm_auction_assign(
            c.data_ptr(), nv.data_ptr(), src.data_ptr(), valid.data_ptr(),
            None if steps is None else steps.data_ptr(), B, Q, N,
            int(num_iters), float(eps_scale), _build.stream_ptr(cost.device))
    _build.check(lib, rc, "psalm_auction_assign")
    LAUNCHES += 1
    return src, valid
