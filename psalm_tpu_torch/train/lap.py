"""Exact linear assignment on the device: kernel K6 and its plain version.

Counterpart of ``psalm_tpu/train/lap.py`` (``lap_assign``, :118): the
Jonker-Volgenant shortest augmenting path that scipy's ``_lsap.c``
implements, row by row, each Dijkstra pop a [Q]-wide relaxation and an
argmin. JAX runs it under counted ``lax.fori_loop``s with a done-freeze; the
result is the one the search gets when it stops at the first free column
(the sink), which is what both versions here do.

  cost     [B, Q, N]  queries x targets (the ``hungarian_assign`` layout);
                      NaN and +inf read as 1e8, -inf as -1e8, as the scipy
                      route guards them
  n_valid  [B]        targets j < n_valid[b] are assigned (n_valid <= Q)
  -> src   [B, N]     long, the query of target j; 0 where not valid
     valid [B, N]     bool, j < n_valid[b]

``lap_assign`` launches K6 (``csrc/lap.cu``: a block per cost matrix, the
matrix, ``u`` and the matching in shared memory; one warp solves it, each
lane holding its columns' ``v`` and a search's ``spc``, ``path``, scanned
flags and owners in registers; a pop's argmin is two ``redux.sync`` on
ordered-int keys and its column's ``spc`` and owner one shuffle) for a CUDA
tensor, with no device-to-host copy and output shapes that do not depend on
``n_valid``'s values; a CPU tensor takes ``lap_assign_plain``, batched torch
ops that repeat ``_solve_single``'s f32 arithmetic in its order, ties of
every argmin to the lowest index as ``jnp.argmin`` breaks them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from psalm_tpu_torch.ops import _build

#: Launches of K6 since the last reset (the plain version does not count).
LAUNCHES = 0

INF = float("inf")
MAX_SMEM = 227 * 1024  # an H100 block's opt-in shared memory


def guarded_cost(cost: torch.Tensor) -> torch.Tensor:
    """[B, Q, N] -> [B, N, Q] f32 rows = targets, non-finite values
    replaced as JAX's ``lap_assign`` and the scipy route replace them."""
    cost_t = cost.detach().float().transpose(1, 2)
    return torch.nan_to_num(cost_t, nan=1e8, posinf=1e8, neginf=-1e8)


def lap_assign_plain(cost: torch.Tensor, n_valid: torch.Tensor,
                     steps: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on any device: ``_solve_single`` over the batch,
    step for step. ``steps`` ([B] int32), when given, receives each
    matrix's count of Dijkstra pops, as K6 reports them. It stops a loop
    once no matrix of the batch is live (a host check per pop)."""
    c = guarded_cost(cost)  # [B, N, Q]
    B, N, Q = c.shape
    dev = c.device
    nv = n_valid.to(dev, torch.long)
    ar = torch.arange(B, device=dev)
    u = torch.zeros(B, N, device=dev)
    v = torch.zeros(B, Q, device=dev)
    col4row = torch.full((B, N), -1, dtype=torch.long, device=dev)
    row4col = torch.full((B, Q), -1, dtype=torch.long, device=dev)
    pops = torch.zeros(B, dtype=torch.long, device=dev)
    for i in range(N):
        live = nv > i
        if not bool(live.any()):
            break  # rows are taken in order: no later row is live
        cur = torch.full((B,), i, dtype=torch.long, device=dev)
        sr = torch.zeros(B, N, dtype=torch.bool, device=dev)
        sc = torch.zeros(B, Q, dtype=torch.bool, device=dev)
        spc = torch.full((B, Q), INF, device=dev)
        path = torch.full((B, Q), -1, dtype=torch.long, device=dev)
        sink = torch.full((B,), -1, dtype=torch.long, device=dev)
        minval = torch.zeros(B, device=dev)
        for _ in range(N):  # JAX's counted bound; each pop scans a column
            act = live & (sink < 0)
            if not bool(act.any()):
                break
            pops += act.long()
            sr2 = sr.clone()
            sr2[ar, cur] = True
            red = minval[:, None] + c[ar, cur] - u[ar, cur][:, None] - v
            better = ~sc & (red < spc)
            spc2 = torch.where(better, red, spc)
            path2 = torch.where(better, cur[:, None], path)
            j = torch.where(sc, INF, spc2).argmin(1)  # the lowest on ties
            mv = spc2[ar, j]
            owner = row4col[ar, j]
            free = owner < 0
            sc2 = sc.clone()
            sc2[ar, j] = True
            a = act[:, None]
            sr = torch.where(a, sr2, sr)
            sc = torch.where(a, sc2, sc)
            spc = torch.where(a, spc2, spc)
            path = torch.where(a, path2, path)
            sink = torch.where(act & free, j, sink)
            minval = torch.where(act, mv, minval)
            cur = torch.where(act & ~free, owner, cur)
        # dual updates, exactly JAX's (lap.py:78-83)
        u_i = u.clone()
        u_i[:, i] = u[:, i] + minval
        extra = torch.where(sr, minval[:, None]
                            - spc.gather(1, col4row.clamp(0, Q - 1)), 0.0)
        extra[:, i] = 0.0
        lv = live[:, None]
        u = torch.where(lv, u_i + extra, u)
        v = torch.where(lv, v + torch.where(sc, spc - minval[:, None], 0.0), v)
        # augment along the alternating path back from the sink
        j = sink.clamp(min=0)
        done = ~live | (sink < 0)
        for _ in range(N):
            if bool(done.all()):
                break
            ip = path[ar, j]
            ipc = ip.clamp(min=0)
            nd = ~done
            row4col[ar, j] = torch.where(nd, ip, row4col[ar, j])
            jnext = col4row[ar, ipc]
            col4row[ar, ipc] = torch.where(nd, j, col4row[ar, ipc])
            done = done | (ip == i)
            j = torch.where(nd, jnext.clamp(min=0), j)
    if steps is not None:
        steps.copy_(pops.to(steps.dtype))
    valid = torch.arange(N, device=dev)[None, :] < nv[:, None]
    return torch.where(valid, col4row, 0), valid


def smem_bytes(N: int, Q: int) -> int:
    """Shared memory of one K6 block: the guarded matrix, ``u``, a row's
    ``path``, the matching and the scanned rows' flags
    (csrc/lap.cu::smem_layout)."""
    return 4 * (N * Q + 2 * N + 2 * Q) + N


def launch_buffers(name: str, cost: torch.Tensor, n_valid: torch.Tensor,
                   steps: Optional[torch.Tensor], smem_of):
    """K6's and K7's inputs checked before a launch, and their buffers:
    (cost f32 contiguous, n_valid int32, src [B, N] long, valid [B, N]
    bool). ``smem_of(N, Q)``: a block's shared memory."""
    if cost.device.type != "cuda":
        raise ValueError(f"{name} kernel: cost is on {cost.device}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, Q, N], got {tuple(cost.shape)}")
    B, Q, N = cost.shape
    if n_valid.shape != (B,) or n_valid.device != cost.device:
        raise ValueError(f"n_valid must be [B] on {cost.device}, got "
                         f"{tuple(n_valid.shape)} on {n_valid.device}")
    if smem_of(N, Q) > MAX_SMEM:
        raise ValueError(f"{name} kernel: a {Q} x {N} matrix does not fit a "
                         "block's shared memory")
    if steps is not None and (steps.dtype != torch.int32
                              or steps.shape != (B,)
                              or steps.device != cost.device):
        raise ValueError("steps must be [B] int32 on the cost's device")
    return (cost.detach().float().contiguous(),
            n_valid.detach().to(torch.int32).contiguous(),
            torch.empty(B, N, dtype=torch.long, device=cost.device),
            torch.empty(B, N, dtype=torch.bool, device=cost.device))


def lap_assign(cost: torch.Tensor, n_valid: torch.Tensor,
               steps: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src [B, N] long, valid [B, N] bool): the exact optimum per matrix.
    A CPU tensor goes to the plain version; a CUDA tensor launches K6, one
    launch for the batch, or raises. ``steps`` ([B] int32 on the card),
    when given, receives each matrix's count of Dijkstra pops."""
    global LAUNCHES
    if cost.device.type == "cpu":
        return lap_assign_plain(cost, n_valid, steps)
    lib = _build.library()
    c, nv, src, valid = launch_buffers("lap_assign", cost, n_valid, steps,
                                       smem_bytes)
    B, Q, N = c.shape
    with torch.cuda.device(cost.device):
        rc = lib.psalm_lap_assign(
            c.data_ptr(), nv.data_ptr(), src.data_ptr(), valid.data_ptr(),
            None if steps is None else steps.data_ptr(), B, Q, N,
            _build.stream_ptr(cost.device))
    _build.check(lib, rc, "psalm_lap_assign")
    LAUNCHES += 1
    return src, valid
