"""Multi-process scale-out with ``torch.distributed`` (counterpart of
``parallel/distributed.py``).

One process per device: ``initialize`` joins the process group,
``global_mesh`` lays the ranks out as a (dp, pt) mesh, and a process
holds only its own slice of a batch (``process_batch_slice``,
``make_global_batch``). The point-parallel sums of one registration ride
:func:`allsum`: every rank gathers the partials of its ``pt`` group and
adds them in rank order, so all ranks hold the same bits and take the
same branches of the LM loop.

The backend is explicit: ``gloo`` on the CPU and for several ranks on one
card (NCCL refuses two ranks on one device), ``nccl`` for one rank per
card. A group that cannot be formed raises; nothing falls back to a
single process.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dynamic_direct_lidar_odometry_tpu_torch.core import tree

# a rank that does not join a collective within this fails the group
_TIMEOUT = datetime.timedelta(seconds=120)


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (one call per process, before any
    collective). Arguments fall back to ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, then torch's own
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``.

    ``local_device_ids``: the card this process drives (its first entry
    becomes the current CUDA device). ``backend`` defaults to ``nccl``
    when a card is named and ``gloo`` otherwise; pass ``gloo`` for
    several ranks on one card.

    Sets ``CUBLAS_WORKSPACE_CONFIG`` when it is unset: the point-parallel
    step runs with deterministic algorithms, which need it for cuBLAS
    (call this before the process's first matrix product on the card).
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs a coordinator address, a process "
            "count and a process id (arguments or environment)"
        )
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    if backend is None:
        backend = "nccl" if local_device_ids else "gloo"
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(
        backend, init_method=init, world_size=int(num_processes),
        rank=int(process_id), timeout=_TIMEOUT,
    )


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_process_count() -> int:
    """Ranks on this host (``LOCAL_WORLD_SIZE``, else all of them)."""
    n = _env_int("LOCAL_WORLD_SIZE")
    return process_count() if n is None else n


def global_mesh(pt: int = 1, device=None):
    """A (dp, pt) mesh over ALL ranks: rank r sits at (r // pt, r % pt).

    Every rank must call this with the same ``pt``. A ``pt`` group must
    not straddle hosts (its sums ride inside every LM iteration), so
    ``pt`` must divide the ranks per host."""
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding

    n_local = local_process_count()
    if pt > 1 and n_local % pt != 0:
        raise ValueError(
            f"pt={pt} must divide local process count {n_local} so the "
            "sum groups stay intra-host"
        )
    n = process_count()
    if n % pt != 0:
        raise ValueError(f"{n} processes not divisible by pt={pt}")
    devices = None if device is None else [device]
    return sharding.make_mesh(n, pt=pt, devices=devices)


def process_batch_slice(global_batch: int, mesh=None) -> slice:
    """The slice of a dp-split global batch this process owns: an equal
    split in process order, or in dp-row order when a ``mesh`` with a
    ``pt`` axis is given (the ranks of one pt group share a slice)."""
    n, i = process_count(), process_index()
    if mesh is not None:
        n, i = mesh.shape["dp"], mesh.dp_index
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def make_global_batch(mesh, local_tree: Any, point_sharded_leaves=()) -> Any:
    """This process's slice of a dp-split batch, placed on its device: no
    process ever holds the full batch. The leading axis stays local (the
    aligners and steps of ``sharding`` take a rank's own slice). A dict
    keeps its keys."""
    def put(x):
        return torch.as_tensor(np.asarray(x)).to(mesh.device)

    if isinstance(local_tree, dict):
        return {k: tree.map_leaves(put, v) for k, v in local_tree.items()}
    return tree.map_leaves(put, local_tree)


def _gather(x: torch.Tensor, group) -> list:
    """All-gather ``x`` over ``group``, staged through host memory under
    gloo (which does not take CUDA tensors for every collective)."""
    n = dist.get_world_size(group)
    host = dist.get_backend(group) == "gloo"
    src = x.detach().cpu().contiguous() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def allsum(xs: Sequence[torch.Tensor], group) -> list:
    """Sum each tensor of ``xs`` over ``group``: one all-gather of the
    flattened partials, added in rank order on every rank (the same bits
    on all of them). Integer tensors sum exactly."""
    shapes = [x.shape for x in xs]
    dtype = xs[0].dtype
    flat = torch.cat([x.reshape(-1).to(dtype) for x in xs])
    parts = _gather(flat, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    out, o = [], 0
    for x, s in zip(xs, shapes):
        k = int(np.prod(s, dtype=np.int64))
        out.append(acc[o:o + k].reshape(s).to(x.dtype))
        o += k
    return out


def allgather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate ``x`` of every rank of ``group`` along ``dim``, in rank
    order (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat(_gather(x, group), dim=dim)



def check_group(group):
    """``group`` when it is a ``torch.distributed`` process group (a
    mesh's ``pt_group``); a mesh axis name or anything else raises."""
    if not isinstance(group, dist.ProcessGroup):
        raise ValueError(
            f"point-parallel mode takes the pt process group (sharding.make_mesh(...).pt_group), "
            f"not {group!r}"
        )
    return group


def check_agree(state: Any, group) -> None:
    """Raise unless every rank of ``group`` holds the same ``state`` (a
    container of tensors): one f64 sum per tensor leaf, gathered in rank
    order and compared bit for bit (the ranks of a pt group replicate
    every stage outside the point loops)."""
    sums = []
    tree.map_leaves(lambda x: sums.append(x.double().sum()) if isinstance(x, torch.Tensor) else None, state)
    mine = torch.stack([x.to(sums[0].device) for x in sums]).view(torch.int64)
    for r, other in enumerate(_gather(mine, group)):
        if not torch.equal(other, mine):
            raise RuntimeError(
                f"point-parallel ranks diverged: rank {r} of the pt group holds another state "
                f"than rank {dist.get_rank(group)} ({int((other != mine).sum())} of {mine.numel()} leaves differ)"
            )

