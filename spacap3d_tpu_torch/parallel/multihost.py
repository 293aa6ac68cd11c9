"""Multi-process runtime over ``torch.distributed``, as the JAX package's
``parallel/multihost.py``.

One process a rank, joined into one process group at the start of a run.
Division of labour:

* **Train**: every rank computes the same global index order (the loader's
  RNG is seeded alike), builds only its contiguous row-block of each global
  batch (``data/loader.py``'s process slicing) and runs the train step on
  it with the data group (``train/step.py``): batch norm and the losses
  reduce over the group, and one all-reduce sums the gradients. A rank's
  rows are its batch; there is no global array to assemble.
* **mul_eval**: the (seed x scene) grid shards by seed (``process_shard``);
  each rank streams its own grid on its own device and the per-seed rows
  are merged by ``allgather_pyobj`` (``eval/mul_eval.py``).
* **Files**: rank 0 alone writes logs, checkpoints and results.

The group's backend follows the device: NCCL for CUDA, one rank a card;
gloo for ``device="cpu"``. ``backend="gloo"`` on CUDA serves ranks that
share one card (gloo all-reduces and broadcasts CUDA tensors through the
host); NCCL refuses two ranks on one device, and so does
``initialize_from_env``, with its own message. Host objects travel over a
gloo side group, so they never need CUDA tensors. A single-process run is
the world-of-one case of every helper here.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may wait for the other ranks; a
# seed-sharded grid's ranks reach its final merge minutes apart at full size
DEFAULT_TIMEOUT_S = 1800.0

_side_group = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def free_port() -> int:
    """A free TCP port on this host, for a ``localhost`` coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_rank(process_id: int) -> int:
    """This rank's index among the ranks of its host: ``LOCAL_RANK`` when a
    launcher sets it, else the process id (one host)."""
    v = _env_int("LOCAL_RANK")
    return process_id if v is None else v


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: for an unindexed ``"cuda"`` in a process
    group, card ``local_rank % count`` of its host (ranks that share a
    host's only card all take card 0); else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank(dist.get_rank()) % torch.cuda.device_count())
    return dev


def _device_identity(dev: torch.device) -> str:
    """The host and the card's UUID."""
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"


def check_one_rank_per_device(identities: Sequence[str], backend: str) -> None:
    """Raises if ``backend`` is NCCL and two ranks name one device."""
    if backend != "nccl":
        return
    seen = {}
    for rank, ident in enumerate(identities):
        if ident in seen:
            raise ValueError(
                f"NCCL cannot run two ranks on one device: ranks {seen[ident]} and {rank} "
                f"both hold {ident}. Give every rank its own card, or pass backend='gloo' "
                f"for ranks that share one card")
        seen[ident] = rank


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Joins (or creates) the process group; returns ``(rank, world)``.

    Explicit arguments win; else ``SPACAP_COORDINATOR`` (``host:port``),
    ``SPACAP_NUM_PROCESSES`` and ``SPACAP_PROCESS_ID`` are read. With no
    coordinator anywhere this is a single-process no-op returning (0, 1),
    so the command lines can call it unconditionally. ``backend`` defaults
    to NCCL on CUDA and gloo on the CPU; NCCL on the CPU raises, and so does
    NCCL with two ranks on one card. ``timeout_s`` bounds the rendezvous
    and every collective. On CUDA the rank's card (``rank_device``) becomes
    the current device."""
    global _side_group
    coordinator_address = coordinator_address or os.environ.get("SPACAP_COORDINATOR")
    if coordinator_address is None:
        return 0, 1
    if num_processes is None:
        num_processes = _env_int("SPACAP_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SPACAP_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address} given without the number of "
                         f"processes ({num_processes}) or this process's id ({process_id}): "
                         f"set SPACAP_NUM_PROCESSES and SPACAP_PROCESS_ID")
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, not device={device!r}; "
                         f"pass backend='gloo' to run ranks on the CPU")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    _side_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))
    if dev.type == "cuda":
        dev = rank_device(dev)
        torch.cuda.set_device(dev)
        try:
            check_one_rank_per_device(allgather_pyobj(_device_identity(dev)), backend)
        except ValueError:
            shutdown()
            raise
    return process_id, num_processes


def shutdown() -> None:
    """Leaves the process group (a no-op outside one)."""
    global _side_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _side_group = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(items: Sequence, rank: Optional[int] = None,
                  world: Optional[int] = None) -> List:
    """This rank's round-robin shard of a work list (``items[rank::world]``),
    so that a seed list balances however the world divides it."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return list(items[rank::world])


def warmup_collectives(device="cuda") -> None:
    """One tiny all-reduce on this rank's device right after init, and an
    all-gather of the ranks over the side group: NCCL forms its
    communicator at the first collective, so every rank forms it now,
    seconds apart, and not at a first train step (or a grid's row merge)
    that ranks reach far apart. A no-op outside a group."""
    if not dist.is_initialized():
        return
    x = torch.ones(1, device=rank_device(device))
    dist.all_reduce(x)
    world = dist.get_world_size()
    ranks = allgather_pyobj(dist.get_rank())
    if int(x.item()) != world or ranks != list(range(world)):
        raise RuntimeError(f"warm-up over {world} ranks: all-reduce {x.item()}, "
                           f"all-gather {ranks}")


def allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather one byte string a rank (any lengths), over the gloo side
    group: the lengths first, then the payloads padded to the longest."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [payload]
    world = dist.get_world_size()
    data = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if payload else \
        torch.zeros(0, dtype=torch.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([data.numel()], dtype=torch.int64), group=_side_group)
    longest = max(int(s) for s in sizes)
    padded = torch.zeros(longest, dtype=torch.uint8)
    padded[:data.numel()] = data
    out = [torch.zeros(longest, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(out, padded, group=_side_group)
    return [bytes(o[:int(s)].numpy()) for o, s in zip(out, sizes)]


def allgather_ints(value: int) -> List[int]:
    """All-gather one integer a rank over the gloo side group (one
    all-gather of an int64); the rank-indexed list."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [value]
    if _side_group is None:
        raise RuntimeError("no side group: join the process group through "
                           "multihost.initialize_from_env")
    out = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([value], dtype=torch.int64), group=_side_group)
    return [int(o) for o in out]


def allgather_pyobj(obj) -> List:
    """All-gather one JSON-serialisable object a rank; returns the
    rank-indexed list (equal on every rank)."""
    return [json.loads(p.decode("utf-8"))
            for p in allgather_bytes(json.dumps(obj).encode("utf-8"))]


def replicate_global(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Broadcasts ``src``'s parameters and buffers to every rank of
    ``group``, in place (one broadcast a dtype), so that every rank starts
    from the same weights. A no-op outside a group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    tensors = list(module.state_dict().values())
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=src, group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
