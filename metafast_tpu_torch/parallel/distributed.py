"""Process groups, the mesh, the exact exchange and the rank launcher.

Counterpart of metafast_tpu/parallel/distributed.py (:25-55).  A JAX mesh
of n devices lives in one process; here every device is a rank of one
``torch.distributed`` process group, one device per rank: NCCL with
``cuda:<local rank>``, gloo on the CPU.  There is no single-process form,
so the port has one route, the JAX package's multi-process one.

Typical use, in every rank:

    from metafast_tpu_torch.parallel import distributed as D
    mesh = D.initialize(world_size, rank, "file:///tmp/store", "cuda")
    # ... sharded_count / ShardedKmerCounter / sharded_connected_labels
    D.shutdown()

``launch`` starts the ranks of ``cli --shards n``: n processes of the same
command, each told its rank, the world size and the group's store through
the environment (``RANK_ENV``, ``WORLD_ENV``, ``STORE_ENV``).

``exchange`` / ``reply`` are the uneven all-to-all that replaces the
JAX package's fixed [n_shards, cap] buckets: first the per-peer counts,
then the payload, so nothing is padded and nothing can drop.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# environment of a rank started by ``launch``
RANK_ENV = "METAFAST_RANK"
WORLD_ENV = "METAFAST_WORLD_SIZE"
STORE_ENV = "METAFAST_STORE"
# a rank that dies makes the others fail after this long, never hang
TIMEOUT = datetime.timedelta(seconds=300)
# the command of one rank; argv follows it
RANK_CMD = [sys.executable, "-m", "metafast_tpu_torch.cli"]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the default process group: its size, this rank
    and the device this rank computes and communicates on."""

    size: int
    rank: int
    device: torch.device


def initialize(world_size: int, rank: int, init_method: str,
               device: str = "cuda") -> Mesh:
    """Join the default process group and return this rank's mesh.

    ``device`` "cuda" takes ``cuda:<rank % device_count>`` over NCCL and
    raises where CUDA or NCCL is missing; "cpu" takes gloo.
    ``init_method`` is a ``file://`` path (a FileStore: ranks of one
    machine meet without a port) or ``tcp://host:port``.
    """
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was requested but "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA process group needs NCCL, which "
                               "this torch build lacks")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return global_mesh()


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh() -> Mesh:
    """The mesh of the default process group (all ranks of the job)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Mesh(dist.get_world_size(), dist.get_rank(), dev)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """global_mesh(), checked to span ``n_devices`` ranks (the JAX
    package's make_mesh takes the first n devices of one process; here
    the group's size is fixed when the ranks start)."""
    mesh = global_mesh()
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"the process group has {mesh.size} ranks, not "
                         f"{n_devices}")
    return mesh


def per_host_files(files: list, process_id: int | None = None,
                   num_processes: int | None = None) -> list:
    """Round-robin split of input files across ranks (data parallel over
    samples, as metafast_tpu/parallel/distributed.py per_host_files)."""
    initialized = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if initialized else 0)
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if initialized else 1)
    return [f for i, f in enumerate(files) if i % n == pid]


# ---------------------------------------------------------------------------
# Collectives on the mesh
# ---------------------------------------------------------------------------

def all_reduce(mesh: Mesh, value: int, op: str = "sum") -> int:
    """An integer reduced over the ranks (op: sum, min or max)."""
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}[op])
    return int(t)


def all_gather_cat(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's tensor (any length along dim 0) concatenated in rank
    order, on every rank."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device)
    sizes = [torch.empty_like(n) for _ in range(mesh.size)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    width = max(sizes)
    pad = t.new_zeros((width,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    dist.all_gather(parts, pad)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def exchange(mesh: Mesh, dest: torch.Tensor, *payload: torch.Tensor):
    """Send row j of every payload tensor to rank ``dest[j]``.

    Returns (received tensors, plan): the rows sent to this rank, grouped
    by sender in rank order, each sender's rows in their order; ``plan``
    lets ``reply`` route one answer row per received row back.
    """
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=mesh.size)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    send, recv = send.tolist(), recv.tolist()
    out = []
    for t in payload:
        got = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
        dist.all_to_all_single(got, t[order].contiguous(), recv, send)
        out.append(got)
    return out, (order, send, recv)


def reply(plan, *answers: torch.Tensor):
    """The answers to an ``exchange``, one row per received row, back at
    the senders: row j answers the sender's row j."""
    order, send, recv = plan
    out = []
    for t in answers:
        back = t.new_empty((sum(send),) + tuple(t.shape[1:]))
        dist.all_to_all_single(back, t.contiguous(), send, recv)
        res = torch.empty_like(back)
        res[order] = back
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# The rank launcher of ``cli --shards n``
# ---------------------------------------------------------------------------

def rank_from_env() -> tuple[int, int, str] | None:
    """(rank, world size, init method) of a rank started by ``launch``,
    else None."""
    if RANK_ENV not in os.environ:
        return None
    return (int(os.environ[RANK_ENV]), int(os.environ[WORLD_ENV]),
            os.environ[STORE_ENV])


def launch(argv: list[str], n: int) -> int:
    """Run ``RANK_CMD + argv`` as n ranks of one process group and wait.

    Rank 0 keeps this process's standard output; the others' goes to
    /dev/null (their errors still reach standard error).  Once a rank
    fails, the others are stopped.  Returns the worst exit code: the
    first failing rank's, or 0.
    """
    with tempfile.TemporaryDirectory(prefix="metafast-ranks-") as td:
        procs = []
        try:
            for r in range(n):
                env = dict(os.environ, **{
                    RANK_ENV: str(r), WORLD_ENV: str(n),
                    STORE_ENV: f"file://{os.path.join(td, 'store')}"})
                procs.append(subprocess.Popen(
                    RANK_CMD + list(argv), env=env,
                    stdout=None if r == 0 else subprocess.DEVNULL))
            worst = 0
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed:
                    worst = failed[0]
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if not worst:
            worst = next((p.returncode for p in procs if p.returncode), 0)
        # a rank killed by a signal has a negative code
        return worst if worst > 0 else (1 if worst else 0)
