"""The multi-process runtime: one process per rank, one ``torch.distributed``
process group over all of them, counterpart of the JAX
``parallel/multihost.py``.

- :func:`initialize` brings the process group up from arguments or the
  ``SD_COORDINATOR`` / ``SD_NUM_PROCESSES`` / ``SD_PROCESS_ID``
  environment (idempotent), as the JAX package's does from the same
  variables.
- :func:`spawn` starts ``n`` ranks on this host, one process each, joins
  them in a group through :func:`initialize` at ``127.0.0.1:<free port>``
  and returns what each returned: the way the CLI, the trainer, the tests
  and ``chip_smoke.py`` run a mesh on one machine.
- :func:`global_mesh` builds the ``('dp', 'tp')`` mesh over every rank of
  the group, with each tp group inside one host.
- :func:`shard_host_batch` gives this rank its rows of a global batch, and
  :func:`fold_in_process` a data seed of its own.

The backend is NCCL when every rank has a card of its own, else gloo (on
the CPU, and when ranks share a card: NCCL refuses two ranks on one
device). :func:`initialize` tells them apart by gathering every process's
host and device before the group comes up. Each rank's device is
:func:`device`.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

# The stride of fold_in_process (a prime; see there).
SEED_STRIDE = 100_003
# Seconds a collective may wait before it fails (a rank that died or went
# another way must not hang the others).
DEFAULT_TIMEOUT_S = 600.0

_device: torch.device | None = None


def device() -> torch.device:
    """This rank's device: the one :func:`spawn` or :func:`initialize` gave
    it, else the CPU."""
    return _device if _device is not None else torch.device("cpu")


def backend_for(devices, hosts=None) -> str:
    """"nccl" when every device is a distinct card, else "gloo". ``hosts``
    (default: one host) names each device's host: ``cuda:0`` on two hosts
    are two cards."""
    devs = [torch.device(d) for d in devices]
    hosts = list(hosts) if hosts is not None else [""] * len(devs)
    if all(d.type == "cuda" for d in devs) and len(
            {(h, d.index) for h, d in zip(hosts, devs)}) == len(devs):
        return "nccl"
    return "gloo"


def rank_devices(kind: str, n: int) -> list[str]:
    """The devices of ``n`` ranks on this host: ``cuda:0`` .. ``cuda:n-1``
    (shared round-robin when the host has fewer cards), or the CPU ``n``
    times."""
    if torch.device(kind).type != "cuda":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the ranks on the CPU")
    return [f"cuda:{r % cards}" for r in range(n)]


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, kind: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               backend: str | None = None) -> None:
    """Bring up the process group (idempotent: returns when one is up).

    ``coordinator`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` come from the arguments or the ``SD_*`` environment.
    With neither, there is nothing to join: a single process runs alone.
    ``kind`` ("cuda", "cuda:N" or "cpu", default: cuda when present) picks
    the device (:func:`device`); with "cuda" a rank takes card
    ``process_id % cards``. ``backend`` (default: :func:`backend_for` over
    every process's host and device, gathered through the coordinator's
    store) is the group's."""
    global _device
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("SD_COORDINATOR")
    if num_processes is None and "SD_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SD_NUM_PROCESSES"])
    if process_id is None and "SD_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SD_PROCESS_ID"])
    if bool(coordinator) != (num_processes is not None):
        # A half-specified fleet must not silently run as disconnected
        # single-process jobs (every host would think it is process 0).
        raise ValueError(
            "multihost.initialize: coordinator and num_processes must be "
            f"given together (got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r})")
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if not coordinator:
        _device = torch.device(kind)
        return
    if process_id is None:
        raise ValueError("multihost.initialize: process_id is required "
                         "with an explicit coordinator")
    dev = torch.device(kind)
    if dev.type != "cuda":
        dev = torch.device("cpu")
    elif dev.index is None:
        dev = torch.device("cuda",
                           process_id % max(torch.cuda.device_count(), 1))
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=timeout)
    store.set(f"sd_device/{process_id}", f"{socket.gethostname()} {dev}")
    fleet = [store.get(f"sd_device/{r}").decode().split(" ")
             for r in range(num_processes)]
    backend = backend or backend_for([d for _, d in fleet],
                                     [h for h, _ in fleet])
    _device = dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(tp: int = 1):
    """The ('dp', 'tp') mesh over every rank of the group, in rank order.
    ``tp`` must divide the ranks of each host, and each tp group must lie
    on one host, so that tensor-parallel collectives never cross hosts."""
    from stroke_derenderer_tpu_torch.parallel.mesh import make_mesh
    n = process_count()
    hosts = [socket.gethostname()] * n
    if dist.is_initialized() and n > 1:
        dist.all_gather_object(hosts, socket.gethostname())
    per_host = {h: hosts.count(h) for h in hosts}
    if any(tp > k or k % tp for k in per_host.values()):
        raise ValueError(
            f"tp={tp} must divide the ranks of each host "
            f"{sorted(per_host.values())} (tensor-parallel groups must stay "
            f"on one host)")
    if any(len(set(hosts[s:s + tp])) != 1 for s in range(0, n, tp)):
        raise ValueError(f"the ranks of a tp group of {tp} lie on more than "
                         "one host: give each host contiguous ranks")
    return make_mesh(n, tp=tp)


def shard_host_batch(mesh, batch, spec=None) -> torch.Tensor:
    """This rank's rows of a global batch (numpy or tensor, leading axis
    the batch), on the rank's device: the rows of its dp index, contiguous
    blocks in dp order, as the JAX package's P('dp') lays them out. Ranks
    of one tp group get the same rows."""
    t = torch.as_tensor(batch)
    dp = mesh.shape["dp"]
    if t.shape[0] % dp:
        raise ValueError(f"batch {t.shape[0]} not divisible by dp={dp}")
    n = t.shape[0] // dp
    d = mesh.dp_index
    return t[d * n:(d + 1) * n].to(mesh.device)


def fold_in_process(seed: int, index: int | None = None) -> int:
    """A data seed of this process's own (``index``: default its rank).

    The stride is a large prime, NOT the process count: the loaders derive
    per-worker streams as seed + w (``data/loader.PrefetchLoader``), so
    adjacent per-process seeds would make process k's worker 1 repeat
    process k+1's worker 0, halving the data's diversity across dp."""
    return seed + (process_index() if index is None else index) * SEED_STRIDE


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, devices, backend, port, timeout_s, threads, fn,
               args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(f"127.0.0.1:{port}", world, rank, kind=devices[rank],
                   timeout_s=timeout_s, backend=backend)
        # Pickled by value here: the queue's own pickler would share
        # tensors through handles that die with this process.
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n: int, devices=None, backend: str | None = None,
          args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int | None = 1) -> list:
    """Run ``fn(*args)`` in ``n`` new processes (the ``spawn`` start
    method), rank r on ``devices[r]`` (default the CPU), joined in one
    process group by :func:`initialize` (``backend``: default
    :func:`backend_for` over ``devices``). Returns each
    rank's result, in rank order. Raises when a rank raised (with its
    traceback) or when the ranks are not done within ``timeout_s``; every
    process is stopped before it returns. ``threads``: each rank's
    ``torch.set_num_threads`` (None leaves torch's default). ``fn`` and
    ``args`` must pickle."""
    devices = list(devices or ["cpu"] * n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, devices, backend, port, timeout_s, threads, fn, args, results))
        for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s + 60.0
    got: dict = {}
    try:
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {n - len(got)} of {n} ranks "
                                       f"not done in {timeout_s} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead and results.empty():
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with "
                                       f"code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(n)]
