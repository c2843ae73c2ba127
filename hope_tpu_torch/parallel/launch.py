"""Starting the ranks of a training CLI (``--devices``, ``--coordinator``,
``--num-processes``, ``--process-id``).

``--devices`` counts the global ranks, one per device. Without
``--num-processes`` the CLI starts ``--devices`` local ranks itself (spawned
processes, rendezvous on a free localhost port); with ``--num-processes P``
each of the P launched processes runs ``--devices / P`` ranks, global rank
``process_id * (devices / P) + j``, and they rendezvous at ``--coordinator``.
A process that runs one rank runs it itself. On CUDA, local rank j takes
``cuda:j`` and the ranks talk over ``nccl``; on the CPU over ``gloo``.

A rank worker is ``worker(args, rank, world, device, backend, on_chunk)``;
:func:`rank_group` joins and leaves its process group.
"""
from __future__ import annotations

import contextlib
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import initialize_multihost, make_mesh, shutdown


def add_flags(ap):
    """The multi-process flags, as the JAX CLIs define them."""
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks, one per device: the env batch (and the replay "
                         "ring) sharded, parameters replicated, gradients summed over the "
                         "ranks. With --num-processes this counts GLOBAL ranks across the "
                         "processes")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="multi-process: rendezvous address host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-process: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process: this process's id (0-based)")


def check_flags(ap, args, divisible: dict):
    """Refuse inconsistent multi-process flags (``ap.error``, exit code 2);
    ``divisible`` maps flag names to values that must divide by
    ``--devices``."""
    if args.devices < 1:
        ap.error("--devices must be at least 1")
    P = args.num_processes
    if P is None:
        if args.process_id is not None:
            ap.error("--process-id goes with --num-processes")
    else:
        if P < 1:
            ap.error("--num-processes must be at least 1")
        if P > 1 and args.coordinator is None:
            ap.error(f"--num-processes {P} needs --coordinator host:port")
        if args.process_id is None or not 0 <= args.process_id < P:
            ap.error(f"--process-id must be in [0, {P}) with --num-processes {P}")
        if args.devices % P:
            ap.error(f"--devices {args.devices} is not a multiple of --num-processes {P}")
    if any(v % args.devices for v in divisible.values()):
        ap.error(f"{' and '.join(divisible)} must be divisible by --devices")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def rank_group(coordinator: str | None, rank: int, world: int, device, backend: str | None):
    """This rank's mesh, inside the default process group (none for one
    rank); the group is left on the way out (after a last barrier where the
    block finished), unless the block left it itself (:func:`.mesh.shutdown`),
    as a worker does after its last collective."""
    device = resolve_device(device)
    if device.index is not None and device.type == "cuda":
        torch.cuda.set_device(device)          # a rank's own card (NCCL binds to it)
    initialize_multihost(coordinator, world, rank, backend)
    mesh = make_mesh(device)
    try:
        yield mesh
    except BaseException:
        if mesh.sharded and dist.is_initialized():
            dist.destroy_process_group()
        raise
    shutdown(mesh)


def _spawned(j: int, worker, args, first: int, world: int, dev_type: str, backend: str,
             threads: int):
    torch.set_num_threads(threads)
    device = f"cuda:{j}" if dev_type == "cuda" else dev_type
    worker(args, first + j, world, device, backend, None)


def run_ranks(args, worker, on_chunk=None):
    """Run ``worker`` for the ranks of this process (the module docstring).
    With one rank it runs here with ``on_chunk`` and its result is returned;
    spawned ranks run without ``on_chunk`` and None is returned. CPU ranks
    spawned here share this process's torch threads evenly."""
    world = args.devices
    if world == 1:
        return worker(args, 0, 1, args.device, None, on_chunk)
    P = args.num_processes or 1
    n_local = world // P
    first = (args.process_id or 0) * n_local
    dev_type = torch.device(args.device).type
    if dev_type == "cuda":
        resolve_device("cuda")
        visible = torch.cuda.device_count()
        if visible < n_local:
            raise SystemExit(f"--devices {world}: {n_local} local rank(s) but only "
                             f"{visible} device(s) visible")
    backend = "nccl" if dev_type == "cuda" else "gloo"
    if args.coordinator is None:
        args.coordinator = f"localhost:{free_port()}"
    if n_local == 1:
        device = "cuda:0" if dev_type == "cuda" else args.device
        return worker(args, first, world, device, backend, on_chunk)
    threads = max(1, torch.get_num_threads() // n_local)
    torch.multiprocessing.start_processes(
        _spawned, args=(worker, args, first, world, dev_type, backend, threads),
        nprocs=n_local, join=True, start_method="spawn")
    return None
