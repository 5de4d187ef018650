"""Multi-process initialization helpers.

The codec's distributed story is purely data parallel: files are
partitioned across processes (``shard_files_across_hosts``), each process
spreads its files over a mesh of its local devices
(``parallel.pipeline``), and no codec tensor ever crosses processes: every
chunk and file is independent and results are assembled on the host. So
the process group carries only the control plane, and ``gloo`` serves it on
every host, with or without a card.

Unlike the JAX package's ``initialize``, a failed initialization is never
turned into a single-process run: an explicit cluster that cannot form
raises, since a process that went on alone would encode the other
processes' files too.
"""

from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group of a multi-process run; a no-op for one
    process.

    With ``coordinator_address`` (``host:port`` of process 0), the group
    forms over ``tcp://`` and ``num_processes`` and ``process_id`` are
    required. Without it, the group forms from torchrun's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). It is a no-op when ``num_processes`` is at most 1, when no
    cluster is described (no argument and no ``WORLD_SIZE`` above 1), and
    when the group is already initialized.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if (coordinator_address is None and num_processes is None and process_id is None
            and int(os.environ.get("WORLD_SIZE", "1")) <= 1):
        return
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = "env://"
    dist.init_process_group(
        "gloo",
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def shard_files_across_hosts(n_files: int) -> range:
    """The slice of corpus file indices this process is responsible for:
    process i of P takes files [i*k, (i+1)*k) with k = ceil(n_files / P).
    One process (no group initialized) takes them all."""
    import torch.distributed as dist

    procs, me = 1, 0
    if dist.is_available() and dist.is_initialized():
        procs, me = dist.get_world_size(), dist.get_rank()
    per = -(-n_files // procs)
    return range(me * per, min((me + 1) * per, n_files))
