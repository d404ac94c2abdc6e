"""Multi-process initialization over ``torch.distributed``.

Counterpart of ``pretorched_tpu/parallel/dist.py`` (a thin wrapper over
``jax.distributed.initialize``). Call ``initialize()`` once per process; it
is a no-op that returns False for a single process.

Deliberate departure: the address, world size and rank come from the
arguments or from torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), where JAX reads ``JAX_COORDINATOR_ADDRESS``.
The backend is NCCL where CUDA is available and Gloo on the CPU; with NCCL
the process takes the card ``LOCAL_RANK`` names (else its rank modulo the
card count).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """Initialize the default process group from the arguments or
    torchrun's environment; returns False (and does nothing) when neither
    names an address or a world size."""
    env = os.environ
    if coordinator_address is None and 'MASTER_ADDR' in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and 'WORLD_SIZE' in env:
        num_processes = int(env['WORLD_SIZE'])
    if process_id is None and 'RANK' in env:
        process_id = int(env['RANK'])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(f'initialize needs an address, a world size and a '
                         f'rank; got {coordinator_address!r}, '
                         f'{num_processes!r}, {process_id!r}')
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        local = int(env.get('LOCAL_RANK', process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)
    return True


def initialize_single(backend=None):
    """A process group of this process alone, on a free port of
    localhost (what a mesh needs when no launcher started a group)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    return initialize(f'127.0.0.1:{port}', 1, 0, backend)
