"""What both programs share: the device check and the process group."""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as tdist

from ..dist import init_distributed

__all__ = ["join_group", "leave_group", "require_device"]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (pass ``--device cpu`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device here (torch.cuda.is_available() "
                           "is False); pass --device cpu to run on the CPU")
    return dev


def join_group(device) -> bool:
    """Join the default process group through ``dist.init_distributed``:
    ``env://`` under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set), else a
    group of one on a free ``localhost`` port; NCCL on the card, gloo on
    the CPU.  Returns whether this call made the group (False where one
    exists already: ``init_distributed`` is then a no-op)."""
    if tdist.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_distributed(device, init_method="env://")
        return True
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed(device, init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return True


def leave_group(made: bool) -> None:
    """Destroy the default group where :func:`join_group` made it."""
    if made and tdist.is_initialized():
        tdist.destroy_process_group()
