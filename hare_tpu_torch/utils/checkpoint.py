"""Checkpoint / resume with ``torch.save`` (``hare_tpu/utils/checkpoint.py``).

An inverse-design sweep checkpoints what it cannot rebuild: the mesh
vertices, the material parameters, the optimizer's ``state_dict()``, the
random generator's ``get_state()`` and the ray-batch cursor.  Acceleration
structures are deterministic functions of the mesh and are REBUILT on
restore, never stored.

Each step is one file, ``step_<n>.pt``, written to a temporary name,
flushed to disk (``fsync``) and moved into place with ``os.replace``, so a
crash after :func:`save_state` returns cannot lose the step and a crash
during it leaves no partial file under a step's name.  The newest
``MAX_TO_KEEP`` steps stay.  Recovery is fail fast, then restart from
:func:`latest_step` with :func:`restore_state`.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

__all__ = ["MAX_TO_KEEP", "latest_step", "restore_state", "save_state"]

# Steps kept, as the JAX package's Orbax manager keeps (max_to_keep=3).
MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_state(directory: str, step: int, state: Any) -> None:
    """Save ``state`` (nested dicts, lists and tuples of tensors and Python
    scalars: parameters, ``optimizer.state_dict()``, a generator's
    ``get_state()``, the cursor) as step ``step``; durable on return.  Steps
    beyond the newest ``MAX_TO_KEEP`` are deleted."""
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        torch.save(state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    _fsync_dir(directory)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    """The most recent saved step, or None when there is none."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _devices(template: Any, out: set) -> set:
    if isinstance(template, torch.Tensor):
        out.add(template.device)
    elif isinstance(template, dict):
        for v in template.values():
            _devices(v, out)
    elif isinstance(template, (list, tuple)):
        for v in template:
            _devices(v, out)
    return out


def _match(template: Any, loaded: Any, where: str) -> Any:
    """``loaded`` checked against ``template`` (keys, lengths, each tensor's
    shape and dtype, each scalar's type) and each tensor placed on its
    template's device."""
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint {where}: a {type(loaded).__name__}, not a tensor")
        if loaded.shape != template.shape or loaded.dtype != template.dtype:
            raise ValueError(f"checkpoint {where}: {tuple(loaded.shape)} {loaded.dtype}, the "
                             f"template {tuple(template.shape)} {template.dtype}")
        return loaded.to(template.device)
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            have = sorted(map(str, loaded)) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"checkpoint {where}: keys {have}, the template "
                             f"{sorted(map(str, template))}")
        return {k: _match(template[k], loaded[k], f"{where}/{k}") for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(template):
            raise ValueError(f"checkpoint {where}: not a sequence of {len(template)}")
        return type(template)(_match(t, x, f"{where}[{i}]")
                              for i, (t, x) in enumerate(zip(template, loaded)))
    if type(loaded) is not type(template):
        raise ValueError(f"checkpoint {where}: a {type(loaded).__name__}, the template a "
                         f"{type(template).__name__}")
    return loaded


def restore_state(directory: str, template: Any, step: Optional[int] = None) -> Any:
    """The state saved at ``step`` (default: the latest), checked against
    ``template`` — the freshly initialized state of the same structure —
    key by key, with each tensor's shape and dtype, and each tensor placed
    on its template tensor's device.  ``torch.load(weights_only=True)``
    maps the storages straight to the template's device where it has one,
    through the host where its tensors sit on several (a card's parameters
    beside an optimizer's step counts or a generator's state, which live
    on the CPU).  Raises ``FileNotFoundError`` when there is no checkpoint
    and ``ValueError`` when the checkpoint does not fit the template."""
    step = latest_step(directory) if step is None else step
    if step is None or not os.path.exists(_path(directory, step)):
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' {step}'} in "
                                f"{directory}")
    devices = _devices(template, set())
    where = next(iter(devices)) if len(devices) == 1 else "cpu"
    loaded = torch.load(_path(directory, step), map_location=where, weights_only=True)
    return _match(template, loaded, "")
