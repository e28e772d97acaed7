"""Frozen run configuration with CLI override (``hare_tpu/utils/config.py``).

The reference's tunables — weld precision, grid domain / target occupancy,
tree depth / leaf size — plus the batch, bounce and histogram sizes a
consumer loop needs, as one frozen dataclass overridable from the command
line.  The fields, defaults and CLI names are the JAX ``HareConfig``'s but
for the TPU traversal knobs (``cap``, ``march``, ``soft``, ``tier``,
``cap_s``), which size the JAX package's candidate buffers and traversal
rounds: the port's kernels have neither, and ``SpatialPartition`` raises on
them.  :meth:`HareConfig.from_json` still reads a JAX config's JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence

__all__ = ["HareConfig"]

# The JAX HareConfig's traversal knobs and their defaults: a JAX config's
# JSON that holds these loads here, any other value raises.
_JAX_KNOBS = {"cap": 16, "march": 32, "soft": None, "tier": None, "cap_s": None}

# Optional integer fields (None by default): the CLI parses them as int.
_OPTIONAL_INTS = ("domain", "win", "max_depth")


@dataclass(frozen=True)
class HareConfig:
    # Scene / mesh compilation (Topology ctor surface)
    precision: int = 15  # weld rounding digits (Hare_Geometry_Topology.cs:70)
    # Accel structure choice + parameters (Spatial_Partition implementations)
    accel: str = "grid"  # brute | grid | octree | kdtree | kdtree_ropes
    domain: Optional[int] = None  # fixed grid resolution (Voxel_Grid.cs:48)
    max_doublings: int = 6  # adaptive cap (Voxel_Grid.cs:128)
    avg_polys: float = 10.0  # adaptive occupancy target (Voxel_Grid.cs:128)
    # octree/kdtree depth cap (Octree - alt.cs:45, KDTree.cs:51); None =
    # right-size to the scene.
    max_depth: Optional[int] = None
    max_tris_per_node: int = 16
    kernel: str = "watertight"  # watertight (default everywhere) | mt
    # Grid window-row width (triangles per packed row); None = the grid's default.
    win: Optional[int] = None
    # Tracing
    n_rays: int = 1 << 15
    n_bounces: int = 8
    n_bins: int = 1024
    bin_dt: float = 1e-3
    sound_speed: float = 343.0
    seed: int = 0
    # Execution
    dtype: str = "float32"
    profile_dir: Optional[str] = None  # torch.profiler trace output
    metrics_path: Optional[str] = None  # JSONL metrics sink
    checkpoint_dir: Optional[str] = None

    def replace(self, **kw) -> "HareConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "HareConfig":
        """A config from :meth:`to_json`, or from the JSON of a JAX
        ``HareConfig``: a traversal knob that holds its JAX default is
        dropped, any other value raises ``ValueError`` naming it."""
        d = json.loads(s)
        for knob, default in _JAX_KNOBS.items():
            if knob in d:
                value = d.pop(knob)
                if value != default:
                    raise ValueError(
                        f"{knob}={value!r} is a TPU traversal knob (candidate buffers and "
                        "rounds); the port's kernels have none"
                    )
        return cls(**d)

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description="hare_tpu_torch run configuration")
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            if isinstance(f.default, bool):
                p.add_argument(name, action="store_true", default=f.default)
            else:
                typ = type(f.default) if f.default is not None else str
                if f.default is None and f.name in _OPTIONAL_INTS:
                    typ = int
                p.add_argument(name, type=typ, default=f.default)
        return p

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None) -> "HareConfig":
        ns = cls.parser().parse_args(argv)
        return cls(**vars(ns))

    def accel_params(self) -> dict:
        """Build parameters for ``SpatialPartition``, by accel kind: the
        grid's ``domain`` (or ``max_doublings`` and ``avg_polys``) and
        ``win``; the trees' ``max_depth`` and ``max_tris_per_node``; none for
        brute."""
        if self.accel == "grid":
            extra = {} if self.win is None else {"win": self.win}
            if self.domain is not None:
                return {"domain": self.domain, **extra}
            return {"max_doublings": self.max_doublings, "avg_polys": self.avg_polys, **extra}
        if self.accel in ("octree", "kdtree", "kdtree_ropes"):
            return {"max_depth": self.max_depth, "max_tris_per_node": self.max_tris_per_node}
        return {}
