"""Ray sampling (``hare_tpu/trace/sampler.py`` ``uniform_sphere``).

``torch.Generator`` streams differ from ``jax.random``'s, so parity tests
feed both packages the same NumPy directions instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["uniform_sphere"]


def uniform_sphere(
    n: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """n directions uniform on S^2 (the standard acoustic source emission).

    The numbers are drawn on the generator's device and then moved to
    ``device`` (the card unless the caller names another), so one seed gives
    the same directions on every device.
    """
    src = generator.device if generator is not None else torch.device("cpu")
    z = torch.rand(n, generator=generator, device=src, dtype=dtype) * 2.0 - 1.0
    phi = torch.rand(n, generator=generator, device=src, dtype=dtype) * (
        2.0 * math.pi
    )
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    out = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return out.to(device)
