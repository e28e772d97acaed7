"""The benchmark's ray source: uniform directions on the sphere, drawn from
the seed with a ``torch.Generator`` on the device that traces them."""

from __future__ import annotations

import math
from typing import List

import torch

# A seed may be any whole number; it maps onto the generator's 64-bit seed.
_SEED_SPACE = 1 << 64


def uniform_sphere(n: int, generator: torch.Generator) -> torch.Tensor:
    """``(n, 3)`` directions uniform on the unit sphere, drawn on the
    generator's device: ``z`` uniform in [-1, 1], the azimuth uniform."""
    dev = generator.device
    z = torch.rand(n, generator=generator, device=dev) * 2.0 - 1.0
    phi = torch.rand(n, generator=generator, device=dev) * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed``; ``stream`` keeps the draws
    of one seed for different purposes apart."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % _SEED_SPACE)


def pool(seed: int, n: int, batches: int, device) -> List[torch.Tensor]:
    """The window's ray directions: ``batches`` batches of ``n``, all drawn
    on ``device`` from ``seed``."""
    g = generator(seed, device)
    return [uniform_sphere(n, g) for _ in range(batches)]


def sample(seed: int, n: int, k: int) -> torch.Tensor:
    """``min(k, n)`` distinct ray indices of a batch of ``n``, ascending,
    drawn on the CPU from ``seed``: the rays the reference re-traces."""
    idx = torch.randperm(n, generator=generator(seed, "cpu", stream=1))[:k]
    return torch.sort(idx).values
