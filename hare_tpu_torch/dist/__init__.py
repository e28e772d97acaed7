"""Ray-parallel execution over ``torch.distributed`` (counterpart of
``hare_tpu/dist``): rays split by rank, geometry and materials replicated,
histograms and gradients summed over ranks."""

from .sharding import (
    backend_for,
    init_distributed,
    make_train_step,
    sharded_histogram,
)

__all__ = [
    "backend_for",
    "init_distributed",
    "make_train_step",
    "sharded_histogram",
]
