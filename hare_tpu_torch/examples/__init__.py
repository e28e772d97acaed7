"""The two inverse-design programs (``examples/`` of the JAX package):
``python -m hare_tpu_torch.examples.fit_absorption`` and
``python -m hare_tpu_torch.examples.fit_vertices``."""
