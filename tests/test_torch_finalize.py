"""K2's hit record as its wrapper allocates it (``accel.common.empty_hit_record``).

On the card ``finalize_hits`` writes the record into nine fresh tensors.
These tests hold that allocation on a CPU device: each field's shape and
dtype, contiguous and 16-byte aligned, no two fields sharing a byte.
"""

import pytest

torch = pytest.importorskip("torch")

from hare_tpu_torch.accel import common  # noqa: E402

CPU = "cpu"

# Each field's dtype and values a ray, in HitRecord's order.
FIELDS = {"hit": (torch.bool, 1), "t": (torch.float32, 1), "u": (torch.float32, 1),
          "v": (torch.float32, 1), "point": (torch.float32, 3), "poly_id": (torch.int32, 1),
          "tri_id": (torch.int32, 1), "normal": (torch.float32, 3),
          "edge_nbr": (torch.int32, 3)}


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 127, 128, 1000, 32_775])
def test_hit_record_allocation(n):
    """The fields' shapes and dtypes, each contiguous and starting at a
    16-byte-aligned address, none overlapping another; a pattern written
    into each field reads back from it unchanged once all are written."""
    rec = common.empty_hit_record(n, CPU)
    assert rec._fields == tuple(FIELDS)
    spans = []
    for name, x in zip(rec._fields, rec):
        dtype, k = FIELDS[name]
        assert x.dtype == dtype and x.shape == ((n,) if k == 1 else (n, k)), name
        assert x.is_contiguous() and x.device.type == CPU, name
        assert x.data_ptr() % 16 == 0, name
        if x.numel():
            spans.append((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for k, x in enumerate(rec):
        x.copy_(torch.full(x.shape, k % 2 == 0) if x.dtype == torch.bool else
                torch.full(x.shape, k + 1, dtype=x.dtype))
    for k, x in enumerate(rec):
        want = (k % 2 == 0) if x.dtype == torch.bool else k + 1
        assert bool((x == want).all()), rec._fields[k]
