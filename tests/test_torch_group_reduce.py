"""The ``group_reduce`` wrapper's host side on the CPU: a tail population
summed after the head, as one call of the kernel takes both; and the
checks on the row counts."""

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr


@pytest.mark.parametrize("b,tail", [(4, (16, 31)), (1, (3, 5)), (17, (1, 2)), (2, (5, 0))])
def test_tail_is_summed_after_the_head(b, tail):
    rng = np.random.default_rng(b)
    head = torch.as_tensor(rng.normal(size=(37 * b, 16)).astype(np.float32))
    rest = torch.as_tensor(rng.normal(size=(tail[0] * tail[1], 16)).astype(np.float32))
    got = gr.group_reduce(torch.cat([head, rest]), b, tail=tail)
    want = torch.cat([gr.group_reduce(head, b), gr.group_reduce(rest, tail[0])])
    assert torch.equal(got, want)
    assert got.shape == (37 + tail[1], 16)


@pytest.mark.parametrize("rows,b,tail", [(10, 3, None), (10, 4, (3, 1)), (10, 2, (3, 4)), (8, 0, None), (8, 2, (0, 1))])
def test_rows_that_are_not_groups_raise(rows, b, tail):
    with pytest.raises(ValueError):
        gr.group_reduce(torch.zeros((rows, 16)), b, tail=tail)
