"""Deterministic scatter-add.

The back-end sums per-edge and per-observation blocks into per-node rows
(the JAX package's `.at[idx].add`).  `Tensor.index_add_` on a CUDA tensor
sums with atomics, so two runs can differ in the last bits, and an LM
acceptance test `new_cost < cost` can then flip and the runs drift apart.
`Tensor.index_put_(..., accumulate=True)` sorts the indices (a stable radix
sort on CUDA) and adds each index's values in that order, so it gives the
same bits on every run.  Every back-end scatter-add goes through here.
"""

from __future__ import annotations


def scatter_add(out, index, values):
    """`out` with `values[e]` added at `index[e]` (`index` a tensor, or a tuple
    of tensors indexing the leading dims of `out`); a new tensor."""
    if not isinstance(index, tuple):
        index = (index,)
    return out.index_put(index, values, accumulate=True)
