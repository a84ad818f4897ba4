"""Custom ops whose batching rule runs each segment of a vmapped batch on its own.

Under `torch.func.vmap` (the batched step of `models/frontend.py`, D segments
in lock-step) almost every op of the step batches with each segment keeping
the bits of its own step.  A few do not, because a batch takes another kernel
whose sums run in another order: on the card a reduction over [D, K] is
split over threads otherwise than one over [K] (the Procrustes fit's
weighted sums, the LM's cost), and a batched cuBLAS product or Cholesky
solve is another routine than a single one (the LM's 6x6 normal equations;
MAGMA's batched solve also allocates, so a CUDA graph cannot hold it).  The
LM (cond(JtJ) ~ 1e9 in float32) then moves such an ulp to millimetres of
pose.  An op made by `per_segment` keeps each segment's arithmetic: its
batching rule calls the op once for each segment of the batch and stacks the
results, so a batch of D costs D small launches where the op has one.
"""

from __future__ import annotations

import torch


def per_segment(name: str, fake):
    """Decorator: `fn` (tensors in, a tensor or a tuple of tensors out; type
    annotations give the schema) as the custom op `radarslampy::<name>`, with
    `fake` for shapes and a batching rule that runs `fn` segment by segment."""
    def wrap(fn):
        op = torch.library.custom_op(f"radarslampy::{name}", mutates_args=())(fn)
        op.register_fake(fake)

        @op.register_vmap
        def _each_segment(info, in_dims, *args):
            outs = [op(*(x if dim is None else x.select(dim, i) for x, dim in zip(args, in_dims)))
                    for i in range(info.batch_size)]
            if isinstance(outs[0], tuple):
                return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
            return torch.stack(outs), 0

        return op
    return wrap
