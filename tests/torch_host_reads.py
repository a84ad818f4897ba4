"""What a body captured in a CUDA graph must not do, checked on the CPU.

A `TorchDispatchMode` that fails on the named ops.  It imports no JAX, so the
rank processes of `tests/torch_dist_ranks.py` use it as the test files do.
"""

from torch.utils._python_dispatch import TorchDispatchMode

# What a step must not do: read a value to the host (`.item()`, `bool()`,
# `.tolist()` all end in _local_scalar_dense), take a shape from data, or
# make a tensor from host data (torch.tensor / as_tensor of numpy: on the
# card a copy from the host, which a CUDA graph cannot hold).
SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select")
HOST_DATA_OPS = ("aten.lift_fresh",)


class Forbid(TorchDispatchMode):
    def __init__(self, names):
        super().__init__()
        self.names = names

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(str(func).startswith(n) for n in self.names):
            raise AssertionError(f"{func} inside the step")
        return func(*args, **(kwargs or {}))
