"""Small device tables that the step looks up on every call: filter taps,
constants, the DoH kernel's schedule.

Each is made once per key (a bounded `functools.lru_cache`), because a copy
from the host in every step could not be captured in a CUDA graph.  A
captured graph reads such a table by its address and holds no reference to
it, so a table evicted from its cache while a graph that read it lives would
leave the graph reading freed memory.  `kept_by(holder)` ties the tables'
lifetime to the graph: while it is active, every table a `device_table`
function returns is also appended to `holder`, which the graph keeps.
`StepGraph` captures inside it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List

_holders: List[list] = []


def device_table(maxsize: int):
    """`functools.lru_cache(maxsize)` whose every result is also appended to
    the holders of the active `kept_by` blocks.  `cache_clear` clears the
    cache only: a holder keeps what it took."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            table = cached(*args)
            for holder in _holders:
                holder.append(table)
            return table

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def kept_by(holder: list):
    """Within the block, append every table looked up to `holder`."""
    _holders.append(holder)
    try:
        yield holder
    finally:
        _holders.remove(holder)
