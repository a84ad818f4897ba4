"""Launch geometry of the DoH kernel (`csrc/doh.cu`), computed in Python by
`ops/cuda/doh_cuda.py`: shared memory within a block's limit, refusal of a
radius that does not fit, and a grid that writes every (sigma, pixel) once."""

import numpy as np
import pytest
import torch

from radarslampy_tpu_torch.ops.cuda import doh_cuda

# blur radii of the sigmas the configs and tests use: 0.1, 1, 2, 4, 5, 10
CONFIG_RADII = (0, 3, 6, 12, 15, 30)
N_SM = 132  # SMs of an H100 SXM


@pytest.mark.parametrize("radius", CONFIG_RADII)
def test_shared_memory_fits(radius):
    g = doh_cuda.launch_geometry(1024, (radius,), N_SM)
    assert g.smem_bytes == doh_cuda.smem_bytes(radius) <= 232_448
    assert g.block == doh_cuda.THREADS
    # as many blocks as the registers allow share an SM at the default radii
    g3 = doh_cuda.launch_geometry(1024, (3, 15, 30), N_SM)
    assert doh_cuda.BLOCKS_PER_SM * (g3.smem_bytes + 1024) <= doh_cuda.SM_SHARED


def test_radius_beyond_the_limit_is_refused():
    rmax = doh_cuda.max_radius(2)
    assert rmax >= max(CONFIG_RADII)
    doh_cuda.launch_geometry(256, (3, rmax), N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        doh_cuda.launch_geometry(256, (3, rmax + 1), N_SM)
    with pytest.raises(ValueError):
        doh_cuda.launch_geometry(256, (), N_SM)
    with pytest.raises(ValueError):
        doh_cuda.launch_geometry(256, (3,) * (doh_cuda.MAX_SIGMA + 1), N_SM)


def test_filters_beyond_the_limit_have_no_geometry():
    # filters of radius max_radius() + 1 build, but no launch geometry exists
    # for them; the CUDA wrapper asks for it before it builds or launches
    r = doh_cuda.max_radius() + 1
    taps = np.zeros(2 * r + 1, np.float32)
    taps[r] = 1.0
    filters = doh_cuda.filters_from_taps([taps], (40.0,), "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        doh_cuda.launch_geometry(64, filters.radii, N_SM)


@pytest.mark.parametrize("size", [77, 1000, 1024])
@pytest.mark.parametrize("radii", [(3, 15, 30), (0, 6), (6, 12)])
def test_grid_covers_every_pixel_once(size, radii):
    g = doh_cuda.launch_geometry(size, radii, N_SM)
    count = np.zeros((len(radii), size, size), np.int32)
    for b, s, y0, x0, rows, cols in doh_cuda.work_items(size, radii, N_SM):
        assert 0 <= b < g.grid
        assert 0 < rows <= doh_cuda.TILE_H and 0 < cols <= doh_cuda.TILE_W
        count[s, y0:y0 + rows, x0:x0 + cols] += 1
    assert (count == 1).all()
    assert g.grid <= doh_cuda.BLOCKS_PER_SM * N_SM and all(g.slots)
    # the schedule the kernel reads: offsets, then the items block by block
    sched = doh_cuda.schedule_array(g)
    assert sched.dtype == np.int32 and len(sched) == g.grid + 1 + sum(map(len, g.slots))
    assert sched[g.grid] == len(sched) - g.grid - 1


def test_schedule_balances_the_blocks():
    # longest item first to the least-loaded block: no block's work exceeds
    # another's by more than one item
    radii = (3, 15, 30)
    g = doh_cuda.launch_geometry(1024, radii, N_SM)
    tiles = g.n_strips * g.n_bands
    loads = [sum(doh_cuda.item_cost(radii[i // tiles]) for i in sl) for sl in g.slots]
    assert max(loads) - min(loads) <= doh_cuda.item_cost(max(radii))
    assert g.grid == doh_cuda.BLOCKS_PER_SM * N_SM


def test_redundant_work_at_the_default_config():
    # multiply-adds issued over the separable minimum, per sigma (1, 5, 10)
    f = doh_cuda.redundant_work(1024, (3, 15, 30))
    assert all(1.0 < x < 1.5 for x in f)


def test_filters_are_checked_when_built():
    with pytest.raises(ValueError):
        doh_cuda.filters_from_taps([np.ones(4, np.float32)], (1.0,), "cpu")
    with pytest.raises(ValueError):
        doh_cuda.filters_from_taps([np.ones(3, np.float32)], (1.0, 2.0), "cpu")
    f = doh_cuda.build_doh_filters((1.0, 5.0, 10.0), "cpu")
    assert f.taps.dtype == torch.float32 and f.taps.shape == (3, 61)
    assert f.scales == (1.0, 625.0, 10000.0) and f.taps.is_contiguous()
    assert f.radii == (3, 15, 30)
