"""The PyTorch port's config, package rules and numpy data copy, held against
the JAX package."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.sim import fakedata as jax_fakedata
from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.sim import fakedata

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROPERTIES = ("clipped_range_bins", "polar_width_padded", "cart_resolution_m",
              "cart_center", "clique_dist_threshold_px", "scan_period_s")


@pytest.mark.parametrize("kw", [
    {},
    dict(cart_size=512, cart_downsample=8, n_candidates=256, k_max=128,
         doh_sigmas=(2.0, 4.0), max_keyframes=64, clique_dist_threshold_m=0.7),
])
def test_config_mirrors_jax(kw):
    a, b = SlamConfig(**kw), JaxConfig(**kw)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for p in PROPERTIES:
        assert getattr(a, p) == getattr(b, p), p


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "radarslampy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "radarslampy_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        from radarslampy_tpu_torch.models.frontend import build_frame_maps
        with pytest.raises(RuntimeError):
            build_frame_maps(SlamConfig(cart_size=64, cart_downsample=64))


@pytest.mark.parametrize("builder", ["grid", "logpolar", "warp", "doh"])
def test_map_builders_default_to_cuda(builder):
    """The public map builders default to the card, as the entry points do:
    a caller who does not ask for the CPU never gets CPU tensors silently."""
    from radarslampy_tpu_torch.ops import grid
    from radarslampy_tpu_torch.ops.cuda import doh_cuda

    cfg = SlamConfig(cart_size=64, cart_downsample=64)
    build = {"grid": lambda **kw: grid.build_grid_maps(cfg, **kw),
             "logpolar": lambda **kw: grid.build_logpolar_map(cfg, **kw),
             "warp": lambda **kw: grid.build_warp_maps(cfg, **kw),
             "doh": lambda **kw: doh_cuda.build_doh_filters(cfg.doh_sigmas, **kw)}[builder]
    assert all(t.device.type == "cpu" for t in build(device="cpu")
               if isinstance(t, torch.Tensor))
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in build() if isinstance(t, torch.Tensor))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_fakedata_copy_renders_identically():
    kw = dict(cart_size=256, cart_downsample=16)
    poses = np.array([[0.0, 0.0, 0.0], [1.5, 0.2, 0.03], [3.0, 0.5, 0.06]])
    a = list(fakedata.render_sequence(np.random.default_rng(3), poses, SlamConfig(**kw),
                                      n_landmarks=300))
    b = list(jax_fakedata.render_sequence(np.random.default_rng(3), poses, JaxConfig(**kw),
                                          n_landmarks=300))
    for (pa, sa), (pb, sb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("mode", ["max", "sum"])
def test_fakedata_copy_corridor_world_renders_identically(mode):
    """The corridor world and both blob compositions: the same rng draws,
    the same landmarks, the same scans."""
    kw = dict(cart_size=256, cart_downsample=16)
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    poses = np.array([[0.0, 0.0, 0.0], [2.2, 0.1, 0.05], [4.3, 0.3, 0.1]])
    rngs = np.random.default_rng(5), np.random.default_rng(5)
    wa = fakedata.make_world_corridor(rngs[0], poses, cfg.max_range_clip_m, per_scan=60.0)
    wb = jax_fakedata.make_world_corridor(rngs[1], poses, jcfg.max_range_clip_m, per_scan=60.0)
    for a, b in zip(wa, wb):
        np.testing.assert_array_equal(a, b)
    for p in poses:
        vel = np.array([8.0, 0.4, 0.2])
        sa = fakedata.render_polar_scan(*wa, p, cfg, velocity=vel, rng=rngs[0], mode=mode)
        sb = jax_fakedata.render_polar_scan(*wb, p, jcfg, velocity=vel, rng=rngs[1], mode=mode)
        np.testing.assert_array_equal(sa, sb)


def test_make_mesh_defaults_to_cuda_and_needs_a_process_group():
    """Like the entry points, a mesh defaults to the card: without one it
    raises unless device="cpu" is asked for; and it needs a process group."""
    from radarslampy_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="process group" if torch.cuda.is_available()
                       else "device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_make_mesh_over_a_group_of_one(tmp_path):
    """A world of one rank (gloo, a file store) is a real group: the mesh
    has the JAX package's axis names and its collectives run."""
    import torch.distributed as dist

    from radarslampy_tpu_torch.parallel import launch
    from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_size, make_mesh,
                                                     make_mesh_2d, psum, shard_along)

    assert launch.initialize(f"file://{tmp_path}/store", 1, 0, cpu=True) == "cpu"
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("kf",)
        assert axis_size(mesh) == 1 and float(psum(torch.tensor(2.5), mesh)) == 2.5
        assert torch.equal(all_gather(torch.tensor([True, False]), mesh),
                           torch.tensor([True, False]))
        assert torch.equal(shard_along(torch.arange(5), mesh), torch.arange(5))
        assert make_mesh_2d(1, 1, device="cpu").mesh_dim_names == ("kf", "batch")
        with pytest.raises(ValueError):
            make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_launcher_defaults_to_nccl_on_the_card(tmp_path):
    """The launcher runs NCCL on the card; gloo only with --cpu.  Without a
    card it raises before joining any group unless --cpu is given."""
    from radarslampy_tpu_torch.parallel import launch

    assert launch.backend() == "nccl" and launch.backend(cpu=True) == "gloo"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--cpu"):
        launch.initialize(f"file://{tmp_path}/store", 1, 0)
    with pytest.raises(RuntimeError, match="--cpu"):
        launch.main(["--proc-id", "0", "--nproc", "1", "--smoke",
                     "--coordinator", f"file://{tmp_path}/store"])
    assert not (tmp_path / "store").exists()
