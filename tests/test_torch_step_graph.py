"""The port's step with no host sync: the decision on the device, the masked
keyframe write, the peeling loop with no host check, and the body that
`StepGraph` captures, on the CPU.

A frame of each kind goes through both packages' steps from the same JAX
state: plain, keyframe, keyframe with a retrack, and a coast (too few inliers
to trust the fit).  The sequence moves 1.2 m a frame (keyframes at 2.4 m,
clear of the 2.0 m threshold); its coast frame is a scan from 30 m off the
track, where no feature tracks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import frontend as JF
from radarslampy_tpu.sim import fakedata as jfd
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import frame_maps_from_numpy, slam_state_from_numpy
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.utils.checkpoint import state_leaves, states_equal
from tests.torch_host_reads import HOST_DATA_OPS, SYNC_OPS, Forbid

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
STEP_M = 1.2
COAST_AT = 7        # frame index of the scan from off the track
N_FRAMES = 9
KINDS = {"plain": (False, False), "keyframe": (True, False),
         "keyframe_retrack": (True, True)}


def u8(scan):
    return np.clip(np.round(scan * 255.0), 0, 255).astype(np.uint8)


def _poses():
    poses = np.zeros((N_FRAMES, 3))
    for t in range(1, N_FRAMES):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [STEP_M * np.cos(th), STEP_M * np.sin(th), 0.0]
    poses[COAST_AT] = poses[COAST_AT - 1] + [0.0, 30.0, 0.0]
    return poses


@pytest.fixture(scope="module")
def run():
    """Frames, both packages' maps, and the JAX step's states along the track."""
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    frames = [u8(s) for _, s in jfd.render_sequence(np.random.default_rng(5), _poses(), jcfg,
                                                    n_landmarks=1200, noise=0.01)]
    jmaps = JF.build_frame_maps(jcfg)
    jinit = jax.jit(lambda p, m: JF.init_state(p, jnp.zeros(3), m, jcfg))
    jstep = jax.jit(lambda s, p, m: JF.slam_step(s, p, m, jcfg))
    states = [jinit(jnp.asarray(frames[0]), jmaps)]
    outs = []
    for f in frames[1:]:
        s, o = jstep(states[-1], jnp.asarray(f), jmaps)
        states.append(s)
        outs.append(o)
    return dict(cfg=cfg, frames=[torch.as_tensor(f) for f in frames], states=states,
                outs=outs, maps=frame_maps_from_numpy(jmaps, cfg, "cpu"))


def _kind(out, cfg):
    if int(out.n_inliers) < cfg.min_inliers_accept:
        return "coast"
    flags = (bool(out.is_keyframe), bool(out.did_retrack))
    return next(k for k, v in KINDS.items() if v == flags)


def test_step_matches_jax_on_every_kind_of_frame(run):
    """Each frame from the JAX state of the frame before: the flags, counts
    and map cursor equal, the pose within the bound of
    tests/test_torch_frontend.py (1e-3 m, 1e-4 rad)."""
    cfg, maps = run["cfg"], run["maps"]
    kinds = []
    for js, jo, frame, js_next in zip(run["states"], run["outs"], run["frames"][1:],
                                      run["states"][1:]):
        ts, to = TF.slam_step(slam_state_from_numpy(js, cfg, "cpu"), frame, maps, cfg)
        for f in ("is_keyframe", "did_retrack", "n_inliers", "n_tracked", "fit_ok"):
            assert getattr(to, f).item() == np.asarray(getattr(jo, f)).item(), f
        dp = np.abs(to.pose.numpy() - np.asarray(jo.pose))
        assert dp[:2].max() < 1e-3 and dp[2] < 1e-4, dp
        np.testing.assert_array_equal(ts.feat_mask.numpy(), np.asarray(js_next.feat_mask))
        np.testing.assert_array_equal(ts.feat_id.numpy(), np.asarray(js_next.feat_id))
        assert int(ts.next_id) == int(js_next.next_id)
        for f in ("cursor", "frame_ids", "feat_ids", "feat_mask", "pc_mask"):
            np.testing.assert_array_equal(getattr(ts.map, f).numpy(),
                                          np.asarray(getattr(js_next.map, f)), f)
        kinds.append(_kind(to, cfg))
    assert set(kinds) == {"plain", "keyframe", "keyframe_retrack", "coast"}, kinds
    assert kinds[COAST_AT - 1] == "coast"


def test_step_and_chunk_do_not_sync(run):
    """init_state, slam_step and slam_step_chunk over every kind of frame
    with the host reads and data-dependent shapes forbidden; the step and the
    chunk also with tensors from host data forbidden (the tables they use
    are made once per device, by a first call outside the check)."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    with Forbid(SYNC_OPS):
        s0 = TF.init_state(frames[0], torch.zeros(3), maps, cfg)
    TF.slam_step(s0, frames[1], maps, cfg)
    with Forbid(SYNC_OPS + HOST_DATA_OPS):
        s = s0
        for f in frames[1:]:
            s, _ = TF.slam_step(s, f, maps, cfg)
        s_c, _ = TF.slam_step_chunk(s0, torch.stack(frames[1:]), maps, cfg)
    assert states_equal(s, s_c)


def test_fmt_step_does_not_sync(run):
    """The step with FMT (`use_fmt=True`: phase correlation of log-polar
    scans seeds KLT) under the same check, over the first frames."""
    cfg = SlamConfig(use_fmt=True, **KW)
    maps = TF.build_frame_maps(cfg, "cpu")
    frames = run["frames"]
    s = TF.init_state(frames[0], torch.zeros(3), maps, cfg)
    TF.slam_step(s, frames[1], maps, cfg)
    with Forbid(SYNC_OPS + HOST_DATA_OPS):
        for f in frames[1:4]:
            s, out = TF.slam_step(s, f, maps, cfg)
    assert float(out.fmt_scale) != 1.0


def test_forbid_catches_a_host_read():
    """The check itself: a step that reads a flag to the host is caught."""
    x = torch.ones(3)
    with pytest.raises(AssertionError, match="_local_scalar_dense"), Forbid(SYNC_OPS):
        bool(x.sum() > 0)


def _map_case(cfg, cursor):
    m = TF.empty_map(cfg, device="cpu")
    g = torch.Generator().manual_seed(cursor)
    m = TF.MapState(*(torch.rand(t.shape, generator=g).to(t.dtype) if t.dim() else t
                      for t in m))
    m = m._replace(cursor=torch.tensor(cursor, dtype=torch.int32))
    K, P = cfg.k_max, cfg.pc_points_per_kf
    row = (torch.full((3,), 7.0), torch.full((K, 2), 8.0), torch.full((K, 2), 9.0),
           torch.full((K,), 5, dtype=torch.int32), torch.ones(K, dtype=torch.bool),
           torch.full((3,), 6.0), torch.full((cfg.sc_rings, cfg.sc_sectors), 4.0),
           torch.full((P, 2), 3.0), torch.ones(P, dtype=torch.bool),
           torch.tensor(42, dtype=torch.int32))
    return m, row


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("cursor", [3, 16])
def test_masked_keyframe_write(in_place, cursor):
    """No keyframe: the map's bytes and its cursor as they were.  A keyframe:
    the row at the cursor (the last row once the map is full) and the cursor
    one on, clamped; every other row as it was."""
    cfg = SlamConfig(**KW)
    m, row = _map_case(cfg, cursor)
    before = [t.clone() for t in m]
    no = TF._write_keyframe(TF.MapState(*(t.clone() for t in m)),
                            torch.tensor(False), *row, in_place=in_place)
    for a, b in zip(no, before):
        assert torch.equal(a, b)
    src = TF.MapState(*(t.clone() for t in m))
    yes = TF._write_keyframe(src, torch.tensor(True), *row, in_place=in_place)
    c = min(cursor, cfg.max_keyframes - 1)
    assert int(yes.cursor) == min(cursor + 1, cfg.max_keyframes)
    assert torch.equal(yes.frame_ids[c], torch.tensor(42, dtype=torch.int32))
    assert torch.equal(yes.poses[c], torch.full((3,), 7.0))
    for name, a, b in zip(TF.MapState._fields, yes, before):
        if name != "cursor":
            keep = torch.arange(a.shape[0]) != c
            assert torch.equal(a[keep], b[keep]), name
    # functional unless in place
    assert all(torch.equal(a, b) for a, b in zip(src, before)) != in_place


def test_in_place_body_equals_the_step(run):
    """`_advance`, the body StepGraph captures, writes into its state's own
    buffers what slam_step returns, bit for bit, frame after frame; the
    packed row unpacks to the step's outputs, dtypes included."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    s = TF.init_state(frames[0], torch.zeros(3), maps, cfg)
    own = TF.clone_state(s)
    buffers = [t.data_ptr() for t in state_leaves(own)]
    packed = torch.zeros(TF.PACKED_WIDTH)
    for f in frames[1:]:
        s, out = TF.slam_step(s, f, maps, cfg)
        TF._advance(own, f, maps, cfg, packed)
        assert states_equal(own, s)
        got = TF.unpack_output(packed)
        for name in TF.StepOutput._fields:
            a, b = getattr(got, name), getattr(out, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert [t.data_ptr() for t in state_leaves(own)] == buffers


def test_step_graph_on_the_cpu_is_the_eager_step(run):
    """StepGraph's calls on the CPU (load, step, output, snapshot) and the
    chunk give slam_step's results; a step before load raises."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    g = TF.StepGraph(maps, cfg)
    with pytest.raises(RuntimeError, match="before load"):
        g.step(frames[1])
    s0 = TF.init_state(frames[0], torch.zeros(3), maps, cfg)
    g.load(s0)
    s = s0
    rows = []
    for f in frames[1:]:
        s, out = TF.slam_step(s, f, maps, cfg)
        rows.append(g.step(f).clone())
        assert all(torch.equal(a, b) for a, b in zip(g.output(), out))
    assert states_equal(g.snapshot(), s)
    s_c, outs = TF.slam_step_chunk(s0, torch.stack(frames[1:]), maps, cfg)
    assert states_equal(s_c, s)
    assert torch.equal(torch.stack([TF.pack_output(TF.StepOutput(*(x[i] for x in outs)))
                                    for i in range(len(rows))]), torch.stack(rows))
    s_g, outs_g = TF.slam_step_chunk(s0, torch.stack(frames[1:]), maps, cfg, g)
    assert states_equal(s_g, s)
    assert all(torch.equal(a, b) for a, b in zip(outs_g, outs))
    other = TF.StepGraph(TF.build_frame_maps(cfg, "cpu"), cfg)
    with pytest.raises(ValueError, match="other maps"):
        TF.slam_step_chunk(s0, torch.stack(frames[1:]), maps, cfg, other)


def test_tables_outlive_their_cache_while_held(run):
    """A step inside `kept_by(holder)` appends every device table it looks up
    to `holder`; a second step looks up the same tables; after the caches
    are cleared a step makes new ones, and the holder still has the old."""
    from radarslampy_tpu_torch.ops import features, motion, tables, tracking

    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    s = TF.init_state(frames[0], torch.zeros(3), maps, cfg)
    held = [[], [], []]

    def step(holder):
        with tables.kept_by(holder):
            TF._advance(TF.clone_state(s), frames[1], maps, cfg,
                        torch.zeros(TF.PACKED_WIDTH))

    step(held[0])
    step(held[1])
    caches = (features._gaussian_taps, features._sigma_table, tracking._binomial_taps,
              motion._information)
    for cached in caches:
        cached.cache_clear()
    step(held[2])
    first, again, fresh = ({id(t) for t in h} for h in held)
    assert first and first == again and not first & fresh
    assert len(held[0]) == len(held[2])
    assert all(torch.equal(a, b) for a, b in zip(held[0], held[2]))
    # outside a block nothing is appended
    n = len(held[0])
    TF.slam_step(s, frames[1], maps, cfg)
    assert len(held[0]) == n and tables._holders == []
