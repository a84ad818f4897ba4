"""The port's batched step on the CPU: `slam_step` of D segments under
`torch.func.vmap` (`frontend.batched_init_state`, `batched_slam_step`), the
batched body that `StepGraph(maps, cfg, batch=D)` captures
(`_advance_batched`), and that graph's CPU calls, against each segment's own
`slam_step`.

D = 3 segments of T = 4 u8 frames at the 512 px config of
`tests/test_torch_batch_odometry.py`: one moving 1.2 m a frame (plain frames
and keyframes, clear of the 2.0 m threshold), one 2.4 m a frame (every frame
a keyframe), one whose second frame is a scan from 30 m off its track (too
few inliers: a coast, with a retrack).  Bound: equal bit for bit, every
state leaf and every output, with vmap's per-op fallback (a loop over the
segments) disabled, so an op without a batching rule fails the test.
"""

import contextlib

import numpy as np
import pytest
import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.utils.checkpoint import state_leaves, states_equal
from tests.test_torch_batch_odometry import CFG_KW
from tests.torch_host_reads import HOST_DATA_OPS, SYNC_OPS, Forbid

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

D, T = 3, 4
STEPS = [(1.2, 0.0, 0.0), (2.4, 0.2, 0.02), (1.2, 0.0, 0.03)]
OFF_TRACK = (2, 2)   # (segment, frame) of the scan from off the track


@contextlib.contextmanager
def no_vmap_fallback():
    """An op with no batching rule raises inside this block, where vmap would
    otherwise loop over the batch."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)


def _frames(cfg):
    frames = np.zeros((D, T, cfg.num_azimuths, cfg.polar_width_padded), np.uint8)
    for d in range(D):
        poses = np.zeros((T, 3))
        for t in range(1, T):
            poses[t] = poses[t - 1] + STEPS[d]
        if d == OFF_TRACK[0]:
            poses[OFF_TRACK[1]] = poses[OFF_TRACK[1] - 1] + [0.0, 30.0, 0.0]
        scans = fd.render_sequence(np.random.default_rng(100 + d), poses, cfg,
                                   n_landmarks=900, noise=0.01)
        for t, (_, scan) in enumerate(scans):
            frames[d, t] = np.clip(np.round(scan * 255.0), 0, 255)
    return torch.as_tensor(frames)


@pytest.fixture(scope="module")
def run():
    """Frames, maps and each segment's own states and outputs, frame by frame."""
    cfg = SlamConfig(**CFG_KW)
    maps = TF.build_frame_maps(cfg, "cpu")
    frames = _frames(cfg)
    states, outs = [], []
    for d in range(D):
        s = TF.init_state(frames[d, 0], torch.zeros(3), maps, cfg)
        ss, oo = [s], []
        for t in range(1, T):
            s, o = TF.slam_step(s, frames[d, t], maps, cfg)
            ss.append(s)
            oo.append(o)
        states.append(ss)
        outs.append(oo)
    return dict(cfg=cfg, maps=maps, frames=frames, states=states, outs=outs)


def _assert_segments_equal(batched, run, t):
    """Every segment of a batched state equals its own run's state at frame t."""
    parts = TF.unstack_states(batched)
    assert len(parts) == D
    for d, s in enumerate(parts):
        assert states_equal(s, run["states"][d][t]), (d, t)


def _assert_outputs_equal(out, run, t):
    for d in range(D):
        for name in TF.StepOutput._fields:
            a, b = getattr(out, name)[d], getattr(run["outs"][d][t - 1], name)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, d, t)


def test_the_segments_see_every_kind_of_frame(run):
    """The sequence holds plain frames, keyframes, retracks and a coast."""
    cfg = run["cfg"]
    kinds = set()
    for oo in run["outs"]:
        for o in oo:
            if int(o.n_inliers) < cfg.min_inliers_accept:
                kinds.add("coast")
            kinds.add("retrack" if bool(o.did_retrack) else
                      "keyframe" if bool(o.is_keyframe) else "plain")
    assert kinds == {"plain", "keyframe", "retrack", "coast"}, kinds


def test_batched_step_equals_each_segment_bit_for_bit(run):
    """init_state and slam_step under vmap, frame after frame: every state
    leaf and every output of every segment equal to its own run's, with no
    vmap fallback, and no DoH launch on the CPU."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    before = doh_cuda.launches
    with no_vmap_fallback():
        s = TF.batched_init_state(frames[:, 0], torch.zeros(D, 3), maps, cfg)
        _assert_segments_equal(s, run, 0)
        for t in range(1, T):
            s, out = TF.batched_slam_step(s, frames[:, t], maps, cfg)
            assert out.pose.shape == (D, 3)
            _assert_segments_equal(s, run, t)
            _assert_outputs_equal(out, run, t)
    assert doh_cuda.launches == before


def test_batched_body_equals_each_segment_bit_for_bit(run):
    """`_advance_batched`, the body the batched graph captures: each segment's
    next state written into its slice of the batched buffers (its map row at
    its own cursor) and its packed row into [D, 13], bit for bit, frame
    after frame, in the same buffers, with no vmap fallback."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    own = TF.clone_state(TF.stack_states([run["states"][d][0] for d in range(D)]))
    buffers = [t.data_ptr() for t in state_leaves(own)]
    packed = torch.zeros(D, TF.PACKED_WIDTH)
    with no_vmap_fallback():
        for t in range(1, T):
            TF._advance_batched(own, frames[:, t], maps, cfg, packed)
            _assert_segments_equal(own, run, t)
            _assert_outputs_equal(TF.unpack_output(packed), run, t)
            for d in range(D):
                assert torch.equal(packed[d], TF.pack_output(run["outs"][d][t - 1]))
    assert [t.data_ptr() for t in state_leaves(own)] == buffers


def test_batched_step_does_not_sync(run):
    """The batched init, step and body with host reads, data-dependent shapes
    and tensors from host data forbidden (what a capture cannot hold)."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    with Forbid(SYNC_OPS):
        s0 = TF.batched_init_state(frames[:, 0], torch.zeros(D, 3), maps, cfg)
    with Forbid(SYNC_OPS + HOST_DATA_OPS):
        s, _ = TF.batched_slam_step(s0, frames[:, 1], maps, cfg)
        TF._advance_batched(TF.clone_state(s0), frames[:, 1], maps, cfg,
                            torch.zeros(D, TF.PACKED_WIDTH))
    _assert_segments_equal(s, run, 1)


def test_batched_graph_on_the_cpu_is_the_vmapped_step(run):
    """StepGraph(batch=D)'s calls on the CPU: rows [D, 13] of each segment's
    outputs, its snapshot each segment's state; a state or a graph of
    another batch is refused."""
    cfg, maps, frames = run["cfg"], run["maps"], run["frames"]
    g = TF.StepGraph(maps, cfg, batch=D)
    s0 = TF.stack_states([run["states"][d][0] for d in range(D)])
    with pytest.raises(ValueError, match="batch"):
        g.load(run["states"][0][0])
    with pytest.raises(ValueError, match="batch"):
        TF.StepGraph(maps, cfg).load(s0)
    g.load(s0)
    for t in range(1, T):
        row = g.step(frames[:, t])
        assert row.shape == (D, TF.PACKED_WIDTH)
        _assert_outputs_equal(g.output(), run, t)
    _assert_segments_equal(g.snapshot(), run, T - 1)


def test_stack_and_unstack_are_inverse(run):
    states = [run["states"][d][1] for d in range(D)]
    stacked = TF.stack_states(states)
    assert stacked.pose.shape == (D, 3) and stacked.map.cursor.shape == (D,)
    assert stacked.map.poses.shape == (D, run["cfg"].max_keyframes, 3)
    for a, b in zip(TF.unstack_states(stacked), states):
        assert states_equal(a, b)


def test_motion_solve_under_vmap_is_each_segment_alone():
    """The LM at `SlamConfig()`'s K = 256 (J [515, 6]), where a batched
    product or Cholesky solve sums in another order than a single one even on
    the CPU: under vmap `lm_delta`'s batching rule solves each system on its
    own, so `solve_motion` of D segments gives each segment its own bits."""
    from radarslampy_tpu_torch.ops.motion import lm_delta, solve_motion

    cfg = SlamConfig()
    K = cfg.k_max
    rng = np.random.default_rng(11)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    pose_prev = f32(rng.normal(0, [5.0, 5.0, 0.5], (D, 3)))
    p_w = f32(rng.uniform(-60, 60, (D, K, 2)))
    pose = pose_prev + f32(rng.normal(0, [1.5, 0.3, 0.02], (D, 3)))
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    d = p_w - pose[:, None, :2]
    p_jt = torch.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], -1)
    p_jt = p_jt + f32(rng.normal(0, 0.05, (D, K, 2)))
    mask = torch.as_tensor(rng.random((D, K)) < 0.8)
    init = pose + f32(rng.normal(0, [0.2, 0.2, 0.01], (D, 3)))
    with no_vmap_fallback():
        batched = torch.func.vmap(lambda *a: solve_motion(*a, cfg))(pose_prev, p_w, p_jt, init,
                                                                     mask)
        J = f32(rng.normal(0, 1, (D, 2 * K + 3, 6)))
        r = f32(rng.normal(0, 1, (D, 2 * K + 3)))
        lam = f32(10.0 ** rng.uniform(-3, 1, D))
        deltas = torch.func.vmap(lm_delta)(J, r, lam)
    for k in range(D):
        one = solve_motion(pose_prev[k], p_w[k], p_jt[k], init[k], mask[k], cfg)
        for a, b in zip(batched, one):
            assert torch.equal(a[k], b)
        assert torch.equal(deltas[k], lm_delta(J[k], r[k], lam[k]))
