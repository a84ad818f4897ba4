"""The port's bench (`radarslampy_tpu_torch.bench`) on the CPU at small
sizes: its workload against bench.py's, built from the JAX package's
`sim/fakedata` in bench.py's rng order; its three paths against each other
and against the JAX step; its entry point; and the measuring helpers it
shares with chip_smoke.py."""

import contextlib
import io
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import frontend as JF
from radarslampy_tpu.sim import fakedata as jfd
from radarslampy_tpu_torch import bench
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models import frontend as F
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.utils.checkpoint import states_equal
from radarslampy_tpu_torch.utils.profiling import (device_busy_us, launched_us, lost_launches,
                                                   step_profile)

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

# tests/test_torch_sequence.py's config: full grid, fewer candidates and LM steps
KW = dict(cart_size=1024, cart_downsample=4, n_candidates=512, mds_iterations=8)
N_MEAS, CHUNK = 4, 3     # two chunks, the second ragged


def _bench_py_workload(cfg, seed, n_warm, n_meas):
    """bench.py's sequence (`bench.py:93-118`), built from the JAX package."""
    rng = np.random.default_rng(seed)
    T = n_warm + n_meas + 1
    poses = np.zeros((T, 3))
    v, w = 10.0 * cfg.scan_period_s, 0.03
    for t in range(1, T):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [v * np.cos(th), v * np.sin(th), w]
    world_pts, world_refl = jfd.make_world_corridor(rng, poses, cfg.max_range_clip_m,
                                                    per_scan=120.0)
    scans = [jfd.render_polar_scan(world_pts, world_refl, p, cfg, rng=rng, noise=0.02)
             for p in poses]
    return poses, scans


@pytest.mark.parametrize("seed", [0, 7])
def test_workload_is_bench_py_s(seed):
    poses, scans = bench.make_workload(SlamConfig(), seed, n_warm=2, n_meas=3)
    jposes, jscans = _bench_py_workload(JaxConfig(), seed, 2, 3)
    assert np.array_equal(poses, jposes)
    assert scans.dtype == np.float32 and scans.shape == (6,) + jscans[0].shape
    assert all(s.tobytes() == j.tobytes() for s, j in zip(scans, jscans))


@pytest.fixture(scope="module")
def paths():
    """Each path once over bench.py's workload at KW on the CPU."""
    cfg = SlamConfig(**KW)
    poses, scans_np = bench.make_workload(cfg, 0, bench.N_WARM, N_MEAS)
    scans = torch.as_tensor(scans_np)
    maps = F.build_frame_maps(cfg, "cpu")
    trials = {p: [bench.run_trial(p, scans, maps, cfg, CHUNK)]
              for p in bench.PATHS}
    return cfg, poses, scans_np, trials


def test_paths_end_equal(paths):
    _, _, _, trials = paths
    bench.check_trials(trials)
    ref = trials["per_call_sync"][0]
    assert len(ref.frame_ms) == N_MEAS and ref.outs.pose.shape == (N_MEAS, 3)
    for p in bench.PATHS:
        r = trials[p][0]
        assert states_equal(r.state, ref.state), p
        assert int(r.state.frame_idx) == bench.N_WARM + N_MEAS
        assert bench._counts(r) == bench._counts(ref), p
        assert r.fps > 0
    # every frame of the curve is a keyframe (2.5 m > the 2 m threshold)
    assert bool(ref.outs.is_keyframe.all())


def test_check_trials_refuses_a_differing_trial(paths):
    """check_trials names a trial whose state, outputs or counts differ."""
    _, _, _, trials = paths
    ref = trials["per_call_sync"][0]
    moved = ref.state._replace(pose=ref.state.pose + 1e-6)
    bad_state = dict(trials, chunked=[ref._replace(state=moved)])
    with pytest.raises(RuntimeError, match="chunked trial 1.*final states differ"):
        bench.check_trials(bad_state)
    bad_outs = ref.outs._replace(n_inliers=ref.outs.n_inliers + 1)
    with pytest.raises(RuntimeError, match="outputs \\['n_inliers'\\] differ"):
        bench.check_trials(dict(trials, per_dispatch=[ref._replace(outs=bad_outs)]))
    with pytest.raises(RuntimeError, match="launches"):
        bench.check_trials(dict(trials, per_dispatch=[ref._replace(doh_launches=1)]))


def test_per_call_poses_match_the_jax_chain(paths):
    """The per_call_sync poses against the JAX slam_step chain over the same
    scans, within tests/test_torch_sequence.py's bound at 8 LM steps: one
    Cartesian pixel and 1/512 rad."""
    cfg, poses, scans, trials = paths
    jcfg = JaxConfig(**KW)
    maps = JF.build_frame_maps(jcfg)
    state = jax.jit(lambda p, m: JF.init_state(p, jnp.zeros(3), m, jcfg))(
        jnp.asarray(scans[0]), maps)
    step = jax.jit(lambda s, p, m: JF.slam_step(s, p, m, jcfg))
    jest = []
    for t, scan in enumerate(scans[1:], start=1):
        state, out = step(state, jnp.asarray(scan), maps)
        if t > bench.N_WARM:
            jest.append(np.asarray(out.pose))
    jest = np.stack(jest)
    est = trials["per_call_sync"][0].outs.pose.numpy()
    np.testing.assert_allclose(est[:, :2], jest[:, :2], atol=cfg.cart_resolution_m, rtol=0)
    np.testing.assert_allclose(est[:, 2], jest[:, 2], atol=1.0 / 512, rtol=0)
    err = np.linalg.norm(est[:, :2] - poses[bench.N_WARM + 1:, :2], axis=1)
    assert err.max() < bench.ATE_LIMIT_M


def test_trace_window_reads_each_stage(paths):
    """The traced window on the CPU: one range per stage, a mean per step,
    no device activity."""
    cfg, _, scans, _ = paths
    maps = F.build_frame_maps(cfg, "cpu")
    tr = bench.trace_window(torch.as_tensor(scans), maps, cfg, 2)
    assert {"slam_step", "slam_step.warp", "slam_step.klt", "slam_step.peeling",
            "slam_step.lm", "slam_step.decision"} <= set(tr.stages)
    host = {k: h for k, (h, _) in tr.stages.items()}
    assert 0 < host["slam_step.klt"] < host["slam_step"] <= tr.window_ms
    assert tr.busy_ms == 0.0 and tr.doh_ms == [] and tr.doh_launches == tr.lost_unread == 0


def test_graph_trace_window_reads_the_steps(paths):
    """The graph's traced window on the CPU: one "step_graph.step" range a
    step, a window, no device activity, no stages."""
    cfg, _, scans, _ = paths
    maps = F.build_frame_maps(cfg, "cpu")
    tr = bench.trace_window(torch.as_tensor(scans), maps, cfg, 1, graph=True)
    assert tr.stages == {} and tr.window_ms > 0
    assert tr.busy_ms == 0.0 and tr.doh_ms == [] and tr.doh_launches == tr.lost_unread == 0


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--frames", "1", "--trials", "1", "--trace-frames", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_bench(SlamConfig(cart_size=256, cart_downsample=16), frames=1)


def test_cpu_entry_point_prints_bench_py_s_keys(tmp_path, monkeypatch):
    """The CLI's line on the CPU, at a 256 px grid in place of SlamConfig()'s
    1,024 px to keep the test short."""
    monkeypatch.setattr(bench, "SlamConfig",
                        lambda: SlamConfig(cart_size=256, cart_downsample=16))
    out = tmp_path / "bench.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--cpu", "--frames", "3", "--trials", "1",
                         "--trace-frames", "2", "--chunk", "2", "--out", str(out)])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    res = json.loads(lines[-1])
    assert json.loads(out.read_text()) == res
    for k in ("metric", "value", "unit", "vs_baseline", "per_call_sync_fps",
              "per_dispatch_fps", "chunked_fps", "chunk_frames", "measured_frames",
              "device_kind"):
        assert k in res, k
    assert res["device"] == "cpu" and res["value"] == res["chunked_fps"] > 0
    assert res["eager_window"]["busy_ms"] is None and res["eager_window"]["window_ms"] > 0
    assert (res["chunk_frames"], res["measured_frames"], res["per_call_samples"]) == (2, 3, 3)
    for k in ("device_kind", "card", "power_limit_w", "device_idle_share",
              "device_idle_share_untraced", "device_busy_ms", "doh_device_ms",
              "doh_bound_share", "trace_lost_unread", "doh_graph_device_ms"):
        assert res[k] is None and "not measured" in res["not_measured"][k], k
    assert all(v["device_ms"] is None and v["host_ms"] > 0 for v in res["stages"].values())
    assert res["step_bound"] is None and res["step_bound_note"]
    assert res["ate_m"] < bench.ATE_LIMIT_M and res["keyframes"] == 3
    assert set(res["doh_launches"]) == set(bench.PATHS)


def test_doh_bound_of_the_default_radii():
    radii = doh_cuda.build_doh_filters((1.0, 5.0, 10.0), "cpu").radii
    ms, by = doh_cuda.doh_bound_ms(1024, radii)
    assert radii == (3, 15, 30) and by == "operations"
    assert round(ms, 5) == 0.00685


def _ev(start, end, device=DeviceType.CUDA, name="kernel", annotation=False):
    return SimpleNamespace(device_type=device, name=name, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_busy_us_is_the_union_of_device_spans():
    events = [_ev(0, 10), _ev(5, 15), _ev(12, 14), _ev(20, 25),
              _ev(0, 100, device=DeviceType.CPU), _ev(30, 40, annotation=True),
              _ev(50, 60, name="slam_step.klt")]
    assert device_busy_us(events) == 15 + 5 + 10
    assert device_busy_us(events, skip=lambda e: e.name.startswith("slam_step")) == 20
    assert device_busy_us(events, 8, 22) == 7 + 2
    assert device_busy_us([]) == 0


def test_step_profile_refuses_a_wrong_step_count():
    step = SimpleNamespace(device_type=DeviceType.CPU, name="slam_step")
    prof = SimpleNamespace(events=lambda: [step, step])
    with pytest.raises(ValueError, match="expected 1 slam_step"):
        step_profile(prof, 1)




def _host(name, id=0, start=0, kernels=(), children=(), kind="cpu_op"):
    return SimpleNamespace(device_type=DeviceType.CPU, name=name, id=id, activity_type=kind,
                           kernels=[SimpleNamespace(duration=d) for d in kernels],
                           cpu_children=list(children),
                           time_range=SimpleNamespace(start=start, end=start + 1))


def test_launched_us_skips_cupti_overhead_records():
    """A range's device time sums its ops' kernels once: CUPTI's overhead
    records among the ops can hold a copy of an op's kernels."""
    mul = _host("aten::mul", kernels=(3.0,))
    copy = _host("aten::copy_", kernels=(2.0, 0.5), children=[_host("aten::empty")])
    overhead = _host("Activity Buffer Request", kernels=(3.0,), kind="overhead")
    lm = _host("slam_step.lm", children=[mul, overhead, copy], kind="user_annotation")
    assert launched_us(lm) == 5.5
    assert launched_us(_host("slam_step.doh", kernels=(7.0,), kind="user_annotation")) == 7.0


def test_lost_launches_are_launches_without_their_device_event():
    kernel = SimpleNamespace(device_type=DeviceType.CUDA, name="kernel", id=11)
    copy = SimpleNamespace(device_type=DeviceType.CUDA, name="Memcpy DtoH", id=13)
    events = [_host("cudaLaunchKernel", 10, start=5), _host("cudaLaunchKernel", 11, start=20),
              _host("cudaMemcpyAsync", 13, start=30), _host("cuLaunchKernel", 14, start=40),
              _host("cudaStreamSynchronize", 15, start=50), _host("aten::add", 16, start=60),
              kernel, copy]
    assert lost_launches(events) == 2          # 10 and 14
    assert lost_launches(events, t0=20) == 1   # 14
    assert lost_launches([kernel, copy]) == 0


def test_check_trace_refuses_a_trace_that_lost_events():
    bench.check_trace(0, 2, 2)
    with pytest.raises(RuntimeError, match="3 launches .* no device event"):
        bench.check_trace(3, 2, 2)
    with pytest.raises(RuntimeError, match="holds 1 DoH kernels, the counter 2 launches"):
        bench.check_trace(0, 1, 2)
