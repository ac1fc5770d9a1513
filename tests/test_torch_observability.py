"""The port's trackers (``tracking.py``), profiler (``utils/profiler.py``),
training timeline (``telemetry/timeline.py``) and the ``Accelerator``'s
telemetry held against the JAX package's: the cases of JAX's
``tests/test_observability.py:22-542`` and ``tests/test_telemetry.py:560-
635``.  The optional trackers' libraries are not installed, so each runs
against a stand-in module put in ``sys.modules``, as JAX's tests do; the
profile schedules are held step for step to JAX's ``_Schedule`` and
``TPUProfiler`` with both packages' trace start / stop spied on.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from accelerate_tpu.telemetry import TrainTimeline as JTrainTimeline
from accelerate_tpu.telemetry import VirtualClock as JVirtualClock
from accelerate_tpu.utils import profiler as jprof
from accelerate_tpu.utils.dataclasses import ProfileKwargs as JProfileKwargs
from accelerate_tpu_torch import Accelerator, ResiliencePlugin
from accelerate_tpu_torch import tracking
from accelerate_tpu_torch.telemetry import TrainTimeline, VirtualClock, validate_chrome_trace
from accelerate_tpu_torch.tracking import JSONLTracker, filter_trackers, resolve_tracker
from accelerate_tpu_torch.utils import profiler as tprof
from accelerate_tpu_torch.utils.dataclasses import LoggerType, ProfileKwargs, TelemetryPlugin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- trackers -----------------------------------------------------------------


def test_jsonl_tracker_roundtrip(tmp_path):
    tracker = JSONLTracker("run1", logging_dir=str(tmp_path))
    tracker.store_init_configuration({"lr": 0.1, "nested": {"a": 1}})
    tracker.log({"loss": 1.5}, step=0)
    tracker.log({"loss": torch.tensor(1.0).item()}, step=1)
    cfg = json.loads((tmp_path / "run1" / "config.json").read_text())
    assert cfg["lr"] == 0.1
    lines = [json.loads(l) for l in (tmp_path / "run1" / "metrics.jsonl").read_text().splitlines()]
    assert [l["loss"] for l in lines] == [1.5, 1.0]
    assert lines[1]["_step"] == 1


def test_jsonl_tracker_survives_sigkill_without_torn_lines(tmp_path):
    """A writer killed mid-stream leaves only whole lines."""
    script = (
        "import sys\n"
        "from accelerate_tpu_torch.tracking import JSONLTracker\n"
        "t = JSONLTracker('killed', logging_dir=sys.argv[1])\n"
        "print('ready', flush=True)\n"
        "i = 0\n"
        "while True:\n"
        "    t.log({'step_metric': i, 'payload': 'x' * 200}, step=i)\n"
        "    i += 1\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                            stdout=subprocess.PIPE, text=True, cwd=REPO,
                            env={**os.environ, "PYTHONPATH": REPO})
    try:
        assert proc.stdout.readline().strip() == "ready"
        path = tmp_path / "killed" / "metrics.jsonl"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if path.exists() and path.stat().st_size > 20_000:
                break
            time.sleep(0.01)
        else:
            raise AssertionError("writer never produced enough lines")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    raw = path.read_bytes()
    lines = raw.split(b"\n")
    assert len(lines) > 20
    for line in lines:
        if line:
            rec = json.loads(line)
            assert rec["step_metric"] == rec["_step"]
    assert raw.endswith(b"\n")


def test_jsonl_tracker_logs_after_finish(tmp_path):
    tracker = JSONLTracker("late", logging_dir=str(tmp_path))
    tracker.log({"a": 1}, step=0)
    tracker.finish()
    tracker.log({"a": 2}, step=1)
    lines = [json.loads(l) for l in (tmp_path / "late" / "metrics.jsonl").read_text().splitlines()]
    assert [l["a"] for l in lines] == [1, 2]


def test_accelerator_tracker_glue(tmp_path):
    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("proj", config={"bs": 8})
    acc.log({"loss": 0.5}, step=0)
    assert acc.get_tracker("jsonl") is not None
    assert acc.get_tracker("jsonl", unwrap=True) is acc.get_tracker("jsonl")
    with pytest.raises(ValueError, match="not initialized"):
        acc.get_tracker("wandb")
    acc.end_training()
    assert (tmp_path / "proj" / "metrics.jsonl").exists()
    assert json.loads((tmp_path / "proj" / "config.json").read_text()) == {"bs": 8}


def test_filter_trackers_unknown_raises_and_missing_skips(tmp_path):
    with pytest.raises(ValueError):
        filter_trackers("definitely_not_a_tracker")
    assert filter_trackers(["jsonl"]) == [JSONLTracker]
    for name in ("wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive", "swanlab",
                 "trackio"):
        assert filter_trackers(name) == []       # not installed here: skipped
        assert name in LoggerType.list()
    own = JSONLTracker("x", logging_dir=str(tmp_path))
    assert resolve_tracker(own, "p") is own
    assert isinstance(resolve_tracker("jsonl", "p", str(tmp_path)), JSONLTracker)
    own.finish()


class _Recorder:
    """Attribute sink: each call lands in the list as (dotted.name, args,
    kwargs); attribute access nests."""

    def __init__(self, calls, prefix=""):
        self._calls, self._prefix = calls, prefix.rstrip(".")

    def __getattr__(self, name):
        dot = "." if self._prefix else ""
        return _Recorder(self._calls, f"{self._prefix}{dot}{name}")

    def __call__(self, *args, **kwargs):
        self._calls.append((self._prefix, args, kwargs))
        return _Recorder(self._calls, self._prefix + "()")

    def __setitem__(self, key, value):
        self._calls.append(("__setitem__", (key, value), {}))


def test_wandb_tracker_contract(monkeypatch):
    calls = []
    fake = types.ModuleType("wandb")
    fake.init = lambda project=None, **kw: calls.append(("init", project, kw)) or _Recorder(
        calls, "run.")
    fake.config = _Recorder(calls, "config.")
    monkeypatch.setitem(sys.modules, "wandb", fake)
    t = tracking.WandBTracker("proj")
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.0}, step=3)
    t.finish()
    assert calls[0] == ("init", "proj", {})
    assert ("config.update", ({"lr": 0.1},), {"allow_val_change": True}) in calls
    assert ("run.log", ({"loss": 1.0},), {"step": 3}) in calls
    assert calls[-1][0] == "run.finish"


def test_mlflow_tracker_contract(monkeypatch):
    calls = []
    fake = types.ModuleType("mlflow")
    rec = _Recorder(calls)
    for name in ("set_experiment", "start_run", "log_param", "log_metrics", "end_run"):
        setattr(fake, name, getattr(rec, name))
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    t = tracking.MLflowTracker("exp")
    t.store_init_configuration({"opt": {"lr": 0.1}})
    t.log({"loss": 2.0, "note": "str-dropped"}, step=7)
    t.finish()
    names = [c[0] for c in calls]
    assert names[:2] == ["set_experiment", "start_run"]
    assert ("log_param", ("opt.lr", 0.1), {}) in calls
    assert ("log_metrics", ({"loss": 2.0},), {"step": 7}) in calls
    assert names[-1] == "end_run"


def test_comet_tracker_contract(monkeypatch):
    calls = []
    fake = types.ModuleType("comet_ml")
    fake.Experiment = lambda project_name=None, **kw: calls.append(
        ("Experiment", project_name, kw)) or _Recorder(calls, "exp.")
    monkeypatch.setitem(sys.modules, "comet_ml", fake)
    t = tracking.CometMLTracker("proj")
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 0.5}, step=2)
    t.finish()
    assert calls[0] == ("Experiment", "proj", {})
    assert ("exp.log_parameters", ({"lr": 0.1},), {}) in calls
    assert ("exp.set_step", (2,), {}) in calls
    assert ("exp.log_metrics", ({"loss": 0.5},), {"step": 2}) in calls
    assert calls[-1][0] == "exp.end"


def test_aim_tracker_contract(monkeypatch, tmp_path):
    calls = []
    fake = types.ModuleType("aim")
    fake.Run = lambda repo=None, experiment=None, **kw: calls.append(
        ("Run", repo, experiment)) or _Recorder(calls, "run.")
    monkeypatch.setitem(sys.modules, "aim", fake)
    t = tracking.AimTracker("exp", logging_dir=str(tmp_path))
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.0}, step=4)
    t.finish()
    assert calls[0] == ("Run", str(tmp_path), "exp")
    assert ("__setitem__", ("hparams", {"lr": 0.1}), {}) in calls
    assert ("run.track", (1.0,), {"name": "loss", "step": 4}) in calls
    assert calls[-1][0] == "run.close"


def test_clearml_tracker_contract(monkeypatch):
    calls = []
    fake = types.ModuleType("clearml")

    class _Task:
        @staticmethod
        def init(project_name=None, **kw):
            calls.append(("Task.init", project_name))
            return _Recorder(calls, "task.")

    fake.Task = _Task
    monkeypatch.setitem(sys.modules, "clearml", fake)
    t = tracking.ClearMLTracker("proj")
    t.store_init_configuration({"lr": 0.1})
    t.log({"train/loss": 2.0}, step=5)
    t.finish()
    assert calls[0] == ("Task.init", "proj")
    assert ("task.connect_configuration", ({"lr": 0.1},), {}) in calls
    assert ("task.get_logger().report_scalar", (), {
        "title": "train", "series": "loss", "value": 2.0, "iteration": 5}) in calls
    assert calls[-1][0] == "task.close"


def test_dvclive_tracker_contract(monkeypatch):
    calls = []
    fake = types.ModuleType("dvclive")
    fake.Live = lambda **kw: _Recorder(calls, "live.")
    monkeypatch.setitem(sys.modules, "dvclive", fake)
    t = tracking.DVCLiveTracker("run")
    t.store_init_configuration({"opt": {"lr": 0.1}})
    t.log({"loss": 3.0})
    t.finish()
    assert ("live.log_params", ({"opt.lr": 0.1},), {}) in calls
    assert ("live.log_metric", ("loss", 3.0), {}) in calls
    assert [c[0] for c in calls if c[0] == "live.next_step"]
    assert calls[-1][0] == "live.end"


@pytest.mark.parametrize("mod_name,tracker_name", [("swanlab", "SwanLabTracker"),
                                                   ("trackio", "TrackioTracker")])
def test_swanlab_and_trackio_tracker_contracts(monkeypatch, mod_name, tracker_name):
    calls = []
    fake = types.ModuleType(mod_name)
    fake.init = lambda project=None, **kw: calls.append(("init", project)) or _Recorder(
        calls, "run.")
    fake.config = _Recorder(calls, "config.")
    fake.log = lambda values, **kw: calls.append(("log", values))
    fake.finish = lambda: calls.append(("finish", None))
    monkeypatch.setitem(sys.modules, mod_name, fake)
    t = getattr(tracking, tracker_name)("proj")
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.5}, step=1)
    t.finish()
    assert calls[0] == ("init", "proj")
    assert any("loss" in str(c) for c in calls)


def test_tensorboard_tracker_contract(monkeypatch, tmp_path):
    calls = []
    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = lambda d, **kw: calls.append(("SummaryWriter", d)) or _Recorder(
        calls, "w.")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    import torch.utils as tu

    monkeypatch.setattr(tu, "tensorboard", tb, raising=False)
    t = tracking.TensorBoardTracker("run1", logging_dir=str(tmp_path))
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.0, "note": "hi"}, step=2)
    t.finish()
    assert calls[0][0] == "SummaryWriter" and calls[0][1].endswith("run1")
    assert ("w.add_hparams", ({"lr": 0.1},), {"metric_dict": {}}) in calls
    assert ("w.add_scalar", ("loss", 1.0), {"global_step": 2}) in calls
    assert ("w.add_text", ("note", "hi"), {"global_step": 2}) in calls
    assert calls[-1][0] == "w.close"


# -- the profiler -------------------------------------------------------------


def test_profile_context_writes_a_trace(tmp_path):
    acc = Accelerator(cpu=True)
    with acc.profile(ProfileKwargs(output_trace_dir=str(tmp_path / "trace"))) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert p.summary["cycles"] == 1 and p.summary["traced_steps"] == [0]
    assert any("mm" in e.key for e in p.key_averages())
    from accelerate_tpu_torch.utils.profiler import CUDAProfiler

    with pytest.raises(ValueError):
        CUDAProfiler(ProfileKwargs()).key_averages()


def _spied(monkeypatch, handler_t, handler_j):
    port_events, jax_events = [], []
    monkeypatch.setattr(tprof, "start_trace",
                        lambda d, **kw: port_events.append(("start", d)) or object())
    monkeypatch.setattr(tprof, "stop_trace", lambda prof, d: port_events.append(("stop", None)))
    monkeypatch.setattr(jprof.jax.profiler, "start_trace",
                        lambda d, **kw: jax_events.append(("start", d)))
    monkeypatch.setattr(jprof.jax.profiler, "stop_trace",
                        lambda: jax_events.append(("stop", None)))
    return (tprof.CUDAProfiler(handler_t), port_events), (jprof.TPUProfiler(handler_j),
                                                          jax_events)


SCHEDULES = [
    dict(wait=2, warmup=1, active=3, repeat=1),
    dict(wait=1, warmup=0, active=1, repeat=2),
    dict(wait=1, warmup=1, active=2, repeat=0),
    dict(active=1),
    dict(wait=0, warmup=2, active=2, repeat=3),
    dict(),
]


@pytest.mark.parametrize("steps", [0, 3, 10])
@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: ",".join(
    f"{k}{v}" for k, v in s.items()) or "none")
def test_profile_schedule_step_for_step_as_jax(monkeypatch, tmp_path, schedule, steps):
    """The same wait / warmup / active / repeat arithmetic: the same window
    edges at the same steps, trace dirs, ``on_trace_ready`` calls, traced
    steps and cycles."""
    ready_t, ready_j = [], []
    t_handler = ProfileKwargs(output_trace_dir=str(tmp_path), on_trace_ready=ready_t.append,
                              **schedule)
    j_handler = JProfileKwargs(output_trace_dir=str(tmp_path), on_trace_ready=ready_j.append,
                               **schedule)
    (tp, t_events), (jp, j_events) = _spied(monkeypatch, t_handler, j_handler)
    tp._enter()
    jp._enter()
    for _ in range(steps):
        tp.step()
        jp.step()
        assert t_events == j_events
    tp._exit()
    jp._exit()
    assert t_events == j_events
    assert ready_t == ready_j
    assert tp.summary == jp.summary
    for cycle in range(4):
        sched = tprof._Schedule(schedule.get("wait", 0), schedule.get("warmup", 0),
                                max(1, schedule.get("active") or 1), schedule.get("repeat", 0))
        jsched = jprof._Schedule(sched.wait, sched.warmup, sched.active, sched.repeat)
        for step in range(cycle * 7, cycle * 7 + 7):
            assert sched.locate(step) == jsched.locate(step)


def test_profile_explicit_active_zero_rejected():
    with pytest.raises(ValueError, match="active"):
        ProfileKwargs(active=0)


def test_profile_memory_and_flops():
    handler = ProfileKwargs(profile_memory=True, with_flops=True)
    profiler = tprof.CUDAProfiler(handler)
    profiler._enter()
    flops = profiler.flops_estimate(lambda x: x @ x, torch.ones(32, 32))
    profiler._exit()
    assert flops == 2 * 32 ** 3
    assert profiler.summary["flops"] == flops
    mem = profiler.summary["memory"]
    assert {"bytes_in_use", "bytes_delta", "peak_bytes_in_use", "bytes_limit"} <= set(mem)


def test_profile_window_counts_flops(tmp_path):
    handler = ProfileKwargs(wait=1, warmup=1, active=2, output_trace_dir=str(tmp_path),
                            with_flops=True)
    with Accelerator(cpu=True).profile(handler) as p:
        for _ in range(5):
            torch.ones(16, 16) @ torch.ones(16, 16)
            p.step()
    # cycle 0 traces steps 2 and 3; cycle 1's window opens at step 6, after the block
    assert p.summary["traced_steps"] == [2, 3]
    assert p.summary["flops"] == 2 * 2 * 16 ** 3
    assert (tmp_path / "trace.json").exists()


# -- the training timeline -----------------------------------------------------


def test_train_timeline_phases_and_summary():
    tl = TrainTimeline(clock=VirtualClock(1.0))
    jtl = JTrainTimeline(clock=JVirtualClock(1.0))
    for t in (tl, jtl):
        for _ in range(3):
            with t.phase("step_dispatch"):
                pass
        with t.phase("data_wait"):
            pass
    assert tl.summary() == jtl.summary()
    assert tl.summary()["step_dispatch"]["count"] == 3
    assert validate_chrome_trace(tl.to_chrome_trace()) == []


def test_timeline_nested_phases_report_exclusive_time():
    clk = VirtualClock(1.0)
    tl = TrainTimeline(clock=clk)
    with tl.phase("data_wait"):
        clk.now += 10.0
        with tl.phase("h2d_staging"):
            clk.now += 5.0
    s = tl.summary()
    assert s["h2d_staging"]["total_s"] == pytest.approx(6.0)
    assert s["data_wait"]["total_s"] == pytest.approx(12.0, abs=1.0)
    spans = {e[1]: e[5] for e in tl.recorder.events()}
    assert spans["data_wait"] > spans["h2d_staging"] > 5.0


def test_timeline_summary_survives_ring_wrap():
    tl = TrainTimeline(capacity=4, clock=VirtualClock(1.0))
    for _ in range(10):
        with tl.phase("step_dispatch"):
            pass
    assert tl.summary()["step_dispatch"]["count"] == 10
    assert len(tl.recorder) == 4


class _Rows(torch.utils.data.Dataset):
    def __init__(self, n=64):
        rng = np.random.default_rng(42)
        self.x = rng.normal(size=(n,)).astype(np.float32)
        self.y = (2 * self.x + 3 + 0.05 * rng.normal(size=(n,))).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": torch.tensor(self.x[i]), "y": torch.tensor(self.y[i])}


def _loss(params, batch):
    return ((params["a"] * batch["x"] + params["b"] - batch["y"]) ** 2).mean()


def _train_losses(telemetry_plugin, epochs=2, **kw):
    acc = Accelerator(cpu=True, telemetry_plugin=telemetry_plugin, **kw)
    dl = acc.prepare(torch.utils.data.DataLoader(_Rows(), batch_size=16))
    state = acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())}, "adamw")
    step = acc.prepare_train_step(_loss, max_grad_norm=1.0)
    losses = []
    for _ in range(epochs):
        for batch in dl:
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
    return acc, losses


def test_accelerator_timeline_bitwise_loss_and_phases():
    acc_off, losses_off = _train_losses(TelemetryPlugin(enabled=False))
    assert acc_off.timeline is None
    acc_on, losses_on = _train_losses(TelemetryPlugin(enabled=True, trace_requests=False))
    assert losses_on == losses_off
    s = acc_on.timeline.summary()
    assert s["step_dispatch"]["count"] == len(losses_on)
    assert "data_wait" in s and "h2d_staging" in s
    assert acc_on.timeline.overhead_frac(10.0) >= 0.0


def test_guard_sync_phase_and_timeline_export(tmp_path):
    acc, losses = _train_losses(
        TelemetryPlugin(timeline=True, export_dir=str(tmp_path / "tl")),
        epochs=1, resilience_plugin=ResiliencePlugin(nan_guard=True))
    s = acc.timeline.summary()
    assert s["guard_sync"]["count"] == s["step_dispatch"]["count"] == len(losses) == 4
    acc.end_training()
    trace = json.loads((tmp_path / "tl" / "train_timeline.json").read_text())
    assert validate_chrome_trace(trace) == []
    assert {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"} >= {
        "step_dispatch", "guard_sync", "data_wait", "h2d_staging"}


def test_accelerator_slo_monitor_observes_steps():
    acc, losses = _train_losses(TelemetryPlugin(enabled=False,
                                                slo={"step_time_s": {"p99_warn": 1e9}}),
                                epochs=1)
    rep = acc.slo_monitor.report()
    assert rep["step_time_s"]["n"] == len(losses) - 1 == 3
    assert rep["step_time_s"]["status"] == "ok"
    assert rep["goodput_frac"]["p50"] > 0.99
    acc._slo_prev_step_t = 1.0
    acc.reset_step_cadence()
    assert acc._slo_prev_step_t is None


def test_telemetry_plugin_env_defaults(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TELEMETRY", "1")
    monkeypatch.setenv("ACCELERATE_TELEMETRY_RING", "64")
    monkeypatch.setenv("ACCELERATE_TELEMETRY_DIR", "/some/dir")
    p = TelemetryPlugin()
    assert p.enabled and p.timeline and p.trace_requests and p.ring_capacity == 64
    assert p.export_dir == "/some/dir"
    assert TelemetryPlugin(timeline=False).timeline is False
    with pytest.raises(ValueError):
        TelemetryPlugin(ring_capacity=0)
    with pytest.raises(ValueError):
        TelemetryPlugin(slo=[1])
    from accelerate_tpu.utils.dataclasses import TelemetryPlugin as JTelemetryPlugin

    j = JTelemetryPlugin()
    assert (j.enabled, j.timeline, j.trace_requests, j.ring_capacity, j.export_dir) == (
        p.enabled, p.timeline, p.trace_requests, p.ring_capacity, p.export_dir)
