"""PyTorch port vs the JAX package: fault injection, retry, stop, ingest.

The port keeps its own copies of ``utils/faults.py``, ``utils/retry.py``,
``utils/events.py``, ``utils/preempt.py`` and ``data/ingest.py``; one
``PHOTON_FAULTS`` string must drill either package the same way. Each
check runs both packages on the same inputs and wants equal answers:
parsed specs, ``flaky`` decisions, backoff schedules, NaN poisoning,
cross-process marker files, corrupted and truncated bytes, stop
decisions and shard-loss budget decisions.
"""

import dataclasses
import errno
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import ingest as jingest
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu.utils import preempt as jpreempt
from photon_ml_tpu.utils import retry as jretry
from photon_ml_tpu_torch.data import ingest as tingest
from photon_ml_tpu_torch.utils import events as tevents
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils import preempt as tpreempt
from photon_ml_tpu_torch.utils import retry as tretry

torch.set_num_threads(1)

SPEC_STRINGS = [
    "cd.update@1.1=kill:1:19",
    "cd.update@0.1=signal",
    "optimizer.gradient=nan:3",
    "ckpt.save=raise:1;ckpt.restore=corrupt:2",
    "io.shard_open=flaky:999:0.7;io.avro_read@part-1.avro=io_error:2",
    "cd.sweep=delay:1:0.25; ckpt.write_bytes=slow:4:",
    " ; io.avro_read=partial ",
]


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    monkeypatch.delenv("PHOTON_FAULTS_STATE_DIR", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


@pytest.mark.parametrize("raw", SPEC_STRINGS)
def test_parse_fault_specs_matches_jax(raw):
    got = [dataclasses.asdict(s) for s in tfaults.parse_fault_specs(raw)]
    want = [dataclasses.asdict(s) for s in jfaults.parse_fault_specs(raw)]
    assert got == want and got


@pytest.mark.parametrize("raw", ["cd.update", "cd.update=explode",
                                 "io.shard_open=flaky:1:1.5"])
def test_bad_fault_specs_raise_in_both(raw):
    with pytest.raises(ValueError):
        jfaults.parse_fault_specs(raw)
    with pytest.raises(ValueError):
        tfaults.parse_fault_specs(raw)


def test_modes_and_point_names_are_the_jax_packages():
    assert tfaults.MODES == jfaults.MODES
    assert set(tfaults.FAULT_POINTS) <= set(jfaults.FAULT_POINTS)
    for name, info in tfaults.FAULT_POINTS.items():
        assert set(info.modes) <= set(jfaults.FAULT_POINTS[name].modes), name
        assert info.has_path == jfaults.FAULT_POINTS[name].has_path, name


def test_flaky_decision_matches_jax():
    rng = np.random.default_rng(0)
    for seed in (0, 1, 42, 2 ** 31):
        for point, tag in (("io.shard_open", None), ("io.avro_read", "p0"),
                           ("ckpt.write_bytes", "")):
            for visit in range(40):
                p = float(rng.uniform())
                assert tfaults.flaky_decision(seed, point, tag, visit, p) \
                    == jfaults.flaky_decision(seed, point, tag, visit, p)


@pytest.mark.parametrize("policy", [
    dict(), dict(max_attempts=6, base_delay_seconds=0.5, seed=7),
    dict(max_attempts=4, base_delay_seconds=0.02, max_delay_seconds=0.5)])
def test_backoff_delays_match_jax(policy):
    for site in ("io.avro_read", "ckpt.write_bytes", "io.shard_open", "x"):
        assert tretry.backoff_delays(site, tretry.RetryPolicy(**policy)) \
            == jretry.backoff_delays(site, jretry.RetryPolicy(**policy))


def test_nan_poisons_floating_tensors_and_leaves_integers():
    ints = torch.arange(4)
    f32 = torch.ones(3)
    bf16 = torch.ones(2, dtype=torch.bfloat16)
    flags = torch.ones(2, dtype=torch.bool)
    out = tfaults.poison_arrays({"a": f32, "b": (ints, bf16), "c": [flags],
                                 "d": None, "e": 3.0})
    assert torch.isnan(out["a"]).all() and out["a"].dtype == torch.float32
    assert out["b"][0] is ints and isinstance(out["b"], tuple)
    assert torch.isnan(out["b"][1]).all() and out["b"][1].dtype == \
        torch.bfloat16
    assert out["c"][0] is flags and out["d"] is None and out["e"] == 3.0
    assert torch.equal(f32, torch.ones(3))  # the input is not mutated


def test_nan_poisons_numpy_like_jax():
    tree = {"f": np.ones((2, 3), np.float32), "d": np.arange(3.0),
            "i": np.arange(5, dtype=np.int32), "s": (np.zeros(2, bool),)}
    got, want = tfaults.poison_arrays(tree), jfaults.poison_arrays(tree)
    for k in ("f", "d", "i"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["s"][0], want["s"][0])
    assert np.isnan(got["f"]).all() and not np.isnan(got["i"]).any()


def test_fault_point_nan_through_arm():
    tfaults.arm("optimizer.gradient", "nan", times=1)
    x = torch.ones(4)
    assert torch.isnan(tfaults.fault_point("optimizer.gradient",
                                           arrays=x)).all()
    assert tfaults.fault_point("optimizer.gradient", arrays=x) is x
    assert tfaults.hits("optimizer.gradient") == 1


def test_tags_times_and_io_modes():
    tfaults.arm("io.avro_read", "io_error", times=2, tag="p1")
    tfaults.fault_point("io.avro_read", tag="p0")  # other tag: no-op
    for _ in range(2):
        with pytest.raises(OSError) as e:
            tfaults.fault_point("io.avro_read", tag="p1")
        assert e.value.errno == errno.EIO
    tfaults.fault_point("io.avro_read", tag="p1")  # budget spent
    tfaults.arm("ckpt.save", "raise")
    with pytest.raises(tfaults.InjectedFault) as e:
        tfaults.fault_point("ckpt.save")
    assert e.value.point == "ckpt.save"
    tfaults.arm("ckpt.write_bytes", "enospc")
    with pytest.raises(OSError) as e:
        tfaults.fault_point("ckpt.write_bytes")
    assert e.value.errno == errno.ENOSPC


def test_environment_specs_are_read_once_and_again_after_disarm(monkeypatch):
    monkeypatch.setenv("PHOTON_FAULTS", "cd.sweep@1=raise:1")
    tfaults.fault_point("cd.sweep", tag="0")
    with pytest.raises(tfaults.InjectedFault):
        tfaults.fault_point("cd.sweep", tag="1")
    tfaults.fault_point("cd.sweep", tag="1")
    tfaults.disarm_all()
    with pytest.raises(tfaults.InjectedFault):
        tfaults.fault_point("cd.sweep", tag="1")


def test_flaky_firing_pattern_matches_jax(monkeypatch):
    monkeypatch.setenv("PHOTON_FAULTS_SEED", "42")
    pattern = {}
    for name, mod in (("torch", tfaults), ("jax", jfaults)):
        mod.arm("io.shard_open", "flaky", times=999, probability=0.6)
        fired = []
        for _ in range(30):
            try:
                mod.fault_point("io.shard_open", tag="part-0.avro")
                fired.append(False)
            except OSError:
                fired.append(True)
        pattern[name] = fired
    assert pattern["torch"] == pattern["jax"] and any(pattern["torch"])


def test_state_dir_markers_are_shared_with_jax(tmp_path, monkeypatch):
    """A times=1 spec claimed by one package is spent for the other: both
    name their marker files the same way."""
    monkeypatch.setenv("PHOTON_FAULTS_STATE_DIR", str(tmp_path))
    tfaults.arm("cd.update", "raise", times=1, tag="1.1")
    jfaults.arm("cd.update", "raise", times=1, tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        tfaults.fault_point("cd.update", tag="1.1")
    jfaults.fault_point("cd.update", tag="1.1")  # the marker is taken
    assert len(os.listdir(tmp_path)) == 1


@pytest.mark.parametrize("mutate", ["corrupt_path", "truncate_path"])
def test_path_mutations_match_jax(tmp_path, mutate):
    data = np.random.default_rng(3).bytes(1000)
    for side in ("t", "j"):
        d = tmp_path / side
        d.mkdir()
        (d / "a.bin").write_bytes(data)
        (d / "b.bin").write_bytes(data[:7])
    getattr(tfaults, mutate)(str(tmp_path / "t"))
    getattr(jfaults, mutate)(str(tmp_path / "j"))
    for name in ("a.bin", "b.bin"):
        got = (tmp_path / "t" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes()
    assert (tmp_path / "t" / "a.bin").read_bytes() != data


def test_call_with_retry_recovers_and_gives_up():
    policy = tretry.RetryPolicy(max_attempts=3, base_delay_seconds=1e-4)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "transient")
        return "ok"

    assert tretry.call_with_retry(flaky, "site.a", policy) == "ok"
    assert tretry.RETRIES["site.a"] >= 2
    with pytest.raises(tretry.RetryExhaustedError) as e:
        tretry.call_with_retry(lambda: (_ for _ in ()).throw(
            tfaults.InjectedFault("x")), "site.b", policy)
    assert e.value.attempts == 3 and isinstance(e.value.last,
                                                tfaults.InjectedFault)
    with pytest.raises(ValueError):  # permanent: no retry
        tretry.call_with_retry(lambda: int("x"), "site.c", policy)
    with pytest.raises(FileNotFoundError):
        tretry.call_with_retry(lambda: open("/nonexistent/x"), "site.d",
                               policy)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _stop_trace(mod, tmp_path, steps):
    """Poll a StopController through ``steps`` of (advance, create
    stop file, latch reason) and return what each poll answered."""
    clock = _Clock()
    stop_file = str(tmp_path / f"stop_{mod.__name__.split('.')[0]}")
    ctl = mod.StopController(max_train_seconds=5.0, stop_file=stop_file,
                             clock=clock)
    out = []
    for advance, touch, latch in steps:
        clock.t += advance
        if touch:
            open(stop_file, "w").close()
        if latch:
            ctl.request_stop(latch)
        out.append(ctl.should_stop())
    return out


@pytest.mark.parametrize("steps", [
    # the stop file is polled at most every 0.25 s: the file made at
    # +0.1 s is seen at +0.3 s, not at +0.2 s
    [(0.0, False, None), (0.1, True, None), (0.1, False, None),
     (0.1, False, None), (10.0, False, None)],
    # the deadline, then a later signal: the first reason wins
    [(1.0, False, None), (4.5, False, None), (0.0, False, "signal:SIGTERM")],
    # an explicit request before anything else
    [(0.0, False, "signal:SIGINT"), (9.0, True, None)],
])
def test_stop_controller_matches_jax(tmp_path, steps):
    got = _stop_trace(tpreempt, tmp_path, steps)
    want = _stop_trace(jpreempt, tmp_path, steps)
    assert [None if g is None else g.split(":")[0] for g in got] == \
        [None if w is None else w.split(":")[0] for w in want]
    assert any(g is not None for g in got)


def test_stop_controller_signal_handlers(tmp_path):
    import signal

    ctl = tpreempt.StopController()
    before = signal.getsignal(signal.SIGTERM)
    ctl.install_signal_handlers()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert ctl.should_stop() == "signal:SIGTERM"
    finally:
        ctl.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) == before
    e = tpreempt.PreemptionRequested("deadline:max_train_seconds", 1, 0)
    assert e.step == "1.0"


@pytest.mark.parametrize("budget,outcomes", [
    (0.3, ["ok", "lost", "ok", "ok"]),
    (0.3, ["ok", "lost", "lost", "ok"]),
    (0.0, ["ok", "ok", "lost"]),
    (0.5, ["lost", "ok", "lost", "ok"]),
])
def test_ingest_budget_decisions_match_jax(budget, outcomes):
    def walk(mod):
        warned = []
        policy = mod.IngestPolicy(budget, warn=warned.append)
        policy.begin(len(outcomes))
        seen = []
        for i, o in enumerate(outcomes):
            try:
                if o == "ok":
                    policy.record_ok(f"p{i}")
                else:
                    policy.quarantine(f"p{i}", "decode", ValueError("bad"))
                seen.append(o)
            except mod.ShardLossExceededError:
                seen.append("abort")
                break
        return seen, policy.summary(), len(warned)

    got, want = walk(tingest), walk(jingest)
    assert got == want


def test_event_listener_failures_are_contained():
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    bus = tevents.EventEmitter()
    seen = []

    def broken(event):
        raise RuntimeError("listener down")

    bus.register_listener(broken)
    bus.register_listener(seen.append)
    ev = tevents.FaultEvent(point="cd.update", coordinate_id="fixed",
                            iteration=0, message="m")
    bus.send_event(ev)
    assert seen == [ev]
    errors = REGISTRY.counter("listener_errors").by_label("listener")
    assert errors[broken.__qualname__] >= 1
