"""The end-to-end arithmetic on synthetic timings: the window closed by the
first step after the deadline, and every step to one synchronize."""
import pytest

from portbench import stats
from portbench.loops import sac_battery


def test_synced_rate_counts_every_step_to_the_synchronize():
    assert stats.synced_rate(0.0, 2.0, 50, 1024) == pytest.approx(25600.0)
    assert stats.synced_rate(0.0, 2.0, 0, 1024) is None


def test_policy_call_after_the_deadline_ends_the_window(monkeypatch):
    clock = iter([float(t) for t in range(100)])
    monkeypatch.setattr(sac_battery.time, "perf_counter", lambda: next(clock))
    steps = []
    rec = sac_battery.Recorder(lambda obs, g: (obs, None), lambda *a, **k: steps.append(1),
                               set(), deadline=4.5)
    rec.on = True
    rec.new_battery(1)                        # nothing to record past battery 0
    n = 0
    with pytest.raises(sac_battery.WindowClosed):
        while True:
            rec.policy({"target": None}, None)
            rec.batch_step(None, None)
            n += 1
    assert n == 5 and rec.steps == 5          # calls at t = 0..4 ran, t = 5 closed
