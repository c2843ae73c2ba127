"""A traced run of the battery cell on the CPU reports the program's spans
and counters through their readers, and the idle gaps of its trace are
named by the program's spans.

On the CPU the profiler records no device activity, so the host's leaf ops
stand in for the card's kernels when the gaps are named: the harness's own
``portbench.trace.idle_gaps`` is given them and the traced pass's ranges."""
import math

from portbench import trace as trace_mod

from .cells import run_small

METRICS = ("env_step_ms.eval", "transition_ms.eval", "rs_search_ms.eval", "observe_ms.eval",
           "lidar_ms.eval", "policy_act_ms.eval", "runner_self_ms.eval",
           "rs_wanted_share.eval", "launches_per_step.eval")
PROGRAM_SPANS = ("eval/step", "policy/act", "env/")


def test_traced_run_reports_the_program_spans(tmp_path, monkeypatch):
    gaps = []
    reduce_events = trace_mod.reduce_events

    def reduce_and_name_host_gaps(events, window_s, units, top=10):
        leaves = [(e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.name.startswith("aten::") and not e.cpu_children]
        ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
                  if "/" in e.name]
        gaps.extend(trace_mod.idle_gaps(leaves, ranges, top))
        return reduce_events(events, window_s, units, top)

    monkeypatch.setattr(trace_mod, "reduce_events", reduce_and_name_host_gaps)
    line = run_small(tmp_path, "hope_sac.eval_dlp1k", trace=1)
    assert line["correct"], line["checks"]
    for m in METRICS:
        assert m in line["metrics"] and math.isfinite(line["metrics"][m]["value"]), m
    got = line["metrics"]
    # the runner's step holds the policy and the env step; the env step its parts
    assert got["env_step_ms.eval"]["value"] >= (got["transition_ms.eval"]["value"]
                                               + got["rs_search_ms.eval"]["value"])
    assert got["observe_ms.eval"]["value"] >= got["lidar_ms.eval"]["value"] > 0
    assert got["runner_self_ms.eval"]["value"] > 0
    assert 0 <= got["rs_wanted_share.eval"]["value"] <= 100
    names = [name for name, _ in gaps]
    assert len(gaps) == 10 and any(n.startswith(PROGRAM_SPANS) for n in names), names
