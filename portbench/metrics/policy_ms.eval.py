"""Host milliseconds of one policy call (the ``portbench/policy`` range the
harness puts around the ``policy_act`` it hands ``build_episode_runner``),
per control step of the traced battery steps."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "portbench/policy" not in tr.spans:
        return None
    return span_ms_per(layer, "portbench/policy", tr.spans["portbench/policy"][0])
