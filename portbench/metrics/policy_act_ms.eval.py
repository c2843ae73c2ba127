"""Host milliseconds of one policy call as the program times it (its
``policy/act`` range inside the agent's ``get_action``), per call of the
traced battery steps."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "policy/act" not in tr.spans:
        return None
    return span_ms_per(layer, "policy/act", tr.spans["policy/act"][0])
