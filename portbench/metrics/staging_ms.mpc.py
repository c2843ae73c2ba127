"""Host milliseconds a battery of the program's ``mpc/staging`` range
(``compute_staging``: the polar grid's RS completions and the templates'
sweep) in the traced part of the MPC battery."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "mpc/staging" not in tr.spans:
        return None
    return span_ms_per(layer, "mpc/staging", tr.spans["mpc/staging"][0])
