"""Host milliseconds a replan of the program's ``mpc/rs_warm`` range (the
Reeds-Shepp warm start's search, 12 words a row through the sweep kernel)
on the traced replans of the MPC battery."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "mpc/rs_warm" not in tr.spans:
        return None
    return span_ms_per(layer, "mpc/rs_warm", tr.spans["mpc/rs_warm"][0])
