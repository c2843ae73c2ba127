"""Host milliseconds a replan of the program's ``mpc/waypoint`` range (the
two-segment latch: 4 staging candidates a row searched at once) on the
traced replans of the MPC battery."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "mpc/waypoint" not in tr.spans:
        return None
    return span_ms_per(layer, "mpc/waypoint", tr.spans["mpc/waypoint"][0])
