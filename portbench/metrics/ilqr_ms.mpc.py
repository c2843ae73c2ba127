"""Host milliseconds a replan of the program's ``ilqr/solve`` range (the
batched iLQR solve, a CUDA graph's replay on the card) on the traced
replans of the MPC battery."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None or "ilqr/solve" not in tr.spans:
        return None
    return span_ms_per(layer, "ilqr/solve", tr.spans["ilqr/solve"][0])
