"""Host milliseconds of the program's ``env/step`` range per control step of
the traced battery steps: the environment's control step,
``ParkingEnv.batch_step``: transition, RS search and observation."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None:
        return None
    return span_ms_per(layer, "env/step", tr.units)
