"""Host milliseconds of the program's ``env/transition`` range per control step of
the traced battery steps: the step's dynamics, termination
and reward, ``ParkingEnv._transition``."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None:
        return None
    return span_ms_per(layer, "env/transition", tr.units)
