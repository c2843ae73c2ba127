"""Host milliseconds of the program's ``env/observe`` range per control step of
the traced battery steps: the observation,
``ParkingEnv.observe_batch`` (lidar, action mask, image, target; the
battery reset's one call included)."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None:
        return None
    return span_ms_per(layer, "env/observe", tr.units)
