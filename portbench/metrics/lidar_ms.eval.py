"""Host milliseconds of the program's ``env/lidar`` range per control step of
the traced battery steps: the lidar inside the observation,
``lidar_observation``."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None:
        return None
    return span_ms_per(layer, "env/lidar", tr.units)
