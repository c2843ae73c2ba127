"""Host milliseconds of the program's ``env/rs_search`` range per control step of
the traced battery steps: the Reeds-Shepp endgame search
over the whole batch, ``ParkingEnv._batch_rs``."""
from portbench.readers import span_ms_per


def read(layer):
    tr = layer.get("trace")
    if tr is None:
        return None
    return span_ms_per(layer, "env/rs_search", tr.units)
