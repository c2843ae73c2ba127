"""Share of the traced battery steps in which the card ran nothing (%)."""
from portbench.readers import device_idle


def read(layer):
    return device_idle(layer)
