"""Share of the traced part of the MPC battery (one staging and its first
replans at each cadence) in which the card ran nothing (%)."""
from portbench.readers import device_idle


def read(layer):
    return device_idle(layer)
