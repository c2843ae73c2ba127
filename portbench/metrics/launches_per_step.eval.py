"""Device activities (kernels, copies, sets) in the traced window per
control step of the traced battery steps (the battery's reset included)."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or tr.units <= 0:
        return None
    return sum(c for c, _ in tr.kernels.values()) / tr.units
