"""The actor forward's FLOPs on the traced battery steps (FlopCounterMode,
B = the battery's episodes) over the traced seconds at the float32 peak, %."""
from portbench.readers import mfu


def read(layer):
    return mfu(layer, "flops")
