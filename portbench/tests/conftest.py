"""The harness's CPU tests run several workers at once: one PyTorch thread
each keeps them from starving one another (as a benchmark run keeps one)."""
import torch

torch.set_num_threads(1)
