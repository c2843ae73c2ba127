"""Time versions of the BEV raster kernel against each other in one run on
the card.

    python3 tools/time_raster_variants.py NAME=path/to/raster_bev.cu[:-DFLAG,...] ...

Each source is compiled with the port's nvcc flags into ``build/`` and its
``render_bev_batch`` entry point is swapped into ``ops.raster_bev.KERNEL``;
then, in the order given and again in reverse, each is held to
``render_bev_batch_plain`` (mismatches in both parity modes) and timed on
``chip_smoke.py``'s kernel-phase inputs (B = 256 DLP scenes): ``device_ms``
in exact and global mode, ``ms``, ``device_ms`` at B = 1024, and
``device_ms`` with every edge slot dead (the cost of everything but the
crossings). One JSON line per source and pass. Needs a CUDA device.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(specs):
    import torch

    import chip_smoke as cs
    from hope_tpu_torch.ops import _build
    from hope_tpu_torch.ops import raster_bev as rb

    if not torch.cuda.is_available():
        sys.exit("time_raster_variants: needs a CUDA device")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for spec in specs:
        name, src = spec.split("=", 1)
        src, _, flags = src.partition(":")
        out = os.path.join(_build.BUILD_DIR, f"variant_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *filter(None, flags.split(",")), "-o", out,
               src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        print(json.dumps({"variant": name, "ptxas": cs.ptxas_summary(log)}), flush=True)
        fn = ctypes.CDLL(out).render_bev_batch
        fn.argtypes = rb.KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda", 0)
    _, raster_in, _ = cs.kernel_inputs(dev)
    want = {ex: rb.render_bev_batch_plain(*raster_in, exact=ex) for ex in (True, False)}
    big = tuple(cs.tile4(t) for t in raster_in[:6]) + raster_in[6:]
    dead = raster_in[:4] + (torch.zeros_like(raster_in[4]),) + raster_in[5:]
    render = rb.render_bev_batch
    for name in list(fns) + list(fns)[::-1]:
        rb.KERNEL._fn = fns[name]
        mism = sum(int((render(*raster_in, exact=ex) != w).sum()) for ex, w in want.items())
        print(json.dumps({
            "variant": name, "mismatches": mism,
            "device_ms": cs.device_ms(lambda: render(*raster_in), 50),
            "global_device_ms": cs.device_ms(lambda: render(*raster_in, exact=False), 50),
            "ms": cs.cuda_ms(lambda: render(*raster_in), 50),
            "b1024_device_ms": cs.device_ms(lambda: render(*big), 50),
            "no_live_edge_device_ms": cs.device_ms(lambda: render(*dead), 50)}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
