"""BEV autoencoder pretraining (counterpart of
``hope_tpu/train/pretrain_autoencoder.py``): BEV images of random Normal
scenes -> AE reconstruction loss -> a checkpoint whose encoder
``train_sac --img-encoder`` grafts into the policy's image towers.

Every 50 steps a fresh batch of Normal scenes is rendered through
``ParkingEnv.batch_reset`` (the raster and mask kernels on the card), and the
AE trains on it with Adam. The checkpoint is the AE's ``state_dict`` at
``<log-dir>/ckpt/step_<steps>/state.pt``.

Usage: python -m hope_tpu_torch.train.pretrain_autoencoder --steps 2000
       python -m hope_tpu_torch.train.pretrain_autoencoder --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import EnvConfig, ObsConfig, actor_net_config
from ..device import resolve_device
from ..envs import ParkingEnv
from ..envs.scenario_gen import generate_bank
from ..models.autoencoder import AEConv, ae_loss
from ..utils.checkpoint import save_checkpoint

RENDER_EVERY = 50


def main(argv=None):
    """Pretrain; returns {"losses": [loss per step], "model": the AE,
    "checkpoint": the file written, "seconds": the training loop's wall}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--log-dir", type=str, default="log/ae")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps, args.batch = 3, 8
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 convolutions in full precision, as on the CPU
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    env_cfg = EnvConfig(obs=ObsConfig(use_img=True), max_edges=96, max_obstacles=32)
    env = ParkingEnv(env_cfg, device=dev)
    model = AEConv(actor_net_config(env_cfg.obs), torch.Generator().manual_seed(args.seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)

    os.makedirs(args.log_dir, exist_ok=True)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        if step % RENDER_EVERY == 0:
            with torch.no_grad():
                scenes, _ = generate_bank(gen, level="Normal", n=args.batch)
                imgs = env.batch_reset(scenes)[1]["img"]
        loss = ae_loss(model, imgs)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if step % 100 == 0 or step == args.steps - 1:
            print(json.dumps({"step": step, "loss": float(loss.detach()),
                              "elapsed": time.time() - t0}), flush=True)
    seconds = time.time() - t0

    path = save_checkpoint(os.path.join(args.log_dir, "ckpt"), model, args.steps)
    print(json.dumps({"saved": args.log_dir}))
    return {"losses": [float(v) for v in losses], "model": model, "checkpoint": path,
            "seconds": seconds}


if __name__ == "__main__":
    main()
