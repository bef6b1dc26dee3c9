"""End-to-end training driver with checkpoint/restart and failure simulation.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 50 --ckpt-every 10 --ckpt-dir <dir> [--device cpu]
    # kill it any time; rerunning the same command resumes from the last
    # committed checkpoint (parameters, optimizer state and the data
    # pipeline's position). --simulate-failure N aborts after step N to
    # exercise the restart path deterministically.

It runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card. The reference's ``repro.launch.train``, flag for flag;
checkpoints keep the reference's key paths (bfloat16 leaves as their
bits, ``repro_torch.ft.checkpoint``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.models import params as PM
from repro_torch.models.common import ShardCtx, torch_dtype
from repro_torch.training.optimizer import adafactor, adamw, cosine_schedule
from repro_torch.training.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    opt = adamw() if args.optimizer == "adamw" else adafactor()
    sched = cosine_schedule(args.lr, warmup=max(args.steps // 10, 1),
                            total=args.steps)
    step_fn = make_train_step(cfg, opt, ShardCtx(), accum=args.accum)

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch * args.accum, seed=0,
                         over_factor=1)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = opt.init(params)
    start = 0
    if mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore((params, opt_state))
        start = extra["step"] + 1
        pipe.load_state_dict(extra["pipe"])
        print(f"[restore] resumed from step {extra['step']}")

    shape = (args.accum, args.batch, args.seq)
    t0 = time.time()
    for step in range(start, args.steps):
        toks, labels = pipe.next_batch()
        batch = {
            "tokens": torch.as_tensor(toks.reshape(shape), device=dev).long(),
            "labels": torch.as_tensor(labels.reshape(shape), device=dev).long(),
        }
        dt = torch_dtype(cfg.compute_dtype)
        if cfg.cross_attn:
            batch["ctx"] = torch.zeros(
                shape[:2] + (cfg.cross_attn.n_ctx, cfg.d_model), dtype=dt,
                device=dev)
        if cfg.enc_dec:
            batch["enc"] = torch.zeros(shape + (cfg.d_model,), dtype=dt,
                                       device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             sched(step))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if step == args.simulate_failure:
            print(f"[failure] simulated crash at step {step}")
            raise SystemExit(42)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step, (params, opt_state),
                           {"step": step, "pipe": pipe.state_dict()})
    mgr.wait()
    mgr.save(args.steps - 1, (params, opt_state),
             {"step": args.steps - 1, "pipe": pipe.state_dict()})
    print("done")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
