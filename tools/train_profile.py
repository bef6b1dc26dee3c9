#!/usr/bin/env python3
"""Where phase 11's full-width train step spends its time, on the card.

    python3 tools/train_profile.py [--seed N] [--top 20]

Builds phase 11's run (qwen2.5-3b at its published widths and depth, bf16,
random weights from ``init_params`` on the card, AdamW, ``accum`` 2 x 4 x
512 tokens from the ``TokenPipeline``, recomputation on), takes two
warm-up steps, then prints, after the card's name and power limit:
  - the step's host time between synchronisations (median of 3), and of
    its parts, each timed alone on the same state and batch: one
    microbatch's loss and gradients (``train_loop.value_and_grad``),
    the same without recomputation (``remat=False``), and the optimizer
    update (``opt.update`` on float32 gradients of the parameters' shapes);
  - a ``torch.profiler`` window over one step (``chip_smoke.device_profile``):
    the device's busy time (the union of its activity intervals) and idle
    share, and the ``--top`` kernels by device time with their launches.
It only times: phase 11 of ``chip_smoke.py`` checks the step.
"""
from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def host_ms(fn, reps=3):
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.core.types import resolve_device
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params as PM
    from repro_torch.training import adamw, make_train_step
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.train_loop import value_and_grad

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    dev = resolve_device(None)
    cfg = configs.get(cs.LM_ARCH)
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(cfg, opt, accum=cs.TRAIN_ACCUM)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=cs.TRAIN_S,
                         global_batch=cs.TRAIN_B * cs.TRAIN_ACCUM,
                         seed=args.seed, over_factor=1)
    shape = (cs.TRAIN_ACCUM, cs.TRAIN_B, cs.TRAIN_S)
    batch = cs._train_batch(cfg, pipe, shape, dev)
    lr = torch.tensor(cs.TRAIN_LR)
    for _ in range(2):
        step(params, state, batch, lr)

    step_ms, samples = host_ms(lambda: step(params, state, batch, lr))
    mb = {k: v[0] for k, v in batch.items()}

    def micro(remat):
        return value_and_grad(cfg, params, mb, loss_fn=functools.partial(
            lm_loss, remat=remat))

    micro_ms, _ = host_ms(lambda: micro(True))
    micro_off_ms, _ = host_ms(lambda: micro(False))
    torch.cuda.reset_peak_memory_stats()
    grads = PM.tree_map(lambda p: torch.full(p.shape, 1e-4, device=dev),
                        params)
    update_ms, _ = host_ms(lambda: opt.update(grads, state, params, lr))
    update_peak = torch.cuda.max_memory_allocated()
    del grads
    print(f"step {step_ms:.3f} ms (samples "
          f"{', '.join(f'{x:.3f}' for x in samples)}); one microbatch's loss and gradients {micro_ms:.3f} ms with "
          f"recomputation, {micro_off_ms:.3f} ms without; AdamW update "
          f"{update_ms:.3f} ms (peak memory during it "
          f"{update_peak / 1e9:.3f} GB)", flush=True)

    wall, busy, per = cs.device_profile(
        lambda: step(params, state, batch, lr))
    if not per:
        print("the profiler recorded no device activity (not measured)")
        return 1
    print(f"profiled step: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.4f}; "
          f"{sum(c for c, _ in per.values())} device activities", flush=True)
    for name, (count, sec) in sorted(per.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(f"  {sec * 1e3:10.3f} ms {count:7d} x  {name[:110]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
