"""Training driver: the step builder and a CLI for small real runs on one
device (the JAX package's ``launch/train.py``).

A train step is the reference's, run eagerly: the chunked-CE loss and
its gradient (``loss.backward()`` into the f32 masters), global-norm
clip, cosine LR, AdamW.  Fault tolerance: checkpoint every
``ckpt_every`` steps (async), deterministic data skip-ahead on restart.

Under a mesh the step takes placed parameters and AdamW state
(``dist.device_put`` by ``dist.sharding``'s rules; ``in_shardings``
places them, as the reference's ``jax.jit(step, in_shardings=...)``
does): the loss gathers the parameters for compute (the FSDP
all-gather, counted in ``dist.gather.copied_bytes``), the gradient
reaches each device's chunk (the reduce-scatter), and each device
updates its own chunks; ``out_shardings`` places the results.

Run it on the card, or on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mistral-nemo-12b --reduced --steps 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import dist
from ..ckpt import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..data import SyntheticTokens
from ..models import api
from ..models.transformer import tree, tree_map
from ..optim import adamw_init, adamw_update, clip_by_global_norm, \
    cosine_schedule

__all__ = ["build_train_step", "train_loop", "main"]


def build_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                     total_steps: int = 10_000, clip: float = 1.0,
                     weight_decay: float = 0.1, in_shardings=None,
                     out_shardings=None):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: ``params`` a ``Decoder`` or a tree of placed masters,
    updated in place with its ``opt_state`` (``optim.AdamWState``);
    ``metrics`` holds the loss, the global gradient norm before clipping
    and the learning rate, as 0-dim f32 tensors (read them only where
    the host needs them: each read waits for the device).
    ``in_shardings`` ``(params, opt_state, batch, step)`` places those
    inputs first (a leaf already so placed is not copied; the step's is
    unused: it is a host int) and ``out_shardings`` ``(params,
    opt_state, metrics)`` the outputs (None leaves one as it is), the
    counterpart of the reference's ``jax.jit(step, in_shardings=(p_sh,
    o_sh, b_sh, repl), out_shardings=(p_sh, o_sh, None))``."""
    def grads_of(params, batch):
        if isinstance(params, dict):
            shards = [t for x in dist.placed_leaves(params)
                      for t in x.shards.values()]
            for t in shards:
                t.requires_grad_(True)
            loss = api.loss_fn(params, cfg, batch)
            loss.backward()
            grads = dist.map_placed(lambda x: x.map(_grad), params)
            for t in shards:
                t.grad = None
                t.requires_grad_(False)
            return loss, grads
        params.requires_grad_(True)
        loss = api.loss_fn(params, cfg, batch)
        loss.backward()
        return loss, tree_map(_grad, tree(params))

    def train_step(params, opt_state, batch, step):
        if in_shardings is not None:
            params, opt_state, batch = (
                x if sh is None else dist.device_put(x, sh)
                for x, sh in zip((params, opt_state, batch), in_shardings))
        loss, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup_steps=warmup,
                             total_steps=total_steps)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         weight_decay=weight_decay)
        if not isinstance(params, dict):
            params.zero_grad(set_to_none=True)
        metrics = {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}
        out = (params, opt_state, metrics)
        if out_shardings is not None:
            out = tuple(x if sh is None else dist.device_put(x, sh)
                        for x, sh in zip(out, out_shardings))
        return out
    return train_step


def _grad(t):
    """``t``'s gradient; zeros where the loss does not reach ``t`` (an
    unused shared block, a stack of zero layers), as the reference's
    ``jax.value_and_grad`` gives them."""
    return torch.zeros_like(t) if t.grad is None else t.grad


def train_loop(cfg, *, steps: int, seq_len: int, global_batch: int,
               seed: int = 0, ckpt_dir: str | None = None,
               ckpt_every: int = 50, log_every: int = 10,
               peak_lr: float = 3e-4, resume: bool = True,
               on_metrics=None, device="cuda"):
    """Single-device training loop (examples, tests, ``chip_smoke.py``).
    Weights are drawn from ``seed`` on ``device`` (other numbers than the
    reference's ``jax.random``), data from ``SyntheticTokens(seed)``.
    With ``ckpt_dir`` and ``resume`` it restores ``(params, opt_state)``
    from the latest committed step and continues there."""
    device = torch.device(device)
    data = SyntheticTokens(cfg.vocab_size, seq_len, global_batch, seed=seed)
    params = api.init_params(torch.Generator(device=device).manual_seed(seed),
                             cfg, device=device)
    opt_state = adamw_init(params)
    start = 0
    if ckpt_dir and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), meta, start = restore_checkpoint(
                ckpt_dir, last, (params, opt_state))
            start = int(start)
            print(f"[train] resumed from step {start}")

    step_fn = build_train_step(cfg, peak_lr=peak_lr, total_steps=steps)
    history = []
    writer = None               # the async save in flight, if any
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = {k: v.to(device) for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['gnorm']:.3f} lr {m['lr']:.2e}")
            if on_metrics:
                on_metrics(m)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            _join(writer)
            writer = save_checkpoint(ckpt_dir, step + 1, (params, opt_state),
                                     meta={"arch": cfg.name},
                                     async_save=True)
    if ckpt_dir:
        # the final save may write the step the last async save writes:
        # let that one finish first, so neither removes the other's files
        _join(writer)
        save_checkpoint(ckpt_dir, steps, (params, opt_state),
                        meta={"arch": cfg.name})
    return params, opt_state, history


def _join(writer) -> None:
    if writer is not None:
        writer.join()


def main(argv=None):
    ap = argparse.ArgumentParser(description="repro_torch trainer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train_loop(cfg, steps=args.steps, seq_len=args.seq_len,
               global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
               peak_lr=args.peak_lr, device=device)


if __name__ == "__main__":
    main()
