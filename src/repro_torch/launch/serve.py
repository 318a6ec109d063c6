"""Serving driver: batched prefill + decode with a pre-allocated KV arena
(the JAX package's ``launch/serve.py``).

The server keeps one cache arena sized to ``max_len``; requests are
processed in fixed batches — prefill fills the arena, then greedy or
sampled decode steps run until length.  Generation runs under
``torch.inference_mode()``, and the compute-dtype copy of the weights is
made once per :func:`generate` call (``api.prepare``), not per token.
Under ``dist.use_mesh`` it takes the parameters placed (``dist.device_put``
by ``dist.sharding``'s rules; ``tp`` is the reference's serving rule):
``prepare`` gathers them once, the caches are placed and decode runs the
sequence-parallel ``_decode_sp``.

Run it on the card, or on the CPU with the kernels' plain versions::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-nemo-12b --reduced [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import api


def build_serve_fns(cfg):
    """``(prefill, decode)`` closed over ``cfg``; each takes the
    parameters as a ``Decoder`` or as the tree ``api.prepare`` made."""
    def prefill(params, batch):
        return api.prefill_step(params, cfg, batch)

    def decode(params, tok, caches, pos):
        return api.decode_step(params, cfg, tok, caches, pos)
    return prefill, decode


@torch.inference_mode()
def generate(cfg, params, batch, *, max_new_tokens: int, max_len: int,
             temperature: float = 0.0, seed: int = 0):
    """Greedy (or sampled) generation for a batch of prompts:
    ``(B, max_new_tokens)`` int32 tokens on the prompts' device.  Sampling
    draws from a ``torch.Generator`` seeded with ``seed`` (other numbers
    than the reference's ``jax.random``)."""
    prefill, decode = build_serve_fns(cfg)
    p = api.prepare(params, cfg)
    tokens = batch["tokens"]
    prompt_len = tokens.shape[1]
    logits, caches = prefill(p, batch)
    caches = api.pad_caches(caches, max_len)
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    outs = []
    for i in range(max_new_tokens):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / temperature, -1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        tok = torch.clamp(tok, max=cfg.vocab_size - 1).to(torch.int32)
        outs.append(tok)
        logits, caches = decode(p, tok, caches, prompt_len + i)
    return torch.cat(outs, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="repro_torch server (batched)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device, dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.vision_seq:
        # the VLM family's stub: zero patch embeddings over the first
        # vision_seq positions
        batch["vision_embeds"] = torch.zeros(
            args.batch, cfg.vision_seq, cfg.d_model,
            dtype=getattr(torch, cfg.compute_dtype), device=device)
    if cfg.family == "audio":
        # the encoder-decoder family's stub: zero frame embeddings
        batch["enc_frames"] = torch.zeros(
            args.batch, cfg.encoder_seq, cfg.d_model,
            dtype=getattr(torch, cfg.compute_dtype), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = generate(cfg, params, batch,
                   max_new_tokens=args.max_new_tokens,
                   max_len=args.prompt_len + args.max_new_tokens + 8)
    out = out.cpu()
    dt = time.perf_counter() - t0
    n_tok = out.numel()
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {device}")
    print(out[:, :12])


if __name__ == "__main__":
    main()
