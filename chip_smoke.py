#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. Card: print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written CUDA kernel from ``src/repro_torch/
   csrc`` (one ``nvcc`` per source, all started together), then count in
   the machine code (``cuobjdump --dump-sass``) the instructions that
   show the tensor-core kernels: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   loads) in the bf16 flash-attention kernel, tf32 ``HMMA`` in the GEMM
   and the tile update; printed on a ``[sass]`` line, each must be above
   0.  ``[ptxas]`` lines give the registers, spills and shared memory of
   the GEMM and flash-decode kernels.
3. Kernels: at the shapes the main paths give them, hold each kernel
   against its plain PyTorch version on the card and time the kernel,
   the plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``), each with CUDA events, L2
   flushed before every launch.  Tolerances: 1e-4 for the GEMM and the
   tile update, 1e-6 for the halo stencil at all four of the Jacobi app's
   halo shapes (corner, both edges, interior), 2e-5 for flash decode
   (``o`` and ``lse``) at the serve path's per-task shape and at
   Mistral-NeMo-12B's decode width, with K and V in f32 and in bf16
   (each call profiled once: one kernel launch; its cluster size, block
   count and resident clusters printed), rtol 1e-5 / atol
   1e-3 for Black-Scholes at the §4.2 app's 2,097,152 options plus put-call
   parity at 1e-4, and for flash attention 2e-5 in f32 and 2e-2 in bf16
   (``tests/test_kernels.py``) at the reference tests' shapes and, in
   both dtypes, the prefill continuation, the rows that see no key, group
   6, ragged Sq and Skv and head dims 32, 64 and 128, then at the prefill
   path's shape (Mistral-NeMo-12B's
   GQA width, B 4 x 1,024 tokens, bf16, causal), which is timed, as are
   B 1 x 8,192 tokens, Granite-3.0-1B-A400M's prefill (B 4, Hq 16,
   Hkv 8, 1,024 tokens, head dim 64) and one position's chunk of it on
   the (2, 2) mesh of phase 20 (B 2, Hq 8, Hkv 4), Qwen2-VL-72B's (B 4, Hq 64,
   Hkv 8, 1,024 tokens, head dim 128: group 8, 8 positions a block) and
   Zamba2-1.2B's shared attention block (B 4, Hq = Hkv = 32, 1,024
   tokens, head dim 64: group 1, 64 positions a block) and whisper-tiny
   at 1,280 frames (B 16, Hq = Hkv = 6, head dim 64, non-causal): its
   encoder's self-attention (1,280 x 1,280) and its decoder's
   cross-attention (224 queries over 1,280 frames, the last query tile
   half full), both also checked in f32 and bf16 at B 2, and the f32
   FFMA path at the prefill shape (which the f32 exactness checks of
   phases 6 and 14 launch).  ``bound_ms``
   is the least time the card could take: the bytes the function must
   move over 3.35 TB/s or its operations over the peak for their type,
   67 TFLOP/s FP32 or 989 TFLOP/s bf16 on the tensor cores (H100 SXM
   data sheet, read from
   ``repro_torch.core.costmodel.H100Params``), the larger.
   Flash attention counts 4 D operations per visible (query, key) pair.
4. Apps (main path 1): the five apps at the §4.2 sizes through
   ``TaskRuntime(executor="staged", kernel_backend="pallas",
   device="cuda")``; each verifies its own result against a plain
   reference.  The launch counters are zeroed just before and read just
   after each app; the GEMM, the tile update, the halo stencil and
   Black-Scholes must each have launched.
5. Serve (main path 2): ``repro_torch.serve_lm.run`` at ``CHIP_SIZES`` on
   ``executor="host", device="cuda"``: every row verified against the
   plain ``decode_mha``, ``requests x shards`` flash-decode launches
   (counters zeroed just before, read just after), the admission peak
   within the budget, and the restarted session's K and V bit-identical.
   Prints req/s and p50/p99 request latency (host-side completion: a
   task completes when its body has queued its kernels) and the
   device's idle share in the serving window of a second, profiled run.
6. LLM (main path 3): ``repro_torch.launch.serve.generate`` with
   Mistral-NeMo-12B at full width, cut to 8 of its 40 layers, weights
   drawn from a seed: B 4 prompts of 1,024 tokens, prefill through the
   flash-attention kernel, 32 greedy decode steps.  The counter is zeroed
   just before and read just after; one launch per layer.  Checks: the
   tokens' shape and range, finite logits, and at full width in f32 (2
   layers) the kernel's prefill logits against the plain ``chunked``
   path within 1e-3 and the decode step against the full forward
   (teacher forcing) within 2e-3; in bf16 the same two differences
   against a tolerance stated with its reason.  Prints prefill ms, decode
   ms per step, tokens/s as the reference's ``main`` counts them, peak
   device memory and the device's idle share over a second, profiled
   ``generate``.
7. Depman (main path 1 under the sharded dependence managers): the five
   apps at the §4.2 sizes, staged with the wave kernels,
   ``dep_manager="sharded"`` over 4 homes with 4-line envelopes, pump
   ``sync`` then ``threaded``.  Each run must reproduce phase 4's wave
   schedule (spawn orders per wave), ``deps_found``, ``blocks_walked``,
   waves, groups, wave-kernel dispatches and every kernel's launches;
   both pumps must put the same envelopes and lines on the rings, and
   the logical stream replayed through the port's
   ``core.sim.predict_dep_traffic`` must predict those envelopes and
   lines.  ``[depman]`` lines give wall, spawn, barrier and pump seconds
   and the wire counts.  Then matmul and Cholesky on the host executor under
   central, sync and threaded, outputs within the parity tolerance.
8. Sharded (main path 1 on the sharded executor): the five apps at the
   §4.2 sizes, ``executor="sharded"``, the wave kernels asked for,
   striped over 4 homes, with no mesh (phase 4's schedule, counts,
   fallbacks and launches), on ``single_device_mesh()`` (every grouped
   wave split per device as ``shard_map``, every group a
   ``sharded_mesh`` fallback, no tile moved, nothing staged) and on 4
   logical devices of the card (every tile on
   ``device_assignment(4)[home]``, nothing staged); home traffic equal
   in the three, and Black-Scholes launched 1, 1 and 4 times, no wave
   kernel under a mesh.  ``[sharded]`` lines give wall, spawn and GC
   seconds, the sharded dispatches, moves, staged and home bytes and
   the dispatch wall by mode.  Then the reference's striped gemm on 4
   and on 2 logical devices (bit-identical to the sequential run;
   measured moves equal to the cross-home bytes, ``g^3/2`` of them on
   2) and its uneven 5-task wave on 4 (``vmap_device``).
9. Fuzz: the 60 seeds of ``repro_torch.fuzz_graphs`` on sequential (the
   oracle), staged, sharded (no mesh), host, staged with the kernels,
   and staged under the sharded managers with each pump: outputs within
   1e-4 (the sharded managers' runs bit-identical to central's), equal
   dependence counts across the deferred paths, equal wire counts
   across the pumps, and one GEMM launch (8x8x8 tiles) per ``_gemm``
   wave dispatch; one ``[fuzz]`` line.
10. Sim: the five apps at the §4.2 sizes under ``executor="sim"``,
   ``kernel_backend="pallas"``, ``device="cuda"`` (the DES; no task body
   runs).  ``[sim]`` lines give the predicted makespan, the sequential
   time, the predicted speedup and tile moves, spawn seconds and the
   phase wall.  The predicted wave-kernel dispatches and fallbacks by
   reason must equal phase 4's; no wrapper may count a launch, and a
   profiler window over one sim run must hold no kernel of ``csrc/``.
   ``calibrate()`` must pass its trend checks.
11. Obs: a staged matmul run (§4.2 size, wave kernels) traced to JSONL
   and exported with ``export_chrome_trace``: a valid document with one
   wave span per wave, and its ``summary_table`` on ``[obs]`` lines; then
   the same run with ``profile_waves=True`` inside ``profile_session
   ("build/obs")``: every GEMM kernel of the run in the written trace,
   launched inside a ``bddt/staged/wave*`` range.
12. Parity: at a small size, ``executor="sequential"`` against staged with
   the wave kernels and against host, all five apps, within each app's
   tolerance.
13. Train (main path 4, run right after phase 6, whose memory it frees
   first): ``repro_torch.launch.train.build_train_step`` with
   Mistral-NeMo-12B at full width, cut to 4 of its 40 layers
   (``TRAIN_REDUCED``, printed on the first ``[train]`` line), weights
   from seed 0, bf16 compute over f32 masters, ``attn_impl="chunked"``
   (the flash kernel has no backward, nor has the TPU kernel), remat
   ``full``: B 2 x S 4,096 from ``SyntheticTokens``, one warm-up and 5
   timed steps.  Checks: loss and gnorm finite, gnorm above 0, every
   parameter leaf changed, the learning rate ``cosine_schedule``'s.
   Prints the median step ms, tokens/s (B·S a step), peak device
   memory, model TFLOP/s (6·N·T + 6·L·B·Hq·S²·Dh, N the parameters less
   the embedding table, T = B·S) and its share of 989 TFLOP/s, the
   device's idle share over a profiled step and the device ms of the
   kernels launched inside each of ``TRAIN_OPS`` (the block loops'
   gradient gathering: ``slice_backward`` and its additions before they
   split their operands once, ``cat``/``stack`` after).  The same for
   the recurrent families (``TRAIN_RECURRENT``, one ``[train_recurrent]``
   line each: xLSTM-1.3B at 8 layers, one of them sLSTM, B 2 x S 2,048;
   Zamba2-1.2B at 7 layers, one shared-block call, B 2 x S 4,096), one
   warm-up and 3 timed steps.  Then at full width in f32
   (2 layers, B 1 x S 1,024, TF32 off) the training path (chunked
   attention, chunked CE, remat ``full`` and ``dots``) against the plain
   one (``impl="naive"``, full-sequence logits, no remat): the loss
   within 1e-5 and the global gradient norm within 1e-4 relative, every
   gradient leaf within 1e-4 of its largest element (the same f32 sums
   in other orders: online softmax over key chunks against one softmax,
   chunked CE against one logsumexp; the CPU parity tests' rule), the
   peak memory of each printed.  At small size: the loss falls by more
   than 0.5 in 60 steps at ``examples/train_lm.py``'s settings (d 256,
   4 layers, vocab 2,048, peak_lr 1e-3), and 6 steps, a checkpoint and
   a resume to 12 equal 12 straight steps bit for bit under
   ``torch.use_deterministic_algorithms(True)``, with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set around that check only (set
   before the first product it slowed the LLM phase's decode steps);
   and three steps of each configuration whose loss reaches no leaf of
   one part (``TRAIN_UNREACHED``: Zamba2 below its first shared-block
   call, DeepSeek-V2-Lite with no MoE layer) are finite, and each such
   leaf has moments of 0 and moved by the weight decay alone, bit for
   bit.  No kernel of ``csrc/`` runs here.
14. MoE (main path 5, run right after phase 6, whose memory it frees):
   ``launch.serve.generate`` with the MoE family at full width, weights
   from seed 0, bf16 compute over f32 masters, B 4 prompts of 1,024
   tokens and 32 greedy steps, timed as phase 6 times them:
   DeepSeek-V2-Lite (MLA, 64 routed + 2 shared experts top-6) cut to 8
   of its 27 layers (``MOE_REDUCED``, printed on the first ``[moe]``
   line), whose path runs no kernel of ``csrc/`` (MLA attention stays
   chunked, as in the reference), and Granite-3.0-1B-A400M (GQA, 32
   experts top-8) at all 24 layers with ``attn_impl="pallas"``: the
   flash-attention counter is zeroed just before and read just after its
   ``generate``, one launch per layer.  Checks: the tokens' shape and
   range, finite logits; Granite's kernel prefill logits against the
   plain ``chunked`` path within 1e-3 in f32 (2 layers) and within a
   quarter of the logits' std in bf16 (drop-free, reason at
   ``BF16_LOGIT_TOL``); at DeepSeek's full width in f32 (2 layers, B 1 x
   256, capacity factor E/k, nothing dropped) the decode step against
   the full forward within 2e-3, ``moe_ffn_ep`` against
   ``moe_ffn_ref`` within 1e-4, the absorbed ``mla_decode`` against
   ``mla_train``'s last row within 2e-3, and ``moe_ffn_ep`` on a 2 x 2
   mesh of 4 logical devices of the card (B 2 x 32) against
   ``moe_ffn_ref`` within 1e-4, its exchanges moving exactly the bytes
   of the chunks that change device.  Prints what phase 6 prints.
15. VLM (main path 6, run right after phase 14, whose memory it frees):
   ``launch.serve.generate`` with Qwen2-VL-72B at full width (d 8,192,
   Hq 64 / Hkv 8 / D 128, d_ff 29,568, ``qkv_bias``, M-RoPE (16, 24,
   24) at theta 1e6), cut to 8 of its 80 layers (``VLM_REDUCED``,
   printed on the first ``[vlm]`` line), weights from seed 0, bf16
   compute over f32 masters, ``attn_impl="pallas"``: B 4 prompts of
   1,024 tokens with a seeded normal ``vision_embeds`` stub (4, 256,
   8,192) spliced over the first 256 positions, 32 greedy steps, timed
   as phase 6 times them; the flash-attention counter zeroed just before
   and read just after one ``generate``, one launch per layer (group
   8).  Checks: phase 6's, with the stub in every forward (kernel
   against chunked and teacher forcing in bf16 within
   ``BF16_LOGIT_TOL`` of the logits' std, and at 2 layers in f32 within
   1e-3 and 2e-3); another stub changes the last-token logits; M-RoPE
   with its three streams equal is RoPE exactly at the published
   sections.
16. Pipe: ``core.pipeline.pipeline_step`` on 4 logical devices of the
   card (a ``Mesh`` with axis ``"stage"``), each stage one f32
   Mistral-NeMo-12B block at full width through ``block_apply`` in
   train mode (chunked attention: the flash kernel has no backward), M 8
   microbatches of 1,024 tokens, the B bodies through
   ``torch.autograd.grad``.  Checks: the timetable
   ``derive_pipeline_schedule(4, 8)`` has 22 clocks and the bodies ran
   in its order; 48 hops moved 1,006,632,960 bytes; each stage's weight
   gradient within 1e-4 of each leaf's largest of autograd over the four
   blocks in sequence.  Prints the step's wall, the sequential wall and
   the bubble share.  No kernel of ``csrc/`` runs here.

17. Hybrid (main path 7, run right after phase 15, whose memory it
   frees): ``launch.serve.generate`` with Zamba2-1.2B at full width and
   depth (38 Mamba2 layers, d 2,048, SSM state 64 over 64 heads of 64,
   the shared attention block before layers 6, 12, ..., 36; 1.10 B
   parameters), weights from seed 0, bf16 compute over f32 masters,
   ``attn_impl="pallas"``: B 4 prompts of 1,024 tokens, 32 greedy
   steps, timed as phase 6 times them; the flash-attention counter
   zeroed just before and read just after one ``generate``, one launch
   per shared call site (6; D 64, group 1).  Checks: phase 6's, the
   f32 model at 8 layers (one shared call): the kernel's prefill against
   ``chunked`` within 1e-3, and teacher forcing, the recurrent decode
   after ``pad_caches`` against the chunked SSD scan over S + 1 tokens
   (one chunk of 1,025), within 2e-3; the same two in bf16 at 8 layers
   within ``BF16_LOGIT_TOL`` of the logits' std, and at full depth
   printed, not held (``RECURRENT_LAYERS_HELD`` says why).  Prints
   phase 6's numbers, the aten ops of one decode step, the cache's
   bytes and the phase's wall.
18. SSM (main path 8): the same run with xLSTM-1.3B at full width and
   depth (42 mLSTM + 6 sLSTM layers, d 2,048, 4 heads, d_inner 4,096;
   1.92 B parameters, as the reference builds it), no attention and no
   kernel launch (the counter must read 0).  Checks: phase 17's, the f32
   model at 8 layers (7 mLSTM + 1 sLSTM), the kernel-against-chunked
   difference printed (0: one path).  Also prints one sLSTM layer's
   ``slstm_scan`` over the 1,024-token prompt: its wall (median of 3)
   and its aten ops, the host cost of the per-step loop.
19. Audio (main path 9): ``launch.serve.generate`` with whisper-tiny at
   full width and depth (4 encoder and 4 decoder layers, d 384, 6 heads
   of 64, vocabulary 51,865; 56,443,392 parameters), weights from seed
   0, bf16 compute over f32 masters: B 16 segments of seeded N(0, 1)
   frame embeddings (the conv front end's stub), 224-token prompts, 32
   greedy steps, timed and held as phase 17 holds, the whole model in
   f32 too.  ``[audio]`` runs the published 1,500 frames under the
   config's own ``attn_impl="chunked"`` (0 flash launches), after
   checking that ``"pallas"`` raises the reference's ``ValueError`` at
   ``prefill_step`` before any launch (1,500 does not split into the
   kernel's 256-row blocks).  ``[audio_kernel]`` runs 1,280 frames, the
   largest length <= 1,500 that does, under ``"pallas"``: 12 launches (a
   layer: the encoder's self-attention, the decoder's causal
   self-attention and its cross-attention), kernel against chunked
   held.  Also printed: the aten ops of one decode step, the cache's
   bytes (self K/V and the encoder output) and the wall of one decode
   step's cross-attention K/V projections, which the reference
   recomputes from the encoder output at every step.
20. Mesh (main path 10, run right after phase 14, whose Granite row it
   prints beside its own): Granite-3.0-1B-A400M at full width and depth
   on a (data, model) = (2, 2) mesh of 4 logical devices of the card
   (``MESH_REDUCED``).  ``launch.train.build_train_step`` with in/out
   shardings under ``fsdp`` (placed f32 masters and AdamW state, bf16
   compute, chunked attention, remat ``full``; B 4 x S 4,096 from
   ``SyntheticTokens``, one warm-up and 3 timed steps), then
   ``launch.serve.generate`` under ``tp`` with ``attn_impl="pallas"``
   (B 4 x 1,024 + 32, timed as phase 6 times it): the flash kernel once
   per layer and mesh position on the position's (batch, head) chunk
   (96 launches, counters zeroed just before and read just after one
   ``generate``), decode through ``_decode_sp`` over the striped cache.
   Prints the mesh, the policy, the bytes each logical device holds,
   the bytes gathered, placed, exchanged by EP and by the stripes'
   combine, step ms, prefill ms, decode ms and tok/s, and the train
   step's device ms inside ``slice_backward``, ``copy_``, ``add``,
   ``add_`` and ``cat`` (``ops_ms``).  Checks, at full
   width in f32 with drop-free capacity and 2 layers (B 4 x 1,024): the
   loss within 1e-5 relative and every gradient leaf within 1e-4 of its
   largest against no mesh, the prefill logits and 4 decode steps within
   1e-4; the placed state of the mesh saved and restored with
   ``shardings=`` onto a (1, 4) mesh, bit for bit.

Then one JSON line of kernel results (each row's ``launches`` from phase
4, 5 or 6, and in ``launches_by_path`` those of phases 7, 8, 9, 14, 15,
17, 18, 19 and 20), the card line again, and last ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.core.costmodel import H100Params
except ImportError as e:
    print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
    sys.exit(2)

# the card's peaks (H100 SXM data sheet), kept in one place: costmodel
_H100 = H100Params()
HBM_BYTES_PER_S = _H100.hbm_bw
FP32_FLOPS_PER_S = _H100.peak_flops_fp32   # outside the tensor cores
BF16_FLOPS_PER_S = _H100.peak_flops_bf16   # dense, on the tensor cores
L2_FLUSH_BYTES = 256 << 20         # > the 50 MB L2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 25) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def device_kernels(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, by name, from a
    profiled call after a warm-up.  A trace with no device event at all
    is taken for a dropped trace (seen once in ~15 runs on the card, in
    the second of two profiles of one process) and the call is profiled
    again, three times at most; a call that launches nothing gives an
    empty list all three times."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def kernel_phase(dev) -> list[dict]:
    """Each kernel against its plain version at its main path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch import serve_lm
    from repro_torch.kernels.black_scholes import kernel as bs
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.jacobi import kernel as jac
    from repro_torch.kernels.matmul import kernel as mm

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, g=None):
        return torch.randn(shape, generator=g or gen, device=dev)

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    rows = []

    # matmul app: 16 waves of 256 tasks, 64^3 tiles (n=1024, tile=64)
    n, m, k, nn = 256, 64, 64, 64
    a, b, c = randn(n, m, k), randn(n, k, nn), randn(n, m, nn)
    nbytes = 4 * (a.numel() + b.numel() + 2 * c.numel())
    flops = 2 * n * m * nn * k + n * m * nn
    rows.append(dict(
        name="matmul_batched", wrapper=lambda: mm.matmul_batched(a, b, c),
        plain=lambda: mm.matmul_batched_plain(a, b, c),
        library=lambda: torch.baddbmm(c, a, b), rtol=1e-4, atol=1e-4,
        source="src/repro_torch/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:38",
        shape=f"{n}x({m},{k})x({k},{nn})", bound=bound(nbytes, flops)))

    # cholesky app: the largest update wave, 120 tasks of 128^3 (n=2048)
    n, m, k, nn = 120, 128, 128, 128
    cu, au, bu = randn(n, m, nn), randn(n, m, k), randn(n, nn, k)
    nbytes = 4 * (au.numel() + bu.numel() + 2 * cu.numel())
    flops = 2 * n * m * nn * k + n * m * nn
    rows.append(dict(
        name="tile_update_batched",
        wrapper=lambda: mm.tile_update_batched(cu, au, bu),
        plain=lambda: mm.tile_update_batched_plain(cu, au, bu),
        library=lambda: torch.baddbmm(cu, au, bu.transpose(1, 2),
                                      alpha=-1.0), rtol=1e-4, atol=1e-4,
        source="src/repro_torch/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:83",
        shape=f"{n}x({m},{k})x({nn},{k})^T", bound=bound(nbytes, flops)))

    # jacobi app (n=4096, tile=512): the four halo shapes of one
    # iteration, each a wave group with the app's offsets; the corner and
    # edge groups reach the fixed boundary rows and columns.  All four are
    # checked; the interior group (36 halos of 1536^2) is timed.
    g, tile = 8, 512
    groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for i in range(g):
        for j in range(g):
            i0, i1 = max(i - 1, 0), min(i + 2, g)
            j0, j1 = max(j - 1, 0), min(j + 2, g)
            groups.setdefault(((i1 - i0) * tile, (j1 - j0) * tile),
                              []).append(((i - i0) * tile, (j - j0) * tile))
    jac_cases, halos = {}, {}
    for (h, w), offsets in sorted(groups.items()):
        halo = halos[(h, w)] = randn(len(offsets), h, w)
        r0 = torch.tensor([o[0] for o in offsets], dtype=torch.int64,
                          device=dev)
        c0 = torch.tensor([o[1] for o in offsets], dtype=torch.int64,
                          device=dev)
        jac_cases[(h, w)] = (
            f"{len(offsets)}x({h},{w})->({tile},{tile})",
            lambda halo=halo, r0=r0, c0=c0: jac.jacobi_halo_batched(
                halo, r0, c0, (tile, tile)),
            lambda halo=halo, r0=r0, c0=c0: jac.jacobi_halo_batched_plain(
                halo, r0, c0, (tile, tile)))
    shape, wrapper, plain = jac_cases[(1536, 1536)]
    n = len(groups[(1536, 1536)])
    # each interior tile reads its (tile+2)^2 window once
    nbytes = 4 * (n * (tile + 2) ** 2 + n * tile * tile) + 8 * 2 * n
    flops = 4 * n * tile * tile
    # one PyTorch call computes the interior group's function: a 3x3
    # five-point convolution over the (tile+2)^2 windows, which all sit at
    # offset (tile, tile) in this group (TF32 off, set in main)
    edge = slice(tile - 1, 2 * tile + 1)
    win = halos[(1536, 1536)][:, None, edge, edge]
    five = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                         [0.0, 0.25, 0.0]], device=dev)[None, None]
    conv_err = (F.conv2d(win, five)[:, 0] - wrapper()).abs().max().item()
    print(f"[kernel] jacobi_halo_batched conv2d yardstick: "
          f"max_abs_err={conv_err} atol=1e-6", flush=True)
    check(conv_err <= 1e-6, f"conv2d yardstick off the kernel by {conv_err}")
    rows.append(dict(
        name="jacobi_halo_batched", wrapper=wrapper, plain=plain,
        library=lambda: F.conv2d(win, five), rtol=1e-6, atol=1e-6,
        checks=list(jac_cases.values()),
        source="src/repro_torch/csrc/jacobi.cu",
        replaces="src/repro/kernels/jacobi/kernel.py:41",
        shape=shape, bound=bound(nbytes, flops)))

    # flash decode: the serve path's per-task shape (one query row against
    # one 512-row KV tile at head_dim 128) is the row's time; the same
    # kernel at Mistral-NeMo-12B's decode width (B 4, Hq 32, Hkv 8, 32k
    # tokens) is checked and timed too, in "wide"
    def fd_case(b, hq, hkv, s, d, kv_dtype=torch.float32, g=None):
        q, kk, vv = (randn(b, hq, d, g=g), randn(b, hkv, s, d, g=g),
                     randn(b, hkv, s, d, g=g))
        kk, vv = kk.to(kv_dtype), vv.to(kv_dtype)
        scale = d ** -0.5
        # q, o and lse in f32; K and V in their own dtype
        nbytes = 4 * (q.numel() + b * hq * d + b * hq) + \
            kk.element_size() * (kk.numel() + vv.numel())
        flops = 4 * b * hq * s * d            # q.k and p.v
        qq = q.to(kv_dtype)                   # SDPA takes one dtype
        label = "" if kv_dtype == torch.float32 else f" {str(kv_dtype)[6:]}"
        return dict(
            shape=f"q({b},{hq},{d}) kv({b},{hkv},{s},{d}){label}",
            wrapper=lambda: fd.flash_decode(q, kk, vv, scale, bk=s),
            plain=lambda: fd.flash_decode_plain(q, kk, vv, scale),
            library=lambda: F.scaled_dot_product_attention(
                qq[:, :, None], kk, vv, scale=scale, enable_gqa=True),
            bound=bound(nbytes, flops))

    sizes = serve_lm.CHIP_SIZES
    serve_case = fd_case(1, 1, 1, sizes["s_tile"], sizes["d"])
    wide_case = fd_case(4, 32, 8, 32768, 128)
    for b_, hq, hkv, s_, d in ((1, 1, 1, sizes["s_tile"], sizes["d"]),
                               (4, 32, 8, 32768, 128)):
        cs, keys = fd.split(s_)
        for kv_dtype in fd.KV_DTYPES:
            smem, resident = fd.occupancy(hq // hkv, d, kv_dtype)
            print(f"[kernel] flash_decode split q({b_},{hq},{d}) "
                  f"kv({b_},{hkv},{s_},{d}) {str(kv_dtype)[6:]}: "
                  f"cluster={cs} keys_per_block={keys} "
                  f"blocks={cs * hkv * b_} blocks_with_keys="
                  f"{-(-s_ // keys) * hkv * b_} smem_bytes={smem} "
                  f"clusters={hkv * b_} resident_clusters={resident}",
                  flush=True)
    # K and V in bf16 (q, o and lse f32), at the same two shapes; drawn
    # from a generator of their own, so the other rows' inputs do not
    # depend on them
    bf16_gen = torch.Generator(device=dev).manual_seed(1)
    bf16_case = fd_case(1, 1, 1, sizes["s_tile"], sizes["d"], torch.bfloat16,
                        g=bf16_gen)
    bf16_wide_case = fd_case(4, 32, 8, 32768, 128, torch.bfloat16,
                             g=bf16_gen)
    for case in (serve_case, wide_case, bf16_case, bf16_wide_case):
        names = device_kernels(case["wrapper"])
        ours = [x for x in names if "flash_decode" in x]
        print(f"[kernel] flash_decode {case['shape']}: device kernels of "
              f"one call {names}", flush=True)
        check(len(ours) == 1, f"flash_decode {case['shape']}: "
                              f"{len(ours)} kernel launches in one call")
    rows.append(dict(
        name="flash_decode", rtol=2e-5, atol=2e-5,
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode/kernel.py:58",
        wide=wide_case, bf16=bf16_case, bf16_wide=bf16_wide_case,
        **serve_case))

    # Black-Scholes: the §4.2 app's 2,097,152 options in one launch (the
    # staged group of its 4096 tasks), inputs drawn as the app draws them
    n = 4096 * 512
    opts = (uniform(10, 200, n), uniform(10, 200, n), uniform(0.1, 2.0, n),
            torch.full((n,), 0.03, device=dev), uniform(0.1, 0.6, n))
    rows.append(dict(
        name="black_scholes", wrapper=lambda: bs.black_scholes(*opts),
        plain=lambda: bs.black_scholes_plain(*opts), library=None,
        rtol=1e-5, atol=1e-3, source="src/repro_torch/csrc/black_scholes.cu",
        replaces="src/repro/kernels/black_scholes/kernel.py:38",
        shape=f"{n} options", bound=bound(7 * 4 * n, 60 * n)))

    # flash attention: the prefill path's shape (Mistral-NeMo-12B's GQA
    # width, B 4 x 1,024 tokens, bf16, causal) is the row's time; B 1 x
    # 8,192 tokens is timed too, in "wide".  SDPA aligns is_causal to the
    # top left, so it is the same function only where Sq == Skv.
    def fa_case(b, hq, hkv, sq, skv, d, dtype, causal=True, bq=256, bk=256):
        q = randn(b, hq, sq, d).to(dtype)
        kk = randn(b, hkv, skv, d).to(dtype)
        vv = randn(b, hkv, skv, d).to(dtype)
        kv_off = skv - sq
        pairs = b * hq * (sum(min(skv, max(0, i + kv_off + 1))
                              for i in range(sq)) if causal else sq * skv)
        nbytes = q.element_size() * (2 * q.numel() + kk.numel() + vv.numel())
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else FP32_FLOPS_PER_S
        kw = dict(causal=causal, bq=bq, bk=bk)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        return dict(
            shape=f"{str(dtype)[6:]} q({b},{hq},{sq},{d}) "
                  f"kv({b},{hkv},{skv},{d}) causal={causal} bq={bq} bk={bk}",
            wrapper=lambda: fa.flash_attention(q, kk, vv, **kw),
            plain=lambda: fa.flash_attention_plain(q, kk, vv, **kw),
            library=lambda: F.scaled_dot_product_attention(
                q, kk, vv, is_causal=causal, enable_gqa=True),
            bound=bound(nbytes, 4 * d * pairs, peak), tol=tol)

    fa_checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((4, 4), (8, 2)):
            for causal in (True, False):
                fa_checks.append(fa_case(2, hq, hkv, 128, 128, 64, dtype,
                                         causal))
    # the corners in both dtypes: bf16 runs the wgmma kernel, f32 the FFMA
    for dtype in (torch.float32, torch.bfloat16):
        fa_checks += [fa_case(1, 2, 2, 32, 128, 64, dtype),
                      fa_case(1, 2, 2, 64, 48, 32, dtype, bq=32, bk=16),
                      fa_case(1, 2, 2, 64, 48, 32, dtype, bq=16, bk=16),
                      fa_case(1, 2, 2, 96, 40, 128, dtype, bq=16, bk=8),
                      fa_case(2, 12, 2, 64, 64, 32, dtype),
                      fa_case(1, 4, 2, 100, 164, 128, dtype),
                      fa_case(2, 32, 8, 256, 256, 128, dtype),
                      # whisper-tiny's encoder and cross-attention at a
                      # small batch: non-causal, G 1, and 224 queries
                      # whose last 64-row tile is half full
                      fa_case(2, 6, 6, 1280, 1280, 64, dtype, causal=False),
                      fa_case(2, 6, 6, 224, 1280, 64, dtype, causal=False)]
    prefill_case = fa_case(4, 32, 8, 1024, 1024, 128, torch.bfloat16)
    rows.append(dict(
        name="flash_attention", rtol=2e-2, atol=2e-2,
        checks=[(c["shape"], c["wrapper"], c["plain"], c["tol"], c["tol"])
                for c in fa_checks + [prefill_case]],
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81",
        wide=fa_case(1, 32, 8, 8192, 8192, 128, torch.bfloat16),
        # Granite-3.0-1B-A400M's prefill (the MoE phase): head dim 64, G 2
        granite=fa_case(4, 16, 8, 1024, 1024, 64, torch.bfloat16),
        # the same on one position of the (2, 2) mesh (the mesh phase):
        # its (batch, head) chunk, B 2, Hq 8, Hkv 4
        granite_mesh=fa_case(2, 8, 4, 1024, 1024, 64, torch.bfloat16),
        # Qwen2-VL-72B's prefill (the VLM phase): head dim 128, G 8
        qwen2_vl=fa_case(4, 64, 8, 1024, 1024, 128, torch.bfloat16),
        # the f32 FFMA path at the prefill shape: the [llm] and [moe] f32
        # exactness checks launch it
        f32=fa_case(4, 32, 8, 1024, 1024, 128, torch.float32),
        # Zamba2-1.2B's shared attention block at prefill (the hybrid
        # phase): head dim 64, G 1
        zamba2=fa_case(4, 32, 32, 1024, 1024, 64, torch.bfloat16),
        # whisper-tiny at 1,280 frames (the audio phase): the encoder's
        # self-attention and the decoder's cross-attention, B 16, G 1,
        # D 64, non-causal (so SDPA is the same function at Sq != Skv)
        whisper_enc=fa_case(16, 6, 6, 1280, 1280, 64, torch.bfloat16,
                            causal=False),
        whisper_cross=fa_case(16, 6, 6, 224, 1280, 64, torch.bfloat16,
                              causal=False),
        **prefill_case))

    results = []
    for row in rows:
        checks = row.get("checks") or [(row["shape"], row["wrapper"],
                                         row["plain"])]
        # the row's other shapes and dtypes: checked, timed, reported
        # under their key
        extras = {key: row[key] for key in EXTRA_CASES if key in row}
        for w in extras.values():
            checks.append((w["shape"], w["wrapper"], w["plain"]) +
                          ((w["tol"],) * 2 if "tol" in w else ()))
        err, errs = 0.0, {}
        for shape, wrapper, plain, *tol in checks:
            rtol, atol = tol or (row["rtol"], row["atol"])
            got = [x.float() for x in _as_tuple(wrapper())]
            want = [x.float() for x in _as_tuple(plain())]
            torch.cuda.synchronize()
            case_err = max((x - y).abs().max().item()
                           for x, y in zip(got, want))
            # the worst element's share of its allowance (allclose: 1.0)
            share = max(((x - y).abs() / (atol + rtol * y.abs())).max().item()
                        for x, y in zip(got, want))
            ok = all(bool(torch.allclose(x, y, rtol=rtol, atol=atol)) and
                     bool(torch.isfinite(x).all().item())
                     for x, y in zip(got, want))
            print(f"[kernel] {row['name']} {shape}: max_abs_err={case_err} "
                  f"tolerance_share={share} rtol={rtol} atol={atol} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{row['name']} {shape} disagrees with its plain "
                      f"version (max_abs_err {case_err}, tolerance "
                      f"{rtol}/{atol})")
            del got, want
            errs[shape] = case_err
            err = max(err, case_err)
        ms = time_ms(row["wrapper"], flush)
        plain_ms = time_ms(row["plain"], flush)
        library_ms = (time_ms(row["library"], flush)
                      if row["library"] is not None else None)
        bound_ms, bound_by = row["bound"]
        print(f"[kernel] {row['name']} {row['shape']}: ms={ms} "
              f"plain_ms={plain_ms} library_ms={library_ms} "
              f"bound_ms={bound_ms} ({bound_by})", flush=True)
        result = dict(name=row["name"], route="cuda", source=row["source"],
                      replaces=row["replaces"], launches=0,
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms, shape=row["shape"])
        for key, w in extras.items():
            extra = dict(shape=w["shape"], ms=time_ms(w["wrapper"], flush),
                         plain_ms=time_ms(w["plain"], flush),
                         library_ms=time_ms(w["library"], flush),
                         bound_ms=w["bound"][0], bound_by=w["bound"][1],
                         max_abs_err=errs[w["shape"]])
            print(f"[kernel] {row['name']} {w['shape']}: " +
                  " ".join(f"{k}={v}" for k, v in extra.items()
                           if k != "shape"), flush=True)
            result[key] = extra
        results.append(result)
    parity_of_black_scholes(dev, gen)
    del flush
    return results


# a kernel row's other shapes and dtypes, each timed beside the row's own
EXTRA_CASES = ("wide", "bf16", "bf16_wide", "granite", "granite_mesh",
               "qwen2_vl", "zamba2", "whisper_enc", "whisper_cross", "f32")


def parity_of_black_scholes(dev, gen) -> None:
    """Put-call parity of the kernel's prices, at 1e-4, on the reference
    test's option distribution (spot 50..150, strike 100, t 1, rate 0.05,
    vol 0.3) at the app's 2,097,152 options."""
    import torch
    from repro_torch.kernels.black_scholes import kernel as bs
    n = 4096 * 512
    spot = 50 + 100 * torch.rand(n, generator=gen, device=dev)
    strike, t, rate, vol = (torch.full((n,), x, device=dev)
                            for x in (100.0, 1.0, 0.05, 0.3))
    call, put = bs.black_scholes(spot, strike, t, rate, vol)
    worst = (call - put - (spot - strike * torch.exp(-rate * t))) \
        .abs().max().item()
    print(f"[kernel] black_scholes put-call parity: max_abs={worst} "
          f"atol=1e-4 {'ok' if worst <= 1e-4 else 'FAIL'}", flush=True)
    check(worst <= 1e-4, f"black_scholes put-call parity off by {worst}")


def ptxas_phase() -> None:
    """Registers, spills and static shared memory of the GEMM and
    flash-decode kernels from the compiler's report, and the dynamic shared
    memory a flash-decode block asks for."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import kernel as fd
    dynamic = {f"G={g} D={d}": fd.occupancy(g, d)[0]
               for g, d in ((1, 128), (4, 128), (8, 128), (8, 64))}
    print(f"[ptxas] flash_decode_split_kernel dynamic_smem_bytes="
          f"{json.dumps(dynamic)}", flush=True)
    for source, function in (("matmul", "tile_gemm_3xtf32_kernel"),
                             ("flash_decode", "flash_decode_split_kernel")):
        for kernel, info in sorted(_build.ptxas_report(source,
                                                       function).items()):
            print(f"[ptxas] {kernel}: {json.dumps(info)}", flush=True)


def record_waves(rt) -> list:
    """Log the staged wave schedule of ``rt``: for each barrier, the spawn
    orders of each wave's tasks (task ids recycle, spawn orders do not)."""
    log: list = []
    build = rt._exec._wavefronts

    def recorded(tasks):
        waves = build(tasks)
        log.append([[td.spawn_order for td in w] for w in waves])
        return waves

    rt._exec._wavefronts = recorded
    return log


APP_NAMES = ("black_scholes", "matmul", "fft", "jacobi", "cholesky")
# what the sharded runs must reproduce of the central run, count for count
SCHEDULE_FIELDS = ("tasks_spawned", "deps_found", "blocks_walked", "waves",
                   "grouped_dispatches", "kernel_dispatches",
                   "kernel_fallbacks")


def app_wrappers() -> tuple[dict, dict]:
    """The wave-registry kernels (launched once per wave-kernel dispatch),
    and those plus Black-Scholes, which launches through its operator's
    vmap rule once per staged group of _price tasks (non_rectangular for
    the registry)."""
    from repro_torch.kernels.black_scholes import kernel as bs
    from repro_torch.kernels.jacobi import kernel as jac
    from repro_torch.kernels.matmul import kernel as mm
    wave = {"matmul_batched": mm.matmul_batched,
            "tile_update_batched": mm.tile_update_batched,
            "jacobi_halo_batched": jac.jacobi_halo_batched}
    return wave, {**wave, "black_scholes": bs.black_scholes}


def app_phase(dev) -> tuple[dict[str, int], dict[str, dict]]:
    """Main path 1: the five apps at §4.2 sizes on the wave kernels.
    Returns the launches per kernel, and per app the central run's wave
    schedule, counts, launches and times (what ``depman_phase`` holds the
    sharded managers to)."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps
    from repro_torch.obs import InMemoryTracker
    from repro_torch.profile_apps import GCTimer

    wave, wrappers = app_wrappers()
    must_launch = {"matmul": "matmul_batched",
                   "cholesky": "tile_update_batched",
                   "jacobi": "jacobi_halo_batched",
                   "black_scholes": "black_scholes"}
    total = dict.fromkeys(wrappers, 0)
    central = {}
    for name in APP_NAMES:
        trk = InMemoryTracker()
        rt = TaskRuntime(RuntimeConfig(
            executor="staged", kernel_backend="pallas", device=str(dev),
            tracker=trk))
        schedule = record_waves(rt)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        with GCTimer() as gct:
            t0 = time.perf_counter()
            out = apps.APPS[name](rt, **apps.PAPER_SIZES[name])
            torch.cuda.synchronize()          # the app self-verifies
            wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        rt.shutdown()
        stats = rt.stats()
        for arr in (out if isinstance(out, tuple) else (out,)):
            full = arr.gather()
            check(tuple(full.shape) == arr.shape and
                  bool(torch.isfinite(full).all().item()),
                  f"{name}: output {arr.name} not finite or misshapen")
        fallbacks: dict[str, int] = {}
        reasons: dict[str, int] = {}
        for e in trk.events_of("kernel_dispatch"):
            if e.data["backend"] != "pallas":
                key = f"{e.data['fn']}:{e.data['reason']}"
                fallbacks[key] = fallbacks.get(key, 0) + 1
                reasons[e.data["reason"]] = \
                    reasons.get(e.data["reason"], 0) + 1
        dispatch_s = sum(e.data["wall_s"] for e in trk.events_of("dispatch"))
        print("[app] " + json.dumps(dict(
            app=name, size=apps.PAPER_SIZES[name], wall_s=wall,
            spawn_s=stats.spawn_time_s, barrier_s=stats.barrier_time_s,
            wait_s=stats.wait_time_s, dispatch_s=dispatch_s,
            gc_s=gct.seconds, tasks=stats.tasks_spawned, waves=stats.waves,
            grouped_dispatches=stats.grouped_dispatches,
            kernel_dispatches=stats.kernel_dispatches,
            kernel_fallbacks=stats.kernel_fallbacks,
            fallbacks_by_reason=fallbacks, launches=launches)), flush=True)
        wave_launches = sum(launches[k] for k in wave)
        check(stats.kernel_dispatches == wave_launches,
              f"{name}: {stats.kernel_dispatches} wave-kernel dispatches "
              f"but {wave_launches} launches")
        if name in must_launch:
            check(launches[must_launch[name]] > 0,
                  f"{name}: {must_launch[name]} never launched")
        for k, v in launches.items():
            total[k] += v
        central[name] = dict(schedule=schedule, launches=launches,
                             fallbacks_by_reason=reasons,
                             wall_s=wall, spawn_s=stats.spawn_time_s,
                             barrier_s=stats.barrier_time_s,
                             gc_s=gct.seconds,
                             **{f: getattr(stats, f)
                                for f in SCHEDULE_FIELDS})
    return total, central


def depman_phase(dev, central: dict[str, dict]) -> dict[str, int]:
    """Main path 1 under the home-sharded dependence managers: the five
    apps at §4.2 sizes, staged with the wave kernels, ``dep_manager=
    "sharded"`` over 4 homes with 4-line envelopes, pump ``sync`` then
    ``threaded``.  Each run must reproduce the central run's wave
    schedule, counts and launches; the two pumps must put the same
    envelopes and lines on the rings.  Then matmul and Cholesky on the
    host executor under central, sync and threaded, outputs within
    ``PARITY_TOL`` of central's.  Returns the launches per kernel."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps
    from repro_torch.core.sim import predict_dep_traffic
    from repro_torch.profile_apps import GCTimer

    _, wrappers = app_wrappers()
    total = dict.fromkeys(wrappers, 0)
    sharded = dict(dep_manager="sharded", n_controllers=4,
                   dep_batch_lines=4)
    for name in APP_NAMES:
        wire = {}
        for pump in ("sync", "threaded"):
            rt = TaskRuntime(RuntimeConfig(
                executor="staged", kernel_backend="pallas", device=str(dev),
                dep_pump=pump, **sharded))
            rt.analyzer.traffic_log = []      # record the logical stream
            schedule = record_waves(rt)
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            with GCTimer() as gct:
                t0 = time.perf_counter()
                apps.APPS[name](rt, **apps.PAPER_SIZES[name])
                torch.cuda.synchronize()      # the app self-verifies
                wall = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
            idle_waits = rt.analyzer.idle_waits
            rt.shutdown()
            st = rt.stats()
            ref = central[name]
            wire[pump] = (st.dep_messages, st.dep_batches, st.dep_lines)
            pred = predict_dep_traffic(rt.analyzer.traffic_log,
                                       sharded["dep_batch_lines"],
                                       rt.analyzer.traffic_deps)
            print("[depman] " + json.dumps(dict(
                app=name, executor="staged", pump=pump, homes=4,
                batch_lines=4, wall_s=wall, spawn_s=st.spawn_time_s,
                barrier_s=st.barrier_time_s, gc_s=gct.seconds,
                pump_wall_s=st.pump_wall_s, pump_idle_waits=idle_waits,
                dep_messages=st.dep_messages, dep_batches=st.dep_batches,
                dep_lines=st.dep_lines,
                predicted_dep_batches=pred["dep_batches"],
                predicted_dep_lines=pred["dep_lines"],
                manager_admissions=st.manager_admissions,
                tasks=st.tasks_spawned, waves=st.waves,
                central_wall_s=ref["wall_s"],
                central_spawn_s=ref["spawn_s"],
                central_barrier_s=ref["barrier_s"],
                central_gc_s=ref["gc_s"], launches=launches)),
                flush=True)
            check(schedule == ref["schedule"],
                  f"depman {name} {pump}: wave schedule differs from "
                  f"central's")
            for fld in SCHEDULE_FIELDS:
                check(getattr(st, fld) == ref[fld],
                      f"depman {name} {pump}: {fld} {getattr(st, fld)} != "
                      f"central's {ref[fld]}")
            check(launches == ref["launches"],
                  f"depman {name} {pump}: launches {launches} != "
                  f"central's {ref['launches']}")
            check(sum(st.manager_admissions) >= st.tasks_spawned,
                  f"depman {name} {pump}: fewer admissions than tasks")
            check((pred["dep_batches"], pred["dep_lines"]) ==
                  (st.dep_batches, st.dep_lines),
                  f"depman {name} {pump}: predict_dep_traffic gives "
                  f"{pred}, the rings carried {st.dep_batches} envelopes "
                  f"and {st.dep_lines} lines")
            for k, v in launches.items():
                total[k] += v
        check(wire["sync"] == wire["threaded"],
              f"depman {name}: wire counts differ across pumps {wire}")

    # the per-home ready deques with real workers: the host executor
    for name in ("matmul", "cholesky"):
        outs = {}
        for label, cfg in (("central", {}),
                           ("sync", dict(dep_pump="sync", **sharded)),
                           ("threaded", dict(dep_pump="threaded",
                                             **sharded))):
            rt = TaskRuntime(RuntimeConfig(executor="host",
                                           device=str(dev), **cfg))
            try:
                torch.cuda.synchronize()
                with GCTimer() as gct:
                    t0 = time.perf_counter()
                    out = apps.APPS[name](rt, **apps.PAPER_SIZES[name])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                idle_waits = rt.analyzer.idle_waits if cfg else None
            finally:
                rt.shutdown()
            st = rt.stats()
            full = out.gather()
            outs[label] = torch.tril(full) if name == "cholesky" else full
            print("[depman] " + json.dumps(dict(
                app=name, executor="host", pump=label, wall_s=wall,
                spawn_s=st.spawn_time_s, barrier_s=st.barrier_time_s,
                gc_s=gct.seconds,
                pump_wall_s=st.pump_wall_s, pump_idle_waits=idle_waits,
                dep_messages=st.dep_messages, dep_batches=st.dep_batches,
                dep_lines=st.dep_lines,
                manager_admissions=st.manager_admissions,
                tasks=st.tasks_spawned, worker_tasks=st.worker_tasks)),
                flush=True)
        rtol, atol = PARITY_TOL[name]
        for label in ("sync", "threaded"):
            gap = (outs[label] - outs["central"]).abs().max().item()
            print(f"[depman] {name} host {label} against central: "
                  f"max_abs_diff={gap} rtol={rtol} atol={atol}", flush=True)
            check(bool(torch.allclose(outs[label], outs["central"],
                                      rtol=rtol, atol=atol)),
                  f"depman {name} host {label}: output differs from "
                  f"central's by {gap}")
    return total


def sharded_phase(dev, central: dict[str, dict]) -> dict[str, int]:
    """Main path 1 on the sharded executor: the five apps at §4.2 sizes,
    ``executor="sharded"``, ``kernel_backend="pallas"``, striped over 4
    homes, in three modes — no mesh (must reproduce phase 4's schedule,
    counts, fallbacks and launches), ``single_device_mesh()`` (every
    grouped wave dispatched per device as ``shard_map``, every group a
    ``sharded_mesh`` fallback, nothing staged or moved, Black-Scholes
    launched once and no wave kernel) and 4 logical devices on the card
    (every tile on ``device_assignment(4)[home]``, nothing staged,
    Black-Scholes launched once per device).  Home traffic is the same in
    all three.  Then the reference's 4-device programs (striped gemm bit
    for bit the sequential run's; an uneven 5-task wave through
    ``vmap_device``) and its 2-device residency program
    (``bytes_moved == cross_home_bytes == g^3/2 * 4096``).  Returns the
    launches per kernel."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps, dist, task
    from repro_torch.core.placement import device_assignment
    from repro_torch.obs import InMemoryTracker
    from repro_torch.profile_apps import GCTimer

    wave, wrappers = app_wrappers()
    total = dict.fromkeys(wrappers, 0)
    meshes = {"none": None,
              "mesh1": dist.single_device_mesh(device=dev),
              "mesh4": dist.Mesh(dist.logical_devices(4, dev), ("data",))}
    bs_launches = {"none": 1, "mesh1": 1, "mesh4": 4}
    for name in APP_NAMES:
        ref = central[name]
        home_bytes = None
        for mode, mesh in meshes.items():
            trk = InMemoryTracker()
            with (dist.use_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext()) as ctx:
                rt = TaskRuntime(RuntimeConfig(
                    executor="sharded", kernel_backend="pallas",
                    device=str(dev), placement="striped", n_controllers=4,
                    tracker=trk))
                schedule = record_waves(rt)
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                with GCTimer() as gct:
                    t0 = time.perf_counter()
                    apps.APPS[name](rt, **apps.PAPER_SIZES[name])
                    torch.cuda.synchronize()      # the app self-verifies
                    wall = time.perf_counter() - t0
                launches = {k: w.launches for k, w in wrappers.items()}
                misplaced = 0
                if mesh is not None:
                    devmap = device_assignment(4, ctx)
                    misplaced = sum(
                        ba.tile_device(idx) != devmap[h % len(devmap)]
                        for ba in rt._arrays for idx, h in ba.home.items())
                rt.shutdown()
            st = rt.stats()
            reasons: dict[str, int] = {}
            for e in trk.events_of("kernel_dispatch"):
                if e.data["backend"] != "pallas":
                    reasons[e.data["reason"]] = \
                        reasons.get(e.data["reason"], 0) + 1
            dispatch_s: dict[str, float] = {}
            grouped_modes = set()
            for e in trk.events_of("dispatch"):
                m = e.data["mode"]
                dispatch_s[m] = dispatch_s.get(m, 0.0) + e.data["wall_s"]
                if e.data["tasks"] > 1:
                    grouped_modes.add(m)
            print("[sharded] " + json.dumps(dict(
                app=name, mode=mode, wall_s=wall, spawn_s=st.spawn_time_s,
                barrier_s=st.barrier_time_s, gc_s=gct.seconds,
                staged_wall_s=ref["wall_s"], waves=st.waves,
                grouped_dispatches=st.grouped_dispatches,
                sharded_dispatches=st.sharded_dispatches,
                tile_moves=st.tile_moves, bytes_moved=st.bytes_moved,
                bytes_staged=st.bytes_staged,
                cross_home_bytes=st.cross_home_bytes,
                local_home_bytes=st.local_home_bytes,
                kernel_dispatches=st.kernel_dispatches,
                fallbacks_by_reason=reasons,
                dispatch_wall_s_by_mode=dispatch_s,
                misplaced_tiles=misplaced, launches=launches)), flush=True)
            what = f"sharded {name} {mode}"
            for k, v in launches.items():
                total[k] += v
            check(launches["black_scholes"] ==
                  (bs_launches[mode] if name == "black_scholes" else 0),
                  f"{what}: black_scholes launched "
                  f"{launches['black_scholes']} times")
            if home_bytes is None:
                home_bytes = (st.cross_home_bytes, st.local_home_bytes)
            check((st.cross_home_bytes, st.local_home_bytes) == home_bytes,
                  f"{what}: home bytes {st.cross_home_bytes}, "
                  f"{st.local_home_bytes} != no mesh's {home_bytes}")
            if mesh is None:
                check(schedule == ref["schedule"],
                      f"{what}: wave schedule differs from phase 4's")
                for fld in SCHEDULE_FIELDS:
                    check(getattr(st, fld) == ref[fld],
                          f"{what}: {fld} {getattr(st, fld)} != phase 4's "
                          f"{ref[fld]}")
                check(launches == ref["launches"],
                      f"{what}: launches {launches} != phase 4's "
                      f"{ref['launches']}")
                check(reasons == ref["fallbacks_by_reason"],
                      f"{what}: fallbacks {reasons} != phase 4's "
                      f"{ref['fallbacks_by_reason']}")
                check(st.sharded_dispatches == 0,
                      f"{what}: {st.sharded_dispatches} sharded dispatches")
                continue
            check(all(launches[k] == 0 for k in wave),
                  f"{what}: a wave kernel launched under a mesh {launches}")
            check(st.kernel_dispatches == 0 and
                  set(reasons) <= {"sharded_mesh"} and
                  st.kernel_fallbacks == ref["kernel_dispatches"] +
                  ref["kernel_fallbacks"],
                  f"{what}: every group must fall back as sharded_mesh "
                  f"({reasons})")
            check(st.bytes_staged == 0, f"{what}: {st.bytes_staged} bytes "
                  "staged")
            check(misplaced == 0, f"{what}: {misplaced} tiles off their "
                  "home device")
            check(st.grouped_dispatches > 0 and
                  grouped_modes <= ({"shard_map"} if mode == "mesh1" else
                                    {"shard_map", "vmap_device"}),
                  f"{what}: grouped waves dispatched as {grouped_modes}")
            if mode == "mesh1":
                check(st.tile_moves == 0 and
                      st.sharded_dispatches == st.grouped_dispatches,
                      f"{what}: {st.tile_moves} moves on one device, "
                      f"{st.sharded_dispatches} of {st.grouped_dispatches} "
                      "grouped waves split per device")

    # the reference's multi-device programs on logical devices
    @task(inout="c", in_=("a", "b"))
    def gemm(c, a, b):
        return c + a @ b

    @task(in_="halo", out="dest")
    def avg(halo, dest=None):
        return halo[:4] * 0.5 + halo[4:] * 0.5

    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 128), dtype=np.float32)
    b = rng.standard_normal((128, 128), dtype=np.float32)

    def prog(rt, tile=32):
        g = 128 // tile
        with rt.scope():
            A = rt.from_array(a, (tile, tile))
            B = rt.from_array(b, (tile, tile))
            C = rt.zeros((128, 128), (tile, tile))
            for i in range(g):
                for j in range(g):
                    for k in range(g):
                        gemm(C[i, j], A[i, k], B[k, j])
            rt.barrier()
            st = rt.stats()
            return C.gather(), st

    seq, _ = prog(TaskRuntime(RuntimeConfig(executor="sequential",
                                            device=str(dev))))
    g, block_bytes = 4, 32 * 32 * 4
    for ndev in (4, 2):
        mesh = meshes["mesh4"] if ndev == 4 else \
            dist.Mesh(dist.logical_devices(2, dev), ("data",))
        with dist.use_mesh(mesh):
            rt = TaskRuntime(RuntimeConfig(
                executor="sharded", placement="striped", n_controllers=ndev,
                device=str(dev)))
            got, st = prog(rt)
        after = rt.stats()
        gap = (got - seq).abs().max().item()
        print("[sharded] " + json.dumps(dict(
            program=f"gemm striped, {ndev} logical devices, {ndev} homes",
            sharded_dispatches=st.sharded_dispatches,
            tile_moves=st.tile_moves, bytes_moved=st.bytes_moved,
            bytes_staged=st.bytes_staged,
            cross_home_bytes=st.cross_home_bytes,
            gather_bytes_moved=after.bytes_moved - st.bytes_moved,
            max_abs_diff_to_sequential=gap)), flush=True)
        check(torch.equal(got, seq), f"sharded gemm on {ndev} devices "
              f"differs from the sequential run by {gap}")
        check(st.sharded_dispatches == 4 and st.bytes_staged == 0 and
              st.bytes_moved == st.cross_home_bytes > 0,
              f"sharded gemm on {ndev} devices: {st}")
        if ndev == 2:
            check(st.cross_home_bytes == g ** 3 // 2 * block_bytes and
                  st.tile_moves == g ** 3 // 2 and
                  after.bytes_moved - st.bytes_moved ==
                  g * g // 2 * block_bytes,
                  f"sharded residency on 2 devices: {st}")
    trk = InMemoryTracker()
    with dist.use_mesh(meshes["mesh4"]):
        with TaskRuntime(RuntimeConfig(executor="sharded", tracker=trk,
                                       placement="striped", n_controllers=4,
                                       device=str(dev))) as rt:
            X = rt.full((24, 4), (4, 4), 1.0)    # 6 blocks on 4 devices
            Y = rt.zeros((20, 4), (4, 4))
            for i in range(5):                   # 5 % 4 != 0
                avg(X[i:i + 2, 0], Y[i, 0])
            rt.barrier()
            ok = bool(torch.equal(Y.gather(), torch.ones(20, 4,
                                                         device=dev)))
    modes = [e.data["mode"] for e in trk.events_of("dispatch")]
    print(f"[sharded] uneven 5-task wave on 4 logical devices: modes "
          f"{modes}, tile_moves {rt.stats().tile_moves}, ok {ok}",
          flush=True)
    check(ok and "vmap_device" in modes,
          f"sharded uneven wave: modes {modes}, ok {ok}")
    return total


def fuzz_phase(dev) -> int:
    """The 60-seed differential corpus (``repro_torch.fuzz_graphs``) on
    the card, the sequential path as the oracle: staged, sharded (no
    mesh), host, staged + kernels, staged + sharded managers sync and
    threaded.  Outputs within ``fuzz_graphs.CARD_TOL`` of the oracle (the
    sharded managers' bit-identical to central's), the dependence
    counts equal across the deferred paths, equal wire counts
    across the pumps, and the GEMM kernel launched once per ``_gemm``
    wave dispatch (8x8x8 tiles).  Returns its launches."""
    import torch
    from repro_torch import fuzz_graphs
    from repro_torch.kernels.matmul import kernel as mm

    gaps = dict.fromkeys(fuzz_graphs.PATHS, 0.0)
    totals = dict(tasks=0, deps_found=0, blocks_walked=0, dep_messages=0,
                  dep_batches=0, dep_lines=0, gemm_dispatches=0,
                  kernel_fallbacks=0)
    mm.matmul_batched.launches = 0
    t0 = time.perf_counter()
    for seed in fuzz_graphs.SEEDS:
        runs = fuzz_graphs.compare_paths(seed, str(dev))
        oracle = runs["sequential"][0]
        for path, (out, _) in runs.items():
            gaps[path] = max(gaps[path], fuzz_graphs.max_gap(out, oracle))
        staged = runs["staged"][1]
        kernels = runs["staged+pallas"][1]
        sync = runs["staged+sharded-sync"][1]
        totals["tasks"] += staged.tasks_spawned
        totals["deps_found"] += staged.deps_found
        totals["blocks_walked"] += staged.blocks_walked
        totals["gemm_dispatches"] += kernels.kernel_dispatches
        totals["kernel_fallbacks"] += kernels.kernel_fallbacks
        for fld in ("dep_messages", "dep_batches", "dep_lines"):
            totals[fld] += getattr(sync, fld)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mm.matmul_batched.launches
    print("[fuzz] " + json.dumps(dict(
        seeds=len(fuzz_graphs.SEEDS), paths=list(fuzz_graphs.PATHS),
        tile=fuzz_graphs.TILE, wall_s=wall, tol=fuzz_graphs.CARD_TOL,
        max_abs_gap_to_sequential=gaps, matmul_batched_launches=launches,
        **totals)), flush=True)
    check(launches > 0, "fuzz: matmul_batched never launched")
    check(launches == totals["gemm_dispatches"],
          f"fuzz: {launches} matmul_batched launches but "
          f"{totals['gemm_dispatches']} _gemm wave dispatches")
    return launches


def csrc_kernels() -> set[str]:
    """The names of the kernels in ``src/repro_torch/csrc/*.cu``."""
    import re
    return {name for path in (ROOT / "src" / "repro_torch" / "csrc")
            .glob("*.cu")
            for name in re.findall(r"\b(\w+_kernel)\b", path.read_text())}


def sim_phase(dev, central: dict[str, dict]) -> None:
    """``executor="sim"`` on the card: the five apps at §4.2 sizes under
    ``kernel_backend="pallas"``, ``device="cuda"``.  The predicted
    wave-kernel dispatches and fallbacks by reason must equal what phase
    4's staged runs launched; no wrapper may count a launch, and a
    profiler window over one sim run must hold no kernel of ``csrc/``.
    Then ``calibrate()`` must pass its trend checks."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch import RuntimeConfig, TaskRuntime, apps
    from repro_torch.core.calibrate import calibrate
    from repro_torch.obs import InMemoryTracker

    _, wrappers = app_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}

    def run(name, tracker=None):
        rt = TaskRuntime(RuntimeConfig(
            executor="sim", kernel_backend="pallas", device=str(dev),
            tracker=tracker))
        try:
            apps.APPS[name](rt, verify=False, **apps.PAPER_SIZES[name])
            rt.barrier()
            return rt.stats(), dict(rt._exec.fallbacks)
        finally:
            rt.shutdown()

    for name in APP_NAMES:
        trk = InMemoryTracker()
        t0 = time.perf_counter()
        st, reasons = run(name, trk)
        wall = time.perf_counter() - t0
        seq = sum(e.data["sequential_s"] for e in trk.events_of("sim_predict"))
        ref = central[name]
        print("[sim] " + json.dumps(dict(
            app=name, size=apps.PAPER_SIZES[name], wall_s=wall,
            spawn_s=st.spawn_time_s, tasks=st.tasks_spawned,
            predicted_total_s=st.predicted_total_s, sequential_s=seq,
            predicted_speedup=seq / st.predicted_total_s,
            predicted_tile_moves=st.tile_moves,
            kernel_dispatches=st.kernel_dispatches,
            kernel_fallbacks=st.kernel_fallbacks,
            fallbacks_by_reason=reasons,
            staged_kernel_dispatches=ref["kernel_dispatches"],
            staged_fallbacks_by_reason=ref["fallbacks_by_reason"])),
            flush=True)
        check(st.predicted_total_s > 0 and seq > 0 and
              st.predicted_total_s < float("inf"),
              f"sim {name}: predicted {st.predicted_total_s} s")
        check((st.kernel_dispatches, st.kernel_fallbacks) ==
              (ref["kernel_dispatches"], ref["kernel_fallbacks"]),
              f"sim {name}: predicted {st.kernel_dispatches} dispatches and "
              f"{st.kernel_fallbacks} fallbacks, the staged run had "
              f"{ref['kernel_dispatches']} and {ref['kernel_fallbacks']}")
        check(reasons == ref["fallbacks_by_reason"],
              f"sim {name}: fallbacks {reasons} != the staged run's "
              f"{ref['fallbacks_by_reason']}")
    after = {k: w.launches for k, w in wrappers.items()}
    check(after == before, f"sim: a kernel launched ({before} -> {after})")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ours = csrc_kernels()
    with torch.profiler.profile(activities=acts) as prof:
        run("cholesky")
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    hits = sorted({n for n in device if any(k in n for k in ours)})
    print(f"[sim] profiled cholesky sim run: {len(device)} device events "
          f"(tile copies and fills), kernels of csrc/ {hits}", flush=True)
    check(not hits, f"sim: kernels of csrc/ ran: {hits}")

    t0 = time.perf_counter()
    res = calibrate()
    print("[sim] calibrate " + json.dumps(dict(
        seconds=time.perf_counter() - t0, **res.as_dict())), flush=True)
    check(res.ok, f"calibrate: {res.as_dict()}")


def kernels_in_ranges(path, kernel: str, prefix: str) -> dict[str, int]:
    """In a ``torch.profiler`` Chrome trace: the launches of device
    kernels named ``*kernel*``, and how many of them were launched (their
    runtime call, matched by correlation id) inside a CPU range whose name
    starts with ``prefix``."""
    evs = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in evs
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(prefix)]
    launched = {e["args"]["correlation"]: e["ts"] for e in evs
                if e.get("cat") == "cuda_runtime" and
                "correlation" in e.get("args", {})}
    kernels = [e for e in evs if e.get("cat") == "kernel" and
               kernel in e.get("name", "")]
    inside = sum(any(a <= launched.get(k["args"].get("correlation"), -1) <= b
                     for a, b in ranges) for k in kernels)
    return dict(ranges=len(ranges), kernels=len(kernels), inside=inside,
                categories=sorted({str(e.get("cat")) for e in evs}))


def obs_phase(dev) -> None:
    """The trace tools on the card.  A staged matmul run (§4.2 size, wave
    kernels) with a ``JsonlTracker`` goes through ``export_chrome_trace``:
    a valid document with one wave span per wave, and its
    ``summary_table``.  A second run with ``profile_waves=True`` inside
    ``profile_session``: every GEMM kernel launched inside a
    ``bddt/staged/wave*`` range of the written trace."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.obs import (JsonlTracker, export_chrome_trace,
                                 load_jsonl, profile_session, summary_table)

    out = ROOT / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "matmul.jsonl"

    def run(**config):
        rt = TaskRuntime(RuntimeConfig(
            executor="staged", kernel_backend="pallas", device=str(dev),
            **config))
        try:
            apps.APPS["matmul"](rt, **apps.PAPER_SIZES["matmul"])
            torch.cuda.synchronize()
        finally:
            rt.shutdown()
        return rt.stats()

    trk = JsonlTracker(str(trace))
    st = run(tracker=trk)
    trk.close()
    doc = export_chrome_trace(trace, out / "matmul.chrome.json")
    evs = json.loads((out / "matmul.chrome.json").read_text())["traceEvents"]
    check(evs == doc["traceEvents"], "obs: the written trace differs")
    waves = [e for e in evs if e["ph"] == "X" and
             e["name"].startswith("wave ")]
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    valid = all(e["ph"] in ("X", "C", "i", "M") for e in evs) and \
        ts == sorted(ts) and min(ts) >= 0 and \
        all(e["dur"] >= 0 for e in evs if e["ph"] == "X")
    print(f"[obs] chrome trace: {len(evs)} events, {len(waves)} wave spans, "
          f"{st.waves} waves, valid={valid}", flush=True)
    check(valid, "obs: the Chrome trace is not valid")
    check(len(waves) == st.waves,
          f"obs: {len(waves)} wave spans for {st.waves} waves")
    for line in summary_table(load_jsonl(trace)).splitlines():
        print(f"[obs] {line}", flush=True)

    mm.matmul_batched.launches = 0
    with profile_session(out, cuda=True) as prof:
        # wave ranges are opened where waves are traced, as in the
        # reference: profile_waves takes a tracker
        st = run(profile_waves=True, tracker="memory")
    launches = mm.matmul_batched.launches
    seen = kernels_in_ranges(prof.trace_path, "tile_gemm_3xtf32_kernel",
                             "bddt/staged/wave")
    print("[obs] profile_session " + json.dumps(dict(
        trace=str(prof.trace_path.relative_to(ROOT)), waves=st.waves,
        matmul_batched_launches=launches, **seen)), flush=True)
    check(seen["ranges"] == st.waves,
          f"obs: {seen['ranges']} wave ranges for {st.waves} waves")
    check(launches > 0 and seen["kernels"] == launches == seen["inside"],
          f"obs: {launches} GEMM launches, {seen['kernels']} in the trace, "
          f"{seen['inside']} inside the wave ranges")


def trace_summary(prof, span: str, top_n: int = 8, ops=()) -> dict:
    """The device's idle share inside the profiler range ``span`` (kernel,
    copy and memset time clipped to the range, over the range's length;
    None when the trace holds no device event), the device ms and the
    range's seconds, and the ``top_n`` most device ms by the operator
    that launched them (``top``: a kernel's ``External id`` names the
    innermost operator or range open at its launch) and by kernel name
    (``top_kernels``), each row ``[name, ms, launches]``; for each
    operator named in ``ops``, the device ms and launches of the kernels
    launched while one was open on the launching thread, nested
    operators included (``ops_ms``: ``aten::slice_backward`` launches
    through ``aten::zeros`` and ``aten::copy_``).  Read from the
    profile's Chrome trace: the profiler's own exporter writes it and
    ``json`` parses it.  ``prof.events()`` and ``key_averages()`` build
    a Python object per event instead, minutes for the ~10^6 events of
    one xLSTM ``generate`` (its sLSTM loop is ~170 k operators)."""
    path = ROOT / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    windows = [e for e in events if e.get("name") == span and
               e.get("cat") == "user_annotation"]
    check(len(windows) == 1, f"{len(windows)} profiler ranges {span}")
    t0 = windows[0]["ts"]
    t1 = t0 + windows[0]["dur"]
    names = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") in ("cpu_op", "user_annotation") and
             "External id" in e.get("args", {})}
    # where each operator ran (thread, start), and the open intervals of
    # the operators asked for, by thread
    starts = {e["args"]["External id"]: (e.get("tid"), e["ts"])
              for e in events if e.get("cat") == "cpu_op" and
              "External id" in e.get("args", {})} if ops else {}
    open_ = {op: {} for op in ops}
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("name") in open_:
            open_[e["name"]].setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    for by_tid in open_.values():
        for spans in by_tid.values():
            spans.sort()
    busy_us, by_op, by_kernel = 0.0, {}, {}
    ops_ms = {op: [0.0, 0] for op in ops}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        busy_us += max(0.0, min(e["ts"] + e["dur"], t1) - max(e["ts"], t0))
        ext = e.get("args", {}).get("External id")
        op = names.get(ext, e["name"])
        for by, name in ((by_op, op), (by_kernel, e["name"])):
            row = by.setdefault(name, [0.0, 0])
            row[0] += e["dur"] / 1e3
            row[1] += 1
        if ext not in starts:
            continue
        tid, ts = starts[ext]
        for name, by_tid in open_.items():
            spans = by_tid.get(tid, ())
            i = bisect.bisect_right(spans, (ts, math.inf)) - 1
            if i >= 0 and spans[i][0] <= ts < spans[i][1]:
                ops_ms[name][0] += e["dur"] / 1e3
                ops_ms[name][1] += 1

    def most(by):
        return sorted(([k, ms, n] for k, (ms, n) in by.items()),
                      key=lambda t: -t[1])[:top_n]
    out = dict(idle=None, busy_ms=None, window_s=(t1 - t0) / 1e6,
               top=most(by_op), top_kernels=most(by_kernel), ops_ms=ops_ms)
    if busy_us > 0.0:
        out.update(idle=1.0 - busy_us / (t1 - t0), busy_ms=busy_us / 1e3)
    return out


def serve_phase(dev) -> int:
    """Main path 2: decode requests served through the host executor and
    ``repro_torch.serve`` at ``serve_lm.CHIP_SIZES``."""
    import torch
    from repro_torch import RuntimeConfig, serve_lm
    from repro_torch.kernels.flash_decode import kernel as fd

    sizes = serve_lm.CHIP_SIZES
    config = RuntimeConfig(executor="host", device=str(dev))
    serve_lm.run(config)                  # warm-up at the example's sizes
    fd.flash_decode.launches = 0
    r = serve_lm.run(config, **sizes)     # verifies, checkpoints, restores
    launches = fd.flash_decode.launches
    st = r["stats"]
    want = sizes["requests"] * sizes["shards"]
    check(r["rows_verified"] == sizes["requests"], "serve: rows unverified")
    check(launches == want,
          f"serve: {launches} flash_decode launches, expected {want}")
    check(st.admission_peak_bytes <= st.admission_budget_bytes,
          "serve: admission peak over the budget")
    check(r["restore_identical"], "serve: restored arena differs")
    check(tuple(r["out"].shape) == (sizes["requests"], sizes["d"]) and
          bool(torch.isfinite(r["out"]).all().item()),
          "serve: output rows not finite or misshapen")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = serve_lm.run(config, **sizes)
    t = trace_summary(prof, serve_lm.SERVE_SPAN)
    print("[serve] " + json.dumps(dict(
        sizes=sizes, executor="host", wall_s=r["wall_s"],
        req_per_s=r["req_per_s"], p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
        latency="host-side completion (a task is complete once its body "
                "has queued its kernels)",
        rows_verified=r["rows_verified"], max_abs_err=r["max_abs_err"],
        flash_decode_launches=launches, tasks=st.tasks_spawned,
        worker_tasks=st.worker_tasks, worker_busy_s=st.worker_busy_s,
        admission_peak_bytes=st.admission_peak_bytes,
        admission_budget_bytes=st.admission_budget_bytes,
        epoch=r["epoch"], restored_epoch=r["restored_epoch"],
        restore_identical=r["restore_identical"],
        profiled_wall_s=profiled["wall_s"], profiled_window_s=t["window_s"],
        device_busy_ms=t["busy_ms"], idle_share=t["idle"])), flush=True)
    return launches


LLM_ARCH = "mistral-nemo-12b"
LLM_LAYERS = 8
LLM_REDUCED = {"n_layers": "40 -> 8 (f32 masters + bf16 compute copy of 40 "
                           "layers ≈ 72 GB)"}
LLM_BATCH, LLM_PROMPT, LLM_NEW = 4, 1024, 32
# bf16 compute: the kernel path against the chunked path, and the decode
# step against the full forward, may differ by a fraction of the logits'
# spread.  bf16 keeps 8 significant bits; the paths round at other places
# (a one-row decode GEMM against a 1,025-row forward GEMM, attention
# outputs rounded once per path) and every layer adds its rounding to the
# residual stream.  Measured on the CPU at 8 layers of d_model 512, the
# teacher-forcing gap was 2.7% of the logits' std; a quarter of the std
# keeps a ninefold margin and still catches a wrong cache position or
# mask, which moves the logits by about their std.
BF16_LOGIT_TOL = 0.25          # times the std of the prefill logits


def llm_diffs(cfg, params, batch) -> tuple[float, float, float]:
    """Max |difference| of (the kernel path's prefill last-token logits
    against the plain ``chunked`` path's; the decode step at position S
    after the kernel's prefill against the full forward over S + 1
    tokens, teacher forcing, with the batch's ``vision_embeds`` in
    both), and the std of the prefill logits.  The full forward runs the
    chunked path: S + 1 = 1,025 tokens do not split into the kernel's
    256-token blocks (the reference raises there too)."""
    import dataclasses
    import torch
    from repro_torch.models import api
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    tokens = batch["tokens"]
    s = tokens.shape[1]
    with torch.inference_mode():
        p = api.prepare(params, cfg)
        got, caches = api.prefill_step(p, cfg, batch)
        want, _ = api.prefill_step(p, chunked, batch)
        d_impl = (got.float() - want.float()).abs().max().item()
        std = got.float().std().item()
        nxt = got[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        dec, _ = api.decode_step(p, cfg, nxt, api.pad_caches(caches, s + 8),
                                 s)
        full = api.forward_logits(
            p, chunked, {**batch, "tokens": torch.cat([tokens, nxt], 1)})
        d_tf = (dec[:, 0].float() - full[:, s].float()).abs().max().item()
    return d_impl, d_tf, std


def serve_timed(cfg, params, batch, new_tokens: int, span: str) -> dict:
    """Drive ``launch.serve.generate`` as a user does, on the card: a
    warm-up, a timed ``generate`` (flash-attention launches counted from
    0 just before it to just after, peak device memory), the same steps
    one by one, synchronized (prefill ms, decode ms a step, finite
    logits, the same tokens), and a profiled ``generate`` (the device's
    idle share inside ``span``, the most device time by launching
    operator)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import serve
    from repro_torch.models import api

    tokens = batch["tokens"]
    b, prompt = tokens.shape
    max_len = prompt + new_tokens + 8           # the reference main's rule
    serve.generate(cfg, params, batch, max_new_tokens=1, max_len=max_len)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = serve.generate(cfg, params, batch, max_new_tokens=new_tokens,
                         max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (b, new_tokens) and
          int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"{span}: tokens {tuple(out.shape)} out of shape or range")

    # the same steps one by one, synchronized: prefill ms, decode ms a
    # step, finite logits, the same tokens
    prefill, decode = serve.build_serve_fns(cfg)
    finite, steps, toks = True, [], []
    with torch.inference_mode():
        p = api.prepare(params, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(p, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        caches = api.pad_caches(caches, max_len)
        for i in range(new_tokens):
            finite &= bool(torch.isfinite(logits).all().item())
            tok = torch.clamp(torch.argmax(logits[:, -1], -1)[:, None],
                              max=cfg.vocab_size - 1).to(torch.int32)
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(p, tok, caches, prompt + i)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(logits).all().item())
        del p, caches, logits
    check(finite, f"{span}: a logit is not finite")
    check(torch.equal(torch.cat(toks, 1), out),
          f"{span}: step-by-step tokens differ from generate's")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(span):
            serve.generate(cfg, params, batch, max_new_tokens=new_tokens,
                           max_len=max_len)
            torch.cuda.synchronize()
    return dict(out=out, max_len=max_len, wall=wall, launches=launches,
                peak=peak, prefill_ms=prefill_ms, steps=steps,
                **trace_summary(prof, span))


def serve_numbers(r: dict) -> dict:
    """The printed numbers of a ``serve_timed`` run."""
    import statistics
    return dict(
        max_len=r["max_len"], wall_s=r["wall"],
        tok_per_s=r["out"].numel() / r["wall"], prefill_ms=r["prefill_ms"],
        decode_ms_per_step=statistics.median(r["steps"]),
        decode_ms_min=min(r["steps"]), decode_ms_max=max(r["steps"]),
        peak_memory_bytes=r["peak"], flash_attention_launches=r["launches"],
        profiled_window_s=r["window_s"], device_busy_ms=r["busy_ms"],
        idle_share=r["idle"],
        top_device_ms=[[name[:60], ms, n] for name, ms, n in r["top"]])


def serve_and_hold(dev, card: str, tag: str, cfg, batch, new_tokens: int,
                   extra=None, launches_expected: int | None = None,
                   f32_layers: int = 2,
                   bf16_held_layers: int | None = None) -> tuple[int, dict]:
    """A main path at full width: weights from seed 0,
    ``launch.serve.generate`` timed by ``serve_timed`` (flash launches
    ``launches_expected``, one a layer by default), then ``llm_diffs`` in
    bf16 and, at ``f32_layers`` layers, in f32; the bf16 model is freed
    before the f32 one is drawn.  With ``bf16_held_layers`` the bf16
    differences held are those of a bf16 model of that depth, and the
    full depth's are printed (``bf16_full_depth``).  ``extra(params)``
    adds numbers of its own on the bf16 model.  Prints one ``[tag]``
    line, checks the [llm] tolerances (the kernel-against-chunked ones
    only where the path launches the kernel: elsewhere the two paths are
    one and the difference is printed), returns the launches and the
    printed row."""
    import dataclasses
    import torch
    from repro_torch.models import api

    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    n_params = api.count_params(params)
    r = serve_timed(cfg, params, batch, new_tokens, f"{tag}/generate")
    launches = r["launches"]
    if launches_expected is None:
        launches_expected = cfg.n_layers
    check(launches == launches_expected,
          f"{tag}: {launches} flash_attention launches, expected "
          f"{launches_expected}")
    bf16_impl, bf16_tf, bf16_std = llm_diffs(cfg, params, batch)
    more = extra(params) if extra else {}
    del params
    torch.cuda.empty_cache()

    def at_depth(n_layers, dtype):
        c = dataclasses.replace(cfg, n_layers=n_layers, compute_dtype=dtype)
        p = api.init_params(torch.Generator(device=dev).manual_seed(0), c,
                            device=dev)
        out = llm_diffs(c, p, batch)
        del p
        torch.cuda.empty_cache()
        return out

    if bf16_held_layers is not None:
        more["bf16_full_depth"] = dict(
            pallas_vs_chunked=bf16_impl, teacher_forcing=bf16_tf,
            logits_std=bf16_std)
        more["bf16_held_layers"] = bf16_held_layers
        bf16_impl, bf16_tf, bf16_std = at_depth(bf16_held_layers,
                                                cfg.compute_dtype)
    tol = BF16_LOGIT_TOL * bf16_std
    f32_impl, f32_tf, f32_std = at_depth(f32_layers, "float32")
    b, prompt = batch["tokens"].shape
    row = dict(
        card=card, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
        batch=b, prompt=prompt, new_tokens=new_tokens,
        params=n_params, **serve_numbers(r),
        f32_pallas_vs_chunked=f32_impl, f32_teacher_forcing=f32_tf,
        f32_logits_std=f32_std, bf16_pallas_vs_chunked=bf16_impl,
        bf16_teacher_forcing=bf16_tf, bf16_logits_std=bf16_std,
        bf16_tol=tol, f32_layers=f32_layers, **more)
    print(f"[{tag}] " + json.dumps(row), flush=True)
    if launches_expected:
        check(f32_impl <= 1e-3,
              f"{tag} f32: pallas vs chunked {f32_impl} > 1e-3")
        check(bf16_impl <= tol,
              f"{tag} bf16: pallas vs chunked {bf16_impl} > {tol}")
    check(f32_tf <= 2e-3, f"{tag} f32: teacher forcing {f32_tf} > 2e-3")
    check(bf16_tf <= tol, f"{tag} bf16: teacher forcing {bf16_tf} > {tol}")
    return launches, row


def llm_phase(dev, card: str) -> int:
    """Main path 3: ``launch.serve.generate`` with Mistral-NeMo-12B at full
    width (8 layers), prefill through the flash-attention kernel."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LLM_ARCH), n_layers=LLM_LAYERS,
                              attn_impl="pallas")
    print(f"[llm] reduced: {json.dumps(LLM_REDUCED, ensure_ascii=False)}",
          flush=True)
    tokens = torch.randint(
        0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    return serve_and_hold(dev, card, "llm", cfg, {"tokens": tokens},
                          LLM_NEW)[0]


MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 1024, 32
DEEPSEEK_ARCH, DEEPSEEK_LAYERS = "deepseek-v2-lite-16b", 8
GRANITE_ARCH = "granite-moe-1b-a400m"
MOE_REDUCED = {
    DEEPSEEK_ARCH: {"n_layers": "27 -> 8: the dense first layer + 7 MoE "
                                "(15.71 B parameters ≈ 94 GB as f32 "
                                "masters plus the bf16 compute copy; 8 "
                                "layers: 4.594 B ≈ 18.4 GB + 8.8 GB)"},
    GRANITE_ARCH: {},                              # all 24 layers
}
# the exactness checks at full width in f32: 2 layers, B 1 x 256
MOE_EXACT_LAYERS, MOE_EXACT_SEQ = 2, 256
# EP on the card: a 2 x 2 (data, model) mesh of 4 logical devices on one
# card, B 2 x 32 tokens
EP_MESH, EP_BATCH, EP_SEQ = (2, 2), 2, 32
# bf16 compute, Granite's prefill logits through the kernel against the
# chunked path: BF16_LOGIT_TOL of the logits' std, the [llm] rule (the
# two paths round the attention output at other places, and 24 layers
# add their rounding to the residual stream), compared drop-free
# (capacity factor E/k): at the served 1.25, a one-ulp change in one
# token's route can move another's choice over the capacity line, and
# the last token, sorted last, is the first one dropped.


def moe_exactness(dev) -> dict:
    """DeepSeek-V2-Lite at full width in f32 (TF32 off, as ``main`` sets
    it), 2 layers (the dense one and one MoE), capacity factor
    ``n_experts / top_k`` (no choice dropped): the decode step against
    the full forward (teacher forcing), ``moe_ffn_ep`` with no mesh
    against ``moe_ffn_ref`` on the decode tokens' shape (B 4 x 1) at
    the full MoE width, the absorbed ``mla_decode`` against
    ``mla_train``'s last row, and ``moe_ffn_ep`` on a 2 x 2 mesh of 4
    logical devices of the card against ``moe_ffn_ref`` (B 2 x 32), with
    the bytes its two exchanges moved."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.models import api, mla, moe

    base = get_config(DEEPSEEK_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=MOE_EXACT_LAYERS, compute_dtype="float32",
        moe_capacity_factor=base.n_experts / base.top_k)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_EXACT_SEQ + 1),
                           dtype=torch.int32, generator=gen, device=dev)
    s = MOE_EXACT_SEQ
    out = {}
    with torch.inference_mode():
        p = api.prepare(params, cfg)
        full = api.forward_logits(p, cfg, {"tokens": tokens})
        _, caches = api.prefill_step(p, cfg, {"tokens": tokens[:, :s]})
        dec, _ = api.decode_step(p, cfg, tokens[:, s:], api.pad_caches(
            caches, s + 8), s)
        out["teacher_forcing"] = (dec[:, 0] - full[:, s]).abs().max().item()
        pm = _layer(p["moe_blocks"]["moe"], 0)
        pa = _layer(p["moe_blocks"]["attn"], 0)
        x = torch.randn(MOE_BATCH, 1, cfg.d_model, generator=gen,
                        device=dev)
        got = moe.moe_ffn_ep(pm, x, cfg)
        want = moe.moe_ffn_ref(pm, x, cfg)
        out["moe_ep_vs_ref"] = (got - want).abs().max().item()
        xa = 0.5 * torch.randn(1, s + 1, cfg.d_model, generator=gen,
                               device=dev)
        pos = torch.arange(s + 1, device=dev)[None]
        train = mla.mla_train(pa, xa, cfg, pos)
        _, cache = mla.mla_prefill(pa, xa[:, :s], cfg, pos[:, :s])
        cache = api.pad_caches(cache, s + 1)
        absorbed, _ = mla.mla_decode(pa, xa[:, s:], cfg, cache, s)
        out["mla_absorbed_vs_train"] = \
            (absorbed[:, 0] - train[:, s]).abs().max().item()

        devs = np.empty(math.prod(EP_MESH), dtype=object)
        devs[:] = dist.logical_devices(devs.size, dev)
        mesh = dist.Mesh(devs.reshape(EP_MESH), ("data", "model"))
        xe = torch.randn(EP_BATCH, EP_SEQ, cfg.d_model, generator=gen,
                         device=dev)
        moe.moe_ffn_ep.exchanged_bytes = 0
        with dist.use_mesh(mesh):
            got = moe.moe_ffn_ep(pm, xe, cfg)
        torch.cuda.synchronize()
        out["ep_exchanged_bytes"] = moe.moe_ffn_ep.exchanged_bytes
        out["ep_vs_ref"] = (got - moe.moe_ffn_ref(pm, xe, cfg)) \
            .abs().max().item()
        # each rank keeps its own chunk of the E/2 experts' buckets and
        # sends the other, both ways: 2 groups x 2 ranks x 2 ways
        n_l = EP_BATCH // EP_MESH[0] * EP_SEQ // EP_MESH[1]
        cap = moe._capacity(cfg.moe_capacity_factor, n_l, cfg)
        out["ep_expected_bytes"] = 8 * (cfg.n_experts // 2) * cap * \
            cfg.d_model * 4
        del p, pm, pa
    del params
    torch.cuda.empty_cache()
    return out


def _layer(stacked, i):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def granite_diffs(cfg, params, tokens) -> tuple[float, float]:
    """Max |difference| of Granite's prefill last-token logits through
    the flash kernel against the plain ``chunked`` path, and the std of
    the kernel's logits."""
    import dataclasses
    import torch
    from repro_torch.models import api
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    with torch.inference_mode():
        p = api.prepare(params, cfg)
        got, _ = api.prefill_step(p, cfg, {"tokens": tokens})
        want, _ = api.prefill_step(p, chunked, {"tokens": tokens})
    return (got.float() - want.float()).abs().max().item(), \
        got.float().std().item()


def moe_phase(dev, card: str) -> int:
    """Main path 5: ``launch.serve.generate`` with the MoE family at full
    width, bf16 compute over f32 masters: DeepSeek-V2-Lite (MLA, 8 of 27
    layers) and Granite-3.0-1B-A400M (GQA, all 24 layers, prefill
    through the flash-attention kernel), B 4 x 1,024 tokens and 32
    greedy steps each; then the f32 exactness and EP checks.  Returns
    Granite's flash-attention launches and its printed row."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    print(f"[moe] reduced: {json.dumps(MOE_REDUCED, ensure_ascii=False)}",
          flush=True)
    runs = {}
    for arch in (DEEPSEEK_ARCH, GRANITE_ARCH):
        cfg = get_config(arch)
        if arch == DEEPSEEK_ARCH:
            cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_LAYERS)
        else:
            cfg = dataclasses.replace(cfg, attn_impl="pallas")
        params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        tokens = torch.randint(
            0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), dtype=torch.int32,
            generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        r = serve_timed(cfg, params, {"tokens": tokens}, MOE_NEW,
                        f"moe/{arch}/generate")
        want = cfg.n_layers if cfg.attn_impl == "pallas" else 0
        check(r["launches"] == want,
              f"moe {arch}: {r['launches']} flash_attention launches, "
              f"expected {want}")
        row = dict(card=card, arch=arch, n_layers=cfg.n_layers,
                   d_model=cfg.d_model,
                   heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                   experts=[cfg.n_experts, cfg.top_k, cfg.d_expert,
                            cfg.n_shared_experts],
                   capacity_factor=cfg.moe_capacity_factor, mla=cfg.mla,
                   attn_impl=cfg.attn_impl, vocab=cfg.vocab_size,
                   compute_dtype=cfg.compute_dtype, batch=MOE_BATCH,
                   prompt=MOE_PROMPT, new_tokens=MOE_NEW,
                   params=api.count_params(params), **serve_numbers(r))
        if arch == GRANITE_ARCH:
            free = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k)
            diff, std = granite_diffs(free, params, tokens)
            row.update(bf16_pallas_vs_chunked=diff, bf16_logits_std=std,
                       bf16_tol=BF16_LOGIT_TOL * std)
            del params
            cfg32 = dataclasses.replace(cfg, n_layers=2,
                                        compute_dtype="float32")
            params32 = api.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg32,
                device=dev)
            row["f32_pallas_vs_chunked"], row["f32_logits_std"] = \
                granite_diffs(cfg32, params32, tokens)
            del params32
        else:
            del params
        torch.cuda.empty_cache()
        print("[moe] " + json.dumps(row), flush=True)
        runs[arch] = row
    exact = moe_exactness(dev)
    print("[moe] " + json.dumps(dict(exactness=exact)), flush=True)
    g = runs[GRANITE_ARCH]
    check(g["f32_pallas_vs_chunked"] <= 1e-3,
          f"moe granite f32: pallas vs chunked {g['f32_pallas_vs_chunked']}"
          " > 1e-3")
    check(g["bf16_pallas_vs_chunked"] <= g["bf16_tol"],
          f"moe granite bf16: pallas vs chunked "
          f"{g['bf16_pallas_vs_chunked']} > {g['bf16_tol']}")
    check(exact["teacher_forcing"] <= 2e-3,
          f"moe deepseek f32: teacher forcing {exact['teacher_forcing']} "
          "> 2e-3")
    check(exact["moe_ep_vs_ref"] <= 1e-4,
          f"moe: moe_ffn_ep vs moe_ffn_ref {exact['moe_ep_vs_ref']} > 1e-4")
    check(exact["mla_absorbed_vs_train"] <= 2e-3,
          f"moe: absorbed mla_decode vs mla_train "
          f"{exact['mla_absorbed_vs_train']} > 2e-3")
    check(exact["ep_vs_ref"] <= 1e-4,
          f"moe: EP on 4 logical devices vs moe_ffn_ref "
          f"{exact['ep_vs_ref']} > 1e-4")
    check(exact["ep_exchanged_bytes"] == exact["ep_expected_bytes"],
          f"moe: EP exchanged {exact['ep_exchanged_bytes']} bytes, "
          f"expected {exact['ep_expected_bytes']}")
    return g["flash_attention_launches"], g


# the model under a mesh: Granite-3.0-1B-A400M whole on a (data, model)
# = (2, 2) mesh of 4 logical devices of the card
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 4096   # train_4k's length
MESH_TRAIN_TIMED = 3                         # after one warm-up step
MESH_REDUCED = {
    "global_batch": "256 -> 4 (train_4k's batch, by memory: f32 masters, "
                    "AdamW moments and gradients placed on one card, "
                    "plus the gathered compute copy)",
    "devices": "4 logical devices of one card (a (2, 2) mesh)",
}
# f32, drop-free (capacity E/k: each position's capacity counts its own
# tokens, so at 1.25 the mesh and the whole batch drop different
# choices): 2 layers, B 4 x 1,024, the mesh against no mesh.  The same
# f32 operations in other orders (the gathered parameters, attention per
# position, the stripes' log-sum-exp merge, chunks of the global norm):
# the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
# largest element (the CPU parity tests' rule), the logits within 1e-4.
MESH_EXACT_LAYERS, MESH_EXACT_BATCH, MESH_EXACT_SEQ = 2, 4, 1024
MESH_LOSS_RTOL, MESH_GRAD_OF_MAX, MESH_LOGIT_TOL = 1e-5, 1e-4, 1e-4


def logical_mesh(dev, shape):
    from repro_torch import dist
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, MESH_AXES,
                     dist.logical_devices(math.prod(shape), dev))


def mesh_counters(reset: bool = False) -> dict:
    """The mesh path's byte counters and the flash launches (zeroed with
    ``reset``)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import dryrun
    owners = dict(dryrun.COUNTERS,
                  flash_attention_launches=(fa.flash_attention, "launches"))
    if reset:
        for obj, attr in owners.values():
            setattr(obj, attr, 0)
    return {k: getattr(obj, attr) for k, (obj, attr) in owners.items()}


# the operators whose device ms the mesh train line reports (every kernel
# launched inside one counted): what each position's slices of q, k and
# v wrote in their backward before they were split once
MESH_TRAIN_OPS = ("aten::slice_backward", "aten::copy_", "aten::add",
                  "aten::add_", "aten::cat")


def mesh_train(dev, card: str, mesh) -> dict:
    """``launch.train.build_train_step``: Granite at full width and
    depth, bf16 over f32 masters, chunked attention, remat ``full``, B 4
    x S 4,096; one warm-up and 3 timed steps, then one profiled.  On the
    mesh under ``fsdp`` with in/out shardings; with ``mesh`` None the
    same steps on the ``Decoder`` with no mesh, the twin to read it
    beside."""
    import contextlib
    import dataclasses
    import statistics
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist import sharding
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config(GRANITE_ARCH), attn_impl="chunked",
                              remat=True, remat_policy="full")
    data = SyntheticTokens(cfg.vocab_size, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH,
                           seed=0)
    kw = dict(peak_lr=3e-4, warmup=100, total_steps=10_000)
    with (dist.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()) as ctx:
        params = api.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        n_params = api.count_params(params)
        if ctx is not None:
            p_sh = sharding.param_shardings(cfg, params, ctx, policy="fsdp")
            o_sh = sharding.opt_state_shardings(p_sh, ctx)
            params = dist.device_put(params, p_sh)
            torch.cuda.empty_cache()
            b_sh = sharding.batch_shardings(
                cfg, {"tokens": data.batch_at(0)["tokens"]}, ctx)
            kw.update(in_shardings=(p_sh, o_sh, b_sh, None),
                      out_shardings=(p_sh, o_sh, None))
        opt = adamw_init(params)
        held = dist.bytes_by_device((params, opt))
        step_fn = train.build_train_step(cfg, **kw)

        def run(step):
            nonlocal params, opt
            batch = {"tokens": data.batch_at(step)["tokens"].to(dev)}
            params, opt, m = step_fn(params, opt, batch, step)
            return m

        run(0)                                     # warm-up; lr(0) = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mesh_counters(reset=True)
        ms, metrics = [], []
        for step in range(1, MESH_TRAIN_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = run(step)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = mesh_counters()
        peak = torch.cuda.max_memory_allocated()
        span = "mesh/train_step" if mesh is not None else \
            "mesh/train_step_no_mesh"
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(span):
                run(MESH_TRAIN_TIMED + 1)
                torch.cuda.synchronize()
        t = trace_summary(prof, span, top_n=10, ops=MESH_TRAIN_OPS)
        del params, opt, prof
    torch.cuda.empty_cache()
    step_ms = statistics.median(ms)
    per_step = {k: v / MESH_TRAIN_TIMED for k, v in counts.items()}
    row = dict(card=card, arch=GRANITE_ARCH, mode="train",
               mesh=None if mesh is None else dict(zip(MESH_AXES,
                                                       MESH_SHAPE)),
               policy=None if mesh is None else "fsdp",
               n_layers=cfg.n_layers, compute_dtype=cfg.compute_dtype,
               attn_impl=cfg.attn_impl, remat=cfg.remat_policy,
               batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ, params=n_params,
               bytes_by_device=held, step_ms=step_ms, step_ms_all=ms,
               tok_per_s=MESH_TRAIN_BATCH * MESH_TRAIN_SEQ / (step_ms / 1e3),
               peak_memory_bytes=peak, step_peak_increase_bytes=peak - base,
               counted_steps=counts,
               gathered_bytes_per_step=per_step["gathered_bytes"],
               placed_bytes_per_step=per_step["placed_bytes"],
               ep_exchanged_bytes_per_step=per_step["ep_exchanged_bytes"],
               flash_attention_launches=counts["flash_attention_launches"],
               loss=[m["loss"] for m in metrics],
               gnorm=[m["gnorm"] for m in metrics],
               profiled_window_s=t["window_s"], device_busy_ms=t["busy_ms"],
               idle_share=t["idle"], ops_ms=t["ops_ms"],
               top_ops_ms=[[name[:40], ms_, n] for name, ms_, n in t["top"]],
               top_kernels_ms=[[name[:70], ms_, n]
                               for name, ms_, n in t["top_kernels"]])
    print("[mesh] " + json.dumps(row), flush=True)
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["gnorm"]) and
              m["gnorm"] > 0 for m in metrics),
          "mesh train: a loss or gnorm is not finite, or a gnorm is 0")
    if mesh is not None:
        check(per_step["gathered_bytes"] >= 4 * n_params,
              "mesh train: a step gathered fewer bytes than the parameters")
    check(counts["flash_attention_launches"] == 0,
          "mesh train: the flash kernel launched in training")
    return row


def mesh_serve(dev, card: str, mesh, granite: dict) -> dict:
    """``launch.serve.generate`` under the mesh, ``tp`` placement (the
    reference's serving rule), ``attn_impl="pallas"``: Granite at full
    width and depth, B 4 x 1,024 + 32, beside the no-mesh run of
    ``[moe]`` (``granite``); one more ``generate`` counts the flash
    launches (one per layer and mesh position) and the bytes."""
    import dataclasses
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import serve
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(GRANITE_ARCH), attn_impl="pallas")
    tokens = torch.randint(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"tokens": tokens}
    with dist.use_mesh(mesh) as ctx:
        decoder = api.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        params = dist.device_put(decoder, sharding.param_shardings(
            cfg, decoder, ctx, policy="tp"))
        del decoder
        torch.cuda.empty_cache()
        held = dist.bytes_by_device(params)
        r = serve_timed(cfg, params, batch, MOE_NEW, "mesh/generate")
        mesh_counters(reset=True)
        with torch.inference_mode():
            out = serve.generate(cfg, params, batch, max_new_tokens=MOE_NEW,
                                 max_len=MOE_PROMPT + MOE_NEW + 8)
            torch.cuda.synchronize()
        counts = mesh_counters()
        del params
    torch.cuda.empty_cache()
    positions = math.prod(MESH_SHAPE)
    row = dict(card=card, arch=GRANITE_ARCH, mode="serve",
               mesh=dict(zip(MESH_AXES, MESH_SHAPE)), policy="tp",
               attn_impl=cfg.attn_impl, n_layers=cfg.n_layers,
               batch=MOE_BATCH, prompt=MOE_PROMPT, new_tokens=MOE_NEW,
               bytes_by_device=held,
               **serve_numbers(r), counted_generate=counts,
               no_mesh=dict((k, granite[k]) for k in (
                   "prefill_ms", "decode_ms_per_step", "tok_per_s",
                   "peak_memory_bytes", "idle_share")))
    print("[mesh] " + json.dumps(row), flush=True)
    check(tuple(out.shape) == (MOE_BATCH, MOE_NEW),
          "mesh serve: tokens out of shape")
    want = cfg.n_layers * positions
    check(r["launches"] == want and
          counts["flash_attention_launches"] == want,
          f"mesh serve: {r['launches']} and "
          f"{counts['flash_attention_launches']} flash launches, expected "
          f"{want} (one per layer and mesh position)")
    check(counts["sp_combine_bytes"] > 0 and counts["ep_exchanged_bytes"] > 0,
          "mesh serve: no stripe combine or EP exchange counted")
    return row


def mesh_exactness(dev, mesh) -> dict:
    """At full width in f32 (TF32 off, as ``main`` sets it), 2 layers, B
    4 x 1,024, drop-free: the loss and every gradient under ``fsdp`` on
    the mesh against no mesh (chunked attention); the prefill logits
    through the f32 flash kernel per position and 4 decode steps through
    ``_decode_sp`` under ``tp`` against no mesh; then the placed
    parameters and AdamW state of the mesh saved and restored with
    ``shardings=`` onto a (1, 4) mesh, bit for bit."""
    import dataclasses
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.models import api
    from repro_torch.models.transformer import tree

    base = get_config(GRANITE_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=MESH_EXACT_LAYERS, compute_dtype="float32",
        moe_capacity_factor=base.n_experts / base.top_k,
        attn_impl="chunked")
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size,
                           (MESH_EXACT_BATCH, MESH_EXACT_SEQ + 4),
                           dtype=torch.int32, generator=gen, device=dev)
    prompt, nxt = tokens[:, :MESH_EXACT_SEQ], tokens[:, MESH_EXACT_SEQ:]
    decoder = api.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
    out = {}
    decoder.requires_grad_(True)
    loss0 = api.loss_fn(decoder, cfg, {"tokens": prompt})
    loss0.backward()
    grads0 = {k: v.grad.detach().clone() for k, v in _flat_tree(
        tree(decoder)).items()}
    decoder.zero_grad(set_to_none=True)
    decoder.requires_grad_(False)
    with dist.use_mesh(mesh) as ctx:
        p_sh = sharding.param_shardings(cfg, decoder, ctx, policy="fsdp")
        placed = dist.device_put(decoder, p_sh)
        for x in dist.placed_leaves(placed):
            for t in x.shards.values():
                t.requires_grad_(True)
        loss1 = api.loss_fn(placed, cfg, {"tokens": prompt})
        loss1.backward()
        gap = 0.0
        for name, x in _flat_tree(placed).items():
            g1 = dist.gather(x.map(lambda t: t.grad)).detach()
            g0 = grads0[name]
            gap = max(gap, ((g1 - g0).abs().max() /
                            g0.abs().max().clamp(min=1e-30)).item())
        for x in dist.placed_leaves(placed):
            for t in x.shards.values():
                t.grad = None
                t.requires_grad_(False)
    out["loss_rel_gap"] = abs(loss1.item() - loss0.item()) / abs(loss0.item())
    out["grad_gap_of_max"] = gap
    del grads0, placed

    pallas = dataclasses.replace(cfg, attn_impl="pallas")
    max_len = MESH_EXACT_SEQ + 8

    def serve_logits(params):
        with torch.inference_mode():
            p = api.prepare(params, pallas)
            logits, caches = api.prefill_step(p, pallas, {"tokens": prompt})
            caches = api.pad_caches(caches, max_len)
            steps = [logits]
            for i in range(nxt.shape[1]):
                logits, caches = api.decode_step(p, pallas, nxt[:, i:i + 1],
                                                 caches, MESH_EXACT_SEQ + i)
                steps.append(logits)
        return steps

    want = serve_logits(decoder)
    with dist.use_mesh(mesh) as ctx:
        mesh_counters(reset=True)
        got = serve_logits(dist.device_put(decoder, sharding.param_shardings(
            cfg, decoder, ctx, policy="tp")))
        launches = mesh_counters()["flash_attention_launches"]
    out["prefill_logits_gap"] = (got[0] - want[0]).abs().max().item()
    out["decode_logits_gap"] = max((a - b).abs().max().item()
                                   for a, b in zip(got[1:], want[1:]))
    out["flash_launches"] = launches

    # the mesh's placed parameters and AdamW state, restored onto (1, 4)
    out["restore_onto_1x4_bit_equal"] = mesh_restore_equal(
        cfg, decoder, mesh, logical_mesh(dev, (1, 4)),
        ROOT / "build" / "mesh_ckpt")
    del decoder
    torch.cuda.empty_cache()
    return out


def mesh_restore_equal(cfg, decoder, mesh, other, ckpt) -> bool:
    """Whether ``decoder``'s parameters and a fresh AdamW state, placed by
    ``fsdp`` on ``mesh`` and saved to ``ckpt``, restore with
    ``shardings=`` onto the mesh ``other`` bit for bit, every leaf laid
    out on ``other``."""
    import shutil
    import torch
    from repro_torch import dist
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.dist import sharding
    from repro_torch.optim import adamw_init

    shutil.rmtree(ckpt, ignore_errors=True)
    with dist.use_mesh(mesh) as ctx:
        placed = dist.device_put(decoder, sharding.param_shardings(
            cfg, decoder, ctx, policy="fsdp"))
        state = (placed, adamw_init(placed))
        save_checkpoint(str(ckpt), 1, state)
    with dist.use_mesh(other) as ctx:
        p_sh = sharding.param_shardings(cfg, decoder, ctx, policy="fsdp")
        restored, _, _ = restore_checkpoint(
            str(ckpt), 1, (decoder, adamw_init(decoder)),
            shardings=(p_sh, sharding.opt_state_shardings(p_sh, ctx)))
    shutil.rmtree(ckpt, ignore_errors=True)

    def by_name(params, opt):
        out = {"step": opt.step}
        for name, tree_ in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
            out.update({f"{name}.{k}": v
                        for k, v in _flat_tree(tree_).items()})
        return out

    saved, got = by_name(*state), by_name(*restored)
    same = saved.keys() == got.keys() and all(
        torch.equal(dist.gather(saved[k]), dist.gather(got[k]))
        for k in saved)
    return same and all(isinstance(x, dist.Placed) and
                        x.sharding.mesh is other for x in got.values())


def _flat_tree(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def mesh_phase(dev, card: str, granite: dict) -> int:
    """The model under a mesh: Granite-3.0-1B-A400M whole on a (2, 2)
    mesh of 4 logical devices of the card, trained (``fsdp``) and served
    (``tp``) through the normal entry points, then held in f32 against
    no mesh.  Returns the flash launches of one ``generate`` and the
    mesh's train row."""
    import torch
    print(f"[mesh] reduced: {json.dumps(MESH_REDUCED, ensure_ascii=False)}",
          flush=True)
    mesh = logical_mesh(dev, MESH_SHAPE)
    train_row = mesh_train(dev, card, mesh)
    mesh_train(dev, card, None)
    torch.cuda.empty_cache()
    row = mesh_serve(dev, card, mesh, granite)
    exact = mesh_exactness(dev, mesh)
    print("[mesh] " + json.dumps(dict(exactness=exact, tolerances=dict(
        loss_rtol=MESH_LOSS_RTOL, grad_gap_of_max=MESH_GRAD_OF_MAX,
        logits=MESH_LOGIT_TOL))), flush=True)
    check(exact["loss_rel_gap"] <= MESH_LOSS_RTOL,
          f"mesh f32: loss gap {exact['loss_rel_gap']}")
    check(exact["grad_gap_of_max"] <= MESH_GRAD_OF_MAX,
          f"mesh f32: gradient gap {exact['grad_gap_of_max']}")
    check(exact["prefill_logits_gap"] <= MESH_LOGIT_TOL,
          f"mesh f32: prefill logits gap {exact['prefill_logits_gap']}")
    check(exact["decode_logits_gap"] <= MESH_LOGIT_TOL,
          f"mesh f32: decode logits gap {exact['decode_logits_gap']}")
    check(exact["flash_launches"] == MESH_EXACT_LAYERS * math.prod(MESH_SHAPE),
          f"mesh f32: {exact['flash_launches']} flash launches")
    check(exact["restore_onto_1x4_bit_equal"],
          "mesh: restore with shardings= onto (1, 4) is not the saved state")
    return row["flash_attention_launches"], train_row


# the dry run (launch/dryrun.py): the two mesh cells above predicted on
# (2, 2) meta devices and held to their runs on the card, then the
# decode_32k cell of one arch per family on the 16 x 16 production mesh
DRYRUN_ARCHS = ("mistral-nemo-12b", "deepseek-v2-lite-16b", "qwen2-vl-72b",
                "zamba2-1.2b", "xlstm-1.3b", "whisper-tiny")
DRYRUN_SHAPE = "decode_32k"
# the predicted peak of a step's allocations against the card's
# max_memory_allocated() increase, held where the step allocates at
# least 1 GiB (the allocator's rounding and workspaces are noise below)
DRYRUN_PEAK_BAND, DRYRUN_PEAK_HELD_FROM = 0.25, 1 << 30


def dryrun_serve_real(dev, cfg, mesh, tokens, max_len: int):
    """``dryrun.serve_steps`` on the card: Granite placed ``tp`` on
    ``mesh``, each step's byte counters (zeroed just before it) and
    its ``max_memory_allocated()`` increase.  Returns ``({step:
    counts}, bytes held by device)``."""
    import torch
    from repro_torch import dist
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import api

    real = {}

    def run(name, fn, inputs, donated):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mesh_counters(reset=True)
        out = fn(*inputs)
        torch.cuda.synchronize()
        real[name] = dict(mesh_counters(), peak_increase_bytes=(
            torch.cuda.max_memory_allocated() - base))
        return out

    with dist.use_mesh(mesh) as ctx:
        decoder = api.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        params = dist.device_put(decoder, sharding.param_shardings(
            cfg, decoder, ctx, policy="tp"))
        del decoder
        torch.cuda.empty_cache()
        held = dist.bytes_by_device(params)
        with torch.inference_mode():
            dryrun.serve_steps(cfg, params, tokens, max_len=max_len,
                               run=run)
        del params
    torch.cuda.empty_cache()
    return real, held


def _held_peak(name: str, predicted: int, real: int) -> bool:
    """Print a step's predicted peak beside the card's; whether it is
    held to the band."""
    ratio = predicted / real if real else float("inf")
    held = real >= DRYRUN_PEAK_HELD_FROM
    print(f"[dryrun] peak {name}: predicted {predicted} bytes, card "
          f"{real} bytes (max_memory_allocated increase), ratio "
          f"{ratio:.4f}" + ("" if held else " (under 1 GiB: printed)"),
          flush=True)
    if held:
        check(abs(ratio - 1) <= DRYRUN_PEAK_BAND,
              f"dryrun: {name}'s predicted peak is {ratio:.4f} of the "
              f"card's, outside +-{DRYRUN_PEAK_BAND}")
    return held


def dryrun_phase(dev, card: str, train_row: dict) -> None:
    """(a) ``launch.dryrun`` predicts ``[mesh]``'s two cells on (2, 2)
    ``meta`` devices: Granite's ``fsdp`` train step (B 4 x S 4,096, as
    ``mesh_train``) and its ``tp`` serving (B 4 x 1,024 + 32, ``pallas``)
    step by step; the bytes each device holds and every byte counter
    must equal the card's runs (the train step's from ``[mesh]``, the
    serving steps' run here), and the predicted peak stay within the
    band of the card's.  (b) ``lower_cell`` traces the ``decode_32k``
    cell of one arch per family on the 16 x 16 mesh at full width and
    depth."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    meta = dryrun.meta_mesh(MESH_SHAPE, MESH_AXES)
    # (a) the train step
    cfg = dataclasses.replace(get_config(GRANITE_ARCH), attn_impl="chunked",
                              remat=True, remat_policy="full")
    tokens = torch.empty((MESH_TRAIN_BATCH, MESH_TRAIN_SEQ),
                         dtype=torch.int32, device="meta")
    tr, held = dryrun.predict_train(cfg, meta, {"tokens": tokens})
    counted = train_row["counted_steps"]
    keys = list(dryrun.COUNTERS)
    card_train = {k: counted[k] // MESH_TRAIN_TIMED for k in keys}
    predicted = {k: tr.counters[k] for k in keys}
    print("[dryrun] " + json.dumps(dict(
        card=card, cell="granite train fsdp (2, 2) B 4 x S 4,096",
        trace_s=tr.wall_s, held_predicted=held,
        held_card=train_row["bytes_by_device"], step_predicted=predicted,
        step_card=card_train, flops=tr.flops,
        collectives=tr.collectives)), flush=True)
    check(all(counted[k] % MESH_TRAIN_TIMED == 0 for k in keys),
          "dryrun: the card's train steps counted unequal bytes")
    check(held == train_row["bytes_by_device"],
          "dryrun: predicted bytes held differ from the card's (train)")
    check(predicted == card_train,
          "dryrun: predicted train step bytes differ from the card's")
    peaks = [_held_peak("train step", tr.peak,
                        train_row["step_peak_increase_bytes"])]
    # (a) serving, step by step
    scfg = dataclasses.replace(get_config(GRANITE_ARCH), attn_impl="pallas")
    max_len = MOE_PROMPT + MOE_NEW + 8
    traces, held = dryrun.predict_serve(
        scfg, meta, torch.empty((MOE_BATCH, MOE_PROMPT), dtype=torch.int32,
                                device="meta"), max_len=max_len)
    prompt = torch.randint(
        0, scfg.vocab_size, (MOE_BATCH, MOE_PROMPT), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    real, card_held = dryrun_serve_real(dev, scfg,
                                        logical_mesh(dev, MESH_SHAPE),
                                        prompt, max_len)
    steps = {name: dict(predicted={k: t.counters[k] for k in keys},
                        card={k: real[name][k] for k in keys},
                        peak_predicted=t.peak,
                        peak_card=real[name]["peak_increase_bytes"],
                        trace_s=t.wall_s,
                        flash_launches_card=real[name][
                            "flash_attention_launches"])
             for name, t in traces.items()}
    print("[dryrun] " + json.dumps(dict(
        card=card, cell="granite serve tp (2, 2) B 4 x 1,024 + 32 pallas",
        held_predicted=held, held_card=card_held, steps=steps)), flush=True)
    check(held == card_held,
          "dryrun: predicted bytes held differ from the card's (serve)")
    for name, row in steps.items():
        check(row["predicted"] == row["card"],
              f"dryrun: predicted {name} bytes differ from the card's")
        peaks.append(_held_peak(name, row["peak_predicted"],
                                row["peak_card"]))
    # (b) the production mesh
    for arch in DRYRUN_ARCHS:
        rec, _ = dryrun.lower_cell(arch, DRYRUN_SHAPE, False)
        mem = rec["memory"]
        print("[dryrun] " + json.dumps(dict(
            cell=f"{arch}__{DRYRUN_SHAPE}__{rec['mesh']}",
            policy=rec["policy"], compile_s=rec["compile_s"],
            gib_per_device=mem["per_device_total_bytes"] / 2**30,
            memory=mem, flops_per_device=rec["flops_per_device"],
            link_bytes=rec["collectives"]["link_bytes"],
            total_link_bytes=rec["collectives"]["total_link_bytes"])),
            flush=True)
        check(rec["n_devices"] == 256 and rec["flops_per_device"] > 0,
              f"dryrun: {arch}'s record is empty")
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f} s; peaks held "
          f"{sum(peaks)} of {len(peaks)}", flush=True)


VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 8
VLM_REDUCED = {"n_layers": "80 -> 8 (0.8777 B parameters a layer ≈ 5.27 GB "
                           "as f32 masters plus the bf16 compute copy; 8 "
                           "layers plus the embedding and the untied head "
                           "(2.49 B) are 9.51 B parameters ≈ 57.1 GB; 10 "
                           "layers ≈ 67.6 GB before activations and the f32 "
                           "check model)"}
VLM_BATCH, VLM_PROMPT, VLM_NEW = 4, 1024, 32


def vlm_phase(dev, card: str) -> int:
    """Main path 6: ``launch.serve.generate`` with Qwen2-VL-72B at full
    width (8 of 80 layers), bf16 compute over f32 masters, prefill
    through the flash-attention kernel at group 8, a seeded normal
    ``vision_embeds`` stub spliced over the first 256 positions; the
    [llm] exactness checks with the stub, the splice's effect and M-RoPE
    against RoPE at full width.  Returns the flash-attention launches of
    one ``generate``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api, rope

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS,
                              attn_impl="pallas")
    print(f"[vlm] reduced: {json.dumps(VLM_REDUCED, ensure_ascii=False)}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT),
                           dtype=torch.int32, generator=gen, device=dev)

    def stub():
        return torch.randn(VLM_BATCH, cfg.vision_seq, cfg.d_model,
                           generator=gen, device=dev).to(
                               getattr(torch, cfg.compute_dtype))

    batch = {"tokens": tokens, "vision_embeds": stub()}

    def extra(params) -> dict:
        # the splice: another stub, other last-token logits
        with torch.inference_mode():
            p = api.prepare(params, cfg)
            a, _ = api.prefill_step(p, cfg, batch)
            b, _ = api.prefill_step(p, cfg, {**batch,
                                             "vision_embeds": stub()})
            splice = (a.float() - b.float()).abs().max().item()
            del p, a, b
        # M-RoPE with the three streams equal (the stub's) is RoPE, at
        # the published sections over head dim 128 and theta 1e6
        x = torch.randn(VLM_BATCH, cfg.n_heads, VLM_PROMPT, cfg.head_dim,
                        generator=gen, device=dev)
        pos = torch.arange(VLM_PROMPT, dtype=torch.int32,
                           device=dev)[None].expand(VLM_BATCH, -1)
        mrope = (rope.apply_mrope(x, pos[None].expand(3, -1, -1),
                                  cfg.mrope_sections, theta=cfg.rope_theta)
                 - rope.apply_rope(x, pos, theta=cfg.rope_theta))
        return dict(qkv_bias=cfg.qkv_bias,
                    mrope_sections=list(cfg.mrope_sections),
                    rope_theta=cfg.rope_theta, vision_seq=cfg.vision_seq,
                    splice_logit_change=splice,
                    mrope_vs_rope=mrope.abs().max().item())

    launches, row = serve_and_hold(dev, card, "vlm", cfg, batch, VLM_NEW,
                                   extra)
    check(row["splice_logit_change"] > 0,
          "vlm: another vision stub left the logits unchanged")
    check(row["mrope_vs_rope"] == 0,
          f"vlm: M-RoPE over equal streams is {row['mrope_vs_rope']} off "
          "RoPE")
    return launches


RECURRENT_BATCH, RECURRENT_PROMPT, RECURRENT_NEW = 4, 1024, 32
HYBRID_ARCH, SSM_ARCH = "zamba2-1.2b", "xlstm-1.3b"
# the exactness models: 8 layers, so that Zamba2 has one shared
# attention call (Mamba segments [0, 6) and [6, 8)) and xLSTM one sLSTM
# layer (7 mLSTM + 1); at 2 layers neither would run that path.  The
# bf16 differences are held at this depth too, and the full depth's
# printed: both stacks amplify a rounding difference with depth, the
# reference's as much as the port's.  Zamba2's Mamba2 blocks have no
# residual (each output replaces the hidden state) and xLSTM's blocks no
# input norm (its residual stream grows with depth), so at random
# weights two paths that round at other places part steeply with
# depth.  ``tools/recurrent_drift.py`` measures it on the CPU
# in both packages, in f32; on the card, the first full-depth run
# (H100 80GB HBM3, 700 W) gave Zamba2 bf16 gaps of 6.23 (kernel against
# chunked) and 5.98 (teacher forcing) at a logits std of 0.90: no
# tolerance there tells a fault from rounding, at 8 layers a quarter of
# the std does.
RECURRENT_LAYERS_HELD = 8


def count_aten_ops(fn) -> int:
    """The aten operators one call of ``fn`` dispatches, each an eager
    call from the host, counted by a ``TorchDispatchMode``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with torch.inference_mode(), Count():
        fn()
    return Count.n


def recurrent_phase(dev, card: str, tag: str, arch: str) -> int:
    """Main paths 7 and 8: ``launch.serve.generate`` with a recurrent
    family at full width and depth, bf16 compute over f32 masters, B 4
    prompts of 1,024 tokens and 32 greedy steps, timed and held as
    ``serve_and_hold`` does, its f32 model at 8 layers.  Zamba2-1.2B
    (``hybrid``) runs its shared attention block through the flash
    kernel (``attn_impl="pallas"``), one launch a call site;
    xLSTM-1.3B (``ssm``) has no attention and launches none.  Also
    printed: the aten ops of one decode step, the cache's bytes and, for
    xLSTM, the host cost of one sLSTM layer's ``slstm_scan`` over the
    prompt (its wall and its aten ops).  Returns the flash-attention
    launches of one ``generate``."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer, xlstm

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    if hybrid:
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
    expected = len(transformer._zamba_attn_positions(cfg)) if hybrid else 0
    print(f"[{tag}] reduced: {{}} (all {cfg.n_layers} layers at the "
          f"published widths)", flush=True)
    tokens = torch.randint(
        0, cfg.vocab_size, (RECURRENT_BATCH, RECURRENT_PROMPT),
        dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"tokens": tokens}
    prompt = RECURRENT_PROMPT

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]

    def extra(params) -> dict:
        with torch.inference_mode():
            p = api.prepare(params, cfg)
            _, caches = api.prefill_step(p, cfg, batch)
            caches = api.pad_caches(caches, prompt + RECURRENT_NEW + 8)
            out = dict(cache_bytes=sum(t.numel() * t.element_size()
                                       for t in leaves(caches)),
                       decode_aten_ops=count_aten_ops(
                           lambda: api.decode_step(p, cfg, tokens[:, -1:],
                                                   caches, prompt)))
            del caches
            if hybrid:
                out.update(ssm=[cfg.ssm_d_inner, cfg.ssm_state,
                                cfg.ssm_heads, cfg.ssm_d_conv,
                                cfg.ssm_chunk],
                           attn_positions=transformer._zamba_attn_positions(
                               cfg), attn_impl=cfg.attn_impl)
            else:
                n_s = transformer._xlstm_slstm_count(cfg)
                p_s = transformer._unstack(p["slstm"])[0]
                x = torch.randn(RECURRENT_BATCH, prompt, cfg.d_model,
                                generator=torch.Generator(
                                    device=dev).manual_seed(2),
                                device=dev).to(transformer._cdtype(cfg))
                xlstm.slstm_scan(p_s, x, cfg)
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    xlstm.slstm_scan(p_s, x, cfg)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                out.update(xlstm_d_inner=cfg.xlstm_d_inner,
                           layers_mlstm_slstm=[cfg.n_layers - n_s, n_s],
                           slstm_layer_ms=statistics.median(walls),
                           slstm_layer_ms_all=walls,
                           slstm_layer_aten_ops=count_aten_ops(
                               lambda: xlstm.slstm_scan(p_s, x, cfg)))
            del p
        return out

    launches, _ = serve_and_hold(dev, card, tag, cfg, batch, RECURRENT_NEW,
                                 extra, launches_expected=expected,
                                 f32_layers=RECURRENT_LAYERS_HELD,
                                 bf16_held_layers=RECURRENT_LAYERS_HELD)
    print(f"[{tag}] phase_wall_s={time.perf_counter() - t_phase}",
          flush=True)
    return launches


AUDIO_ARCH = "whisper-tiny"
# B 16 segments of 30 s (1,500 frames) batched for transcription, with
# 224-token prompts (half of whisper's 448-token text context, the size
# of its previous-text prompt) and 32 greedy steps
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW = 16, 224, 32
# the flash kernel's block contract: min(256, S) divides S.  1,500 frames
# do not split, so under "pallas" the reference raises there; 1,280
# frames (25.6 s of audio) is the largest length <= 1,500 that splits
AUDIO_KERNEL_FRAMES = 1280
AUDIO_KERNEL_REDUCED = {
    "encoder_seq": "1500 -> 1280: the largest length ≤ 1500 that the "
                   "flash kernel's 256-block contract takes; the "
                   "reference raises at 1500"}


def audio_phase(dev, card: str) -> int:
    """Main path 9: ``launch.serve.generate`` with whisper-tiny at full
    width and depth (4 encoder and 4 decoder layers, d 384, 6 heads of
    64; 56,443,392 parameters), bf16 compute over f32 masters, B 16
    segments of seeded N(0, 1) frame embeddings (the conv front end's
    stub) with 224-token prompts and 32 greedy steps, timed and held as
    ``serve_and_hold`` does, the whole model in f32 too.  ``[audio]``:
    the published 1,500 frames under the config's own
    ``attn_impl="chunked"``, no flash launch; first, ``"pallas"`` must
    raise the reference's ``ValueError`` at ``prefill_step`` with no
    launch.  ``[audio_kernel]``: 1,280 frames under ``"pallas"``, 12
    launches (per layer the encoder's self-attention, the decoder's
    causal self-attention and its cross-attention).  Also printed: the
    aten ops of one decode step, the cache's bytes and the wall of one
    decode step's cross-attention K/V projections, which the reference
    recomputes from the encoder output at every step.  Returns the
    kernel run's launches."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import api, transformer
    from repro_torch.models.layers import linear

    t_phase = time.perf_counter()
    base = get_config(AUDIO_ARCH)
    tokens = torch.randint(
        0, base.vocab_size, (AUDIO_BATCH, AUDIO_PROMPT), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    cd = getattr(torch, base.compute_dtype)

    def frames(n):
        return torch.randn(AUDIO_BATCH, n, base.d_model, device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(2)).to(cd)

    def wall_ms(fn, reps=5) -> list[float]:
        fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    def extra_for(cfg, batch):
        def extra(params) -> dict:
            with torch.inference_mode():
                p = api.prepare(params, cfg)
                _, caches = api.prefill_step(p, cfg, batch)
                caches = api.pad_caches(caches,
                                        AUDIO_PROMPT + AUDIO_NEW + 8)
                enc_out = caches["enc_out"]
                kv = caches["self"]

                def step():
                    api.decode_step(p, cfg, tokens[:, -1:], caches,
                                    AUDIO_PROMPT)

                layers = transformer._unstack(p["dec_blocks"])

                def projections():
                    for p_l in layers:
                        linear(p_l["xattn"]["wk"], enc_out)
                        linear(p_l["xattn"]["wv"], enc_out)

                proj, dec = wall_ms(projections), wall_ms(step)
                out = dict(
                    encoder_seq=cfg.encoder_seq,
                    encoder_layers=cfg.encoder_layers,
                    attn_impl=cfg.attn_impl,
                    cache_bytes=dict(
                        self_kv=sum(t.numel() * t.element_size()
                                    for t in kv.values()),
                        enc_out=enc_out.numel() * enc_out.element_size()),
                    decode_aten_ops=count_aten_ops(step),
                    xattn_kv_proj_ms=statistics.median(proj),
                    xattn_kv_proj_ms_all=proj,
                    decode_step_ms_same_window=statistics.median(dec))
                del p, caches, enc_out, kv
            return out
        return extra

    # [audio]: the published shape, the config's own chunked attention
    cfg = base
    batch = {"tokens": tokens, "enc_frames": frames(cfg.encoder_seq)}
    print("[audio] reduced: {} (all layers at the published widths, "
          f"{cfg.encoder_seq} frames)", flush=True)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
    fa.flash_attention.launches = 0
    try:
        with torch.inference_mode():
            api.prefill_step(params, dataclasses.replace(
                cfg, attn_impl="pallas"), batch)
        raised = None
    except ValueError as e:
        raised = str(e)
    want = (f"seq lens ({cfg.encoder_seq}, {cfg.encoder_seq}) not "
            "divisible by (256, 256)")
    print(f"[audio] pallas at {cfg.encoder_seq} frames raised: {raised!r} "
          f"launches={fa.flash_attention.launches}", flush=True)
    check(raised == want and fa.flash_attention.launches == 0,
          f"audio: pallas at {cfg.encoder_seq} frames gave {raised!r} "
          f"after {fa.flash_attention.launches} launches, expected "
          f"{want!r} before any")
    del params
    torch.cuda.empty_cache()
    serve_and_hold(dev, card, "audio", cfg, batch, AUDIO_NEW,
                   extra_for(cfg, batch), launches_expected=0,
                   f32_layers=cfg.n_layers)
    del batch
    torch.cuda.empty_cache()

    # [audio_kernel]: 1,280 frames through the flash kernel
    cfg = dataclasses.replace(base, encoder_seq=AUDIO_KERNEL_FRAMES,
                              attn_impl="pallas")
    batch = {"tokens": tokens, "enc_frames": frames(cfg.encoder_seq)}
    print("[audio_kernel] reduced: " +
          json.dumps(AUDIO_KERNEL_REDUCED, ensure_ascii=False), flush=True)
    launches, _ = serve_and_hold(
        dev, card, "audio_kernel", cfg, batch, AUDIO_NEW,
        extra_for(cfg, batch),
        launches_expected=cfg.encoder_layers + 2 * cfg.n_layers,
        f32_layers=cfg.n_layers)
    print(f"[audio] phase_wall_s={time.perf_counter() - t_phase}",
          flush=True)
    return launches


PIPE_ARCH = "mistral-nemo-12b"
PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS = 4, 8, 1024
# each stage's weight gradient against autograd over the four blocks in
# sequence: the same f32 products, summed over the microbatches in the
# same order; each leaf within 1e-4 of its largest element (the [train]
# exactness rule)
PIPE_GRAD_OF_MAX = 1e-4


def pipe_phase(dev, card: str) -> None:
    """``core.pipeline.pipeline_step`` on 4 logical devices of the card
    (a ``Mesh`` with axis ``"stage"``): each stage one f32
    Mistral-NeMo-12B block at full width through ``block_apply`` in
    train mode with chunked attention, M 8 microbatches of 1,024 tokens;
    the bodies run in the derived timetable's order, the hops and bytes
    are counted, and each stage's weight gradient is held against
    autograd over the four blocks in sequence.  No kernel of ``csrc/``
    runs here."""
    import dataclasses
    import torch
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (derive_pipeline_schedule,
                                           pipeline_step, schedule_table)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import transformer

    s_, m_, t_ = PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS
    cfg = dataclasses.replace(get_config(PIPE_ARCH), n_layers=s_,
                              compute_dtype="float32", attn_impl="chunked")
    params = transformer.tree(transformer.init_block(
        torch.Generator(device=dev).manual_seed(0), cfg, layers=s_,
        device=dev))
    n_params = sum(a.numel() for a in transformer.tree_leaves(params))
    micros = torch.randn(m_, t_, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    positions = torch.arange(t_, dtype=torch.int32, device=dev)[None]
    stage_of = {params["ln1"]["scale"][s].data_ptr(): s for s in range(s_)}
    order = []

    def block(w, x):
        return transformer.block_apply(w, x[None], cfg, positions,
                                       mode="train")[0][0]

    def stage_fwd(w, x):
        order.append(("F", stage_of.get(w["ln1"]["scale"].data_ptr())))
        return block(w, x)

    def stage_bwd(w, x, g):
        order.append(("B", stage_of.get(w["ln1"]["scale"].data_ptr())))
        wg = transformer.tree_map(lambda a: a.detach().requires_grad_(True),
                                  w)
        xg = x.detach().requires_grad_(True)
        leaves = transformer.tree_leaves(wg)
        with torch.enable_grad():
            gx, *gw = torch.autograd.grad(block(wg, xg), [xg] + leaves, g)
        by_leaf = {id(a): g for a, g in zip(leaves, gw)}
        return gx, transformer.tree_map(lambda a: by_leaf[id(a)], wg)

    devs = dist.logical_devices(s_, dev)
    mesh = dist.Mesh(devs, ("stage",))
    table = derive_pipeline_schedule(s_, m_)
    print("[pipe] timetable\n" + schedule_table(table), flush=True)
    # warm-up: one body of each kind on one microbatch
    w0 = transformer.tree_map(lambda a: a[0], params)
    stage_bwd(w0, micros[0], torch.ones_like(micros[0]))
    del w0
    order.clear()

    torch.cuda.synchronize()
    fa_before = fa.flash_attention.launches
    pipeline_step.hops = pipeline_step.hopped_bytes = 0
    t0 = time.perf_counter()
    dw = pipeline_step(stage_fwd, stage_bwd, params, micros, mesh=mesh,
                       stage_axis="stage", n_stages=s_)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hops, hopped = pipeline_step.hops, pipeline_step.hopped_bytes

    # the sequential model under autograd, summed over the microbatches
    seq = transformer.tree_map(lambda a: a.detach().requires_grad_(True),
                               params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in range(m_):
        h = micros[m]
        for s in range(s_):
            h = block(transformer.tree_map(lambda a: a[s], seq), h)
        h.sum().backward()
        del h
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    flat_dw = transformer.tree_leaves(dw)
    flat_seq = transformer.tree_leaves(seq)
    worst, smallest = 0.0, math.inf
    for got, want in zip(flat_dw, flat_seq):
        for s in range(s_):
            ref = want.grad[s]
            top = ref.abs().max().item()
            smallest = min(smallest, top)
            worst = max(worst, (got[s] - ref).abs().max().item() /
                        max(top, 1e-30))
    clocks = len(table)
    bubble = 1 - 2 * s_ * m_ / (s_ * clocks)
    want_order = [(t.kind, t.stage) for row in table for t in row if t]
    want_bytes = 2 * (s_ - 1) * m_ * t_ * cfg.d_model * 4
    # the blocks' products over every (stage, microbatch) body, forward
    # only; the step does 4 times that (each B recomputes its F), autograd
    # in sequence 3 times
    fwd_flop = 2 * n_params * t_ * m_
    print("[pipe] " + json.dumps(dict(
        card=card, arch=PIPE_ARCH, stages=s_, micro=m_, tokens=t_,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim], d_ff=cfg.d_ff,
        params_per_stage=n_params // s_, clocks=clocks, hops=hops,
        hopped_bytes=hopped, wall_ms=wall * 1e3, sequential_ms=seq_wall * 1e3,
        bubble_share=bubble, forward_product_tflop=fwd_flop / 1e12,
        step_tflop_per_s=4 * fwd_flop / wall / 1e12,
        sequential_tflop_per_s=3 * fwd_flop / seq_wall / 1e12,
        grad_err_of_max=worst,
        smallest_grad_leaf_max=smallest,
        flash_attention_launches=fa.flash_attention.launches - fa_before)),
        flush=True)
    del dw, seq, params, micros
    torch.cuda.empty_cache()
    check(clocks == 2 * m_ + 2 * (s_ - 1),
          f"pipe: {clocks} clocks, expected {2 * m_ + 2 * (s_ - 1)}")
    check(order == want_order,
          "pipe: the bodies did not run in the derived timetable's order")
    check(hops == 2 * (s_ - 1) * m_,
          f"pipe: {hops} hops, expected {2 * (s_ - 1) * m_}")
    check(hopped == want_bytes,
          f"pipe: {hopped} bytes hopped, expected {want_bytes}")
    check(smallest > 0, "pipe: a stage's weight gradient is all zero")
    check(worst <= PIPE_GRAD_OF_MAX,
          f"pipe: dW off autograd by {worst} of a leaf's largest")


TRAIN_ARCH = "mistral-nemo-12b"
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 4096          # the train_4k shape's length
TRAIN_TIMED = 5                           # after one warm-up step
TRAIN_REDUCED = {
    "n_layers": "40 -> 4 (f32 masters, gradients, mu and nu are 16 B a "
                "parameter: 2.433 B parameters ≈ 38.9 GB at 4 layers, plus "
                "≈ 3.5 GB of bf16 casts and ≈ 3 GB of logits chunks; 8 "
                "layers ≈ 56 GB before activations)",
    "global_batch": "256 -> 2 (the train_4k shape's batch, by memory)",
}
# the operators whose device ms each train line reports, every kernel
# launched inside one counted (trace_summary's ops_ms)
TRAIN_OPS = ("aten::slice_backward", "aten::select_backward", "aten::add",
             "aten::cat", "aten::stack")
# the recurrent families' train steps: full width, cut in depth to one
# sLSTM layer (xLSTM, every 8th) and one shared-block call (Zamba2, at
# layer 6 of every 6), bf16 compute over f32 masters, remat full
TRAIN_RECURRENT = {"xlstm-1.3b": dict(n_layers=8, batch=2, seq=2048),
                   "zamba2-1.2b": dict(n_layers=7, batch=2, seq=4096)}
TRAIN_RECURRENT_TIMED = 3                 # after one warm-up step
TRAIN_RECURRENT_REDUCED = {
    "n_layers": "xLSTM 48 -> 8 (one sLSTM layer: its loop over time is "
                "the family's own backward), Zamba2 38 -> 7 (one call of "
                "the shared block); the step time grows with depth",
    "global_batch": "256 -> 2 (as [train]); xLSTM's sequence 4,096 -> "
                    "2,048 (its sLSTM loop is host-bound, ~30 eager ops a "
                    "step, forward, recompute and backward)",
}
# configurations whose loss reaches no leaf of one part (the prefix)
TRAIN_UNREACHED = (("zamba2-1.2b", 2, "shared_"),
                   ("deepseek-v2-lite-16b", 1, "moe_blocks."))
# the exactness check at full width in f32: 2 layers, B 1 x S 1,024
EXACT_LAYERS, EXACT_SEQ = 2, 1024
# f32 against f32, the same operations summed in other orders (online
# softmax over key chunks against one softmax, chunked CE against one
# logsumexp): the loss within 1e-5 and the global norm within 1e-4
# relative, and each gradient leaf within 1e-4 of its largest element,
# the rule of the CPU parity tests (tests/test_torch_train.py)
EXACT_LOSS_RTOL, EXACT_GNORM_RTOL, EXACT_GRAD_OF_MAX = 1e-5, 1e-4, 1e-4


def plain_loss(params, cfg, tokens):
    """The next-token loss without the training path's devices: one
    logsumexp over the full-sequence (B, S, V) f32 logits, the reference's
    labels (shifted, the last 0) and mask (the last position out)."""
    import torch
    from repro_torch.models import api
    logits = api.forward_logits(params, cfg, {"tokens": tokens}).float()
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    mask = torch.ones(tokens.shape, device=tokens.device)
    mask[:, -1] = 0.0
    nll = torch.logsumexp(logits, -1) - \
        logits.gather(-1, labels[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum()


def train_exactness(dev) -> dict:
    """At full width in f32 (TF32 off, as ``main`` sets it): the training
    path (chunked attention, chunked CE, remat ``full`` and ``dots``)
    against the plain one (``impl="naive"``, full-sequence logits, no
    remat): loss, global gradient norm, the largest per-leaf gradient gap
    over the leaf's largest gradient, and the peak memory of each."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    base = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=EXACT_LAYERS,
                               compute_dtype="float32")
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             base, device=dev).requires_grad_(True)
    tokens = torch.randint(0, base.vocab_size, (1, EXACT_SEQ),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(2))
    runs = {"plain": dataclasses.replace(base, attn_impl="naive",
                                         remat=False),
            "full": dataclasses.replace(base, remat=True,
                                        remat_policy="full"),
            "dots": dataclasses.replace(base, remat=True,
                                        remat_policy="dots")}
    out, plain_grads = {}, None
    for name, cfg in runs.items():
        params.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = plain_loss(params, cfg, tokens) if name == "plain" else \
            api.loss_fn(params, cfg, {"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in params.named_parameters()}
        row = {"loss": loss.item(),
               "gnorm": torch.sqrt(sum((g.double() ** 2).sum()
                                       for g in grads.values())).item(),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if plain_grads is None:
            plain_grads = {n: g.clone() for n, g in grads.items()}
        else:
            row["grad_gap_of_max"] = max(
                ((g - plain_grads[n]).abs().max() /
                 plain_grads[n].abs().max()).item()
                for n, g in grads.items())
        out[name] = row
    del params, plain_grads, grads
    torch.cuda.empty_cache()
    for name in ("full", "dots"):
        row, want = out[name], out["plain"]
        row["loss_rel_gap"] = abs(row["loss"] - want["loss"]) / \
            abs(want["loss"])
        row["gnorm_rel_gap"] = abs(row["gnorm"] - want["gnorm"]) / \
            want["gnorm"]
    return out


def _same_state(a, b) -> bool:
    import torch
    from repro_torch.models.transformer import tree_leaves
    (pa, oa), (pb, ob) = a, b
    return int(oa.step) == int(ob.step) and all(
        torch.equal(x, y) for x, y in
        zip(list(pa.parameters()) + tree_leaves(oa.mu) + tree_leaves(oa.nu),
            list(pb.parameters()) + tree_leaves(ob.mu) + tree_leaves(ob.nu)))


def train_small(dev) -> dict:
    """The loss falls at ``examples/train_lm.py``'s settings; a run
    stopped at step 6, checkpointed and resumed to 12 equals the straight
    run to 12 bit for bit, under deterministic algorithms."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("qwen1.5-4b").reduced(d_model=256, n_layers=4,
                                           d_ff=512, vocab_size=2048)
    _, _, hist = train.train_loop(cfg, steps=60, seq_len=128,
                                  global_batch=8, log_every=59,
                                  peak_lr=1e-3, device=dev)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    check(last < first - 0.5,
          f"train: loss {first} -> {last}, not below the first - 0.5")

    # tests/test_integration.py::_tiny_cfg, as the reference's restart test
    tiny = get_config("qwen1.5-4b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512)
    kw = dict(seq_len=32, global_batch=4, log_every=1000, peak_lr=1e-3,
              device=dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    # deterministic cuBLAS products need this setting; it is set only
    # around the check: set before the first product it changes cuBLAS's
    # choices in every phase (the [llm] decode steps ran slower with it)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        straight = train.train_loop(tiny, steps=12, **kw)[:2]
        with tempfile.TemporaryDirectory(dir=build) as ck:
            train.train_loop(tiny, steps=6, ckpt_dir=ck, ckpt_every=1000,
                             **kw)
            resumed = train.train_loop(tiny, steps=12, ckpt_dir=ck,
                                       ckpt_every=1000, **kw)[:2]
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    same = _same_state(straight, resumed)
    check(same, "train: the resumed run differs from the straight run")
    return {"loss_first": first, "loss_last": last,
            "resume_bitwise": same, "unreached": train_unreached(dev)}


def train_unreached(dev) -> dict:
    """Three steps (peak lr 1e-2, warm-up 1) of each ``TRAIN_UNREACHED``
    configuration at ``reduced()``, B 2 x S 64: finite, and each leaf the
    loss does not reach has moments of 0 and equals its initial value
    decayed step by step, ``p - (p * 0.1) * lr``, bit for bit (1-D
    leaves unchanged), as the reference's zero gradient leaves it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw_init

    out = {}
    for arch, n_layers, prefix in TRAIN_UNREACHED:
        cfg = get_config(arch).reduced(n_layers=n_layers)
        params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        want = {n: p.detach().clone() for n, p in params.named_parameters()
                if n.startswith(prefix)}
        opt = adamw_init(params)
        step = train.build_train_step(cfg, peak_lr=1e-2, warmup=1,
                                      total_steps=10)
        data = SyntheticTokens(cfg.vocab_size, 64, 2, seed=0)
        losses = []
        for k in range(3):
            batch = {"tokens": data.batch_at(k)["tokens"].to(dev)}
            params, opt, m = step(params, opt, batch, k)
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]) and math.isfinite(
                float(m["gnorm"])), f"train {arch}: a loss or gnorm is "
                "not finite")
            for w in want.values():
                if w.ndim >= 2:
                    w.sub_((w * 0.1) * m["lr"])
        got = dict(params.named_parameters())
        mu, nu = _flat_tree(opt.mu), _flat_tree(opt.nu)
        exact = all(torch.equal(got[n].detach(), w) and
                    not mu[n].any() and not nu[n].any()
                    for n, w in want.items())
        check(bool(want) and exact, f"train {arch} at {n_layers} layers: an "
              "unreached leaf moved otherwise than by the decay")
        out[f"{arch}/{n_layers}"] = {"loss": losses, "unreached_leaves":
                                     len(want), "decayed_exactly": exact}
    return out


def train_recurrent(dev, card: str) -> None:
    """One ``[train_recurrent]`` line for each ``TRAIN_RECURRENT`` arch:
    ``build_train_step`` at full width, one warm-up and
    ``TRAIN_RECURRENT_TIMED`` timed steps (the median), the peak memory,
    and a profiled step's idle share, top operators and ``TRAIN_OPS``."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw_init

    print("[train_recurrent] reduced: " + json.dumps(
        TRAIN_RECURRENT_REDUCED, ensure_ascii=False), flush=True)
    for arch, shape in TRAIN_RECURRENT.items():
        cfg = dataclasses.replace(
            get_config(arch), n_layers=shape["n_layers"],
            compute_dtype="bfloat16", attn_impl="chunked", remat=True,
            remat_policy="full")
        params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        n_params = api.count_params(params)
        opt = adamw_init(params)
        data = SyntheticTokens(cfg.vocab_size, shape["seq"], shape["batch"],
                               seed=0)
        step_fn = train.build_train_step(cfg)

        def run(step):
            batch = {"tokens": data.batch_at(step)["tokens"].to(dev)}
            return step_fn(params, opt, batch, step)[2]

        run(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], []
        for step in range(1, TRAIN_RECURRENT_TIMED + 1):
            t0 = time.perf_counter()
            m = run(step)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("train/recurrent_step"):
                run(TRAIN_RECURRENT_TIMED + 1)
                torch.cuda.synchronize()
        t = trace_summary(prof, "train/recurrent_step", top_n=8,
                          ops=TRAIN_OPS)
        del params, opt, prof
        torch.cuda.empty_cache()
        print("[train_recurrent] " + json.dumps(dict(
            card=card, arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
            compute_dtype=cfg.compute_dtype, remat=cfg.remat_policy,
            batch=shape["batch"], seq=shape["seq"], params=n_params,
            step_ms=statistics.median(ms), step_ms_all=ms,
            peak_memory_bytes=peak, idle_share=t["idle"],
            device_busy_ms=t["busy_ms"],
            loss=[m["loss"] for m in metrics],
            gnorm=[m["gnorm"] for m in metrics],
            ops_ms=t["ops_ms"],
            top_ops_ms=[[name[:40], ms_, n] for name, ms_, n in t["top"]])),
            flush=True)
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["gnorm"])
                  and m["gnorm"] > 0 for m in metrics),
              f"train {arch}: a loss or gnorm is not finite, or a gnorm is 0")


def train_phase(dev, card: str) -> None:
    """Main path 4: ``launch.train.build_train_step`` with Mistral-NeMo-12B
    at full width (4 layers), bf16 compute over f32 masters, chunked
    attention, remat ``full``, and the recurrent families' steps; then
    the f32 exactness check and the small runs."""
    train_step(dev, card)
    train_recurrent(dev, card)
    exact = train_exactness(dev)
    small = train_small(dev)
    print("[train] " + json.dumps(dict(exactness=exact, small=small,
                                       tolerances=dict(
                                           loss_rtol=EXACT_LOSS_RTOL,
                                           gnorm_rtol=EXACT_GNORM_RTOL,
                                           grad_gap_of_max=EXACT_GRAD_OF_MAX)
                                       )), flush=True)
    for name in ("full", "dots"):
        row = exact[name]
        check(row["loss_rel_gap"] <= EXACT_LOSS_RTOL,
              f"train f32 {name}: loss gap {row['loss_rel_gap']}")
        check(row["gnorm_rel_gap"] <= EXACT_GNORM_RTOL,
              f"train f32 {name}: gnorm gap {row['gnorm_rel_gap']}")
        check(row["grad_gap_of_max"] <= EXACT_GRAD_OF_MAX,
              f"train f32 {name}: gradient gap {row['grad_gap_of_max']} of "
              "the leaf's largest")


def train_step(dev, card: str) -> None:
    """The ``[train]`` step: Mistral-NeMo-12B at full width (4 layers),
    one warm-up and ``TRAIN_TIMED`` timed steps, a profiled one."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw_init, cosine_schedule

    print(f"[train] reduced: {json.dumps(TRAIN_REDUCED, ensure_ascii=False)}",
          flush=True)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              compute_dtype="bfloat16", attn_impl="chunked",
                              remat=True, remat_policy="full")
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    n_params = api.count_params(params)
    n_embed = params.embed.table.numel()
    opt = adamw_init(params)
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    kw = dict(peak_lr=3e-4, warmup=100, total_steps=10_000)
    step_fn = train.build_train_step(cfg, **kw)

    def run(step):
        batch = {"tokens": data.batch_at(step)["tokens"].to(dev)}
        return step_fn(params, opt, batch, step)[2]

    run(0)                                         # warm-up; lr(0) = 0
    torch.cuda.synchronize()
    before = [p.detach().to("cpu", copy=True) for p in params.parameters()]
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for step in range(1, TRAIN_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    unchanged = [n for (n, p), b in zip(params.named_parameters(), before)
                 if torch.equal(p.detach().cpu(), b)]
    del before
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("train/step"):
            run(TRAIN_TIMED + 1)
            torch.cuda.synchronize()
    t = trace_summary(prof, "train/step", top_n=12, ops=TRAIN_OPS)
    idle, busy_ms, window_s = t["idle"], t["busy_ms"], t["window_s"]
    del params, opt, prof
    torch.cuda.empty_cache()

    step_ms = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * (n_params - n_embed) * tokens + \
        6 * cfg.n_layers * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * \
        cfg.head_dim
    tflops = flops / (step_ms / 1e3) / 1e12
    lrs = [float(cosine_schedule(s, peak_lr=kw["peak_lr"],
                                 warmup_steps=kw["warmup"],
                                 total_steps=kw["total_steps"]))
           for s in range(1, TRAIN_TIMED + 1)]
    print("[train] " + json.dumps(dict(
        card=card, arch=TRAIN_ARCH, n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim],
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl, remat=cfg.remat_policy, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, params=n_params, params_less_embedding=n_params -
        n_embed, step_ms=step_ms, step_ms_all=ms,
        tok_per_s=tokens / (step_ms / 1e3), peak_memory_bytes=peak,
        model_tflop_per_step=flops / 1e12, model_tflops=tflops,
        share_of_989=tflops / 989.0, profiled_window_s=window_s,
        device_busy_ms=busy_ms, idle_share=idle,
        idle_share_of_timed_step=None if busy_ms is None else
        1.0 - busy_ms / step_ms,
        loss=[m["loss"] for m in metrics],
        gnorm=[m["gnorm"] for m in metrics], lr=[m["lr"] for m in metrics],
        ops_ms=t["ops_ms"],
        top_ops_ms=[[name[:40], ms, n] for name, ms, n in t["top"]],
        top_kernels_ms=[[name[:70], ms, n]
                        for name, ms, n in t["top_kernels"]])),
        flush=True)
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["gnorm"])
              for m in metrics), "train: a loss or gnorm is not finite")
    check(all(m["gnorm"] > 0 for m in metrics), "train: a gnorm is 0")
    check(not unchanged, f"train: leaves unchanged by 5 steps: {unchanged}")
    check([m["lr"] for m in metrics] == lrs,
          f"train: lr {[m['lr'] for m in metrics]} != cosine_schedule's "
          f"{lrs}")


PARITY_SIZES = {
    "black_scholes": dict(n_options=8192, task_options=512),
    "matmul": dict(n=256, tile=64),
    "fft": dict(n=128, row_block=32, tile=32),
    "jacobi": dict(n=512, tile=128, iters=2),
    "cholesky": dict(n=512, tile=128),
}
PARITY_TOL = {"black_scholes": (1e-5, 1e-3), "matmul": (2e-4, 2e-4),
              "fft": (2e-2, 2e-1), "jacobi": (1e-5, 1e-5),
              "cholesky": (2e-2, 2e-2)}


def parity_phase(dev) -> None:
    """Sequential vs staged with the wave kernels and vs host, small
    sizes, on the card."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps

    for name, size in PARITY_SIZES.items():
        outs = {}
        for executor, backend in (("sequential", "xla"),
                                  ("staged", "pallas"), ("host", "xla")):
            rt = TaskRuntime(RuntimeConfig(
                executor=executor, kernel_backend=backend,
                device=str(dev)))
            try:
                out = apps.APPS[name](rt, **size)
                rt.barrier()
            finally:
                rt.shutdown()
            outs[executor] = [a.gather() for a in
                              (out if isinstance(out, tuple) else (out,))]
        rtol, atol = PARITY_TOL[name]
        for executor in ("staged", "host"):
            worst = 0.0
            for s, g in zip(outs["sequential"], outs[executor]):
                if name == "cholesky":
                    s, g = torch.tril(s), torch.tril(g)
                worst = max(worst, (s - g).abs().max().item())
                check(bool(torch.allclose(g, s, rtol=rtol, atol=atol)),
                      f"parity {name}: {executor} differs from sequential")
            print(f"[parity] {name} {size} {executor}: "
                  f"max_abs_diff={worst} ok", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    sass = {f"{source}:{function}": _build.sass_counts(source, function,
                                                       patterns)
            for source, kernels in sorted(_build.TENSOR_CORE_SASS.items())
            for function, patterns in kernels.items()}
    print(f"[sass] {json.dumps(sass)}", flush=True)
    check(all(n > 0 for counts in sass.values() for n in counts.values()),
          f"a tensor-core kernel lacks its instructions: {sass}")
    ptxas_phase()

    kernels = kernel_phase(dev)
    launches, central = app_phase(dev)
    launches["flash_decode"] = serve_phase(dev)
    launches["flash_attention"] = llm_phase(dev, card)
    torch.cuda.empty_cache()
    moe_launches, granite = moe_phase(dev, card)
    torch.cuda.empty_cache()
    mesh_launches, mesh_train_row = mesh_phase(dev, card, granite)
    torch.cuda.empty_cache()
    dryrun_phase(dev, card, mesh_train_row)
    torch.cuda.empty_cache()
    vlm_launches = vlm_phase(dev, card)
    torch.cuda.empty_cache()
    hybrid_launches = recurrent_phase(dev, card, "hybrid", HYBRID_ARCH)
    torch.cuda.empty_cache()
    ssm_launches = recurrent_phase(dev, card, "ssm", SSM_ARCH)
    torch.cuda.empty_cache()
    audio_launches = audio_phase(dev, card)
    torch.cuda.empty_cache()
    pipe_phase(dev, card)
    torch.cuda.empty_cache()
    train_phase(dev, card)
    by_path = {"depman": depman_phase(dev, central),
               "sharded": sharded_phase(dev, central),
               "fuzz": {"matmul_batched": fuzz_phase(dev)},
               "moe": {"flash_attention": moe_launches},
               "mesh": {"flash_attention": mesh_launches},
               "vlm": {"flash_attention": vlm_launches},
               "hybrid": {"flash_attention": hybrid_launches},
               "ssm": {"flash_attention": ssm_launches},
               "audio": {"flash_attention": audio_launches}}
    sim_phase(dev, central)
    obs_phase(dev)
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {
            path: n[row["name"]] for path, n in by_path.items()
            if row["name"] in n}
    parity_phase(dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
