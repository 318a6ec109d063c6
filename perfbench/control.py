"""The readings that set a cell's limits, on the card at the cell's own
size: the program's numbers over many seeds (the lower readings), the
control's (the plain reference computed with fp8 products in the
program's place, the upper readings), and for a training cell the fault
of half the batch left out, the mean taken over the rest.

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out chiprun_out/control-<name>.jsonl]

One JSON line a seed on standard output (and in ``--out``).  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def half_batch():
    """The program's loss over the first half of each batch's rows."""
    from repro_torch.models import api
    orig = api.loss_fn

    def loss_fn(params, cfg, batch):
        t = batch["tokens"]
        return orig(params, cfg, {**batch, "tokens": t[:t.shape[0] // 2]})
    return api, orig, loss_fn


def train_seed(c: dict, control: bool) -> dict:
    from perfbench import common
    from perfbench.kinds import train
    n = c["traffic"]["check_steps"]
    drop = c["cell"]["drop_leaves_below"]
    state, prog = train.program_steps(c, n)
    del state
    common.free(c["device"])
    ref = train.reference_steps(c, n)
    out = {"program": train.compare(prog, ref, drop), "loss": ref["loss"]}
    if control:
        ctl = train.reference_steps(c, n, precision="fp8")
        out["control_fp8"] = train.compare(ctl, ref, drop)
        api, orig, fault = half_batch()
        api.loss_fn = fault
        try:
            state, half = train.program_steps(c, n)
        finally:
            api.loss_fn = orig
        del state
        common.free(c["device"])
        out["fault_half_batch"] = train.compare(half, ref, drop)
    return out


def serve_seed(c: dict, control: bool) -> dict:
    import torch
    from perfbench import common, program
    from perfbench.kinds import serve
    from perfbench.reference import model as ref_model
    cfg = program.model_config(c["config"], "serve")
    params = program.decoder(cfg, c["config"], c["seed"], c["device"])
    batches = []
    with serve.Hooks(c["device"], timed=False) as hooks:
        for k in range(len(c["traffic"]["prompt_lengths"])):
            batches.append(serve.serve_batch(c, cfg, params,
                                             serve.prompts(c, k), hooks))
    del params
    common.free(c["device"])
    picks = serve.check_sample(c, batches)
    out = {"program": serve.served_gaps(c, batches, picks,
                                        ref_model.Arith("f32"))}
    if control:
        out["control_fp8"] = serve.served_gaps(
            c, batches, picks, ref_model.Arith("fp8"),
            tokens_of=lambda lg: torch.argmax(lg, -1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for path in (REPO / "src", REPO):
        sys.path.insert(0, str(path))
    import torch
    from perfbench import common
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.cell_of(common.manifest(), args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = {"config": cell["config"], "traffic": cell["traffic"],
             "cell": cell["cell"], "seed": s, "device": torch.device("cuda", 0),
             "t_start": t0}
        fn = train_seed if cell["traffic"]["kind"] == "train" else serve_seed
        row = {"workload": args.workload, "seed": s, **fn(c, s in ctl),
               "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
