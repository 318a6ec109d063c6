"""The system under test, as the harness sets it up: the program's model
configuration built from a configuration file, and its parameter tree
with the weights the harness draws from the seed.  This is the only
module besides the kinds' drivers that imports the program."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Decoder

from . import common


def model_config(conf: dict, mode: str) -> ModelConfig:
    """The program's ``ModelConfig`` for ``mode`` (``"train"`` or
    ``"serve"``): each field of ``program.fields`` read from the file's
    key it names, then ``program.settings`` and ``program.<mode>``."""
    prog = conf["program"]
    kw = {field: conf[key] for field, key in prog["fields"].items()}
    kw.update(prog["settings"])
    kw.update(prog.get(mode, {}))
    return ModelConfig(**kw)


def decoder(cfg: ModelConfig, conf: dict, seed: int, device) -> Decoder:
    """The program's parameter tree on ``device``, every weight drawn by
    name from the seed (``common.draw_into``)."""
    dec = Decoder(cfg, device=device)
    common.draw_into(dict(dec.named_parameters()), conf, seed)
    return dec
