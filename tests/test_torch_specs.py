"""repro_torch's input stand-ins (``configs.input_specs``,
``data.make_batch_specs``) against the JAX package's, on the CPU.

The reference gives ``jax.ShapeDtypeStruct`` leaves; the port gives
tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing.  Every cell of the ten architectures (32: three shapes
each, and ``long_500k`` for the two sub-quadratic families) must give
the reference's leaves, shape and dtype, in the reference's pytree
order: the batch with its modality stubs (Qwen2-VL's ``vision_embeds``,
whisper's ``enc_frames``) and every family's decode caches.
"""
import jax
import pytest
import torch

import repro.configs as ref_configs
import repro.data as ref_data
from repro_torch import configs, data

CELLS = [(arch, shape) for arch in configs.ARCH_IDS
         for shape in configs.applicable_shapes(configs.get_config(arch))]


def _leaves(t):
    """Leaves in the reference's pytree order (dict keys sorted, lists and
    tuples in order)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _same_leaves(got, want):
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert isinstance(a, torch.Tensor) and a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


def test_the_cells_are_the_references_32():
    assert len(CELLS) == 32
    assert CELLS == [(a, s) for a in ref_configs.ARCH_IDS
                     for s in ref_configs.applicable_shapes(
                         ref_configs.get_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    got = configs.input_specs(configs.get_config(arch), shape)
    want = ref_configs.input_specs(ref_configs.get_config(arch), shape)
    assert set(got) == set(want)
    if "batch" in got:
        assert set(got["batch"]) == set(want["batch"])
    else:
        assert set(got) == {"token", "caches", "pos"}
    _same_leaves(got, want)


def test_whisper_specs_carry_the_frames_and_the_encoder_output():
    cfg = configs.get_config("whisper-tiny")
    batch = configs.input_specs(cfg, "prefill_32k")["batch"]
    assert tuple(batch["enc_frames"].shape) == (32, 1500, 384)
    assert batch["enc_frames"].dtype == torch.bfloat16
    caches = configs.input_specs(cfg, "decode_32k")["caches"]
    assert tuple(caches["enc_out"].shape) == (128, 1500, 384)
    assert tuple(caches["self"]["k"].shape) == (4, 128, 6, 32768, 64)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_make_batch_specs_matches_reference(arch):
    got = data.make_batch_specs(configs.get_config(arch), 96, 3)
    want = ref_data.make_batch_specs(ref_configs.get_config(arch), 96, 3)
    assert set(got) == set(want)
    _same_leaves(got, want)
