"""ModelConfig: one dataclass covering all assigned architecture families,
plus the assigned input-shape suite."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # block structure
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu | relu2
    qkv_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False    # command-r: attn & ffn share the norm
    norm_eps: float = 1e-5

    # positions
    rope_type: str = "rope"         # rope | mrope | sinusoidal | none
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()

    # attention impl knobs
    attn_impl: str = "chunked"
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_dense: int = 0            # leading dense layers (deepseek: 1)
    first_dense_ff: int = 0         # their FFN width
    moe_renorm: bool = True
    moe_capacity_factor: float = 1.25
    moe_impl: str = "ep"            # ep | ref

    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid (zamba2)
    ssm_d_inner: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0             # zamba2: shared attn block period

    # xLSTM
    xlstm_d_inner: int = 0
    xlstm_d_conv: int = 4
    xlstm_chunk: int = 256
    slstm_every: int = 0            # every k-th block is sLSTM

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # VLM stub
    vision_seq: int = 0

    # numerics / staging
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    logit_softcap: float = 0.0
    embed_scale: bool = False       # whisper/gemma style sqrt(d) scaling

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, 128)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling of this config (same family/topology,
        tiny dims).  Used by per-arch smoke tests on CPU."""
        small = dict(
            n_layers=min(self.n_layers, 4) if not self.attn_every
            else min(self.n_layers, 2 * self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                  // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=512,
        )
        if self.moe:
            # capacity_factor = n_experts -> provably drop-free, so smoke
            # tests can assert exact prefill/decode vs forward equivalence
            small.update(n_experts=min(self.n_experts, 8),
                         top_k=min(self.top_k, 2), d_expert=64,
                         first_dense_ff=min(self.first_dense_ff, 256),
                         moe_capacity_factor=8.0)
        if self.mla:
            small.update(kv_lora_rank=32, rope_head_dim=16,
                         nope_head_dim=32, v_head_dim=32)
        if self.ssm_d_inner:
            small.update(ssm_d_inner=256, ssm_state=16, ssm_heads=8,
                         ssm_chunk=16)
        if self.xlstm_d_inner:
            small.update(xlstm_d_inner=256, xlstm_chunk=16)
        if self.is_encoder_decoder:
            small.update(encoder_layers=2, encoder_seq=64)
        if self.vision_seq:
            small.update(vision_seq=16)
        if self.mrope_sections:
            small.update(mrope_sections=(4, 6, 6))
        # CPU-friendly numerics for smoke tests
        small.update(compute_dtype="float32", attn_q_chunk=64,
                     attn_k_chunk=64)
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assignment's skip rules: long_500k only for sub-quadratic
    families; decode shapes for anything with a decoder (all 10 archs)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
