"""Config system: ModelConfig (architecture), ShapeConfig (workload),
MeshConfig (distribution), RunConfig (composition + CLI overrides)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    norm: str = "rms"      # rms | layernorm | nonparametric
    act: str = "silu"      # silu (SwiGLU) | gelu
    rope_theta: float = 1e4
    use_rope: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    topk_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    ssm_chunk: int = 128
    # hybrid (Zamba2): one shared attention block applied every ``attn_every``
    attn_every: int = 0
    # enc-dec (Whisper)
    n_enc_layers: int = 0
    enc_ctx: int = 0        # encoder frames (audio stub length)
    max_target_positions: int = 0  # bounded decoder (whisper: 448 by family)
    # VLM stub
    n_vision_tokens: int = 0
    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes from the source config
    source: str = ""

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        attn = qkv + self.n_heads * self.d_head * d
        mlp_mult = 3 if self.act == "silu" else 2
        if self.family == "moe":
            mlp = self.n_experts * mlp_mult * d * ff + d * self.n_experts
        else:
            mlp = mlp_mult * d * ff
        if self.family == "ssm":
            blk = self._ssm_block_params()
            return emb + L * blk
        if self.family == "hybrid":
            blk = self._ssm_block_params()
            shared = attn * 4 + mlp_mult * d * ff  # concat(2d) shared block
            return emb + L * blk + shared
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp)
            dec = L * (2 * attn + mlp)  # self + cross
            return emb // 2 + enc + dec + self.enc_ctx * d  # tied emb + pos
        return emb + L * (attn + mlp)

    def _ssm_block_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.n_ssm_heads
        in_proj = d * (2 * di + 2 * N + H)
        conv = (di + 2 * N) * self.conv_kernel
        out = di * d
        return in_proj + conv + out + 2 * H + di  # A_log, D, norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6·N_active·D."""
        if self.family != "moe":
            return self.param_count()
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        attn = qkv + self.n_heads * self.d_head * d
        mlp_mult = 3 if self.act == "silu" else 2
        mlp = self.topk_experts * mlp_mult * d * ff + d * self.n_experts
        return emb + L * (attn + mlp)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode
    # decode shapes: cache holds ``seq_len`` tokens, one new token is decoded


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")
    # which mesh axes shard what
    batch_axes: tuple[str, ...] = ("data",)       # + 'pod' prepended if present
    tensor_axis: str = "model"
    fsdp_axes: tuple[str, ...] = ()               # param/optimizer sharding (ZeRO)
    seq_axes_decode: tuple[str, ...] = ("model",)  # KV-cache sequence sharding


@dataclasses.dataclass(frozen=True)
class PolicyDefaults:
    kind: str = "fier"
    budget: int = 4096
    group: int = 32
    page: int = 16
    skip_layers: int = 2


def pad_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    return pad_to(cfg.vocab, multiple)
