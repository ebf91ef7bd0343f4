"""Architecture configuration dataclasses for the model zoo (counterpart of
``repro.models.config``).

One :class:`ModelConfig` describes any of the 10 assigned architectures
(dense / moe / vlm / hybrid / ssm / audio). Family-specific sub-configs are
optional fields; ``family`` selects the block implementation. Plain data, as
in the reference; only :attr:`ModelConfig.activation_dtype` differs, giving a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention [arXiv:2405.04434]."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hymba's parallel heads)."""
    state_dim: int = 16
    expand: int = 2
    conv_kernel: int = 4
    dt_rank: Optional[int] = None  # default d_model // 16


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack [arXiv:2405.04517]: mLSTM with periodic sLSTM."""
    slstm_every: int = 4  # every k-th layer mixes in the sLSTM cell
    proj_factor: float = 2.0  # up-projection factor of the mLSTM block


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (seamless-m4t: speech encoder + text decoder)."""
    enc_layers: int = 24
    dec_layers: int = 24


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """VLM frontend stub (InternVL2): ViT+projector are NOT implemented; the
    input pipeline provides patch embeddings (B, num_patches, d_model)."""
    num_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attention_window: Optional[int] = None  # sliding window; None = full
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"
    # the reference's training knobs: per-layer remat (torch.utils.checkpoint
    # here), the long-sequence attention's kv-step remat and custom VJP
    # (flash_mha vs chunked_attend); remat_group and unroll_layers are kept
    # so configs carry over and are read by nothing in the port
    remat: bool = True
    attn_remat_inner: bool = True
    attn_custom_vjp: bool = True
    remat_group: int = 1
    unroll_layers: bool = False
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, num_layers: int = 2, d_model: int = 256, **kw) -> "ModelConfig":
        """Smoke-test variant of the SAME family (2 layers, d_model<=512,
        <=4 experts), preserving structural traits (GQA ratio, MoE, MLA, ...)."""
        if d_model > 512:
            raise ValueError(f"reduced d_model {d_model} > 512")
        heads = max(2, min(self.num_heads, d_model // 64))
        # preserve a GQA ratio if the full config has one
        ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
        kv = max(1, heads // ratio) if ratio > 1 else heads
        while heads % kv != 0:
            kv -= 1
        changes = dict(
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else max(4 * d_model, 64),
            vocab_size=512,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                d_ff_expert=d_model,
                num_shared=min(1, self.moe.num_shared),
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=64, q_lora_rank=96, rope_head_dim=32,
                nope_head_dim=d_model // heads, v_head_dim=d_model // heads,
            )
        if self.encdec is not None:
            changes["encdec"] = EncDecConfig(enc_layers=num_layers, dec_layers=num_layers)
        if self.attention_window is not None:
            changes["attention_window"] = 32
        changes.update(kw)
        return dataclasses.replace(self, **changes)
