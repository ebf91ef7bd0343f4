"""deepseek-v2-236b [arXiv:2405.04434] — MoE with Multi-head Latent Attention.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; MLA kv_lora=512;
2 shared + 160 routed experts, top-6. ``attention_window`` stays None:
at long_500k ``launch.shapes.shape_variant`` keeps full attention over the
compressed MLA latent cache, context-parallel over ``data``, where the
dense configs switch to a sliding window.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434",
)
