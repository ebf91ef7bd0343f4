"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct] — 16-expert MoE.

32L d_model=4096 32H (GQA kv=8) d_ff(expert)=6400 vocab=32064, top-2 routing,
no shared experts, standard GQA attention (no MLA).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, num_shared=0),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
