"""hymba-1.5b [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba's attention is sliding-window in most layers (its own design); it is
modelled with window=1024.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    attention_window=1024,
    ssm=SSMConfig(state_dim=16, expand=2, conv_kernel=4),
    source="arXiv:2411.13676",
)
