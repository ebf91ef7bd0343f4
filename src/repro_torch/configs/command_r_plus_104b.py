"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
