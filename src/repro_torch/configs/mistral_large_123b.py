"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407] — dense GQA.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
