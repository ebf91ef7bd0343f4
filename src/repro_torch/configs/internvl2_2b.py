"""internvl2-2b [arXiv:2404.16821] — VLM: InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The ViT/projector
frontend is stubbed: the caller provides patch embeddings
(B, 256, d_model); we implement the language decoder that consumes them.
"""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    vlm=VLMConfig(num_patches=256),
    source="arXiv:2404.16821",
)
