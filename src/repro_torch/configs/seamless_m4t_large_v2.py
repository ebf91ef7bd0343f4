"""seamless-m4t-large-v2 [arXiv:2308.11596] — encoder-decoder, multimodal.

24L (split 24 enc + 24 dec per the model card's w2v-BERT encoder + text
decoder) d_model=1024 16H kv=16 d_ff=8192 vocab=256206. The mel+conv speech
frontend is stubbed: the source is frame embeddings (B, src_len, d_model)
(``models.encdec.source_embeds``).
"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    encdec=EncDecConfig(enc_layers=24, dec_layers=24),
    source="arXiv:2308.11596",
)
