"""xlstm-125m [arXiv:2405.04517] — sLSTM + mLSTM block stack.

12L d_model=768 4H d_ff=0 (no FFN; the mLSTM block carries its own
up/down projection) vocab=50304. Every 4th layer mixes in the sLSTM cell
(a per-layer flag blends the two cells of each block). Recurrent state is
O(1) per token.
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
