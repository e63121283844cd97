"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone.

24L enc + 24L dec, d=1024 16H (kv=16) d_ff=8192 vocab 256206.  The speech
frontend is a STUB per task instructions: input_specs supplies precomputed
frame embeddings (B, S, D) to the encoder.  [arXiv:2308.11596]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206, head_dim=64, encdec=True, frontend="audio_stub",
)
