"""qwen3-4b [dense] — qk-norm GQA.

36L d=2560 32H (GQA kv=8) d_ff=9728 vocab 151936.  [hf:Qwen/Qwen3-*]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)
