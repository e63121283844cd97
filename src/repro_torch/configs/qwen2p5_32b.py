"""qwen2.5-32b [dense] — GQA with QKV bias.

64L d=5120 40H (GQA kv=8) d_ff=27648 vocab 152064.  [hf:Qwen/Qwen2.5-*]
Query heads pad 40→48 for TP=16 head parallelism (waste surfaces in the
MODEL_FLOPS/HLO ratio).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
)
