"""qwen1.5-1.8b-chat — paper's transformer-only model (benchmark suite)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5504,
    vocab_size=151936, head_dim=128, qkv_bias=True,
)
