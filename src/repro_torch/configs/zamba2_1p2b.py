"""zamba2-1.2b-instruct — paper's hybrid model #2 (benchmark suite).

Mamba2 backbone with shared attention blocks; modeled here as an SSM-heavy
hybrid for traffic/CR purposes (see jamba_tiny.py note).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=26, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=32000, head_dim=128, parallel_hybrid=True, sub_quadratic=True,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2),
)
