"""granite-moe-1b-a400m [moe] — IBM Granite 3.0 1B-A400M base.

24L d=1024 16H (GQA kv=8) per-expert d_ff=512, vocab 49155, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=0,
    vocab_size=49155, head_dim=64, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512),
)
