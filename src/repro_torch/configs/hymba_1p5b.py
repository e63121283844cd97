"""hymba-1.5b [hybrid] — parallel attention ∥ Mamba heads per layer.

32L d=1600 25H (GQA kv=5) d_ff=5504 vocab 32001, ssm_state=16.  SWA (1024)
everywhere except 3 global layers (first/middle/last).  [arXiv:2411.13676]
SSM head_dim set to 50 (64 heads) so heads divide TP=16 without padding;
query heads pad 25→32 for head-parallel prefill (see DESIGN §4).
Meta-tokens are out of scope (stub note in DESIGN).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64, parallel_hybrid=True,
    attn_layout="hymba_3global", window=1024, sub_quadratic=True,
    ssm=SSMConfig(d_state=16, headdim=50, expand=2),
)
