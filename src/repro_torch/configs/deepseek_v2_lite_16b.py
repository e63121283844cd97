"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE.

27L d=2048 16H MLA (kv_lora=512, rope 64, nope 128, v 128), per-expert
d_ff=1408, vocab 102400, 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434]  Note: the pool line says "MoE 64e top-6" with a
"160 routed" aside that matches full V2, not Lite; we follow the primary
spec (64 routed).  V2-Lite's dense first layer is simplified to MoE-everywhere.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=102400, head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
)
