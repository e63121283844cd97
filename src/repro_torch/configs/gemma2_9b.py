"""gemma2-9b [dense] — alternating local/global attention, logit softcaps.

42L d=3584 16H (GQA kv=8) d_ff=14336 vocab 256000, head_dim=256, window
4096 on even layers, attn softcap 50, final softcap 30, sandwich norms,
sqrt(d) embedding scaling, tied embeddings.  [arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab_size=256000, head_dim=256, attn_layout="alternating_local",
    window=4096, attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    scale_embeddings=True, tie_embeddings=True,
)
