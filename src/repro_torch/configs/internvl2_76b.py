"""internvl2-76b [vlm] — InternViT frontend (stub) + 80L LLM backbone.

80L d=8192 64H (GQA kv=8) d_ff=28672 vocab 128256.  The ViT frontend is a
STUB: input_specs supplies 256 precomputed patch embeddings that replace
the first 256 token positions.  [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128, frontend="vision_stub",
    n_frontend_tokens=256, rope_theta=5e5,
)
