"""mamba2-370m [ssm] — attention-free SSD (state-space duality).

48L d=1024, d_state=128, headdim=64 (32 heads at expand=2), vocab 50280.
[arXiv:2405.21060]  No KV cache exists; LEXI's cache path applies to the
SSM *state* cache instead (DESIGN §4 applicability note).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, tie_embeddings=True, sub_quadratic=True,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2),
)
