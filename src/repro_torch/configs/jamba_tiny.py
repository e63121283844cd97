"""jamba-tiny-dev (319M) — paper's hybrid model #1 (benchmark suite).

Used by the Table-2/3/Fig-7 reproduction.  Approximation note: Jamba
interleaves attention and Mamba layers serially with MoE on alternate
layers; our runnable zoo realizes hybrids as parallel attn∥SSM blocks, so
this config is used (a) at full shape analytically by the Simba traffic
model and (b) reduced for CR measurements, where only tensor shapes and
value distributions matter.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-tiny-dev", family="hybrid",
    n_layers=8, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=0,
    vocab_size=65536, head_dim=64, parallel_hybrid=True, sub_quadratic=True,
    ssm=SSMConfig(d_state=16, headdim=64, expand=2),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=2048),
)
