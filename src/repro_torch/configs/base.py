"""Config schema: architectures, shapes, meshes, runs.

Every assigned architecture is a ``ModelConfig``; the four canonical input
shapes are ``ShapeConfig``s; ``RunConfig`` carries the LEXI codec knobs plus
distribution/training hyper-parameters.  Everything is a frozen dataclass so
configs hash cleanly (and repr identically to the JAX package's, which
the page-transfer config fingerprint relies on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.collectives import CodecConfig


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int               # routed experts
    top_k: int
    d_ff: int                    # per-expert hidden size
    n_shared: int = 0            # always-on shared experts (deepseek)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention geometry."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64            # may be non-power-of-2 (hymba: 50)
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128             # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        di = self.d_inner(d_model)
        assert di % self.headdim == 0, (di, self.headdim)
        return di // self.headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                    # dense FFN hidden (per-expert size in MoEConfig)
    vocab_size: int
    head_dim: int = 128
    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norm: bool = False      # gemma2 sandwich norms
    rope_theta: float = 10_000.0
    attn_layout: str = "full"    # full | alternating_local | hymba_3global
    window: Optional[int] = None # sliding-window size for local layers
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    parallel_hybrid: bool = False  # hymba: attn and SSM heads in parallel
    # encoder-decoder / multimodal frontends
    encdec: bool = False         # n_layers encoder + n_layers decoder
    frontend: str = "none"       # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0   # patch/frame tokens supplied pre-embedded
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) scaling
    sub_quadratic: bool = False  # eligible for long_500k (SSM/hybrid)

    # ---- derived ----
    def padded_heads(self, tp: int) -> int:
        """Query heads padded up to a multiple of tp (zero-init extra heads;
        the waste is reported via the MODEL_FLOPS/HLO ratio)."""
        if self.n_heads == 0:
            return 0
        return -(-self.n_heads // tp) * tp

    def kv_repeat(self, tp: int) -> int:
        """KV-head replication factor when kv < tp (MaxText-style)."""
        if self.n_kv_heads == 0:
            return 1
        return max(1, tp // self.n_kv_heads)

    def padded_vocab(self, tp: int) -> int:
        return -(-self.vocab_size // (tp * 128)) * (tp * 128)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.head_dim
        if self.n_heads:
            if self.mla is not None:
                m = self.mla
                q = d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_dim) \
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
                o = self.n_heads * m.v_dim * d
                per_layer += q + kv + o
            else:
                per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            per_layer += d * (2 * di + 2 * self.ssm.d_state + nh) \
                + di * self.ssm.d_conv + di * d
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.n_experts * 3 * e.d_ff + d * e.n_experts
            per_layer += d * e.n_shared * 3 * e.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        total = emb + l * per_layer * (2 if self.encdec else 1)
        if self.encdec:  # cross-attention in decoder layers
            total += l * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                          + self.n_heads * hd * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d, l = self.d_model, self.n_layers
        inactive = l * d * 3 * e.d_ff * (e.n_experts - e.top_k)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason) for each of the 40 cells (skips documented)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("full-attention arch: 512k-token decode cache is "
                       "quadratic-history; skipped per task instructions")
    return True, ""


# ---------------------------------------------------------------------------
# mesh + run
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pod: int = 1                 # >1 => multi-pod (pure extra DP / batch)

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pod


@dataclasses.dataclass(frozen=True)
class RunConfig:
    codec: CodecConfig = CodecConfig()
    fsdp: bool = True            # shard stacked block params over data
    fsdp_min_size: int = 1 << 16
    # "megatron": model axis = tensor parallelism (head/ffn sharding with
    #   sequence-parallel boundaries).  "fsdp": model axis = extra parameter
    #   sharding; batch shards over it too and block compute is fully local
    #   (ZeRO-3-style; weight gathers are LEXI-compressed).  The §Perf
    #   hillclimb shows fsdp wins for small-d_model training shapes.
    tp_strategy: str = "megatron"
    remat: bool = True
    loss_chunk: int = 512        # seq chunk for vocab-sharded xent
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    decode_ring: int = 256       # raw tail tokens before block compression
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    seed: int = 0
