"""Simba-style 6×6 chiplet mesh communication model (paper §5.1/§5.3; a
copy of ``repro/hw/noc.py``, which imports neither JAX nor ``repro``).

Replaces the paper's trace-driven HeteroGarnet runs with an analytical
network model.  Layers map round-robin onto the 6×6 compute array (4 west-
edge memory chiplets, Simba-style package DRAM).  Traffic classes per phase:

  weights      : memory -> compute, streamed once per phase (weight-resident
                 execution within a phase; per-layer working set),
  activations  : producer -> consumer chiplet, once per token per layer,
  KV cache     : write once per token; decode reads the history once per
                 cache block of tokens (block-resident reuse, matching the
                 block-by-block compression granularity),
  SSM state    : read + write once per token per layer (fixed size).

Latency: wormhole routing with a hop-dependent contention factor
(bytes x (1 + 0.5·(hops-1)) / link_bw + router pipeline per hop); compute is
dense FLOPs at 4 TOPS/chiplet.  LEXI scales each class by its *measured*
whole-value compression ratio (fed from the real codec, not assumed).

Calibration targets (paper Table 3 / Fig 7): comm = 68–95 % of e2e
uncompressed; LEXI cuts comm 33–45 % and e2e 30–35 %.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

MESH_X, MESH_Y = 6, 6
LINK_GBPS = 100.0                    # paper: 100 Gb/s inter-chiplet links
ROUTER_NS_PER_HOP = 5.0
CHIPLET_TOPS = 4.0                   # Simba-class chiplet, dense ops/s
MEM_PORTS = ((0, 0), (0, 2), (0, 3), (0, 5))   # west-edge memory chiplets
CACHE_REUSE_BLOCK = 256              # decode re-reads history once per block


def _xy_hops(a: Tuple[int, int], b: Tuple[int, int]) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """The per-transfer cost model of one inter-chiplet route — the single
    source of truth for link latency, shared by the phase-level simulator
    below (``simulate``) and the serving-stack page transport
    (``repro_torch.serve.transport``), which meters every prefill→decode
    replica handoff through it to report the paper's link-byte/latency
    reduction.

    Wormhole routing with a hop-dependent contention factor plus a router
    pipeline charge per hop (paper §5.1).
    """
    gbps: float = LINK_GBPS
    router_ns_per_hop: float = ROUTER_NS_PER_HOP

    def transfer_ns(self, nbytes: float, hops: int = 1) -> float:
        hops = max(int(hops), 1)
        contention = 1.0 + 0.5 * (hops - 1)
        return (hops * self.router_ns_per_hop
                + nbytes * contention / (self.gbps / 8.0))


@dataclasses.dataclass
class MeteredLink:
    """LinkModel façade that accounts every priced transfer into a
    telemetry registry under ``<prefix>.bytes`` / ``<prefix>.transfers``
    / ``<prefix>.model_ns``.  ``registry`` is duck-typed (anything with
    ``counter(name).inc(n)`` — in practice
    :class:`repro_torch.serve.telemetry.MetricsRegistry`), so the hardware
    model stays import-free of the serving stack."""
    link: LinkModel
    registry: object
    prefix: str = "link"

    def transfer_ns(self, nbytes: float, hops: int = 1) -> float:
        ns = self.link.transfer_ns(nbytes, hops)
        reg = self.registry
        reg.counter(f"{self.prefix}.bytes").inc(int(nbytes))
        reg.counter(f"{self.prefix}.transfers").inc()
        reg.counter(f"{self.prefix}.model_ns").inc(ns)
        return ns


def _chiplet_of(layer: int) -> Tuple[int, int]:
    idx = layer % (MESH_X * MESH_Y)
    return (idx % MESH_X, idx // MESH_X)


def _nearest_mem(c: Tuple[int, int]) -> Tuple[int, int]:
    return min(MEM_PORTS, key=lambda m: _xy_hops(m, c))


@dataclasses.dataclass
class SimResult:
    comm_ms: float
    compute_ms: float
    class_ms: Dict[str, float]

    @property
    def e2e_ms(self) -> float:
        # the paper reports comm dominating 68-95 % of e2e; Simba overlaps
        # compute with NoC transfers only marginally -> serial composition.
        return self.comm_ms + self.compute_ms


def _kv_width(cfg) -> float:
    if cfg.mla is not None:
        return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    return 2.0 * cfg.n_kv_heads * cfg.head_dim


def simulate(cfg, *, in_tokens: int, out_tokens: int,
             crs: Dict[str, float]) -> Dict[str, SimResult]:
    """Prefill + decode phases under three methods (paper Table 3 rows):
    uncompressed / compressed weights only / full LEXI."""
    methods = {
        "uncompressed": {"weights": 1.0, "activations": 1.0, "cache": 1.0},
        "weights_only": {"weights": crs["weights"], "activations": 1.0,
                         "cache": 1.0},
        "lexi": dict(crs),
    }
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer_w = (cfg.param_count() - emb) / cfg.n_layers * 2.0
    active_scale = cfg.active_param_count() / cfg.param_count()
    kvw = _kv_width(cfg) if cfg.n_heads else 0.0
    ssm_state = 0.0
    if cfg.ssm is not None:
        ssm_state = (cfg.ssm.n_heads(d) * cfg.ssm.headdim * cfg.ssm.d_state
                     * 2.0 + cfg.ssm.d_inner(d) * (cfg.ssm.d_conv - 1) * 2.0)

    link = LinkModel()
    out: Dict[str, SimResult] = {}
    for mname, mcr in methods.items():
        cls_ns = {"weights": 0.0, "activations": 0.0, "cache": 0.0}
        flops = 0.0

        def xfer(src, dst, nbytes, cls):
            cls_ns[cls] += link.transfer_ns(nbytes,
                                            max(_xy_hops(src, dst), 1))

        for li in range(cfg.n_layers):
            c = _chiplet_of(li)
            mem = _nearest_mem(c)
            nxt = _chiplet_of(li + 1)
            # --- weights: once per phase (prefill + decode) ---------------
            w = per_layer_w / mcr["weights"]
            xfer(mem, c, 2.0 * w, "weights")
            # --- activations: per token, both phases ----------------------
            a_tok = 2.0 * d * 2.0 / mcr["activations"]   # boundary in+out
            xfer(c, nxt, a_tok * (in_tokens + out_tokens), "activations")
            # --- hybrid caches --------------------------------------------
            if kvw:
                k_write = kvw * 2.0 * (in_tokens + out_tokens) / mcr["cache"]
                xfer(c, mem, k_write, "cache")
                # decode: history re-read once per reuse block
                hist = 0.0
                for blk_start in range(0, out_tokens, CACHE_REUSE_BLOCK):
                    hist += (in_tokens + blk_start) * kvw * 2.0
                xfer(mem, c, hist / mcr["cache"], "cache")
            if ssm_state:
                s_rw = 2.0 * ssm_state * out_tokens / mcr["cache"]
                xfer(c, mem, s_rw, "cache")
            # --- compute ---------------------------------------------------
            flops += (2.0 * per_layer_w / 2.0 * active_scale
                      * (in_tokens + out_tokens))
        compute_ms = flops / (CHIPLET_TOPS * 1e12 * MESH_X * MESH_Y) * 1e3
        comm_ms = sum(cls_ns.values()) * 1e-6
        out[mname] = SimResult(
            comm_ms=comm_ms, compute_ms=compute_ms,
            class_ms={k: v * 1e-6 for k, v in cls_ns.items()})
    return out
