"""Language models (ports ``repro/models/lm.py``): decoder-only, the
vision-stub VLM (``front_embeds`` take the first ``n_frontend_tokens``
positions) and the encoder-decoder (a non-causal encoder trunk over
``enc_embeds``, whose normed output is every decoder layer's
cross-attention memory; at tp > 1 the encoder runs sequence-sharded and
its output is gathered, LEXI-packed, to every rank).

The vocabulary is padded to a multiple of tp * 128 (``padded_vocab``) and,
at tp > 1, sharded over the ranks (rows of ``embed``, columns of
``lm_head``); padded logit columns are masked to NEG_INF.  The embedding
is a vocab-sharded lookup whose partials (exactly one nonzero per token)
are reduce-scattered over the sequence in prefill (the trunk's
sequence-sharded layout) or summed in decode; logits stay vocab-sharded
(``serve.engine.greedy_token`` reduces them).

Training on a data x model mesh (``launch.mesh.Mesh``): ``lm_table(cfg,
tp=M, data=D, run=run)`` is the reference's table -- under the megatron
strategy the tp table FSDP-sharded over the D data ranks; under the fsdp
strategy the blocks built at tp = 1 and sharded over ("data", "model")
(("model",) at D = 1), the embedding and the head vocab-sharded over
model.  ``train_forward`` is the train path of ``lm_forward`` (each
layer's weights gathered, LEXI-packed, then its block, both under
activation checkpointing): at M > 1 the rank's sequence shard goes
through the blocks' tp path (megatron), or a raw all-to-all moves the
batch from sequence- to batch-sharded and back around blocks that run
locally (fsdp).  ``train_loss`` is the rank's share of the global mean
next-token loss (``chunked_xent``: vocab-sharded, and at M > 1 tp = 1's
function, not the reference's; ROADMAP.md section 3, item 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from . import attention, blocks, layers
from .params import PDef, apply_fsdp, fsdp_dims, stack, strip_model_specs


def lm_table(cfg: ModelConfig, tp: int = 1, data: int = 1,
             run: Optional[RunConfig] = None) -> Dict:
    """The parameter table at ``tp`` model ranks; with ``run`` (training)
    on a ``data`` x ``tp`` mesh: under ``run.tp_strategy`` "megatron" its
    leaves FSDP-sharded over ``data`` ranks when ``run.fsdp``; under
    "fsdp" the blocks built at tp = 1 (their "model" specs stripped) and
    sharded over ("data", "model") (("model",) at data = 1), the
    embedding and the head kept vocab-sharded over model
    (``repro/models/lm.py:33-128``)."""
    vp = cfg.padded_vocab(tp)
    d = cfg.d_model
    fsdp_mode = run is not None and run.tp_strategy == "fsdp"
    tp_blocks = 1 if fsdp_mode else tp
    t: Dict = {
        "embed": PDef((vp, d), "normal:0.02", spec=("model", None)),
        "final_norm": PDef((d,), "ones"),
    }
    if cfg.encdec:
        t["enc_blocks"] = stack(blocks.block_table(cfg, tp_blocks),
                                cfg.n_layers)
        t["enc_norm"] = PDef((d,), "ones")
    t["blocks"] = stack(blocks.block_table(cfg, tp_blocks,
                                           cross=cfg.encdec), cfg.n_layers)
    if not cfg.tie_embeddings:
        t["lm_head"] = PDef((d, vp), "normal:0.02", spec=(None, "model"))
    if fsdp_mode:
        for key in ("blocks", "enc_blocks"):
            if key in t:
                t[key] = strip_model_specs(t[key])
        t = apply_fsdp_tree(t, data * tp, run, ("data", "model")
                            if data > 1 else ("model",))
    elif run is not None and run.fsdp and data > 1:
        t = apply_fsdp_tree(t, data, run)
    return t


def apply_fsdp_tree(t: Dict, n: int, run: RunConfig,
                    axes=("data",)) -> Dict:
    """FSDP over the ``n`` ranks of mesh ``axes``: the stacked blocks
    never on their layer dim; under the megatron strategy the embedding
    and the head too, on their largest free dim (the fsdp strategy keeps
    them vocab-sharded only)."""
    out = dict(t)
    for key in ("blocks", "enc_blocks"):
        if key in out:
            out[key] = apply_fsdp(out[key], n, run.fsdp_min_size,
                                  skip_dim0=True, axes=axes)
    if run.tp_strategy != "fsdp":
        for key in ("embed", "lm_head"):
            if key in out:
                out[key] = apply_fsdp(out[key], n, run.fsdp_min_size)
    return out


def lm_fsdp_dims(table: Dict) -> Dict:
    """Each leaf's FSDP dim (None: replicated), as a tree beside the
    params."""
    return {"blocks": fsdp_dims(table["blocks"]),
            "embed": table["embed"].fsdp_dim,
            "lm_head": table["lm_head"].fsdp_dim if "lm_head" in table
            else None}


def layer_params(params, i: int, key: str = "blocks"):
    """Layer ``i``'s leaves (views) of the stacked block tree ``key``
    (``enc_blocks``: the encoder's); a ``PackedWeight`` leaf slices all
    its packed fields."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params[key])


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor, tg=None,
                 scatter: bool = False) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) bf16 (gemma-style sqrt(d) scaling when
    the config asks for it).  At tp > 1 ``tokens`` are the same on every
    rank and ``table`` the rank's vocab rows: each rank looks up its rows
    (zero elsewhere) and the partials are reduce-scattered over the
    sequence (``scatter``: (B, S/tp, D), prefill) or summed (decode)."""
    if cl.world(tg) == 1:
        emb = table[tokens.to(torch.int64)]
    else:
        v_loc = table.shape[0]
        idx = tokens.to(torch.int64) - tg.rank * v_loc
        ok = (idx >= 0) & (idx < v_loc)
        emb = torch.where(ok[..., None], table[idx.clamp(0, v_loc - 1)],
                          torch.zeros((), dtype=table.dtype,
                                      device=table.device))
        emb = cl.psum_scatter(emb, tg, 1) if scatter else cl.psum(emb, tg)
    if cfg.scale_embeddings:
        emb = (emb.float() * float(cfg.d_model) ** 0.5).to(torch.bfloat16)
    return emb


def logits_for(cfg: ModelConfig, params, x: torch.Tensor,
               tg=None) -> torch.Tensor:
    """x (B,1,D) -> (B,1,Vp) f32 logits, padded columns masked (at tp > 1
    the rank's Vp/tp columns).  A packed ``lm_head`` goes through
    ``layers.matmul_f32`` like every weight."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.softcap(layers.matmul_f32(x, head), cfg.final_softcap)
    v_loc = head.shape[1]
    col_ok = cl.rank(tg) * v_loc + torch.arange(v_loc, device=x.device) \
        < cfg.vocab_size
    return torch.where(col_ok, logits, layers.NEG_INF)


def encode(cfg: ModelConfig, run: RunConfig, params,
           enc_embeds: torch.Tensor, tg=None) -> torch.Tensor:
    """An encoder-decoder's encoder trunk: frame embeddings (B, Sm, D)
    through the non-causal encoder blocks (the config's softcap), then
    ``enc_norm`` -> the memory (B, Sm, D) bf16.  At tp > 1 (Sm % tp == 0,
    as the reference's slice needs) the rank runs its contiguous Sm / tp
    frames through the blocks' tp path (its gathers' bytes labelled
    ``encoder``), and the normed shards are gathered LEXI-packed
    (``memory``), so every rank holds the whole memory
    (``repro/models/lm.py:319-331``).  The reference's tp = 1 gather of
    the memory round-trips it through the codec, the identity without
    escape overflow; the port drops it (see ``blocks``)."""
    tp, sm = cl.world(tg), enc_embeds.shape[1]
    if sm % tp:
        raise ValueError(f"{cfg.name}: {sm} encoder frames do not split "
                         f"over tp {tp}")
    sm_loc = sm // tp
    x = enc_embeds[:, cl.rank(tg) * sm_loc:(cl.rank(tg) + 1) * sm_loc] \
        .to(torch.bfloat16)
    positions = torch.arange(sm, dtype=torch.int32, device=x.device)
    spec = layers.AttnSpec(causal=False, softcap=cfg.attn_softcap)
    for i in range(cfg.n_layers):
        x = blocks.block_forward(cfg, run, layer_params(params, i,
                                                        "enc_blocks"),
                                 x, positions, spec, tg=tg,
                                 kind="encoder")[0]
    x = layers.rms_norm(x, params["enc_norm"], cfg.norm_eps)
    if tp == 1:
        return x
    return cl.compressed_all_gather(x, tg, run.codec, gather_axis=1,
                                    kind="memory")


def front_embed(cfg: ModelConfig, x: torch.Tensor,
                front_embeds: torch.Tensor, tg=None) -> torch.Tensor:
    """A vision-stub VLM's embeddings: ``front_embeds`` (B,
    n_frontend_tokens, D) replace the token embeddings of the first
    n_frontend_tokens positions of the rank's sequence shard x (B, S/tp,
    D) (positions ``rank * S/tp + arange(S/tp)``), so the front tokens
    may end inside shard 0, span shards or fill several
    (``repro/models/lm.py:312-316``)."""
    s_loc = x.shape[1]
    pos = cl.rank(tg) * s_loc + torch.arange(s_loc, device=x.device)
    nf = cfg.n_frontend_tokens
    fe = front_embeds.index_select(1, pos.clamp(0, nf - 1))
    return torch.where((pos < nf)[None, :, None], fe.to(x.dtype), x)


def lm_forward(cfg: ModelConfig, run: RunConfig, params,
               tokens: torch.Tensor, want_cache: bool = False,
               cache_fn=None, groups: int = 1, tg=None,
               xcache_fn=None, front_embeds: Optional[torch.Tensor] = None,
               enc_embeds: Optional[torch.Tensor] = None):
    """Trunk forward: tokens (B, S) -> (final-normed hidden (B, S, D),
    per-layer ``cache_fn(i, kv, ssm_state)`` results or None).  At tp > 1
    (``tg``) every rank takes the whole of ``tokens`` and returns its
    sequence shard (B, S/tp, D) of the hidden state (S % tp == 0).

    ``cache_fn`` (prefill) turns each layer's cache payload -- its rope'd
    (k, v), or an MLA layer's latent (B, S, W), or None without attention
    -- (and a hybrid's or an SSM model's final ``SSMState``, else None)
    into its decode cache right away, so the raw tensors of only one
    layer are alive at a time.  Without ``cache_fn`` the list holds the
    (kv, ssm_state) pairs.  ``xcache_fn(i, xkv)`` does the same for an
    encoder-decoder's cross-attention payload (the memory's (k, v)).  The
    B sequences run as ``groups`` separate prefills (``B``: each sequence
    on its own): MoE layers dispatch each group's tokens on their own, and
    at tp > 1 the gathers compress each group's activations on their own.

    A vision-stub VLM's ``front_embeds`` (B, n_frontend_tokens, D)
    replace the embeddings of the first ``n_frontend_tokens`` positions
    (``front_embed``); an encoder-decoder's ``enc_embeds`` (B, Sm, D) go
    through ``encode``, and the whole memory goes to every decoder layer
    (at tp > 1 too: every rank holds the same ``front_embeds`` and
    ``enc_embeds``)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    if s % cl.world(tg):
        raise ValueError(f"prefill of {s} tokens does not split over tp "
                         f"{cl.world(tg)}")
    x = embed_tokens(cfg, params["embed"], tokens, tg, scatter=True)
    if cfg.frontend == "vision_stub" and front_embeds is not None:
        x = front_embed(cfg, x, front_embeds, tg)
    memory = mem_pos = None
    if cfg.encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             "enc_embeds")
        memory = encode(cfg, run, params, enc_embeds, tg)
        mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                               device=tokens.device)
    caches = [] if want_cache else None
    for i in range(cfg.n_layers):
        win: Optional[int] = None if wins is None else int(wins[i])
        out = blocks.block_forward(cfg, run, layer_params(params, i), x,
                                   positions, spec, window=win,
                                   want_cache=want_cache, groups=groups,
                                   tg=tg, memory=memory,
                                   mem_positions=mem_pos)
        x, kv, st = out[:3]
        if want_cache:
            caches.append(cache_fn(i, kv, st) if cache_fn is not None
                          else (kv, st))
            if memory is not None and xcache_fn is not None:
                xcache_fn(i, out[3])
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), caches


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def gathered_embed(params, dims, run: RunConfig, mesh) -> torch.Tensor:
    """The embedding table, its FSDP shard gathered (compressed)."""
    e = params["embed"]
    if dims.get("embed") is not None:
        e = blocks.gather_fsdp(e, dims["embed"], run, mesh, in_scan=False)
    return e


def gathered_head(cfg: ModelConfig, params, dims, run: RunConfig,
                  mesh) -> torch.Tensor:
    if cfg.tie_embeddings:
        return gathered_embed(params, dims, run, mesh).T
    h = params["lm_head"]
    if dims.get("lm_head") is not None:
        h = blocks.gather_fsdp(h, dims["lm_head"], run, mesh, in_scan=False)
    return h


def chunked_xent(cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
                 head: torch.Tensor, labels: torch.Tensor,
                 tg=None) -> torch.Tensor:
    """Vocab-sharded cross entropy in sequence chunks of ``run.loss_chunk``:
    x (B, S/tp, D) bf16 (the rank's sequence shard), head (D, Vp/tp) (its
    vocab shard), labels (B, S) (the whole sequence) -> the f32 SUM of
    the token losses of the rank's own S/tp positions.  Padded vocab
    columns are masked to NEG_INF at the rank's offset; the max shift
    carries no gradient (``detach``, the reference's ``stop_gradient``).

    At tp > 1 (Megatron's vocab-parallel cross entropy) x is gathered
    over the group (``lexi_all_gather``, its bytes labelled ``loss``), the
    rank's logits cover all S positions of its vocab shard, the max is a
    ``pmax`` and the exp-sums and target logits a ``psum`` (differentiable:
    its backward psums the cotangents), so every rank holds each token's
    whole log-sum-exp; each rank then sums only its own positions (the
    others masked to 0, so every chunk's psum is in every rank's backward
    too), and the sum over ranks counts every token once: tp = 1's
    function.  The
    reference's ``chunked_xent`` (``repro/models/lm.py:167-204``) psums
    each rank's partials of its own positions with the other ranks'
    partials of theirs, mixing tokens (ROADMAP.md section 3, item 9)."""
    tp, me = cl.world(tg), cl.rank(tg)
    if tp > 1:
        x = cl.lexi_all_gather(x, tg, run.codec, gather_axis=1, kind="loss")
    b, s, _ = x.shape
    v = head.shape[1]
    off = me * v
    col_ok = off + torch.arange(v, device=x.device) < cfg.vocab_size
    lo, hi = me * (s // tp), (me + 1) * (s // tp)
    c = min(run.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        logits = layers.softcap(layers.matmul_f32(x[:, c0:c0 + c], head),
                                cfg.final_softcap)
        logits = torch.where(col_ok, logits, layers.NEG_INF)
        mx = cl.pmax(logits.detach().max(-1).values, tg)
        se = torch.exp(logits - mx[..., None]).sum(-1)
        idx = labels[:, c0:c0 + c].to(torch.int64) - off
        ok = (idx >= 0) & (idx < v)
        tgt = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
        tgt = torch.where(ok, tgt, 0.0)
        if tp > 1:
            se, tgt = cl.psum(torch.stack([se, tgt]), tg).unbind(0)
        loss = torch.log(se) + mx - tgt
        if tp > 1:
            # every chunk stays in every rank's graph (masked, not
            # skipped), so every rank runs each chunk's psum backward
            pos = torch.arange(c0, c0 + c, device=x.device)
            loss = torch.where((pos >= lo) & (pos < hi), loss, 0.0)
        total = total + loss.sum()
    return total


def unbind_layers(stacked, n_layers: int) -> list:
    """The per-layer trees of a stacked block tree, each leaf unbound
    once (the backward of ``unbind`` is one ``stack``; indexing each
    layer would allocate a whole-leaf gradient per layer)."""
    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        return t.unbind(0)
    return split(stacked)


def train_forward(cfg: ModelConfig, run: RunConfig, params,
                  tokens: torch.Tensor, mesh, dims: Dict) -> torch.Tensor:
    """The train path of ``lm_forward``: tokens (B, S) (every model rank
    of a data index the same) -> the final-normed hidden state of the
    rank's sequence shard (B, S/tp, D).  Each layer gathers its
    FSDP-sharded weights (``blocks.gather_fsdp``) and runs its block; with
    ``run.remat`` both run under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body), so the backward
    gathers each layer's weights again.  At tp > 1 the embedding is
    reduce-scattered over the sequence; under the megatron strategy the
    shard goes through the blocks' tp path, under fsdp a raw all-to-all
    moves (B, S/tp, D) to (B/tp, S, D), the blocks run locally, and a
    second moves it back (``repro/models/lm.py:277-350``)."""
    import torch.utils.checkpoint as ckpt

    b, s = tokens.shape
    tg = mesh.axis_group(("model",))
    tp = cl.world(tg)
    if s % tp:
        raise ValueError(f"sequence {s} does not split over model {tp}")
    fsdp_mode = run.tp_strategy == "fsdp" and tp > 1
    if fsdp_mode and b % tp:
        raise ValueError(f"tp_strategy=fsdp needs the per-data-rank batch "
                         f"{b} divisible by model={tp}")
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    x = embed_tokens(cfg, gathered_embed(params, dims, run, mesh), tokens,
                     tg, scatter=True)
    if fsdp_mode:
        x = cl.all_to_all(x, tg, split_axis=0, concat_axis=1)
    btg = None if fsdp_mode else tg

    def body(p_layer, xb, win):
        p = blocks.gather_fsdp(p_layer, dims["blocks"], run, mesh)
        return blocks.block_forward(cfg, run, p, xb, positions, spec,
                                    window=win, tg=btg)[0]

    for i, p_layer in enumerate(unbind_layers(params["blocks"],
                                              cfg.n_layers)):
        win: Optional[int] = None if wins is None else int(wins[i])
        if run.remat:
            x = ckpt.checkpoint(body, p_layer, x, win, use_reentrant=False)
        else:
            x = body(p_layer, x, win)
    if fsdp_mode:
        x = cl.all_to_all(x, tg, split_axis=1, concat_axis=0)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def train_loss(cfg: ModelConfig, run: RunConfig, params, batch: Dict,
               mesh, dims: Dict) -> torch.Tensor:
    """This rank's share of the global mean next-token loss: the token-loss
    sum of its data rank's batch slice and its own sequence shard over
    the GLOBAL token count (B * S * data).  No collective reduces the
    loss value inside autograd (the reference's rule: the caller sums the
    ranks' values outside it); the sharded leaves' gradients come from
    the gathers' reduce-scatters, the replicated ones are summed by
    ``train.optimizer.sync_grads``."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = train_forward(cfg, run, params, tokens, mesh, dims)
    head = gathered_head(cfg, params, dims, run, mesh)
    b, s = tokens.shape
    return chunked_xent(cfg, run, x, head, labels,
                        mesh.axis_group(("model",))) / (
        b * s * mesh.size(("data",)))
